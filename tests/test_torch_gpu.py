"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where torch sees no CUDA device. On a machine
with a card (and no JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Shapes are small and ragged on purpose (D not a multiple of 32, one-lane D,
min_disp > 0, even and odd blocks, crops and row counts that are no multiple
of the cost kernel's tile, single pixels, rows and columns, long diagonals,
unaligned volumes), with stress maps for the keep-mask kernels (every
scatter on one address, rows past 48 KB of shared memory, one component
over a 4K frame, a component per pixel) and the torch ops of rectification
and reprojection held to the same calls on the CPU, the remap kernel to
its plain version on rig maps and on maps of every edge case (off-image
taps, integer and half-pixel coordinates), the points layer's two kernels
(reprojection and compaction) to the plain ops bit for bit, with no host
sync and three kernels a frame; chip_smoke.py checks
the full-size shapes of the main path. The sparse path (torch ops, no
kernel of its own) is held to the port's CPU run: SIFT keypoints and
descriptors, the distance matrix, the robust fits given the same samples,
and the pose of a rendered scene; the robust fits index no CUDA tensor with
a boolean mask (a host sync). The learned matcher is held to its CPU run
under PyTorch's default cuDNN flags: the net's outputs, detection with and
without corner refinement (and twice on the card), the corner refinement
against float64 and the LK refinement of matches. Calibration (torch ops,
no kernel of its own) is held to its CPU run at chip_smoke.py phase 9's
bounds: the saddle response, the candidates, the corners of rendered boards
(1e-3 px), homographies, Zhang's K and poses, calibrate_camera and
calibrate_stereo (1e-8 relative); its LM makes no host sync. The streaming
path: nvJPEG against PIL, the prefetch loader's side-stream batches against
synchronous copies (no host sync in the consumer's loop), stream_reconstruct
against the per-pair path, and the bench's config 1 step (one cost launch,
equal to its CPU run). XFeat training: two train_steps on the card against
the CPU with the same draws (TF32 allowed by the caller), train() at a small
size (no kernel launched, the weights saved and served), and the stereo
pool's build (every dense and speckle kernel launched) followed by a stereo
train_step (none launched).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu_torch import native
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import epipolar as EP
from stereo_reconstruction_cv_tpu_torch.ops import features as FT
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops import matching as MT
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from stereo_reconstruction_cv_tpu_torch.ops import robust as RB
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cloud as CL
from stereo_reconstruction_cv_tpu_torch.ops.cuda import cost as CK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import lr as LK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import op_chain as OC
from stereo_reconstruction_cv_tpu_torch.ops.cuda import remap as RK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import speckle as SPK
from stereo_reconstruction_cv_tpu_torch.parallel import streaming as ST
from stereo_reconstruction_cv_tpu_torch.pipeline import stages
from stereo_reconstruction_cv_tpu_torch.tools import micro_i16
from stereo_reconstruction_cv_tpu_torch.utils import synth
from remap_edge import edge_map

pytestmark = pytest.mark.gpu

P1, P2 = 8 * 3 * 121, 32 * 3 * 121


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _planes(seed, H, W, dev, cap=63, dtype=torch.int32):
    rng = np.random.default_rng(seed)
    left = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).to(dev)
    right = torch.roll(left, -3, 1)
    out = []
    for p in (CK.xsobel_clip(left, cap), CK.xsobel_clip(right, cap), left, right):
        p = p.to(dtype, copy=True)
        p[:, 0] = cap
        p[:, -1] = cap
        out.append(p)
    return out


# uint8 planes take the packed kernel, int32 planes (byte-range values) the
# int32 one; both are held to the plain version on the same shapes.
PLANE_DTYPES = [torch.uint8, torch.int32]


def _paths_grown(fn):
    """fn()'s result and how much it grew each of CK.cost_paths' counts."""
    before = dict(CK.cost_paths)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: CK.cost_paths[k] - before[k] for k in before}


@pytest.mark.parametrize("dtype", PLANE_DTYPES)
@pytest.mark.parametrize("H,W,D,md,block", [
    (24, 60, 16, 0, 11), (33, 150, 100, 3, 11), (17, 41, 32, 8, 5), (9, 50, 48, 1, 11),
])
def test_cost_volume_kernel_equals_plain(dev, H, W, D, md, block, dtype):
    planes = _planes(H * W, H, W, dev, dtype=dtype)
    got, grew = _paths_grown(lambda: CK.cost_volume(*planes, D, md, block))
    ref = CK.cost_volume_plain(*planes, D, md, block)
    assert torch.equal(got, ref)
    assert grew == ({"u8x2": 1, "i32": 0} if dtype == torch.uint8 else {"u8x2": 0, "i32": 1})


@pytest.mark.parametrize("dtype", PLANE_DTYPES)
@pytest.mark.parametrize("H", [9, 70])  # one row band short of 64 rows, and two
@pytest.mark.parametrize("block", [1, 4, 5, 11])
@pytest.mark.parametrize("D", [1, 17, 96, 100, 256])
def test_cost_volume_tiles_and_edges_equal_plain(dev, H, block, D, dtype):
    """Cropped width 131: no multiple of any tile's columns (32, 54, 60, 61);
    D % 8 != 0 takes the masked scalar stores."""
    md = 3
    planes = _planes(H + block + D, H, md + D + 131, dev, dtype=dtype)
    got = CK.cost_volume(*planes, D, md, block)
    ref = CK.cost_volume_plain(*planes, D, md, block)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _extreme_planes(kind, H, W, dev, cap=63):
    """uint8 planes at the packed lanes' extremes, pinned as cost_planes pins
    them: "alternating", raw columns 0/255 and Sobel columns 0/2*cap, the
    right view one column over; "flat", the left view at 255 and 2*cap, the
    right at 0, so every BT term away from the pins is 255 or 2*cap and the
    box sums reach check_cost_bounds' worst case; "full", the left at 255
    and the right at 0 on both planes (no pins), a pixel cost of 318 and box
    sums past int16 (the plain version's wrap)."""
    x = torch.arange(W, device=dev)
    odd = (x % 2 == 1).expand(H, W)
    byte = torch.uint8
    if kind == "alternating":
        sl, rl = (torch.where(odd, 2 * cap, 0), torch.where(odd, 255, 0))
        sr, rr = (torch.where(odd, 0, 2 * cap), torch.where(odd, 0, 255))
    elif kind in ("flat", "full"):
        top = 255 if kind == "full" else 2 * cap
        sl, rl = torch.full((H, W), top, device=dev), torch.full((H, W), 255, device=dev)
        sr, rr = torch.zeros(H, W, device=dev), torch.zeros(H, W, device=dev)
    planes = [p.to(byte) for p in (sl, sr, rl, rr)]
    if kind != "full":
        for p in planes:
            p[:, 0] = cap
            p[:, -1] = cap
    return planes


@pytest.mark.parametrize("kind,block", [("alternating", 11), ("flat", 11), ("full", 14),
                                        ("full", 11), ("alternating", 4)])
@pytest.mark.parametrize("D", [64, 100])
def test_cost_volume_packed_lanes_at_their_extremes_equal_plain(dev, kind, block, D):
    H, W = 70, 3 + D + 131
    planes = _extreme_planes(kind, H, W, dev)
    got, grew = _paths_grown(lambda: CK.cost_volume(*planes, D, 3, block))
    ref = CK.cost_volume_plain(*planes, D, 3, block)
    assert grew == {"u8x2": 1, "i32": 0}
    assert torch.equal(got, ref)
    if kind == "flat" and block == 11:
        # the worst box sum check_cost_bounds admits at cap 63: 121 * 189
        assert int(got.max()) == 121 * (2 * 63 + 63)
    if kind == "full" and block == 14:
        assert int((got.int() & 0xFFFF).max()) == 14 * 14 * 318  # past int16, below 2^16


def test_cost_volume_takes_int32_kernel_where_lanes_would_carry(dev):
    """A box of 15 on byte planes could carry between 16-bit lanes: the
    planes are widened for the int32 kernel, which wraps as the plain
    version does."""
    planes = _extreme_planes("full", 40, 3 + 32 + 60, dev)
    got, grew = _paths_grown(lambda: CK.cost_volume(*planes, 32, 3, 15))
    assert grew == {"u8x2": 0, "i32": 1}
    assert torch.equal(got, CK.cost_volume_plain(*planes, 32, 3, 15))


@pytest.mark.parametrize("H", [2160, 1112])  # a 4K frame, and one halo-extended mesh block
def test_cost_volume_packed_equals_int32_kernel_at_4k(dev, H):
    W, D = 3840, 256
    planes = _planes(7, H, W, dev)
    bytes_ = [p.to(torch.uint8) for p in planes]
    got, grew = _paths_grown(lambda: CK.cost_volume(*bytes_, D, 0, 11))
    assert grew == {"u8x2": 1, "i32": 0}
    assert torch.equal(got, CK.cost_volume(*planes, D, 0, 11))


def test_sgbm_disparity_takes_packed_cost_kernel(dev):
    """The main path's planes are bytes (cap 63), so one SGBM call is one
    packed launch; int32 planes of the same pair take the int32 kernel."""
    rng = np.random.default_rng(11)
    left = torch.from_numpy(rng.integers(0, 256, (48, 160), dtype=np.uint8)).to(dev)
    right = torch.roll(left, -4, 1)
    cfg = DP.SGBMConfig(num_disparities=32, num_directions=5)
    _, grew = _paths_grown(lambda: DP.sgbm_disparity(left, right, cfg))
    assert grew == {"u8x2": 1, "i32": 0}
    planes = DP.cost_planes(left, right, cfg.pre_filter_cap)
    assert all(p.dtype == torch.uint8 for p in planes)
    wide = [p.int() for p in planes]
    C, grew = _paths_grown(lambda: CK.cost_volume(*wide, 32, 0, cfg.block_size))
    assert grew == {"u8x2": 0, "i32": 1}
    assert torch.equal(C, CK.cost_volume(*planes, 32, 0, cfg.block_size))


def _sweep_all_directions(C, start, p1=P1, p2=P2):
    """Each direction of DIRS_8 written onto a copy of `start` and added onto
    another, against the plain deltas (u16 sums)."""
    C32 = C.to(torch.int32)
    for dx, dy in SK.DIRS_8:
        ref = SK.path_delta_plain(C32, dx, dy, p1, p2)
        for accumulate in (False, True):
            acc = start.clone()
            SK.path_sweep_cuda(C, acc, dx, dy, p1, p2, accumulate=accumulate)
            torch.cuda.synchronize()
            want = ((SK.u16(start) if accumulate else 0) + ref) & 0xFFFF
            assert torch.equal(SK.u16(acc), want), (dx, dy, accumulate)


@pytest.mark.parametrize("D", [1, 17, 33, 100, 256, 512])
@pytest.mark.parametrize("H,W", [(1, 1), (1, 40), (40, 1), (4, 300), (300, 4), (23, 37)])
def test_path_sweep_shapes_equal_plain(dev, D, H, W):
    """Single pixels, single rows and columns, long diagonals both ways;
    D % K != 0 (17, 33) takes the scalar accesses, the rest the vector ones."""
    rng = np.random.default_rng(D * 1000 + H * W)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    start = torch.from_numpy(rng.integers(0, 1 << 16, (H, W, D)).astype(np.uint16).view(np.int16)).to(dev)
    _sweep_all_directions(C, start)


@pytest.mark.parametrize("D", [64, 128, 256, 512])
def test_path_sweep_unaligned_takes_the_scalar_path(dev, D):
    """Volumes that start 2 bytes past an aligned address: D % K == 0 but no
    vector access, the same kernel's scalar path."""
    H, W = 13, 29
    rng = np.random.default_rng(D)
    n = H * W * D
    cbuf = torch.from_numpy(rng.integers(0, 20000, n + 1, dtype=np.int16)).to(dev)
    sbuf = torch.from_numpy(rng.integers(0, 1 << 16, n + 1).astype(np.uint16).view(np.int16)).to(dev)
    C, start = cbuf[1:].view(H, W, D), sbuf[1:].view(H, W, D)
    assert not SK.sweep_vector_path(D, C.data_ptr(), start.data_ptr())
    _sweep_all_directions(C, start)


@pytest.mark.parametrize("D", [1, 17, 33, 100, 256, 512])
@pytest.mark.parametrize("H,W", [(1, 1), (1, 40), (40, 1), (4, 90), (90, 4)])
def test_sgm_aggregate_shapes_equal_plain(dev, D, H, W):
    rng = np.random.default_rng(D + H)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    for nd in (5, 8):
        dirs = SK.directions_for(nd)
        S = SK.sgm_aggregate(C, P1, P2, dirs)
        torch.cuda.synchronize()
        assert torch.equal(S, SK.sgm_aggregate_plain(C, P1, P2, dirs))


@pytest.mark.parametrize("nd", [5, 8])
@pytest.mark.parametrize("H,W,D,md", [(19, 37, 16, 0), (26, 45, 100, 3), (8, 70, 256, 2)])
def test_sgm_kernels_equal_plain(dev, nd, H, W, D, md):
    rng = np.random.default_rng(D + nd)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    vols = SK.path_deltas_cuda(C, nd, P1, P2)
    plain = [sum(SK.path_delta_plain(C, dx, dy, P1, P2) for dx, dy in g)
             for g in SK.delta_groups(nd) if g]
    assert len(vols) == len(plain)
    for v, p in zip(vols, plain):
        assert torch.equal(SK.u16(v), p)
    got = SK.sgm_wta(C, P1, P2, nd, 10, md)
    ref = SK.sgm_wta_plain(C, P1, P2, nd, 10, md)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    keep = LK.lr_check_maps(got[2], got[3], got[0], D, md, 1)
    assert torch.equal(keep, LK.lr_check_maps_plain(got[2], got[3], got[0], D, md, 1))


def test_lr_kernel_ties_and_margins(dev):
    """Many equal winning costs: the atomic scatter must keep the smallest d."""
    rng = np.random.default_rng(5)
    H, Wc, D, md = 12, 90, 24, 4
    best = torch.from_numpy(rng.integers(0, D, (H, Wc), dtype=np.int32)).to(dev)
    minS = torch.from_numpy(rng.integers(0, 3, (H, Wc), dtype=np.int32)).to(dev)
    disp = best.float() + md + torch.from_numpy(rng.uniform(-0.5, 0.5, (H, Wc)).astype(np.float32)).to(dev)
    for max_diff in (0, 1, 3):
        got = LK.lr_check_maps(best, minS, disp, D, md, max_diff)
        assert torch.equal(got, LK.lr_check_maps_plain(best, minS, disp, D, md, max_diff))


def _lr_case(kind, seed=0):
    """(best, minS, disp, D, min_disp) int32/int32/f32 numpy maps for the LR
    kernel's stress cases."""
    rng = np.random.default_rng(seed)
    H, Wc, D, md = {"one column": (20, 64, 64, 0), "constant best": (9, 300, 48, 0),
                    "min_disp": (17, 150, 40, 7), "ragged": (13, 301, 33, 2),
                    "rows per block": (71, 30, 16, 3), "past 48 KB": (3, 12400, 16, 0),
                    "single row": (1, 7, 5, 1)}[kind]
    best = rng.integers(0, D, (H, Wc)).astype(np.int32)
    if kind == "one column":  # Wc == D: every left pixel aims at right column D
        best = np.broadcast_to(np.arange(Wc, dtype=np.int32), (H, Wc)).copy()
    elif kind == "constant best":
        best[:] = 17
    best[rng.random((H, Wc)) < 0.05] = -1  # no winner: nothing scattered
    minS = rng.integers(0, 3, (H, Wc)).astype(np.int32)  # many tied winning costs
    frac = rng.uniform(-0.5, 0.5, (H, Wc)).astype(np.float32)
    frac[rng.random((H, Wc)) < 0.2] = 0.0
    disp = (np.maximum(best, 0) + frac + md).astype(np.float32)
    return best, minS, disp, D, md


@pytest.mark.parametrize("kind", ["one column", "constant best", "min_disp", "ragged",
                                  "rows per block", "past 48 KB", "single row"])
def test_lr_kernel_stress_equals_plain(dev, kind):
    """One launch with the right-view rows in shared memory: all scatters on
    one address, min_disp > 0, Wc not a multiple of 4 or of the block,
    several rows a block, a row past 48 KB; written and ANDed into `out`,
    aligned (vector path) and one byte off (scalar path)."""
    best, minS, disp, D, md = (torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                               for a in _lr_case(kind))
    H, Wc = best.shape
    rows = LK.lr_rows_per_block(H, Wc, D, md)
    if kind == "rows per block":
        assert rows > 1 and H % rows != 0
    if kind == "past 48 KB":
        assert 4 * (md + D + Wc) > LK.SMEM_DEFAULT
    rng = np.random.default_rng(1)
    for max_diff in (0, 1, 3):
        ref = LK.lr_check_maps_plain(best, minS, disp, D, md, max_diff)
        got = LK.lr_check_maps(best, minS, disp, D, md, max_diff)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), max_diff
        start = torch.from_numpy(rng.random((H, Wc)) < 0.7).to(dev)
        buf = torch.empty(H * Wc + 1, dtype=torch.bool, device=dev)
        for out in (start.clone(), buf[1:].view(H, Wc)):
            out.copy_(start)
            assert LK.lr_check_maps(best, minS, disp, D, md, max_diff, out=out) is out
            torch.cuda.synchronize()
            assert torch.equal(out, start & ref), max_diff


def test_lr_kernel_refuses_a_row_past_a_block(dev):
    Wc = LK.SMEM_BLOCK_MAX // 4 + 1
    best = torch.zeros((2, Wc), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        LK.lr_check_maps(best, best, best.float(), 16, 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        LK.lr_check_maps(best, best, best.float(), 16, 0, 1,
                         out=torch.ones((Wc, 2), dtype=torch.bool, device=dev).t())


def _keep_case(kind, H, W, seed=0):
    """(labels int32, valid bool) numpy fixpoint label maps for speckle_keep."""
    if kind == "one component":
        return np.zeros((H, W), np.int32), np.ones((H, W), bool)
    if kind == "singletons":
        return np.arange(H * W, dtype=np.int32).reshape(H, W), np.ones((H, W), bool)
    if kind == "all invalid":
        return np.full((H, W), H * W, np.int32), np.zeros((H, W), bool)
    disp, valid = _speckle_case("random", H, W, seed)
    labels, converged = SPK.speckle_labels_plain(torch.from_numpy(disp), torch.from_numpy(valid),
                                                 5.0, max_rounds=4096)
    assert converged
    return labels.numpy(), valid


@pytest.mark.parametrize("kind,H,W,T", [
    ("one component", 2160, 3584, 100), ("one component", 37, 70, 0),
    ("one component", 33, 65, 33 * 65), ("one component", 33, 65, 33 * 65 - 1),
    ("singletons", 300, 512, 0), ("singletons", 129, 257, 1), ("all invalid", 40, 64, 0),
    ("speckled", 200, 321, 3), ("speckled", 64, 128, 0), ("speckled", 64, 128, 64 * 128),
])
def test_speckle_keep_kernel_stress_equals_plain(dev, kind, H, W, T):
    """One component over a 4K frame (one global atomic a block and pass),
    a component per pixel (past every block's table), all invalid, T = 0 and
    T >= H*W; the count cells are zero again after each call."""
    labels_np, valid_np = _keep_case(kind, H, W)
    labels, valid = torch.from_numpy(labels_np).to(dev), torch.from_numpy(valid_np).to(dev)
    ref = SPK.speckle_keep_plain(labels, valid, T)
    for _ in range(2):
        keep = SPK.speckle_keep_cuda(labels, valid, T)
        torch.cuda.synchronize()
        assert torch.equal(keep, ref)
        assert not SPK.count_cells(labels.device, H * W).any()


@pytest.mark.parametrize("x0", [1, 2, 4, 64])
def test_speckle_keep_reads_valid_through_its_row_stride(dev, x0):
    """valid as a column slice of a wider map: 4-byte aligned rows (vector
    path, W % 4 == 0) and unaligned ones (scalar path)."""
    H, W = 45, 128
    labels_np, valid_np = _keep_case("speckled", H, W, seed=x0)
    wide = np.zeros((H, W + x0), bool)
    wide[:, x0:] = valid_np
    valid = torch.from_numpy(wide).to(dev)[:, x0:]
    labels = torch.from_numpy(labels_np).to(dev)
    keep = SPK.speckle_keep_cuda(labels, valid, 3)
    torch.cuda.synchronize()
    assert torch.equal(keep, SPK.speckle_keep_plain(labels, valid.contiguous(), 3))


def test_speckle_keep_in_a_cuda_graph(dev):
    """Captured once, replayed over two label maps of one shape in turns:
    the count cells it captured are zero again after each replay."""
    H, W = 96, 160
    maps = [tuple(torch.from_numpy(a).to(dev) for a in _keep_case(kind, H, W, seed=3))
            for kind in ("speckled", "singletons")]
    labels, valid = (t.clone() for t in maps[0])
    SPK.speckle_keep_cuda(labels, valid, 4)  # makes the count cells outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = SPK.speckle_keep_cuda(labels, valid, 4)
    for k in (0, 1, 0, 1):
        labels.copy_(maps[k][0])
        valid.copy_(maps[k][1])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(keep, SPK.speckle_keep_plain(*maps[k], 4)), k
        assert not SPK.count_cells(labels.device, H * W).any()


K_4K = np.array([[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]])
# Relative error allowed between the card's and the CPU's points where they
# are not bit-equal: a few f32 ulps (chip_smoke.py F32_RTOL).
F32_RTOL = 4.0e-7


def _rig(kind, W, H):
    K = torch.tensor(K_4K * np.array([[W / 3840], [H / 2160], [1.0]]), dtype=torch.float64)
    if kind == "identity":  # the reference's 4K benchmark rig
        R, T, dist = torch.eye(3, dtype=torch.float64), torch.tensor([-0.14, 0.0, 0.0]), None
    else:  # rotation, vertical and forward baseline components, distortion
        R = G.rodrigues_to_matrix(torch.tensor([0.01, 0.04, -0.02], dtype=torch.float64))
        T = torch.tensor([-0.8, 0.05, 0.1])
        dist = torch.tensor([0.2090, -0.5576, -7.2e-6, 5.2e-4, 0.3812], dtype=torch.float64)
    res = RC.stereo_rectify(K, dist, K, dist, (W, H), R, T.to(torch.float64), alpha=0.0)
    return K, dist, res


@pytest.mark.parametrize("rig", ["identity", "rotated"])
@pytest.mark.parametrize("H,W", [(48, 64), (181, 321)])
def test_rectify_and_reproject_on_the_card_match_the_cpu(dev, rig, H, W):
    """rectify_remap within 1 LSB of the CPU's (the inverse rotation and the
    f32 weights may round differently); reproject_image_to_3d bit-equal or
    within F32_RTOL, with the same finite points."""
    K, dist, res = _rig(rig, W, H)
    rng = np.random.default_rng(H)
    img = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8))
    for R, P in ((res.R1, res.P1), (res.R2, res.P2)):
        ref = RC.rectify_remap(img, K, dist, R, P)
        got = RC.rectify_remap(img.to(dev), K, dist, R, P).cpu()
        assert got.dtype == torch.uint8
        assert int((got.to(torch.int16) - ref.to(torch.int16)).abs().max()) <= 1
    disp = rng.uniform(0, 30, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.2] = 0.0
    disp[0, :3] = -1.0  # the SGBM margin's value
    Q = res.Q.to(torch.float32)
    ref = G.reproject_image_to_3d(torch.from_numpy(disp), Q)
    got = G.reproject_image_to_3d(torch.from_numpy(disp).to(dev), Q.to(dev)).cpu()
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin)
    rel = (got[fin] - ref[fin]).abs() / ref[fin].abs().clamp_min(1e-30)
    assert float(rel.max()) <= F32_RTOL


@pytest.mark.parametrize("H,W", [(720, 1280), (2160, 3840), (181, 321)])
def test_remap_kernel_equals_plain_on_rotated_rig_maps(dev, H, W):
    """remap_bilinear on the card is one kernel launch a call, torch.equal
    to the plain version on the card, for both cameras of a rotated,
    distorted rig (181 x 321: rows that are no multiple of 4 wide)."""
    K, dist, res = _rig("rotated", W, H)
    img = torch.from_numpy(np.random.default_rng(W).integers(0, 256, (H, W), dtype=np.uint8)).to(dev)
    for R, P in ((res.R1, res.P1), (res.R2, res.P2)):
        m = RC.rectify_map(K, dist, R, P, (W, H), device=dev)
        before = RK.launches["remap"]
        got = RC.remap_bilinear(img, m)
        assert RK.launches["remap"] == before + 1
        want = RK.remap_bilinear_plain(img, m)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and got.shape == (H, W)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,channels,Wo", [
    (torch.uint8, 3, 44), (torch.uint8, 3, 45), (torch.float32, 3, 44), (torch.float32, 3, 45),
    (torch.uint8, 1, 44), (torch.float32, 1, 45),
])
def test_remap_kernel_equals_plain_on_edge_maps(dev, dtype, channels, Wo):
    """Off-image taps on all four sides, integer and half-pixel coordinates
    (rounding ties): the kernel's bits are the plain version's, through its
    vector path (Wo % 4 == 0) and its pixel-at-a-time path."""
    H, W = 23, 31
    rng = np.random.default_rng(channels + Wo)
    shape = (H, W) if channels == 1 else (H, W, channels)
    img = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == torch.uint8
           else rng.uniform(-50, 300, shape).astype(np.float32))
    img = torch.from_numpy(img).to(dev)
    m = torch.from_numpy(edge_map(H, W, 37, Wo, Wo)).to(dev)
    got = RK.remap_bilinear_cuda(img, m)
    want = RK.remap_bilinear_plain(img, m)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (37, Wo, *shape[2:])
    if dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def test_remap_kernel_raises_on_what_it_does_not_take(dev):
    m = torch.zeros((8, 8, 2), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        RC.remap_bilinear(torch.zeros((8, 8), dtype=torch.int16, device=dev), m)
    with pytest.raises(ValueError, match="contiguous"):
        RC.remap_bilinear(torch.zeros((8, 16), dtype=torch.uint8, device=dev)[:, ::2], m)
    with pytest.raises(ValueError, match="map must be"):
        RC.remap_bilinear(torch.zeros((8, 8), dtype=torch.uint8, device=dev), m.double())


def _bits(t):
    return t.contiguous().view(torch.int32)


def _cloud_disparity(rng, H, W):
    """Disparities like SGBM's (0 where invalid, the margin's -1) and +-0.5,
    which with _offset_q's Q makes W == 0 away from d == 0."""
    disp = rng.uniform(0.5, 90.0, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.2] = 0.0
    disp[:, :5] = -1.0
    disp[rng.random((H, W)) < 0.05] = -0.5
    disp[rng.random((H, W)) < 0.05] = 0.5
    disp[0, -1] = -0.0
    return disp


def _cloud_qs(W, H):
    """The benchmark's rig's Q, and the rotated rig's with Q[3, 3] = Q[3, 2] / 2,
    so that d = -0.5 gives W == 0 exactly."""
    _, res = synth.rectified_rig((W, H))
    q = _rig("rotated", W, H)[2].Q.to(torch.float32).clone()
    q[3, 3] = q[3, 2] * 0.5
    return {"rig": res.Q.numpy(), "offset": q}


@pytest.mark.parametrize("H,W", [(720, 1280), (2160, 3840), (181, 321)])
@pytest.mark.parametrize("q", ["rig", "offset"])
def test_reproject_kernel_equals_plain(dev, H, W, q):
    """One launch a call, bit-equal to the plain ops on the CPU and on the
    card (signed zeros included), with W == 0 (-> inf, so the point is 0) at
    d == 0, -0.0 and, for "offset", d == -0.5."""
    Q = _cloud_qs(W, H)[q]
    disp = torch.from_numpy(_cloud_disparity(np.random.default_rng(H + W), H, W))
    before = dict(CL.launches)
    got = G.reproject_image_to_3d(disp.to(dev), Q)
    assert CL.launches == {**before, "reproject": before["reproject"] + 1}
    want_card = CL.reproject_plain(disp.to(dev), Q)
    torch.cuda.synchronize()
    want = G.reproject_image_to_3d(disp, Q)
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    zero_w = disp == (0.0 if q == "rig" else -0.5)  # W == 0: (X, Y, Z) / inf
    assert bool(zero_w.any()) and bool((want[zero_w] == 0).all())
    assert torch.equal(_bits(got).cpu(), _bits(want))
    assert torch.equal(_bits(got), _bits(want_card))


@pytest.mark.parametrize("H,W", [(181, 321), (4, 8)])  # odd H * W: pts[1] is not 16-byte aligned
def test_reproject_kernel_writes_into_a_batch_tensor(dev, H, W):
    """out= writes each pair's points in place, through the vector path and
    the unaligned one; a CUDA Q (read back to the host) gives the same bits."""
    Q = _cloud_qs(W, H)["rig"]
    disp = torch.from_numpy(_cloud_disparity(np.random.default_rng(3), H, W)).to(dev)
    pts = torch.full((2, H, W, 3), 7.0, device=dev)
    for p in pts:
        assert G.reproject_image_to_3d(disp, Q, out=p) is p
    want = G.reproject_image_to_3d(disp.cpu(), Q)
    for p in pts:
        assert torch.equal(_bits(p).cpu(), _bits(want))
    got = G.reproject_image_to_3d(disp, torch.as_tensor(Q, device=dev))
    assert torch.equal(_bits(got).cpu(), _bits(want))


def test_reproject_kernel_raises_on_what_it_does_not_take(dev):
    d = torch.zeros((8, 8), device=dev)
    with pytest.raises(ValueError, match="float32"):
        G.reproject_image_to_3d(d.double(), np.eye(4))
    with pytest.raises(ValueError, match="contiguous"):
        G.reproject_image_to_3d(torch.zeros((8, 16), device=dev)[:, ::2], np.eye(4))
    with pytest.raises(ValueError, match="out must be"):
        G.reproject_image_to_3d(d, np.eye(4), out=torch.empty((8, 8, 4), device=dev))
    with pytest.raises(ValueError, match="4 x 4"):
        G.reproject_image_to_3d(d, np.eye(3))
    with pytest.raises(ValueError, match="one CUDA device"):
        CL.compact_cuda(d, torch.zeros((8, 8, 3)), torch.ones((8, 8), dtype=torch.bool, device=dev))


def _compact_case(kind, H, W, dev):
    rng = np.random.default_rng(H * W)
    disp = torch.from_numpy(_cloud_disparity(rng, H, W)).to(dev)
    pts = torch.from_numpy(rng.normal(0, 3, (H, W, 3)).astype(np.float32)).to(dev)
    bad = torch.from_numpy(rng.random((H, W, 3)) < 0.02).to(dev)
    pts[bad] = float("inf")
    pts[torch.from_numpy(rng.random((H, W, 3)) < 0.01).to(dev)] = float("nan")
    valid = torch.from_numpy(rng.random((H, W)) < 0.8).to(dev)
    if kind == "all invalid":
        valid[:] = False
    elif kind == "all kept":
        disp, valid = disp.abs() + 1.0, torch.ones_like(valid)
        pts = torch.nan_to_num(pts, nan=1.0, posinf=2.0)
    return disp, pts, valid


@pytest.mark.parametrize("kind", ["random", "all invalid", "all kept"])
@pytest.mark.parametrize("H,W", [(181, 321), (720, 1280), (1, 1), (64, 64), (2160, 3840)])
def test_compact_kernel_equals_the_mask(dev, kind, H, W):
    """One call a frame: the first `count` rows are pts[mask] in row-major
    order, bit for bit, and count is mask.sum() (int64, shape (1,)); at one
    pixel, one tile exactly (4096) and many tiles."""
    disp, pts, valid = _compact_case(kind, H, W, dev)
    before = dict(CL.launches)
    out, count = ST.cloud_points(disp, pts, valid)
    assert CL.launches == {**before, "compact": before["compact"] + 1}
    mask = valid & torch.isfinite(pts).all(-1) & (disp > 0)
    want = pts[mask]
    torch.cuda.synchronize()
    assert count.dtype == torch.int64 and count.shape == (1,) and count.device == disp.device
    assert out.shape == (H * W, 3) and out.dtype == torch.float32
    n = int(count)
    assert n == int(mask.sum()) == len(want)
    if kind == "all invalid":
        assert n == 0
    if kind == "all kept":
        assert n == H * W
    assert torch.equal(_bits(out[:n]), _bits(want))


def test_points_layer_makes_no_host_sync_and_launches_three_kernels(dev):
    """On precomputed maps, the reprojection (Q a numpy array) and the
    compaction raise nothing under sync_debug_mode "error", copy nothing
    between host and card, and launch one reprojection kernel and two
    compaction kernels (launch counts and the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    H, W = 720, 1280
    Q = _cloud_qs(W, H)["rig"]
    disp = torch.from_numpy(_cloud_disparity(np.random.default_rng(5), H, W)).to(dev)
    valid = disp > 1.0
    pts = G.reproject_image_to_3d(disp, Q)  # warm
    ST.cloud_points(disp, pts, valid)
    torch.cuda.synchronize()
    before = dict(CL.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            pts = G.reproject_image_to_3d(disp, Q)
            out, count = ST.cloud_points(disp, pts, valid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert CL.launches == {"reproject": before["reproject"] + 1, "compact": before["compact"] + 1}
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3, names
    assert sum("reproject_kernel" in n for n in names) == 1
    assert sum("count_kernel" in n for n in names) == 1
    assert sum("scatter_kernel" in n for n in names) == 1
    mask = valid & torch.isfinite(pts).all(-1) & (disp > 0)
    assert int(count) == int(mask.sum())


def test_dense_batch_step_writes_each_pairs_points_in_place(dev):
    """dense_batch_step with a host Q: its maps are sgbm_disparity's on the
    card, its points (B, H, W, 3) the plain ops' on those maps on the CPU,
    bit for bit, one reprojection launch a pair."""
    from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig

    H, W = 48, 96
    rng = np.random.default_rng(9)
    left = torch.from_numpy(rng.integers(0, 256, (2, H, W), dtype=np.uint8)).to(dev)
    right = torch.roll(left, -6, 2)
    Q = _cloud_qs(W, H)["rig"]
    cfg = SGBMConfig(num_disparities=16, num_directions=5, speckle_window_size=0)
    before = CL.launches["reproject"]
    disp, pts, valid = ST.dense_batch_step(left, right, Q, cfg)
    assert CL.launches["reproject"] == before + 2
    assert pts.shape == (2, H, W, 3) and pts.is_contiguous()
    for i in range(2):
        d, v = DP.sgbm_disparity(left[i], right[i], cfg)
        assert torch.equal(disp[i], d) and torch.equal(valid[i], v)
        assert torch.equal(_bits(pts[i]).cpu(), _bits(G.reproject_image_to_3d(d.cpu(), Q)))


@pytest.mark.parametrize("nd", [5, 8])
@pytest.mark.parametrize("H,W,D", [(19, 37, 16), (9, 41, 100)])
def test_sgm_aggregate_kernel_equals_plain(dev, nd, H, W, D):
    rng = np.random.default_rng(H + nd)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    dirs = SK.directions_for(nd)
    S = SK.sgm_aggregate(C, P1, P2, dirs)
    torch.cuda.synchronize()
    assert S.dtype == torch.int32 and torch.equal(S, SK.sgm_aggregate_plain(C, P1, P2, dirs))
    got = SK.wta_maps(S, 2, 10)
    for a, b in zip(got, SK.sgm_wta(C, P1, P2, nd, 10, 2)):
        assert torch.equal(a, b)


def _speckle_case(kind, H, W, seed=0):
    rng = np.random.default_rng(seed)
    disp = (rng.random((H, W)) * 60).astype(np.float32)
    if kind == "random":
        valid = rng.random((H, W)) >= 0.4
    elif kind == "all valid":
        valid = np.ones((H, W), bool)
        disp = np.broadcast_to(np.arange(W) // 16 * 20.0, (H, W)).astype(np.float32)  # bands
    elif kind == "all invalid":
        valid = np.zeros((H, W), bool)
    elif kind == "constant":  # one component
        valid = np.ones((H, W), bool)
        disp[:] = 7.0
    elif kind == "ramp":  # one component: neighbours 0.7 apart, within max_diff
        valid = np.ones((H, W), bool)
        disp = (0.7 * np.add.outer(np.arange(H), np.arange(W))).astype(np.float32)
    elif kind == "comb down":  # teeth in the first tile row, joined below its border
        disp[:] = 7.0
        valid = np.zeros((H, W), bool)
        valid[:32, ::3] = True
        valid[32:33, :] = True
    elif kind == "comb right":  # teeth in the first tile column, joined right of it
        disp[:] = 7.0
        valid = np.zeros((H, W), bool)
        valid[::3, :32] = True
        valid[:, 32:33] = True
    elif kind == "checkerboard":
        valid = (np.add.outer(np.arange(H), np.arange(W)) % 2) == 0
    elif kind == "serpentine":  # one-pixel stripes joined at alternate ends
        valid = np.zeros((H, W), bool)
        valid[::2, 1:W - 1] = True
        for k, y in enumerate(range(1, H - 1, 2)):
            valid[y, W - 2 if k % 2 == 0 else 1] = True
        disp[:] = 7.0
    else:
        raise ValueError(kind)
    return disp, valid


@pytest.mark.parametrize("kind,H,W,T", [
    ("random", 1, 300, 2), ("random", 300, 1, 2), ("random", 37, 70, 0),
    ("random", 65, 33, 5), ("all valid", 40, 97, 100), ("all invalid", 33, 65, 0),
    ("checkerboard", 35, 66, 0), ("serpentine", 63, 50, 100), ("random", 200, 321, 3),
])
def test_speckle_kernels_equal_plain(dev, kind, H, W, T):
    disp_np, valid_np = _speckle_case(kind, H, W)
    disp = torch.from_numpy(disp_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    labels = SPK.speckle_labels_cuda(disp, valid, 5.0)
    ref, converged = SPK.speckle_labels_plain(disp, valid, 5.0, max_rounds=4096)
    torch.cuda.synchronize()
    assert converged and torch.equal(labels, ref)
    keep = SPK.speckle_filter(disp, valid, T, 5.0)
    assert torch.equal(keep, SPK.speckle_keep_plain(ref, valid, T))
    assert torch.equal(SPK.speckle_keep_cuda(ref, valid, T), keep)
    assert np.array_equal(keep.cpu().numpy(), native.filter_speckles(disp_np, valid_np, T, 5.0))


def _wta_inputs(seed, A, B, D, dev, hi=(20000, 40000)):
    """C and two u16 delta volumes (int16 bits) on the card."""
    rng = np.random.default_rng(seed)
    C = torch.from_numpy(rng.integers(0, hi[0], (A, B, D)).astype(np.int16)).to(dev)
    ds = [torch.from_numpy(rng.integers(0, hi[1], (A, B, D)).astype(np.uint16).view(np.int16)).to(dev)
          for _ in range(2)]
    return C, ds


@pytest.mark.parametrize("A,B,D,ur,md,hi", [
    (7, 33, 1, 10, 0, (20000, 40000)), (19, 37, 24, 10, 3, (20000, 40000)),
    (9, 41, 96, 0, 0, (20000, 40000)), (11, 13, 24, 10, 0, (6, 12)),  # ties, uniqueness hits
    (5, 3, 3, 10, 1, (6, 12)), (3, 17, 256, 10, 2, (20000, 40000)),
])
def test_wta_kernels_equal_plain(dev, A, B, D, ur, md, hi):
    C, ds = _wta_inputs(A * B + D, A, B, D, dev, hi)
    for nv in (1, 2):
        vols = ds[:nv]
        ref = SK.wta_volume_plain(C, vols, ur, md)
        got = SK.wta_volume(C, vols, ur, md)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        packed = SK.pack_maps(*ref)
        for red in SK.REDUCTIONS:
            for ext in SK.EXTRACTS:
                for bh, bw in ((8, 512), (1, 1), (3, 5), (2, 64)):
                    out = SK.wta_packed(C, vols, ur, md, bh, bw, red, ext)
                    torch.cuda.synchronize()
                    assert torch.equal(out, packed), (nv, red, ext, bh, bw)


def _wta_plain_rows(C, ur, md, rows=128):
    """wta_maps(C widened to int32) in blocks of rows (a 4K x 256 volume
    widened whole would take ~16 GB of temporaries)."""
    parts = [SK.wta_maps(C[a:a + rows].to(torch.int32), md, ur) for a in range(0, C.shape[0], rows)]
    return tuple(torch.cat(p) for p in zip(*parts))


@pytest.mark.parametrize("A,B,D,ur,md,hi,offset", [
    (720, 1216, 64, 10, 0, 20000, 0),   # 1280x720 x 64: block matching's cell
    (2160, 3584, 256, 10, 0, 20000, 0),  # 3840x2160 x 256
    (7, 33, 1, 10, 0, 20000, 0), (19, 37, 24, 10, 3, 20000, 0), (5, 3, 3, 10, 1, 6, 0),
    (11, 13, 24, 0, 0, 6, 0),            # ties and uniqueness hits
    (9, 41, 96, 10, 2, 20000, 0), (3, 17, 300, 10, 0, 20000, 0), (4, 5, 512, 10, 0, 9, 0),
    (13, 29, 64, 10, 0, 20000, 1),       # C 2 bytes off 16: the element-by-element loads
    (13, 29, 17, 10, 0, 20000, 0),
])
def test_wta_without_a_delta_volume_equals_plain(dev, A, B, D, ur, md, hi, offset):
    """The no-volume form of csrc/wta.cu (block matching's WTA, S = C) is
    bit-equal to wta_maps(C widened to int32): disp, valid, best and minS.
    Negative costs too (the packed key's arithmetic shift)."""
    gen = torch.Generator(device=dev).manual_seed(A * B + D)
    flat = torch.randint(-hi // 4, hi, (A * B * D + offset,), generator=gen, device=dev,
                         dtype=torch.int16)
    C = flat[offset:].view(A, B, D)
    assert (C.data_ptr() % 16 == 0) == (offset == 0)
    before = dict(SK.launches)
    got = SK.wta_volume(C, (), ur, md)
    torch.cuda.synchronize()
    assert SK.launches["wta_volume"] == before["wta_volume"] + 1
    ref = _wta_plain_rows(C, ur, md)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(got[1], SK.sgm_wta(C, 0, 0, 0, ur, md)[1])


def test_block_matching_on_the_card_equals_the_cpu_with_one_wta_launch(dev):
    """sgbm_disparity at zero paths on a 720p pair x 64: the card's maps are
    the CPU's, one wta_volume launch a frame, no path sweep."""
    from stereo_reconstruction_cv_tpu_torch.tools.probe_sweep import textured_pair

    left, right = (torch.from_numpy(a) for a in
                   textured_pair(np.random.default_rng(synth.SEED + 1), 720, 1280, 30))
    cfg = DP.SGBMConfig(num_disparities=64, num_directions=0)
    DP.sgbm_disparity(left.to(dev), right.to(dev), cfg)  # the build, outside the counts
    torch.cuda.synchronize()
    counts = (CK.launches, SK.launches, LK.launches, SPK.launches)
    before = [dict(c) for c in counts]
    disp, valid = DP.sgbm_disparity(left.to(dev), right.to(dev), cfg)
    torch.cuda.synchronize()
    grew = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c if c[k] != b[k]}
    assert grew["wta_volume"] == 1 and grew["cost_volume"] == 1 and grew["lr_check"] == 1
    assert not {k for k in grew if k.startswith("sgm_")}
    disp_h, valid_h = DP.sgbm_disparity(left, right, cfg)
    assert torch.equal(disp.cpu(), disp_h) and torch.equal(valid.cpu(), valid_h)
    assert float(valid_h.float().mean()) > 0.3


def _grown(counts, before):
    return {(i, k): c[k] - b.get(k, 0) for i, (c, b) in enumerate(zip(counts, before))
            for k in c if c[k] != b.get(k, 0)}


def test_block_matching_replays_its_graph_exactly(dev):
    """After the first frame of a shape, sgbm_disparity at zero paths
    replays a CUDA graph (FrameGraph): on each of four other 720p pairs the
    replay equals the eager stages (DP._frame) bit for bit and adds the same
    launch counts; the maps it returned before are left as they were; the
    CPU gives the same maps; at most MAX_GRAPHS graphs are kept."""
    from stereo_reconstruction_cv_tpu_torch.tools.probe_sweep import textured_pair

    rng = np.random.default_rng(synth.SEED + 7)
    pairs = [tuple(torch.from_numpy(a) for a in textured_pair(rng, 720, 1280, 30))
             for _ in range(5)]
    cfg = DP.SGBMConfig(num_disparities=64, num_directions=0)
    DP._graphs.clear()
    first = DP.sgbm_disparity(pairs[0][0].to(dev), pairs[0][1].to(dev), cfg)
    assert len(DP._graphs) == 1
    counts = (CK.launches, CK.cost_paths, SK.launches, LK.launches, SPK.launches)
    outs, copies = [], []
    for left, right in pairs[1:]:
        lc, rc = left.to(dev), right.to(dev)
        torch.cuda.synchronize()
        before = [dict(c) for c in counts]
        outs.append(DP.sgbm_disparity(lc, rc, cfg))
        replayed = _grown(counts, before)
        before = [dict(c) for c in counts]
        eager = DP._frame(lc, rc, cfg)
        assert _grown(counts, before) == replayed
        assert replayed[(2, "wta_volume")] == 1 and replayed[(0, "cost_volume")] == 1
        torch.cuda.synchronize()
        assert torch.equal(outs[-1][0], eager[0]) and torch.equal(outs[-1][1], eager[1])
        copies.append(tuple(t.clone() for t in outs[-1]))
    assert len(DP._graphs) == 1
    assert not torch.equal(outs[0][0], outs[1][0])  # each pair is copied in
    for (d, v), (dc, vc) in zip(outs, copies):  # later replays overwrote nothing returned
        assert torch.equal(d, dc) and torch.equal(v, vc)
    assert not torch.equal(first[0], outs[-1][0])
    for (left, right), (d, v) in list(zip(pairs[1:], outs))[:2]:
        disp_h, valid_h = DP.sgbm_disparity(left, right, cfg)
        assert torch.equal(d.cpu(), disp_h) and torch.equal(v.cpu(), valid_h)
    for h in range(DP.MAX_GRAPHS + 1):
        DP.sgbm_disparity(pairs[0][0][:96 + h].to(dev), pairs[0][1][:96 + h].to(dev), cfg)
    assert len(DP._graphs) == DP.MAX_GRAPHS
    DP._graphs.clear()


def test_block_matching_replay_kernels_reach_the_profiler(dev):
    """A replayed frame's kernels are in the profiler's device trace under
    their own names (the benchmark reads the WTA pass's time by its name),
    each linked to the replay's launch."""
    from torch.profiler import ProfilerActivity, profile

    from stereo_reconstruction_cv_tpu_torch.tools.probe_sweep import textured_pair

    left, right = (torch.from_numpy(a).to(dev) for a in
                   textured_pair(np.random.default_rng(synth.SEED + 8), 720, 1280, 30))
    cfg = DP.SGBMConfig(num_disparities=64, num_directions=0)
    DP._graphs.clear()
    DP.sgbm_disparity(left, right, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            DP.sgbm_disparity(left, right, cfg)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("wta_cost_kernel<" in n for n in names) == 3
    assert sum("cost_volume_u8x2_kernel" in n for n in names) == 3
    DP._graphs.clear()


@pytest.mark.parametrize("H,W", [(37, 512), (5, 128), (1, 32)])
@pytest.mark.parametrize("dtype", list(OC.DTYPES))
def test_op_chain_kernel_equals_plain(dev, H, W, dtype):
    x = torch.from_numpy(np.random.default_rng(H + W).integers(1, 1000, (H, W))).to(dtype).to(dev)
    for ops in (("add", "min"), ("roll", "add", "min"), ("roll",), ("roll", "add"), ()):
        got = OC.op_chain(x, ops)
        ref = OC.op_chain_plain(x, ops)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got.view(torch.int16) if dtype == torch.uint16 else got,
                                                  ref.view(torch.int16) if dtype == torch.uint16 else ref)


@pytest.mark.parametrize("kind", ["constant", "ramp"])
@pytest.mark.parametrize("H,W", [(32, 32), (64, 96), (96, 64), (33, 65), (130, 250), (1, 70),
                                 (70, 1)])
def test_speckle_one_component_equals_plain(dev, kind, H, W):
    """Maps that are one component, as the main path's nearly are: tile
    multiples and ragged sizes."""
    disp_np, valid_np = _speckle_case(kind, H, W)
    disp = torch.from_numpy(disp_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    labels = SPK.speckle_labels_cuda(disp, valid, 5.0)
    ref, converged = SPK.speckle_labels_plain(disp, valid, 5.0, max_rounds=4096)
    torch.cuda.synchronize()
    assert converged and torch.equal(labels, ref)
    assert bool((labels == 0).all())


@pytest.mark.parametrize("kind", ["comb down", "comb right"])
@pytest.mark.parametrize("H,W", [(40, 100), (100, 40), (64, 64)])
def test_speckle_comb_joined_across_tile_borders_equals_plain(dev, kind, H, W):
    """Teeth that meet only across a tile border: one component."""
    disp_np, valid_np = _speckle_case(kind, H, W)
    disp = torch.from_numpy(disp_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    labels = SPK.speckle_labels_cuda(disp, valid, 5.0)
    ref, converged = SPK.speckle_labels_plain(disp, valid, 5.0, max_rounds=4096)
    torch.cuda.synchronize()
    assert converged and torch.equal(labels, ref)
    assert int(torch.unique(labels[valid]).numel()) == 1


@pytest.mark.parametrize("kind", ["random", "ramp", "serpentine"])
def test_speckle_kernels_read_column_slices(dev, kind):
    """A column slice of a wider map (the SGBM map without its margin) gives
    the labels and keep mask of its contiguous copy."""
    disp_np, valid_np = _speckle_case(kind, 75, 150)
    disp = torch.from_numpy(disp_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    for x0 in (1, 19, 64):
        d, v = disp[:, x0:], valid[:, x0:]
        assert not d.is_contiguous()
        labels = SPK.speckle_labels_cuda(d, v, 5.0)
        ref = SPK.speckle_labels_cuda(d.contiguous(), v.contiguous(), 5.0)
        keep = SPK.speckle_keep_cuda(labels, v, 20)
        torch.cuda.synchronize()
        assert torch.equal(labels, ref)
        assert torch.equal(keep, SPK.speckle_keep_plain(ref, v.contiguous(), 20))


# csrc/sgm.cu WTA_STAGES: the fused sweep's steps in flight, by K (K = 1
# loads each step itself).
WTA_STAGES = {1: 16, 2: 16, 4: 16, 8: 8, 16: 4}


def _fused_equal_plain(C, nd, direction, md=2, vols=None):
    """sgm_sweep_wta with `direction` last against its plain version."""
    C32 = C.to(torch.int32)
    groups = [g for g in SK.delta_groups(nd, direction) if g]
    if vols is None:
        vols = SK.path_deltas_cuda(C, nd, P1, P2, fused=direction)
    partial = sum(SK.path_delta_plain(C32, dx, dy, P1, P2) for g in groups for dx, dy in g)
    got = SK.sweep_wta_cuda(C, vols, nd, P1, P2, 10, md, direction)
    ref = SK.sweep_wta_plain(C32, partial, nd, P1, P2, 10, md, direction)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b), (tuple(C.shape), nd, direction)


@pytest.mark.parametrize("direction", [(-1, 0), (0, 1)])
@pytest.mark.parametrize("D", [17, 33, 100, 128, 250, 256, 512])
@pytest.mark.parametrize("extra", [-1, 0, 1, "33", "64"])
def test_sweep_wta_path_lengths_equal_plain(dev, direction, D, extra):
    """Paths one short of, at and one past the ring depth P, and past one and
    two 32-step store buffers; D % K != 0 (33, 250) takes the general path."""
    P = WTA_STAGES[SK.lanes_k(D)]
    n = int(extra) if isinstance(extra, str) else P + extra
    H, W = (3, n) if direction[1] == 0 else (n, 3)
    rng = np.random.default_rng(D * 100 + n)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    for nd in (5, 8):
        _fused_equal_plain(C, nd, direction)


@pytest.mark.parametrize("direction", [(-1, 0), (0, 1)])
@pytest.mark.parametrize("H,W", [(1, 1), (1, 45), (45, 1), (7, 9)])
@pytest.mark.parametrize("D", [1, 64, 256])
def test_sweep_wta_small_frames_equal_plain(dev, direction, H, W, D):
    rng = np.random.default_rng(D + H * W)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    for nd in (5, 8):
        _fused_equal_plain(C, nd, direction)


@pytest.mark.parametrize("direction", [(-1, 0), (0, 1)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_sweep_wta_unaligned_second_volume_takes_the_scalar_path(dev, direction, D):
    """A second delta volume 2 bytes off an aligned address: the same
    kernel's scalar path."""
    H, W = 13, 41
    rng = np.random.default_rng(D + 7)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    vols = SK.path_deltas_cuda(C, 8, P1, P2, fused=direction)
    buf = torch.empty(H * W * D + 1, dtype=torch.int16, device=dev)
    off = buf[1:].view(H, W, D)
    off.copy_(vols[1])
    assert not SK.sweep_vector_path(D, C.data_ptr(), vols[0].data_ptr(), off.data_ptr())
    _fused_equal_plain(C, 8, direction, vols=[vols[0], off])


# Direction lists the S-volume route takes: 5 and 8 paths, one direction
# (zero delta volumes), a list without FUSED_DIR, duplicates, and a list
# past one sgm_sweep_sum pass (SK.SUM_PASS).
AGGREGATE_LISTS = {
    "5": SK.DIRS_5, "8": SK.DIRS_8, "one direction": ((1, -1),),
    "no FUSED_DIR": ((1, 0), (-1, -1), (1, -1), (-1, 0)),
    "duplicate": ((1, 0), (0, 1), (1, 0), (-1, 1), (0, 1)),
    "two passes": SK.DIRS_8 + SK.DIRS_5 + ((0, 1),),
}


@pytest.mark.parametrize("case", list(AGGREGATE_LISTS))
@pytest.mark.parametrize("H,W,D", [(19, 37, 100), (11, 23, 24), (6, 40, 256)])
def test_sgm_aggregate_direction_lists_equal_plain(dev, case, H, W, D):
    """Each list goes through aggregate_passes' path sweeps and one
    sgm_sweep_sum a pass, and nothing else."""
    dirs = AGGREGATE_LISTS[case]
    rng = np.random.default_rng(H * D + len(dirs))
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    before = dict(SK.launches)
    S = SK.sgm_aggregate(C, P1, P2, dirs)
    torch.cuda.synchronize()
    assert torch.equal(S, SK.sgm_aggregate_plain(C, P1, P2, dirs))
    passes = len(SK.aggregate_passes(dirs))
    assert {k: SK.launches[k] - before[k] for k in SK.launches} == {
        **dict.fromkeys(SK.launches, 0),
        "sgm_path_sweep": len(dirs) - passes, "sgm_sweep_sum": passes}


def _sum_equal_plain(C, vols, direction, nd=3, out=None):
    """sgm_sweep_sum against sweep_sum_plain (written, or added onto out)."""
    C32 = C.to(torch.int32)
    partial = sum((SK.u16(v) for v in vols), torch.zeros_like(C32))
    start = None if out is None else out.clone()
    got = SK.sweep_sum_cuda(C, vols, nd, P1, P2, direction, out=out)
    ref = SK.sweep_sum_plain(C32, partial, nd, P1, P2, direction)
    torch.cuda.synchronize()
    if out is not None:
        assert got is out
        ref = ref + start
    assert got.dtype == torch.int32 and torch.equal(got, ref), (tuple(C.shape), len(vols), direction)


def _u16_volumes(rng, shape, dev, n=2):
    return [torch.from_numpy(rng.integers(0, 1 << 16, shape).astype(np.uint16).view(np.int16)).to(dev)
            for _ in range(n)]


@pytest.mark.parametrize("D", [1, 17, 32, 33, 100, 128, 250, 512])
@pytest.mark.parametrize("H,W", [(1, 1), (1, 45), (45, 1), (7, 9)])
def test_sweep_sum_volumes_and_shapes_equal_plain(dev, D, H, W):
    """Zero, one and two delta volumes; K = 1 (D <= 32), D % K != 0 (33,
    250: the general path), single pixels, rows and columns; a vertical, a
    horizontal and a diagonal direction."""
    rng = np.random.default_rng(D * 100 + H * W)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    vols = _u16_volumes(rng, (H, W, D), dev)
    for direction in ((0, 1), (-1, 0), (1, -1)):
        for nv in (0, 1, 2):
            _sum_equal_plain(C, vols[:nv], direction, nd=1 + 4 * nv)


@pytest.mark.parametrize("direction", [(-1, 0), (0, 1)])
@pytest.mark.parametrize("D", [17, 33, 100, 128, 250, 256, 512])
@pytest.mark.parametrize("extra", [-1, 0, 1, "33", "64"])
def test_sweep_sum_path_lengths_equal_plain(dev, direction, D, extra):
    """Paths one short of, at and one past the cp.async ring's depth, and
    long ones, with each number of volumes."""
    P = WTA_STAGES[SK.lanes_k(D)]
    n = int(extra) if isinstance(extra, str) else P + extra
    H, W = (3, n) if direction[1] == 0 else (n, 3)
    rng = np.random.default_rng(D * 100 + n)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    vols = _u16_volumes(rng, (H, W, D), dev)
    for nv in (0, 1, 2):
        _sum_equal_plain(C, vols[:nv], direction)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_sweep_sum_unaligned_volume_and_out_take_the_general_path(dev, D):
    """A second volume, or an S to add onto, that starts off its vector
    alignment: the same kernel's general path."""
    H, W = 13, 41
    rng = np.random.default_rng(D + 11)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    vols = _u16_volumes(rng, (H, W, D), dev)
    buf = torch.empty(H * W * D + 1, dtype=torch.int16, device=dev)
    off = buf[1:].view(H, W, D)
    off.copy_(vols[1])
    assert not SK.sweep_vector_path(D, C.data_ptr(), vols[0].data_ptr(), off.data_ptr())
    for direction in ((0, 1), (-1, 0)):
        _sum_equal_plain(C, [vols[0], off], direction)
        start = torch.from_numpy(rng.integers(-1 << 20, 1 << 20, (H, W, D), dtype=np.int32)).to(dev)
        sbuf = torch.empty(H * W * D + 1, dtype=torch.int32, device=dev)
        out = sbuf[1:].view(H, W, D)
        out.copy_(start)
        _sum_equal_plain(C, vols, direction, out=out)  # S 4 bytes off 16
        _sum_equal_plain(C, vols, direction, out=start.clone())


def test_sweep_sum_refuses_what_it_does_not_take(dev):
    C = torch.zeros((4, 5, 16), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="at most two"):
        SK.sweep_sum_cuda(C, [C, C, C], 9, P1, P2)
    with pytest.raises(ValueError, match="unit step"):
        SK.sweep_sum_cuda(C, [C], 5, P1, P2, (2, 0))
    with pytest.raises(ValueError, match="out must be"):
        SK.sweep_sum_cuda(C, [C], 5, P1, P2, out=torch.zeros((4, 5, 16), dtype=torch.int16, device=dev))


def test_sgm_aggregate_in_a_cuda_graph(dev):
    """Captured once, replayed over two cost volumes of one shape in turns."""
    H, W, D = 24, 70, 128
    rng = np.random.default_rng(3)
    Cs = [torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
          for _ in range(2)]
    C = Cs[0].clone()
    SK.sgm_aggregate(C, P1, P2)  # the build and the allocator's first blocks, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        S = SK.sgm_aggregate(C, P1, P2)
    for k in (0, 1, 0, 1):
        C.copy_(Cs[k])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(S, SK.sgm_aggregate_plain(Cs[k], P1, P2)), k


@pytest.mark.parametrize("nd", [5, 8])
def test_sgm_aggregate_peak_memory(dev, nd):
    """One call holds at most C + its u16 volumes + S, and 5% more."""
    H, W, D = 96, 512, 128
    C = torch.from_numpy(np.random.default_rng(nd).integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    SK.sgm_aggregate(C, P1, P2, SK.directions_for(nd))  # the build, outside the measure
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    S = SK.sgm_aggregate(C, P1, P2, SK.directions_for(nd))
    torch.cuda.synchronize()
    vols = 1 if nd == 5 else 2
    held = C.nbytes + vols * C.nbytes + S.nbytes
    assert torch.cuda.max_memory_allocated() - base + C.nbytes <= 1.05 * held


@pytest.mark.parametrize("H", [1, 37])
@pytest.mark.parametrize("W", OC.WIDTHS)
@pytest.mark.parametrize("dtype", list(OC.DTYPES))
def test_op_chain_wrap_edge_equals_plain(dev, dtype, W, H):
    """Every op set at the wrap edge (micro_i16.edge_values): integer adds
    that wrap past the largest value, bf16 and f32 adds that round; W = 32
    keeps one 16-bit value a register, wider rows two."""
    x = micro_i16.make_input(dtype, H, W, dev, edge=True)
    for bits in range(8):
        ops = [o for o, b in OC.OPS.items() if bits & b]
        got = OC.op_chain(x, ops)
        ref = OC.op_chain_plain(x, ops)
        torch.cuda.synchronize()
        if dtype == torch.uint16:
            got, ref = got.view(torch.int16), ref.view(torch.int16)
        assert torch.equal(got, ref), ops


# ---------------------------------------------------------------------------
# The sparse path on the card against the CPU
# ---------------------------------------------------------------------------

def _smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SCENE_K = np.array([[200.0, 0.0, 160.0], [0.0, 200.0, 120.0], [0.0, 0.0, 1.0]])
SCENE_T = np.array([-0.3, 0.02, 0.01])


def _scene(dev, H=240, W=320):
    K = SCENE_K.copy()
    K[:2] *= W / 320.0
    R = synth.rotation_about((0.2, 1.0, 0.1), 2.0)
    left, right = synth.render_pair(K, R, SCENE_T, H, W, seed=2, device=dev)
    return K, R, left, right


@pytest.mark.parametrize("H,W", [(240, 320), (450, 700)])
def test_sift_and_descriptors_on_the_card_match_the_cpu(dev, H, W):
    _, _, left, _ = _scene(dev, H, W)
    fc = FT.detect_and_describe(left, 1024)
    fh = FT.detect_and_describe(left.cpu(), 1024)
    share, desc_err, n_cpu, _ = _smoke().same_features(torch, fh, fc)
    assert n_cpu > 200 and share >= 0.99 and desc_err <= 1e-4
    d32 = MT.squared_distance_matrix(fc.descriptors, fc.descriptors.flip(0))
    a, b = fc.descriptors.double(), fc.descriptors.flip(0).double()
    d64 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None] - 2.0 * a @ b.T
    assert float((d32.double() - d64).abs().max() / d64.abs().max()) <= 1e-4


def _robust_inputs():
    """200 correspondences of a two-view scene, 0.3 px noise, 30% outliers,
    20 padded slots invalid, as float64 CPU tensors; and the scene's K."""
    rng = np.random.default_rng(9)
    K = np.array([[820.0, 0.0, 330.0], [0.0, 810.0, 245.0], [0.0, 0.0, 1.0]])
    X = np.stack([rng.uniform(-2, 2, 220), rng.uniform(-1.5, 1.5, 220), rng.uniform(3, 8, 220)], -1)
    R = synth.rotation_about((0.1, 1.0, -0.2), 5.0)
    t = np.array([-1.0, 0.1, 0.05])

    def proj(P):
        x = P @ K.T
        return x[:, :2] / x[:, 2:] + rng.normal(scale=0.3, size=(len(P), 2))

    p1, p2 = proj(X), proj(X @ R.T + t)
    bad = rng.random(220) < 0.3
    p2[bad] = rng.uniform([0, 0], [660, 490], (int(bad.sum()), 2))
    mask = np.ones(220, bool)
    mask[200:] = False
    return [torch.from_numpy(a) for a in (p1, p2, mask, K)]


def test_robust_fits_on_the_card_equal_the_cpu(dev, monkeypatch):
    """The same samples: the same LMedS F and 5-point RANSAC E (float64)."""
    p1, p2, mask, K = _robust_inputs()
    draws = {}

    def same_draws(generator, num_points, mask_, num_hypotheses, k):
        key = (num_hypotheses, k)
        if key not in draws:
            g = torch.Generator().manual_seed(num_hypotheses + k)
            draws[key] = draw(g, num_points, mask_.cpu(), num_hypotheses, k)
        return draws[key].to(mask_.device)

    draw = RB.sample_indices
    monkeypatch.setattr(RB, "sample_indices", same_draws)
    out = {}
    for d in (torch.device("cpu"), dev):
        args = [x.to(d) for x in (p1, p2, mask)]
        f = RB.find_fundamental(None, *args, num_hypotheses=256)
        e = RB.find_essential(None, args[0], args[1], K.to(d), mask=f.inlier_mask, num_hypotheses=512)
        out[d.type] = [x.cpu() for x in (f.model, f.inlier_mask, e.model, e.inlier_mask)]
    torch.cuda.synchronize()
    (fh, mh, eh, meh), (fc, mc, ec, mec) = out["cpu"], out["cuda"]

    def unit(M):
        M = M / M.norm()
        return M * torch.sign(M.flatten()[M.abs().argmax()])

    assert torch.equal(mh, mc) and torch.equal(meh, mec) and int(mec.sum()) > 120
    assert float((unit(fc) - unit(fh)).abs().max()) <= 1e-10
    assert float((unit(ec) - unit(eh)).abs().max()) <= 1e-10


def test_robust_fit_indexes_no_cuda_tensor_by_a_mask(dev, monkeypatch):
    """Boolean-mask indexing waits for the host (its shape is data-
    dependent); the robust fits use where/argmax/gather instead."""
    p1, p2, mask, K = (x.to(dev) for x in _robust_inputs())
    seen = []
    getitem = torch.Tensor.__getitem__

    def spy(self, idx):
        items = idx if isinstance(idx, tuple) else (idx,)
        if self.is_cuda and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items):
            seen.append(tuple(self.shape))
        return getitem(self, idx)

    monkeypatch.setattr(torch.Tensor, "__getitem__", spy)
    gen = torch.Generator(device=dev).manual_seed(0)
    f = RB.find_fundamental(gen, p1, p2, mask, num_hypotheses=256)
    e = RB.find_essential(gen, p1, p2, K, mask=f.inlier_mask, num_hypotheses=512)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert not seen, seen
    assert int(e.num_inliers) > 120


def test_estimate_geometry_on_the_card_finds_the_rig(dev):
    K, R, left, right = _scene(dev)
    g = stages.estimate_geometry((left, right), 0.3, K, device="cuda")
    Rg, t = g["Rotation Matrix"], g["Translation Vector"].ravel()
    assert np.degrees(np.arccos(np.clip((np.trace(Rg @ R.T) - 1) / 2, -1, 1))) < 0.1
    assert np.degrees(np.arccos(t @ SCENE_T / np.linalg.norm(SCENE_T))) < 2
    assert g["num_inliers_E"] > 0.5 * g["num_matches"] > 100
    n1 = EP.pixel_to_normalized(torch.from_numpy(g["pts1"]), torch.from_numpy(K))
    assert n1.dtype == torch.float64


# The learned matcher (torch ops and cuDNN convolutions, no kernel of its
# own), held to the port's CPU run under PyTorch's default cuDNN flags, which
# allow TF32: the net must turn it off itself.

@pytest.fixture()
def tf32_default():
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=True):
        yield


def _xfeat_pair(dev, H, W):
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages as S

    _, _, left, right = _scene(dev, H, W)
    return S._xfeat_model(None, dev), S._xfeat_model(None, "cpu"), left, right


@pytest.mark.parametrize("H,W", [(240, 320), (448, 704)])
def test_xfeat_net_on_the_card_matches_the_cpu(dev, tf32_default, H, W):
    model, model_h, left, right = _xfeat_pair(dev, H, W)
    x = torch.stack([left, right]).float() / 255.0
    for name, a, b in zip(("logits", "desc", "rel"), model(x), model_h(x.cpu())):
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        assert err <= 1e-5, (name, err)
    assert torch.backends.cudnn.allow_tf32  # the caller's flag, restored


@pytest.mark.parametrize("image_refine", [True, False])
@pytest.mark.parametrize("H,W", [(240, 320), (448, 704)])
def test_xfeat_detection_on_the_card_matches_the_cpu(dev, tf32_default, H, W, image_refine):
    from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF

    model, model_h, left, right = _xfeat_pair(dev, H, W)
    card = XF.detect_pair(model, left, right, 512, image_refine=image_refine)
    cpu = XF.detect_pair(model_h, left.cpu(), right.cpu(), 512, image_refine=image_refine)
    for fc, fh in zip(card, cpu):
        share, desc_err, n_cpu, _ = _smoke().same_features(torch, fh, fc)
        assert n_cpu > 100 and share >= 0.99 and desc_err <= 1e-4
    again = XF.detect_pair(model, left, right, 512, image_refine=image_refine)
    assert all(torch.equal(a.keypoints, b.keypoints) for a, b in zip(card, again))


@pytest.mark.parametrize("H,W", [(240, 320), (448, 704)])
def test_xfeat_refinements_on_the_card(dev, H, W):
    """corner_subpix_patch in float32 against its float64 run on the card;
    refine_matches_lk on the card against the CPU (positions, and which
    matches move)."""
    from stereo_reconstruction_cv_tpu_torch.calib.chessboard import corner_subpix_patch
    from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF
    from stereo_reconstruction_cv_tpu_torch.ops.refine import refine_matches_lk

    model, _, left, right = _xfeat_pair(dev, H, W)
    plain = XF.detect_pair(model, left, right, 512, image_refine=False)[0]
    c32 = corner_subpix_patch(left, plain.keypoints, 3, 5, 5.0)
    c64 = corner_subpix_patch(left, plain.keypoints.double(), 3, 5, 5.0)
    assert float((c32.double() - c64).abs().amax(-1)[plain.mask].max()) <= 1e-3
    fl, fr = XF.detect_pair(model, left, right, 512)
    m = MT.match_learned(fl.descriptors, fr.descriptors, fl.mask, fr.mask)
    p1, p2, w = MT.gather_correspondences(fl.keypoints, fr.keypoints, m)
    q, moved = refine_matches_lk(left, right, p1, p2, win=9, iters=16)
    qh, moved_h = refine_matches_lk(left.cpu(), right.cpu(), p1.cpu(), p2.cpu(), win=9, iters=16)
    w = w.cpu()
    good, good_h = (moved.cpu() != 0).any(-1), (moved_h != 0).any(-1)
    assert int(w.sum()) > 50 and int(((good != good_h) & w).sum()) <= 0.005 * int(w.sum())
    both = good & good_h & w
    assert float((q.cpu() - qh).abs().amax(-1)[both].max()) <= 1e-3


# ---------------------------------------------------------------------------
# Calibration on the card against the CPU (chip_smoke.py phase 9's bounds)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calib_set():
    """chip_smoke.py's calibration set at 1920x1080, 3 poses x 2 cameras,
    rendered on the card (None without one)."""
    if not torch.cuda.is_available():
        return None
    return synth.calibration_set(torch.device("cuda"), H=1080, W=1920, n=3)


def test_chessboard_detection_on_the_card_matches_the_cpu(dev, calib_set):
    """The saddle response within 1e-5 of its maximum, the same candidates
    from the same response, and every view's corners within 1e-3 px."""
    from stereo_reconstruction_cv_tpu_torch.calib import chessboard as CB

    img = calib_set["views"][0][0]
    small = img.to(torch.float32).reshape(270, 4, 480, 4).mean((1, 3))
    rc, rh = CB.saddle_response(small), CB.saddle_response(small.cpu())
    assert float((rc.cpu() - rh).abs().max()) <= 1e-5 * float(rh.max())
    for a, b in zip(CB.nms_candidates(rh.to(dev), 256, 4), CB.nms_candidates(rh, 256, 4)):
        assert torch.equal(a.cpu(), b)
    for views in calib_set["views"]:
        for img in views:
            ok, c = CB.find_chessboard_corners(img)
            ok_h, ch = CB.find_chessboard_corners(img.cpu())
            assert ok and ok_h and c.device.type == "cuda"
            assert float((c.cpu() - ch).abs().max()) <= 1e-3
    img = calib_set["views"][0][0]
    starts = calib_set["truth"][0][0].float() + 0.7
    sc = CB.corner_subpix(img, starts.to(dev))
    sh = CB.corner_subpix(img.cpu(), starts)
    assert float((sc.cpu() - sh).abs().max()) <= 1e-3


def _calib_views(rng, V, noise=0.3):
    """V noisy views (V, 63, 2) of the 9 x 7 grid through K_4K and phase 9's
    distortion, with camera 2 of phase 7's rig; float64 CPU tensors."""
    from stereo_reconstruction_cv_tpu_torch.calib import zhang as Z

    K = torch.from_numpy(synth.K_4K)
    dist = torch.tensor(synth.CALIB_DIST, dtype=torch.float64)
    obj = Z.build_object_points(9, 7, 0.03)
    poses = synth.board_poses(V, synth.K_4K, 3840, 2160)
    R_rig, T_rig = synth.rotation_about(synth.SCENE_AXIS, synth.SCENE_DEG), np.array(synth.SCENE_T)
    out = []
    for cam in (0, 1):
        rv = torch.stack([G.matrix_to_rodrigues(torch.from_numpy(R_rig @ R if cam else R))
                          for R, _ in poses])
        tv = torch.from_numpy(np.stack([R_rig @ t + T_rig if cam else t for _, t in poses]))
        img = G.project_points(obj, rv, tv, K, dist)
        out.append(img + torch.from_numpy(rng.normal(size=tuple(img.shape)) * noise))
    return obj, out[0], out[1]


def test_zhang_and_lm_on_the_card_match_the_cpu(dev):
    """Homographies, Zhang's K, the poses: 1e-8 relative; calibrate_camera's
    K 1e-8 relative, its errors 1e-8; calibrate_stereo's R and T 1e-8."""
    from stereo_reconstruction_cv_tpu_torch.calib import stereo as ST
    from stereo_reconstruction_cv_tpu_torch.calib import zhang as Z

    obj, c1, c2 = _calib_views(np.random.default_rng(11), 10)
    Hh = Z.homography_dlt(obj[:, :2], c1)
    Hc = Z.homography_dlt(obj[:, :2].to(dev), c1.to(dev))
    assert float((Hc.cpu() - Hh).abs().max() / Hh.abs().max()) <= 1e-8
    Kh = Z.zhang_intrinsics(Hh, (3840, 2160))
    Kc = Z.zhang_intrinsics(Hc, (3840, 2160))
    assert float((Kc.cpu() - Kh).abs().max() / Kh.abs().max()) <= 1e-8
    for a, b in zip(Z.extrinsics_from_homography(Hc, Kc), Z.extrinsics_from_homography(Hh, Kh)):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-8
    img = torch.cat([c1, c2])
    rh = Z.calibrate_camera(obj, img, (3840, 2160))
    rc = Z.calibrate_camera(obj.to(dev), img.to(dev), (3840, 2160))
    assert rc.K.device.type == "cuda"
    assert float((rc.K.cpu() - rh.K).abs().max() / rh.K.abs().max()) <= 1e-8
    for k in ("rms", "mean_error"):
        assert abs(float(getattr(rc, k)) / float(getattr(rh, k)) - 1) <= 1e-8
    sh = ST.calibrate_stereo(obj, c1, c2, (3840, 2160))
    sc = ST.calibrate_stereo(obj.to(dev), c1.to(dev), c2.to(dev), (3840, 2160))
    for k in ("R", "T", "K1", "K2"):
        a, b = getattr(sc, k).cpu(), getattr(sh, k)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-8, k


def test_lm_makes_no_host_sync_on_the_card(dev):
    """The LM steps run under CUDA's sync debug mode "error": no step reads
    a value back to the host."""
    from stereo_reconstruction_cv_tpu_torch.calib import zhang as Z

    obj, c1, _ = _calib_views(np.random.default_rng(12), 6)
    obj, img = obj.to(dev), c1.to(dev)
    Hs = Z.homography_dlt(obj[:, :2], img)
    K0 = Z.zhang_intrinsics(Hs, (3840, 2160))
    rv, tv = Z.extrinsics_from_homography(Hs, K0)
    theta0 = Z._pack(K0, torch.zeros(5, dtype=torch.float64, device=dev), rv, tv)
    res_fn = lambda th: Z._residuals(th, obj, img)  # noqa: E731
    Z.levenberg_marquardt(res_fn, theta0, 1)  # warm: first-use set-up may sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        theta = Z.levenberg_marquardt(res_fn, theta0, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(theta).all())


# ---------------------------------------------------------------------------
# The streaming path and the bench's config 1 on the card
# ---------------------------------------------------------------------------

# Largest difference in grey levels between nvJPEG's frames and PIL's
# (libjpeg-turbo's) on the same noise image with no chroma subsampling: the
# luma planes differ only by their inverse DCTs' rounding, RGB also by the
# colour conversion's (4 levels on the card). With 4:2:0 chroma their
# upsamplers differ too, by up to 36 levels in RGB; the luma plane, all the
# streaming path reads, is never subsampled.
NVJPEG_PIL_LEVELS = {True: 2, False: 4}  # gray, RGB


def _jpeg_pairs(root, n, H, W, seed=0):
    """n pairs of distinct random-texture gray JPEGs (PIL, quality 95)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for k in range(n):
        row = []
        for side in "lr":
            img = rng.integers(0, 256, (H, W), dtype=np.uint8)
            path = root / f"pair{k}_{side}.jpg"
            Image.fromarray(img).save(path, quality=95)
            row.append(str(path))
        paths.append(tuple(row))
    return paths


def test_nvjpeg_decode_against_pil_and_bad_bytes(dev, tmp_path):
    """nvJPEG's gray and RGB frames against PIL's decode of the same file
    (4:4:4, within NVJPEG_PIL_LEVELS; gray against libjpeg's own luma, PIL's
    draft mode "L"), and bytes that are no JPEG raise DataError."""
    from PIL import Image

    from stereo_reconstruction_cv_tpu_torch.errors import DataError

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (120, 200, 3), dtype=np.uint8)
    for mode, img in (("L", rgb[..., 0]), ("RGB", rgb)):
        path = tmp_path / f"{mode}.jpg"
        Image.fromarray(img).save(path, quality=95, subsampling=0)
        for gray in (True, False):
            got = native.load_image(str(path), gray, "nvjpeg")
            with Image.open(path) as im:
                if gray:
                    im.draft("L", im.size)  # libjpeg's own luma, as nvJPEG's Y
                want = np.asarray(im.convert("L" if gray else "RGB"))
            assert got.shape == want.shape
            err = int(np.abs(got.astype(int) - want.astype(int)).max())
            assert err <= NVJPEG_PIL_LEVELS[gray], (mode, gray, err)
    with pytest.raises(DataError):
        native.decode_jpeg(b"\x00not a jpeg" * 20, True, "nvjpeg")


def test_prefetch_loader_side_stream_frames_equal_synchronous_copies(dev, tmp_path):
    """Batches copied on the loader's side stream and handed over through
    its events equal each frame decoded and copied synchronously, and the
    consumer's loop makes no host sync (sync debug mode "error")."""
    from stereo_reconstruction_cv_tpu_torch.parallel.prefetch import PrefetchLoader

    paths = _jpeg_pairs(tmp_path, 5, 1080, 1920)
    got = []
    with PrefetchLoader(paths, batch_size=2, prefetch=2, decoder="nvjpeg", device=dev) as loader:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for left, right in loader:
                got.append((left * 1, right * 1))  # consumer work on its own stream
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert [l.shape[0] for l, _ in got] == [2, 2, 1]
    assert loader.images_decoded == 10 and loader.h2d_copies == 3
    frames = [f for l, r in got for f in zip(l, r)]
    for row, (l, r) in zip(paths, frames):
        for p, t in zip(row, (l, r)):
            assert torch.equal(t, torch.from_numpy(native.load_image(p, True, "nvjpeg")).to(dev))


def test_stream_reconstruct_on_the_card_equals_the_per_pair_path(dev, tmp_path):
    """Three rendered pairs (shifted copies of one) through the streamed
    path give the clouds of sgbm_disparity -> reproject_image_to_3d on the
    same decoded frames, bit for bit."""
    from PIL import Image

    from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
    from stereo_reconstruction_cv_tpu_torch.io.ply import read_ply
    from stereo_reconstruction_cv_tpu_torch.parallel.streaming import stream_reconstruct

    left, right = synth.render_pair(np.array([[150.0, 0, 80], [0, 150.0, 48], [0, 0, 1]]),
                                    np.eye(3), (-0.14, 0, 0), 96, 160, seed=1)
    paths = []
    for k in range(3):
        row = []
        for side, img in zip("lr", (left, right)):
            path = tmp_path / f"p{k}{side}.jpg"
            Image.fromarray(np.roll(img.numpy(), 7 * k, 0)).save(path, quality=95)
            row.append(str(path))
        paths.append(tuple(row))
    Q = np.array([[1, 0, 0, -80.0], [0, 1, 0, -48.0], [0, 0, 0, 150.0], [0, 0, 1 / 0.14, 0]])
    cfg = SGBMConfig(num_disparities=16, num_directions=8, speckle_window_size=0)
    clouds = stream_reconstruct(paths, Q, cfg, str(tmp_path / "out"), batch_size=2,
                                decoder="nvjpeg", device=dev)
    Qt = torch.as_tensor(Q, dtype=torch.float32, device=dev)
    for row, path in zip(paths, clouds):
        l, r = (torch.from_numpy(native.load_image(p, True, "nvjpeg")).to(dev) for p in row)
        d, v = DP.sgbm_disparity(l, r, cfg)
        pts = G.reproject_image_to_3d(d, Qt)
        want = pts[v & torch.isfinite(pts).all(-1) & (d > 0)].cpu().numpy()
        got, _ = read_ply(path)
        assert len(want) > 0
        np.testing.assert_array_equal(got, want)


def test_config1_step_launches_cost_volume_once_and_equals_the_cpu(dev):
    from stereo_reconstruction_cv_tpu_torch import benchmarks as B

    l, r = B._textured((200, 64), 5, 4, torch.device("cpu"))
    counts = (CK.launches, SK.launches, LK.launches, SPK.launches)
    before = [dict(c) for c in counts]
    disp, valid = B.sad_wta_step(l.to(dev), r.to(dev), 16)
    torch.cuda.synchronize()
    grew = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c if c[k] != b[k]}
    assert grew == {"cost_volume": 1, "wta_volume": 1}
    disp_h, valid_h = B.sad_wta_step(l, r, 16)
    assert torch.equal(disp.cpu(), disp_h) and torch.equal(valid.cpu(), valid_h)


def _v4_trainable(device):
    from stereo_reconstruction_cv_tpu_torch.models import checkpoint as CKPT
    from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF

    model = XF.XFeatNet().to(device)
    model.load_state_dict(CKPT.load_params(CKPT.default_checkpoint(), device))
    return model


def _rendered_views(n, H, W, seed=0):
    K = np.array([[115.0, 0, W / 2], [0, 115.0, H / 2], [0, 0, 1]])
    return torch.from_numpy(np.stack([synth.render_pair(K, np.eye(3), (-0.14, 0, 0), H, W,
                                                        seed=seed + s)[0].numpy()
                                      for s in range(n)]).astype(np.float32))


def test_train_step_on_the_card_equals_the_cpu(dev, tf32_default, monkeypatch):
    """Two train_steps from the v4 weights with the same draws (made on the
    CPU), with TF32 allowed in cuDNN and cuBLAS (train_step turns it off for
    its losses and their backward): the losses to 1e-5 relative, each step's
    gradients to 1e-4 of each tensor's largest entry and the parameters
    after two by chip_smoke.py's move_error (tests/test_torch_xfeat_train.py's
    tolerances against the JAX reference)."""
    from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF
    from stereo_reconstruction_cv_tpu_torch.models import xfeat_train as XT

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    imgs = _rendered_views(4, 128, 128)
    gen = torch.Generator().manual_seed(0)
    draws = [XF.draw_warps(gen, 4) for _ in range(2)]
    runs = {}
    for device in ("cpu", dev):
        model = _v4_trainable(device)
        state = XF.create_train_state(model, XT.warmup_cosine(1e-3, 1, 10), max_norm=1.0)
        losses, grads = [], []
        for d in draws:
            losses.append(float(XF.train_step(state, imgs.to(device),
                                              XF.WarpDraws(*(t.to(device) for t in d)))))
            grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
        runs[str(device)] = (losses, grads, {n: p.detach().cpu() for n, p in model.named_parameters()})
    (lh, gh, ph), (lc, gc, pc) = runs["cpu"], runs[str(dev)]
    np.testing.assert_allclose(lc, lh, rtol=1e-5)
    for c, h in zip(gc, gh):
        for n in h:
            assert float((c[n] - h[n]).abs().max() / h[n].abs().max()) <= 1e-4, n
    smoke = _smoke()
    move, share, move_all = smoke.move_error(pc, ph, gh, 1e-3)
    assert move <= smoke.TRAIN_MOVE_TOL and share > 1 / 3 and move_all <= 2.0, (move, share, move_all)


def test_train_runs_and_saves_on_the_card(dev, tmp_path):
    from stereo_reconstruction_cv_tpu_torch.io.image import save_image
    from stereo_reconstruction_cv_tpu_torch.models import checkpoint as CKPT
    from stereo_reconstruction_cv_tpu_torch.models import xfeat_train as XT

    for i, img in enumerate(_rendered_views(3, 120, 200)):
        save_image(str(tmp_path / f"v{i}.jpg"), img.numpy().astype(np.uint8), quality=95)
    counts = (CK.launches, SK.launches, LK.launches, SPK.launches, OC.launches)
    before = [dict(c) for c in counts]
    hist = XT.train([str(tmp_path)], steps=5, batch=4, crop=96, output=str(tmp_path / "w"),
                    log_every=2, device="cuda")
    assert [c == b for c, b in zip(counts, before)] == [True] * len(counts)
    assert [h[0] for h in hist] == [0, 2, 4] and all(np.isfinite(v) for _, v in hist)
    model = CKPT.load_model(str(tmp_path / "w.npz"), dev)
    logits, desc, rel = model(_rendered_views(1, 64, 96).to(dev) / 255.0)
    assert torch.isfinite(logits).all() and desc.shape == (1, 8, 12, 64)


def test_stereo_pool_launches_the_dense_kernels_and_train_step_none(dev, tmp_path, monkeypatch):
    from stereo_reconstruction_cv_tpu_torch.io.image import save_image
    from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF
    from stereo_reconstruction_cv_tpu_torch.models import xfeat_train as XT

    K = synth.K_4K * np.array([[0.1], [0.1], [1.0]])
    monkeypatch.setattr(XT, "POOL_K", K)
    pairs = []
    for s in range(2):
        left, right = synth.render_pair(K, synth.rotation_about((0.2, 1.0, 0.1), 2.0),
                                        (-0.14, 0.004, -0.003), 216, 384, seed=s, device=dev)
        folder = tmp_path / f"pair{s}"
        folder.mkdir()
        save_image(str(folder / "img1.jpg"), left.cpu().numpy(), quality=95)
        save_image(str(folder / "img2.jpg"), right.cpu().numpy(), quality=95)
        pairs.append(str(folder))
    counts = (CK.launches, SK.launches, LK.launches, SPK.launches, OC.launches)
    before = [dict(c) for c in counts]
    pool = XT.build_stereo_pool(pairs, width=192, ndisp=16, cache_dir=str(tmp_path), device="cuda")
    grew = {k for c, b in zip(counts, before) for k in c if c[k] != b[k]}
    assert grew == {"cost_volume", "sgm_path_sweep", "sgm_sweep_wta", "lr_check",
                    "speckle_labels", "speckle_keep"}, grew
    assert all(t.device.type == "cuda" for t in pool) and pool[0].shape[0] == 2
    before = [dict(c) for c in counts]
    gen = torch.Generator(device=dev).manual_seed(0)
    state = XF.create_train_state(_v4_trainable(dev), 1e-4, max_norm=1.0)
    loss = XF.train_step(state, XT._device_batch(pool[0], gen, 2, 64), XF.draw_warps(gen, 2),
                         XT._stereo_batch(pool, gen, 2, 64))
    assert np.isfinite(float(loss))
    assert [dict(c) for c in counts] == before


# ---------------------------------------------------------------------------
# The carried path sweep and the row-sharded SGBM over a mesh of the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 17, 33, 128, 256])
@pytest.mark.parametrize("H,W", [(1, 1), (1, 40), (5, 37), (30, 9)])
@pytest.mark.parametrize("carry", ["zero", "random", "in only", "out only"])
def test_carried_path_sweep_equals_plain(dev, D, H, W, carry):
    """Every direction with dy != 0, written and accumulated: the deltas and
    the last row's lam against the plain scan from the same carry (None on
    the side not given); D % K != 0 (17, 33) takes the scalar accesses."""
    rng = np.random.default_rng(D * 7 + H * W)
    C = torch.from_numpy(rng.integers(0, 20000, (H, W, D), dtype=np.int16)).to(dev)
    start = torch.from_numpy(rng.integers(0, 1 << 16, (H, W, D)).astype(np.uint16).view(np.int16)).to(dev)
    cin = None
    if carry != "out only":
        cin = torch.from_numpy((rng.integers(0, 30000, (W, D)) if carry != "zero"
                                else np.zeros((W, D))).astype(np.int32)).to(dev)
    for dx, dy in [d for d in SK.DIRS_8 if d[1] != 0]:
        delta, lam = SK.path_delta_carry_plain(C, dx, dy, P1, P2, cin)
        for accumulate in (False, True):
            acc = start.clone()
            cout = None if carry == "in only" else torch.full((W, D), -7, dtype=torch.int32,
                                                               device=dev)
            SK.path_sweep_cuda(C, acc, dx, dy, P1, P2, accumulate, cin, cout)
            torch.cuda.synchronize()
            want = ((SK.u16(start) if accumulate else 0) + delta) & 0xFFFF
            assert torch.equal(SK.u16(acc), want), (dx, dy, accumulate)
            if cout is not None:
                assert torch.equal(cout, lam), (dx, dy, accumulate)


def _cuda_mesh(nd, ns):
    from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M

    n = torch.cuda.device_count()
    return M.make_mesh(nd, ns, devices=[torch.device("cuda", i % n) for i in range(nd * ns)])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 3)])
@pytest.mark.parametrize("nd,D,md", [(8, 16, 0), (5, 33, 3)])
def test_exact_sharded_sgbm_on_the_card_equals_single_device(dev, shape, nd, D, md):
    from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M
    from stereo_reconstruction_cv_tpu_torch.parallel import sgm_sharded as SS
    from stereo_reconstruction_cv_tpu_torch.tools.probe_sweep import textured_pair

    rng = np.random.default_rng(D + nd)
    pairs = [textured_pair(rng, 48, 101, 9) for _ in range(shape[0])]
    L = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    R = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    cfg = DP.SGBMConfig(num_disparities=D, min_disparity=md, num_directions=nd,
                        speckle_window_size=20)
    before = dict(SK.launches)
    d, v = (M.gather(x, dev) for x in SS.sharded_sgbm_disparity(_cuda_mesh(*shape), L, R, cfg,
                                                                exact=True))
    assert SK.launches["sgm_path_sweep_carry"] > before["sgm_path_sweep_carry"]
    for k in range(shape[0]):
        d1, v1 = DP.sgbm_disparity(L[k], R[k], cfg)
        assert torch.equal(d[k], d1) and torch.equal(v[k], v1)


@pytest.mark.parametrize("max_size", [50, 200])
def test_sharded_speckle_on_the_card_equals_single_device(dev, max_size):
    from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M
    from stereo_reconstruction_cv_tpu_torch.parallel import sgm_sharded as SS

    rng = np.random.default_rng(max_size)
    B, H, W = 2, 96, 128
    disp = np.full((B, H, W), 10.0, np.float32)
    valid = rng.uniform(size=(B, H, W)) > 0.15
    for (y0, y1, x0, x1), dv in [((10, 90, 5, 8), 200.0), ((22, 27, 40, 45), 120.0),
                                 ((65, 80, 90, 100), 90.0), ((40, 55, 100, 120), 60.0)]:
        disp[:, y0:y1, x0:x1] = dv
        valid[:, y0:y1, x0:x1] = True
    disp[1] = (rng.integers(0, 6, size=(H, W)) * 40).astype(np.float32)
    d, v = torch.from_numpy(disp).to(dev), torch.from_numpy(valid).to(dev)
    keep = M.gather(SS.sharded_speckle_filter(_cuda_mesh(2, 4), d, v, max_size, 32.0), dev)
    for k in range(B):
        assert torch.equal(keep[k], SPK.speckle_filter(d[k], v[k], max_size, 32.0))


def test_mesh_step_on_four_cards_waits_once_and_keeps_clouds_on_their_rows(dev, monkeypatch):
    """A 2x2 mesh over four cards: a batch step after the first makes no host
    sync under CUDA's sync debug mode "error" but the batch's one join copy,
    and each pair's maps, points and cloud stay on its own data row's cards,
    the row's pairs taking its cards in turn; its maps equal the pair's
    single-device SGBM on its halo-extended shards."""
    from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M
    from stereo_reconstruction_cv_tpu_torch.parallel import sgm_sharded as SS
    from stereo_reconstruction_cv_tpu_torch.parallel import streaming as ST
    from stereo_reconstruction_cv_tpu_torch.tools.probe_sweep import textured_pair

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    mesh = M.make_mesh(2, 2, devices=[torch.device("cuda", i) for i in range(4)])
    rng = np.random.default_rng(21)
    pairs = [textured_pair(rng, 96, 160, 9) for _ in range(4)]
    L, R = (torch.from_numpy(np.stack([p[s] for p in pairs])) for s in (0, 1))
    cfg = DP.SGBMConfig(num_disparities=32, num_directions=5, speckle_window_size=20)
    Q = np.array([[1, 0, 0, -80.0], [0, 1, 0, -48.0], [0, 0, 0, 100.0], [0, 0, 1 / 0.14, 0]])
    sharding = M.batch_row_sharding(mesh)
    Ls, Rs = M.place(L, sharding), M.place(R, sharding)
    ST.dense_batch_step(Ls, Rs, Q, cfg, mesh)  # warm: first-use set-up may sync
    for i in range(4):
        torch.cuda.synchronize(i)
    copies = []
    to_host = SS._to_host

    def one_copy(x):
        copies.append(x.shape)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return to_host(x)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(SS, "_to_host", one_copy)
    torch.cuda.set_sync_debug_mode("error")
    try:
        disp, pts, valid = ST.dense_batch_step(Ls, Rs, Q, cfg, mesh)
        clouds = [ST.cloud_points(d, p, v) for d, p, v in zip(disp, pts, valid)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(copies) == 1
    for b in range(4):
        want = mesh.devices[b // 2][b % 2]
        assert {disp[b].device, pts[b].device, valid[b].device} == {want}, b
        assert {t.device for t in clouds[b]} == {want}, b
    core = cfg.with_(speckle_window_size=0)
    x0 = cfg.min_disparity + cfg.num_disparities
    for b in range(4):
        ds, vs = [], []
        for j in range(2):
            lo, hi = max(0, j * 48 - 32), min(96, (j + 1) * 48 + 32)
            d1, v1 = DP.sgbm_disparity(L[b, lo:hi].to(dev), R[b, lo:hi].to(dev), core)
            ds.append(d1[j * 48 - lo:j * 48 - lo + 48])
            vs.append(v1[j * 48 - lo:j * 48 - lo + 48])
        d1, v1 = torch.cat(ds), torch.cat(vs)
        keep = SPK.speckle_filter(d1[:, x0:], v1[:, x0:], 20, 32.0)
        assert torch.equal(disp[b].to(dev), d1), b
        assert torch.equal(valid[b].to(dev), torch.nn.functional.pad(keep, (x0, 0), value=False)), b
