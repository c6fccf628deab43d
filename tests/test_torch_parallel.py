"""Port vs JAX reference: the device mesh and row-sharded SGBM.

The reference's sharded functions run here on the 8 CPU devices of
tests/conftest.py, as tests/test_parallel.py runs them; the port's mesh is a
grid of CPU devices (``[torch.device("cpu")] * n``), so its shards run the
plain versions of the kernels. Each reference result is computed once per
module. Exact mode and the sharded speckle filter are bit-exact; halo mode
is held to the reference only where the reference is right (reference fault
12: its edge shards run on zero halo rows).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.config import SGBMConfig as RefConfig
from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu.parallel import mesh as RM
from stereo_reconstruction_cv_tpu.parallel import sgm_sharded as RS
from stereo_reconstruction_cv_tpu_torch import convert
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.ops.cuda import speckle as SPK
from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M
from stereo_reconstruction_cv_tpu_torch.parallel import sgm_sharded as S
from stereo_reconstruction_cv_tpu_torch.parallel import streaming

P1, P2 = 8 * 3 * 121, 32 * 3 * 121
CPU = torch.device("cpu")
MESHES = [(1, 4), (2, 2), (2, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # torch's CPU ops run 10-20x slower here on all of a shared host's threads.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(seed, B=2, H=64, W=128, d0=8):
    """tests/test_parallel.py:make_batch: a random texture shifted by d0."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(B, H, W + d0)).astype(np.float32)
    return base[:, :, d0:].astype(np.uint8), base[:, :, :-d0].astype(np.uint8)


def sinusoid_batch(B=2, H=128, W=192, d0=8, seed=3):
    """A smooth texture shifted by d0, with noise drawn for each view apart
    (real-image-like): SGBM's decisions are not knife-edge ties there, unlike
    pure noise, and its subpixel values vary."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:H, :W + d0].astype(np.float32)
    out = []
    for b in range(B):
        f = rng.uniform(0.05, 0.2, 4)
        out.append((np.sin(f[0] * x + f[1] * y) + np.sin(f[2] * x - f[3] * y + b)) * 50 + 128)
    base = np.stack(out).astype(np.float32)

    def view(a):
        return np.clip(a + rng.normal(0, 6, a.shape), 0, 255).astype(np.uint8)

    return view(base[:, :, :-d0]), view(base[:, :, d0:])  # left[x] = right[x - d0]


def ref_mesh(nd, ns):
    return RM.make_mesh(n_data=nd, n_space=ns)


def ref_put(x, mesh):
    return jax.device_put(jnp.asarray(x), RM.batch_row_sharding(mesh))


def port_mesh(nd, ns):
    return M.make_mesh(nd, ns, devices=[CPU] * (nd * ns))


def single(left, right, cfg):
    maps = [DP.sgbm_disparity(torch.from_numpy(l), torch.from_numpy(r), cfg)
            for l, r in zip(left, right)]
    return torch.stack([d for d, _ in maps]), torch.stack([v for _, v in maps])


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def test_make_mesh_raises_without_cuda_and_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    mesh = M.make_mesh(devices=[CPU] * 4, n_space=2)
    assert mesh.shape == {"data": 2, "space": 2}
    with pytest.raises(ValueError, match="need 3x2 devices"):
        M.make_mesh(3, 2, devices=[CPU] * 4)


@pytest.mark.parametrize("spec", [("data", "space"), ("data",), ()])
def test_place_and_gather_round_trip(spec):
    x = torch.arange(4 * 8 * 5).reshape(4, 8, 5)
    mesh = port_mesh(2, 4)
    xs = M.place(x, M.Sharding(mesh, spec))
    b = 2 if "data" in spec else 4
    h = 2 if "space" in spec else 8
    assert all(blk.shape == (b, h, 5) for row in xs.blocks for blk in row)
    assert torch.equal(M.gather(xs), x)
    xs.blocks[0][0][0, 0, 0] = -1  # blocks are copies, not views of x
    assert int(x[0, 0, 0]) == 0


def test_place_refuses_uneven_splits():
    mesh = port_mesh(2, 4)
    with pytest.raises(ValueError, match="batch 3"):
        M.place(torch.zeros(3, 8, 4), M.batch_row_sharding(mesh))
    with pytest.raises(ValueError, match="6 rows"):
        M.place(torch.zeros(2, 6, 4), M.batch_row_sharding(mesh))


def test_neighbour_exchange_gives_nothing_at_the_image_edges():
    blocks = [torch.full((4, 3), float(j)) for j in range(3)]
    prev, nxt = M.from_prev(blocks, 2), M.from_next(blocks, 2)
    assert prev[0] is None and nxt[-1] is None
    assert [float(p[0, 0]) for p in prev[1:]] == [0.0, 1.0]
    assert [float(n[0, 0]) for n in nxt[:-1]] == [1.0, 2.0]


# ---------------------------------------------------------------------------
# The carried sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carry", ["zero", "random"])
@pytest.mark.parametrize("dx,dy", [d for d in SK.DIRS_8 if d[1] != 0])
def test_carried_sweep_matches_scan_rows_carry(dx, dy, carry):
    rng = np.random.default_rng(100 + 10 * dx + 3 * dy + (carry == "random"))
    C = rng.integers(0, 3000, size=(9, 23, 16)).astype(np.int32)
    c0 = (np.zeros((23, 16), np.int32) if carry == "zero"
          else rng.integers(0, 9000, size=(23, 16)).astype(np.int32))
    L_ref, out_ref = RS._scan_rows_carry(jnp.asarray(C), dx, dy, P1, P2, jnp.asarray(c0))
    L, out = SK.scan_rows_carry(torch.from_numpy(C), dx, dy, P1, P2, torch.from_numpy(c0))
    np.testing.assert_array_equal(L.numpy(), np.asarray(L_ref))
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_ref))
    # What the kernel's plain version writes: the deltas L - C onto a u16
    # volume and the last row normalised; a normalised carry gives the same.
    Ct = torch.from_numpy(C).to(torch.int16)
    acc, cout = torch.zeros_like(Ct), torch.empty(23, 16, dtype=torch.int32)
    lam0 = torch.from_numpy(c0 - c0.min(axis=1, keepdims=True))
    SK.path_sweep(Ct, acc, dx, dy, P1, P2, False, lam0, cout)
    np.testing.assert_array_equal(SK.u16(acc).numpy(), np.asarray(L_ref) - C)
    last = np.asarray(out_ref)
    np.testing.assert_array_equal(cout.numpy(), last - last.min(axis=1, keepdims=True))


def test_carried_sweep_kernel_refuses_cpu_tensors():
    C = torch.zeros(4, 8, 16, dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        SK.path_sweep_cuda(C, torch.zeros_like(C), 0, 1, P1, P2, False,
                           torch.zeros(8, 16, dtype=torch.int32), None)
    with pytest.raises(ValueError, match="horizontal"):
        SK.path_sweep(C, torch.zeros_like(C), 1, 0, P1, P2, False,
                      torch.zeros(8, 16, dtype=torch.int32), None)


# ---------------------------------------------------------------------------
# Exact mode
# ---------------------------------------------------------------------------

EXACT_CFG = {8: dict(num_disparities=16, num_directions=8, speckle_window_size=0, backend="xla"),
             5: dict(num_disparities=16, num_directions=5, speckle_window_size=0, backend="xla")}


@pytest.fixture(scope="module")
def exact_reference():
    """The reference's exact mode on a 2x2 mesh, per path count."""
    left, right = make_batch(11, B=2, H=64, W=128)
    out = {}
    for nd, kw in EXACT_CFG.items():
        cfg = RefConfig(**kw)
        mesh = ref_mesh(2, 2)
        d, v = jax.jit(lambda a, b: RS.sharded_sgbm_disparity(mesh, a, b, cfg, exact=True))(
            ref_put(left, mesh), ref_put(right, mesh))
        out[nd] = (np.asarray(d), np.asarray(v))
    return left, right, out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("nd", [8, 5])
def test_exact_mode_is_bit_exact(exact_reference, nd, shape):
    left, right, ref = exact_reference
    cfg = convert.sgbm_config(RefConfig(**EXACT_CFG[nd]))
    mesh = port_mesh(*shape)
    B = shape[0]
    d, v = S.sharded_sgbm_disparity(mesh, torch.from_numpy(left[:B]),
                                    torch.from_numpy(right[:B]), cfg, exact=True)
    d, v = M.gather(d), M.gather(v)
    d1, v1 = single(left[:B], right[:B], cfg)
    assert torch.equal(v, v1) and torch.equal(d, d1)
    np.testing.assert_array_equal(d.numpy(), ref[nd][0][:B])
    np.testing.assert_array_equal(v.numpy(), ref[nd][1][:B])


def test_exact_mode_identical_across_mesh_shapes():
    """tests/test_parallel.py::test_bit_exact_across_mesh_shapes, with the
    LR check and the speckle filter on."""
    left, right = make_batch(12, B=2, H=64, W=128)
    cfg = convert.sgbm_config(RefConfig(num_disparities=16, num_directions=5,
                                        speckle_window_size=20))
    outs = []
    for nd, ns in [(2, 2), (1, 4), (1, 2)]:
        d, v = S.sharded_sgbm_disparity(port_mesh(nd, ns), torch.from_numpy(left[:nd]),
                                        torch.from_numpy(right[:nd]), cfg, exact=True)
        outs.append((M.gather(d)[:1], M.gather(v)[:1]))
    for d, v in outs[1:]:
        assert torch.equal(d, outs[0][0]) and torch.equal(v, outs[0][1])


def test_exact_mode_refuses_shards_below_the_cost_halo():
    left, right = make_batch(13, B=1, H=20, W=64)
    cfg = convert.sgbm_config(RefConfig(num_disparities=16, speckle_window_size=0))
    with pytest.raises(ValueError, match="needs 6 rows"):
        S.sharded_sgbm_disparity(port_mesh(1, 4), torch.from_numpy(left),
                                 torch.from_numpy(right), cfg, exact=True)


# ---------------------------------------------------------------------------
# Halo mode
# ---------------------------------------------------------------------------

HALO = 32


@pytest.fixture(scope="module")
def halo_reference():
    """The reference on the 1x4 mesh (halo mode) and, for the edge shards,
    its single-device SGBM on the block with no halo at the image edge."""
    left, right = sinusoid_batch()
    cfg = RefConfig(num_disparities=16, num_directions=8, speckle_window_size=0,
                    backend="xla")
    mesh = ref_mesh(1, 4)
    d, v = jax.jit(lambda a, b: RS.sharded_sgbm_disparity(mesh, a, b, cfg, halo=HALO))(
        ref_put(left[:1], mesh), ref_put(right[:1], mesh))
    h = left.shape[1] // 4
    top = RD.sgbm_disparity(jnp.asarray(left[0, :h + HALO]), jnp.asarray(right[0, :h + HALO]), cfg)
    bot = RD.sgbm_disparity(jnp.asarray(left[0, -h - HALO:]), jnp.asarray(right[0, -h - HALO:]),
                            cfg)
    edges = (tuple(np.asarray(a)[:h] for a in top), tuple(np.asarray(a)[-h:] for a in bot))
    return left, right, cfg, (np.asarray(d)[0], np.asarray(v)[0]), edges


def test_halo_mode_interior_shards_match_the_reference(halo_reference):
    left, right, cfg, (dr, vr), _ = halo_reference
    d, v = S.sharded_sgbm_disparity(port_mesh(1, 4), torch.from_numpy(left[:1]),
                                    torch.from_numpy(right[:1]), convert.sgbm_config(cfg),
                                    halo=HALO)
    d, v = M.gather(d)[0].numpy(), M.gather(v)[0].numpy()
    h = left.shape[1] // 4
    np.testing.assert_array_equal(d[h:3 * h], dr[h:3 * h])
    np.testing.assert_array_equal(v[h:3 * h], vr[h:3 * h])


def test_halo_mode_edge_shards_match_the_no_halo_block(halo_reference):
    left, right, cfg, _, (top, bot) = halo_reference
    d, v = S.sharded_sgbm_disparity(port_mesh(1, 4), torch.from_numpy(left[:1]),
                                    torch.from_numpy(right[:1]), convert.sgbm_config(cfg),
                                    halo=HALO)
    d, v = M.gather(d)[0].numpy(), M.gather(v)[0].numpy()
    h = left.shape[1] // 4
    np.testing.assert_array_equal(d[:h], top[0])
    np.testing.assert_array_equal(v[:h], top[1])
    np.testing.assert_array_equal(d[-h:], bot[0])
    np.testing.assert_array_equal(v[-h:], bot[1])


def test_reference_fault_12_edge_shards_see_zero_halos(halo_reference):
    """The reference's edge shards differ from SGBM on their own block: its
    ppermute hands them HALO zero rows beyond the image edge."""
    left, right, cfg, (dr, _), (top, bot) = halo_reference
    h = left.shape[1] // 4
    assert (dr[:h] != top[0]).mean() > 0.5
    assert (dr[-h:] != bot[0]).mean() > 0.5
    # ... and equal SGBM on the block with HALO black rows above it.
    zeros = np.zeros((HALO, left.shape[2]), np.uint8)
    dz, _ = RD.sgbm_disparity(jnp.asarray(np.concatenate([zeros, left[0, :h + HALO]])),
                              jnp.asarray(np.concatenate([zeros, right[0, :h + HALO]])), cfg)
    np.testing.assert_array_equal(dr[:h], np.asarray(dz)[HALO:HALO + h])


def test_data_only_sharding_equals_the_unsharded_batch():
    left, right = make_batch(14, B=4, H=32, W=96)
    cfg = convert.sgbm_config(RefConfig(num_disparities=16, num_directions=8,
                                        speckle_window_size=30))
    d, v = S.sharded_sgbm_disparity(port_mesh(4, 1), torch.from_numpy(left),
                                    torch.from_numpy(right), cfg, halo=16)
    d1, v1 = single(left, right, cfg)
    assert torch.equal(M.gather(d), d1) and torch.equal(M.gather(v), v1)


# ---------------------------------------------------------------------------
# Sharded speckle
# ---------------------------------------------------------------------------

def structured_maps(seed=0, B=2, H=96, W=128):
    """tests/test_parallel.py's map (a snake across every boundary of 24-row
    shards, islands straddling them, invalid holes, a noise frame), plus
    islands of 150 and 300 pixels across boundaries, which a max_size of 200
    splits and a 7-bit count field (reference fault 3) cannot hold."""
    rng = np.random.default_rng(seed)
    disp = np.full((B, H, W), 10.0, np.float32)
    valid = rng.uniform(size=(B, H, W)) > 0.15
    for (y0, y1, x0, x1), dv in [((10, 90, 5, 8), 200.0), ((22, 27, 40, 45), 120.0),
                                 ((47, 50, 60, 63), 150.0), ((65, 80, 90, 100), 90.0),
                                 ((40, 55, 100, 120), 60.0)]:
        disp[:, y0:y1, x0:x1] = dv
        valid[:, y0:y1, x0:x1] = True
    disp[1] = (rng.integers(0, 6, size=(H, W)) * 40).astype(np.float32)
    return disp, valid


@pytest.mark.parametrize("max_size", [50, 200])
def test_sharded_speckle_equals_single_device(max_size):
    disp, valid = structured_maps()
    keep = M.gather(S.sharded_speckle_filter(port_mesh(2, 4), torch.from_numpy(disp),
                                             torch.from_numpy(valid), max_size, 32.0))
    for k in range(disp.shape[0]):
        d, v = torch.from_numpy(disp[k]), torch.from_numpy(valid[k])
        assert SPK.speckle_labels_plain(d, v, 32.0)[1]  # the flood converged
        assert torch.equal(keep[k], SPK.speckle_filter(d, v, max_size, 32.0))
    # The 150-pixel island across rows 72 survives 50 and not 200; the snake both.
    assert bool(keep[0, 40:60, 5:8].all())
    assert bool(keep[0, 65:80, 90:100].all()) == (max_size < 150)
    assert bool(keep[0, 40:55, 100:120].all())
    assert not bool(keep[0, 22:27, 40:45].any())


def test_sharded_speckle_equals_the_reference():
    disp, valid = structured_maps()
    rmesh = ref_mesh(2, 4)
    ref = jax.jit(lambda d, v: RS.sharded_speckle_filter(rmesh, d, v, 50, 32.0))(
        ref_put(disp, rmesh), ref_put(valid, rmesh))
    keep = M.gather(S.sharded_speckle_filter(port_mesh(2, 4), torch.from_numpy(disp),
                                             torch.from_numpy(valid), 50, 32.0))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Streaming over a mesh
# ---------------------------------------------------------------------------

def test_stream_reconstruct_over_a_mesh_writes_the_same_clouds(tmp_path):
    from PIL import Image

    left, right = sinusoid_batch(B=4, H=48, W=96, seed=5)
    pairs = []
    for i in range(4):
        paths = []
        for name, img in (("l", left[i]), ("r", right[i])):
            path = str(tmp_path / f"{name}{i}.jpg")
            Image.fromarray(img).save(path, quality=95)
            paths.append(path)
        pairs.append(tuple(paths))
    Q = np.array([[1, 0, 0, -48.0], [0, 1, 0, -24.0], [0, 0, 0, 100.0], [0, 0, 1 / 0.14, 0]])
    cfg = convert.sgbm_config(RefConfig(num_disparities=16, num_directions=8,
                                        speckle_window_size=20))
    plain = streaming.stream_reconstruct(pairs, Q, cfg, str(tmp_path / "plain"), batch_size=2,
                                         device="cpu")
    meshed = streaming.stream_reconstruct(pairs, Q, cfg, str(tmp_path / "mesh"), batch_size=2,
                                          mesh=port_mesh(2, 1))
    assert [os.path.basename(p) for p in meshed] == [os.path.basename(p) for p in plain]
    for a, b in zip(plain, meshed):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # Row-sharded (halo mode): the loader's blocks and the gathered maps run.
    rows = streaming.stream_reconstruct(pairs[:2], Q, cfg, str(tmp_path / "rows"), batch_size=1,
                                        mesh=port_mesh(1, 2))
    assert len(rows) == 2 and all(os.path.getsize(p) > 100 for p in rows)


# ---------------------------------------------------------------------------
# The 2x2 deployment (the benchmark's backlog_mesh4 cell) at a small size
# ---------------------------------------------------------------------------

def mesh_params(speckle=100):
    """main.ipynb cell 10's parameters at 16 disparities (the benchmark's
    configuration cut for the CPU)."""
    return {"min_disparity": 0, "num_disparities": 16, "block_size": 11, "p1": 2904,
            "p2": 11616, "disp12_max_diff": 1, "pre_filter_cap": 63, "uniqueness_ratio": 10,
            "speckle_window_size": speckle, "speckle_range": 32, "num_directions": 5,
            "speckle_backend": "propagate"}


@pytest.mark.parametrize("shape,halo", [((2, 2), 12), ((1, 4), 16), ((2, 2), 32)])
def test_halo_mode_equals_the_plain_mesh_reference(shape, halo):
    """benchmark/reference/sgbm_mesh.py (plain torch, float32, halo rows only
    from interior neighbours, the whole-frame speckle filter) against the
    port's halo mode on a mesh of CPU devices, bit for bit."""
    from benchmark.reference import sgbm_mesh as RSM
    from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig

    left, right = sinusoid_batch(B=shape[0], H=64, W=96, seed=11)
    config = {"sgbm": mesh_params(), "mesh": {"data": shape[0], "space": shape[1]},
              "halo": halo}
    d, v = (M.gather(x) for x in S.sharded_sgbm_disparity(
        port_mesh(*shape), torch.from_numpy(left), torch.from_numpy(right),
        SGBMConfig(**config["sgbm"]), halo=halo))
    for k in range(shape[0]):
        dr, vr = RSM.maps(config, torch.from_numpy(left[k]), torch.from_numpy(right[k]))
        assert torch.equal(d[k], dr) and torch.equal(v[k], vr), k
        assert 0.2 < float(vr.float().mean()) < 0.95


def test_stream_reconstruct_on_a_2x2_mesh_writes_the_reference_clouds(tmp_path):
    """stream_reconstruct(mesh=) over a 2x2 mesh (each pair's cloud made on
    its own data row's devices): PLY bytes equal to the plain halo-mode
    reference's clouds, in the input's order."""
    from PIL import Image

    from benchmark.reference import rig as RR
    from benchmark.reference import sgbm_mesh as RSM
    from stereo_reconstruction_cv_tpu_torch import native
    from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
    from stereo_reconstruction_cv_tpu_torch.io import ply as PLY

    left, right = sinusoid_batch(B=4, H=48, W=96, seed=9)
    pairs = []
    for i in range(4):
        paths = []
        for name, img in (("l", left[i]), ("r", right[i])):
            path = str(tmp_path / f"{name}{i}.jpg")
            Image.fromarray(img).save(path, quality=95)
            paths.append(path)
        pairs.append(tuple(paths))
    Q = np.array([[1, 0, 0, -48.0], [0, 1, 0, -24.0], [0, 0, 0, 100.0], [0, 0, 1 / 0.14, 0]])
    config = {"sgbm": mesh_params(20), "mesh": {"data": 2, "space": 2}, "halo": 32}
    out = streaming.stream_reconstruct(pairs, Q, SGBMConfig(**config["sgbm"]),
                                       str(tmp_path / "mesh"), batch_size=4,
                                       mesh=port_mesh(2, 2))
    assert [os.path.basename(p) for p in out] == [f"cloud_{i:04d}.ply" for i in range(4)]
    for i, path in enumerate(out):
        frames = [torch.from_numpy(native.load_image(p, True, "libjpeg")) for p in pairs[i]]
        disp, valid = RSM.maps(config, *frames)
        cloud = RR.cloud(disp, valid, torch.as_tensor(Q, dtype=torch.float32))
        assert cloud.shape[0] > 100
        PLY.write_ply(str(tmp_path / f"ref{i}.ply"), cloud.numpy())
        with open(path, "rb") as fa, open(tmp_path / f"ref{i}.ply", "rb") as fb:
            assert fa.read() == fb.read(), i


@pytest.mark.parametrize("max_size", [50, 200])
def test_batched_speckle_join_equals_single_device(monkeypatch, max_size):
    """Four frames over a 2x2 mesh (two a data row): every frame's keep mask
    equals the single-device filter, and the batch's boundary records reach
    the host in one copy."""
    disp, valid = structured_maps(B=2)
    disp = np.concatenate([disp, disp[::-1, ::-1]])
    valid = np.concatenate([valid, valid[::-1, ::-1]])
    copies = []
    to_host = S._to_host
    monkeypatch.setattr(S, "_to_host", lambda x: copies.append(x.shape) or to_host(x))
    keep = M.gather(S.sharded_speckle_filter(port_mesh(2, 2), torch.from_numpy(disp),
                                             torch.from_numpy(valid), max_size, 32.0))
    assert copies == [(2, 5, 2, disp.shape[2])]  # (data rows x boundaries, record, frames, W)
    for k in range(disp.shape[0]):
        d, v = torch.from_numpy(disp[k]), torch.from_numpy(valid[k])
        assert torch.equal(keep[k], SPK.speckle_filter(d, v, max_size, 32.0)), k
