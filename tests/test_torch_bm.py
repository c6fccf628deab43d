"""Block matching on the port's normal path (``SGBMConfig(num_directions=0)``), on the CPU.

With no path, ``sgbm_disparity`` runs the cost, the WTA over the cost volume
alone (``sgm_wta`` at zero paths, ``wta_volume`` with no delta volume), the
LR check and the speckle filter. Held bit for bit to the benchmark's plain
reference (``benchmark/reference/bm.py``) on pairs with occlusions and noise
(many small components, many LR rejects), and its WTA to the JAX package's
``wta_disparity`` on the same cost volume widened to int32 (on the int16
volume the reference wraps S * 100: ROADMAP C, reference fault 9). The entry
points that take zero paths (row tiles, the host speckle filter, the batched
dense step, the stream) equal the whole frame; those that do not (the
coarse-to-fine path, both sharded modes) refuse it by name. The kernel's
no-volume form is held to the plain WTA on the card (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from benchmark.reference import bm as RBM
from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu_torch import native
from stereo_reconstruction_cv_tpu_torch.config import SGBMConfig
from stereo_reconstruction_cv_tpu_torch.io import ply as PLY
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops.cuda import sgm as SK
from stereo_reconstruction_cv_tpu_torch.parallel import mesh as M
from stereo_reconstruction_cv_tpu_torch.parallel import sgm_sharded as SS
from stereo_reconstruction_cv_tpu_torch.parallel import streaming as ST
from stereo_reconstruction_cv_tpu_torch.utils import profiling

Q = np.array([[1.0, 0, 0, -80.0], [0, 1.0, 0, -48.0], [0, 0, 0, 150.0], [0, 0, 1 / 0.14, 0]])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bm_config(D, uniqueness=10, speckle=100, **kw) -> SGBMConfig:
    return SGBMConfig(num_disparities=D, num_directions=0, uniqueness_ratio=uniqueness,
                      speckle_window_size=speckle, **kw)


def occluded_pair(seed, H, W, near, far):
    """uint8 pair of smoothed noise: a near block (disparity `near`) over a
    far background (`far`), each view with noise of its own, so the maps
    have occlusions, LR rejects and small speckles."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, size=(H + 2, W + near + 2)).astype(np.float32)
    tex = sum(tex[i:i + H, j:j + W + near] for i in range(3) for j in range(3)) / 9.0
    tex = (tex - tex.mean()) * 3.0 + 128.0
    fg = np.zeros((H, W), bool)
    fg[H // 4:3 * H // 4, W // 3:2 * W // 3] = True
    xs = np.arange(W)
    left = np.where(fg, tex[:, xs], tex[:, xs + far // 2])
    fg_r = np.zeros((H, W), bool)
    fg_r[H // 4:3 * H // 4, W // 3 - near:2 * W // 3 - near] = True
    right = np.where(fg_r, tex[:, np.clip(xs + near, 0, W + near - 1)],
                     tex[:, np.clip(xs + far // 2 + far, 0, W + near - 1)])

    def view(a):
        return torch.from_numpy(np.clip(a + rng.normal(0, 6, a.shape), 0, 255).astype(np.uint8))

    return view(left), view(right)


def maps_config(cfg: SGBMConfig) -> dict:
    """A benchmark configuration's sgbm group from cfg, for the reference."""
    keys = ("min_disparity", "num_disparities", "block_size", "p1", "p2", "disp12_max_diff",
            "pre_filter_cap", "uniqueness_ratio", "speckle_window_size", "speckle_range",
            "num_directions")
    return {"sgbm": {k: getattr(cfg, k) for k in keys}}


@pytest.mark.parametrize("H,W,D,seed", [(56, 192, 16, 3), (96, 256, 32, 11)])
@pytest.mark.parametrize("uniqueness", [10, 0])
@pytest.mark.parametrize("speckle", [100, 0])
def test_block_matching_equals_the_plain_reference(H, W, D, seed, uniqueness, speckle):
    left, right = occluded_pair(seed, H, W, near=D - 4, far=D // 3)
    cfg = bm_config(D, uniqueness, speckle)
    disp, valid = DP.sgbm_disparity(left, right, cfg)
    ref_disp, ref_valid = RBM.maps(maps_config(cfg), left, right)
    assert disp.shape == valid.shape == (H, W)
    assert torch.equal(disp, ref_disp) and torch.equal(valid, ref_valid)
    x0 = DP.margin(cfg)[0]
    kept = valid[:, x0:].float().mean()
    assert 0.2 < kept < 1.0, kept  # rejects and keeps both present


def test_the_control_leaves_out_the_uniqueness_test():
    left, right = occluded_pair(5, 56, 192, 12, 5)
    cfg = bm_config(16)
    ctl = RBM.maps(maps_config(cfg), left, right, control=True)
    assert all(torch.equal(a, b) for a, b in zip(ctl, RBM.maps(maps_config(bm_config(16, 0)),
                                                               left, right)))
    assert not torch.equal(ctl[1], RBM.maps(maps_config(cfg), left, right)[1])


@pytest.mark.parametrize("D,lo,hi,ur,md", [(16, 0, 6, 10, 0), (24, 0, 30000, 0, 3),
                                           (64, 0, 20000, 10, 0), (3, 0, 4, 10, 1)])
def test_zero_path_wta_equals_the_jax_wta(D, lo, hi, ur, md):
    """sgm_wta at zero paths on a given C against the JAX package's
    wta_disparity on C widened to int32; small ranges make ties and
    uniqueness hits."""
    rng = np.random.default_rng(D + hi)
    C = rng.integers(lo, hi, (9, 37, D)).astype(np.int16)
    disp, valid, best, minS = SK.sgm_wta(torch.from_numpy(C), 0, 0, 0, ur, md)
    ref_disp, ref_valid = RD.wta_disparity(jnp.asarray(C.astype(np.int32)), md, ur)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(ref_disp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    S = C.astype(np.int32)
    np.testing.assert_array_equal(best.numpy(), S.argmin(-1))
    np.testing.assert_array_equal(minS.numpy(), S.min(-1))


def test_zero_path_wta_on_a_cost_volume_equals_the_jax_wta():
    left, right = occluded_pair(2, 40, 128, 10, 4)
    C = DP.sgbm_cost(left, right, bm_config(16))
    got = SK.sgm_wta(C, 0, 0, 0, 10, 0)
    ref = RD.wta_disparity(jnp.asarray(C.numpy().astype(np.int32)), 0, 10)
    for a, b in zip(got[:2], ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(torch.equal(a, b) for a, b in zip(got, SK.wta_volume(C, (), 10, 0)))


@pytest.mark.parametrize("nd", [-1, 1, 2, 4, 6, 7, 9])
def test_num_directions_outside_0_5_8_raises(nd):
    left, right = occluded_pair(1, 24, 64, 6, 2)
    with pytest.raises(ValueError, match="0 \\(block matching\\), 5 or 8"):
        DP.sgbm_disparity(left, right, SGBMConfig(num_disparities=16, num_directions=nd))


def test_zero_paths_leave_p1_and_p2_unchecked():
    """P1 and P2 are unused at zero paths; with paths a P2 past the u16
    volumes' bound still raises."""
    SK.check_sgm_bounds(-1, 70000, 64, 0)
    with pytest.raises(ValueError, match="P2"):
        SK.check_sgm_bounds(8, 70000, 64, 5)
    with pytest.raises(ValueError, match="num_disp"):
        SK.check_sgm_bounds(8, 32, 513, 0)


def test_wta_packed_refuses_no_volume():
    C = torch.zeros((2, 3, 8), dtype=torch.int16)
    with pytest.raises(ValueError, match="one or two delta volumes"):
        SK.wta_packed(C, [])


@pytest.mark.parametrize("entry", ["fast", "sharded_halo", "sharded_exact", "tiled_small_halo"])
def test_entry_points_that_refuse_block_matching(entry):
    left, right = occluded_pair(4, 32, 96, 8, 3)
    cfg = bm_config(16)
    cpu = M.make_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    call, mode = {
        "fast": (lambda: DP.sgbm_disparity_fast(left, right, cfg), "coarse-to-fine"),
        "sharded_halo": (lambda: SS.sharded_sgbm_disparity(cpu, left[None], right[None], cfg),
                         "halo mode"),
        "sharded_exact": (lambda: SS.sharded_sgbm_disparity(cpu, left[None], right[None], cfg,
                                                            exact=True), "exact mode"),
        "tiled_small_halo": (lambda: DP.sgbm_disparity_tiled(left, right, cfg, tile_rows=8,
                                                             halo=5), "halo of at least 6"),
    }[entry]
    with pytest.raises(ValueError, match=mode):
        call()


@pytest.mark.parametrize("tile_rows,halo", [(16, 6), (24, 32)])
def test_tiled_and_host_speckle_block_matching_equal_the_whole_frame(tile_rows, halo):
    left, right = occluded_pair(8, 72, 128, 12, 4)
    cfg = bm_config(16)
    whole = DP.sgbm_disparity(left, right, cfg)
    tiled = DP.sgbm_disparity_tiled(left, right, cfg, tile_rows=tile_rows, halo=halo)
    assert all(torch.equal(a, b) for a, b in zip(tiled, whole))
    assert all(torch.equal(a, b) for a, b in zip(DP.sgbm_disparity_auto(left, right, cfg), whole))
    host = DP.sgbm_disparity_host_speckle(left, right, cfg)
    assert torch.equal(host[0], whole[0])
    assert torch.equal(host[1], DP.filter_speckles_host(*DP.sgbm_disparity(
        left, right, cfg.with_(speckle_window_size=0)), 100, 32.0))


def test_frame_bytes_counts_no_delta_volume():
    cfg = bm_config(64)
    cells = 720 * (1280 - 64) * 64
    assert DP.frame_bytes(720, 1280, cfg) == cells * 2 + 64 * 720 * 1280


def test_the_wta_stage_has_its_own_span():
    from torch.profiler import ProfilerActivity, profile

    left, right = occluded_pair(6, 32, 96, 8, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        DP.sgbm_disparity(left, right, bm_config(16))
    names = [e.name()[len(profiling.SPAN_PREFIX):] for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profiling.SPAN_PREFIX)]
    assert sorted(names) == ["sgbm", "sgbm.cost", "sgbm.post", "sgbm.wta"]


@pytest.mark.parametrize("backend", ["propagate", "exact"])
def test_frames_off_the_card_make_no_graph(backend):
    """Only block matching on a CUDA device replays a graph (FrameGraph): a
    CPU frame runs its stages eagerly, every call, and keeps nothing."""
    left, right = occluded_pair(6, 32, 96, 8, 3)
    cfg = bm_config(16).with_(speckle_backend=backend)
    before = dict(DP._graphs)
    first = DP.sgbm_disparity(left, right, cfg)
    again = DP.sgbm_disparity(left, right, cfg)
    assert DP._graphs == before
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_dense_batch_step_and_stream_reconstruct_take_block_matching(tmp_path):
    """Unchanged callers: the batched step equals sgbm_disparity pair by
    pair, and stream_reconstruct's clouds equal the per-pair path's."""
    cfg = bm_config(16)
    pairs = [occluded_pair(20 + k, 48, 128, 12, 4) for k in range(3)]
    lefts, rights = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    disp, pts, valid = ST.dense_batch_step(lefts, rights, Q, cfg)
    for k, (l, r) in enumerate(pairs):
        d, v = DP.sgbm_disparity(l, r, cfg)
        assert torch.equal(disp[k], d) and torch.equal(valid[k], v)
        assert torch.equal(pts[k], G.reproject_image_to_3d(d, Q))
    files = []
    for k, (l, r) in enumerate(pairs):
        row = tuple(str(tmp_path / f"p{k}{s}.jpg") for s in "lr")
        for img, path in zip((l, r), row):
            Image.fromarray(img.numpy()).save(path, quality=95)
        files.append(row)
    clouds = ST.stream_reconstruct(files, Q, cfg, str(tmp_path / "out"), batch_size=2,
                                   decoder="libjpeg", device="cpu")
    for row, path in zip(files, clouds):
        l, r = (torch.from_numpy(native.load_image(p, True, "libjpeg")) for p in row)
        d, v = DP.sgbm_disparity(l, r, cfg)
        p = G.reproject_image_to_3d(d, Q)
        want = p[v & torch.isfinite(p).all(-1) & (d > 0)].numpy()
        got, _ = PLY.read_ply(path)
        assert len(want) > 0
        np.testing.assert_array_equal(got, want)
