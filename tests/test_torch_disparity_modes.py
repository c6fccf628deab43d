"""Port vs JAX reference: row-tiled SGBM, the memory rule that picks it, and
the coarse-to-fine fast path.

Both run here on the CPU (the port's plain versions of the kernels, the
reference's XLA path), torch on one thread. The tiled maps are bit-exact,
as the single-device maps are; the fast path's coarse level is bit-exact and
its refined f32 disparity is held to 1e-6 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.config import SGBMConfig as RefConfig
from stereo_reconstruction_cv_tpu.ops import disparity as RD
from stereo_reconstruction_cv_tpu_torch import convert
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP

FAST_ATOL = 1e-6  # px: the refined disparity's f32 parabola, same operations


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def textured_pair(seed, H, W, shift):
    """uint8 pair with left[y, x] ~ right[y, x - shift]: 3x3-smoothed noise,
    with noise of its own on each view so that subpixel values vary."""
    rng = np.random.default_rng(seed)
    n = rng.uniform(0, 255, size=(H + 2, W + shift + 2)).astype(np.float32)
    base = sum(n[i:i + H, j:j + W + shift] for i in range(3) for j in range(3)) / 9.0
    base = (base - base.mean()) * 3.0 + 128.0

    def view(a):
        return np.clip(a + rng.normal(0, 4, a.shape), 0, 255).astype(np.uint8)

    return view(base[:, :W]), view(base[:, shift:])


def both(left, right):
    return (torch.from_numpy(left), torch.from_numpy(right)), (jnp.asarray(left), jnp.asarray(right))


@pytest.mark.parametrize("ndirs,speckle", [(8, 50), (5, 0)])
def test_tiled_matches_the_reference(ndirs, speckle):
    """Three tiles of 32 rows with 16-row halos, clamped at the edges; the
    speckle filter over the stitched map."""
    left, right = textured_pair(1, 96, 128, 9)
    ref_cfg = RefConfig(num_disparities=16, num_directions=ndirs, speckle_window_size=speckle,
                        backend="xla")
    (lt, rt), (lj, rj) = both(left, right)
    dr, vr = RD.sgbm_disparity_tiled(lj, rj, ref_cfg, tile_rows=32, halo=16)
    d, v = DP.sgbm_disparity_tiled(lt, rt, convert.sgbm_config(ref_cfg), tile_rows=32, halo=16)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dr))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    # The tiles run apart: with no halo their seams restart every path.
    d0, _ = DP.sgbm_disparity_tiled(lt, rt, convert.sgbm_config(ref_cfg), tile_rows=32, halo=0)
    dr0, _ = RD.sgbm_disparity_tiled(lj, rj, ref_cfg, tile_rows=32, halo=0)
    np.testing.assert_array_equal(d0.numpy(), np.asarray(dr0))
    assert not torch.equal(d0, d)


def test_auto_tiles_only_a_frame_that_does_not_fit(monkeypatch):
    left, right = textured_pair(2, 80, 112, 7)
    cfg = convert.sgbm_config(RefConfig(num_disparities=16, speckle_window_size=30))
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    assert DP.fits_whole_frame(80, 112, cfg, "cpu")
    whole = DP.sgbm_disparity(lt, rt, cfg)
    got = DP.sgbm_disparity_auto(lt, rt, cfg, tile_rows=32)
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    calls = []
    tiled = DP.sgbm_disparity_tiled
    monkeypatch.setattr(DP, "fits_whole_frame", lambda *a: False)
    monkeypatch.setattr(DP, "sgbm_disparity_tiled",
                        lambda *a, **k: calls.append(k) or tiled(*a, **k))
    got = DP.sgbm_disparity_auto(lt, rt, cfg, tile_rows=32)
    assert calls == [{"tile_rows": 32}]
    assert all(torch.equal(a, b) for a, b in zip(got, tiled(lt, rt, cfg, tile_rows=32)))


def test_frame_bytes_counts_the_volumes():
    cfg = convert.sgbm_config(RefConfig(num_disparities=128, num_directions=8))
    cells = 720 * (1280 - 128) * 128
    assert DP.frame_bytes(720, 1280, cfg) == cells * 2 * 3 + 64 * 720 * 1280
    assert DP.frame_bytes(720, 1280, cfg.with_(num_directions=5)) == cells * 2 * 2 + 64 * 720 * 1280


def test_fast_pieces_match_the_reference():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(37, 51), dtype=np.uint8)
    np.testing.assert_array_equal(DP.box2(torch.from_numpy(img)).numpy(),
                                  np.asarray(RD._box2(jnp.asarray(img))))
    plane = rng.integers(0, 200, size=(9, 20)).astype(np.int32)
    for s in (-3, -1, 0, 2, 5):
        np.testing.assert_array_equal(DP.shift_plane(torch.from_numpy(plane), s).numpy(),
                                      np.asarray(RD._shift_plane(jnp.asarray(plane), s)))
    d0 = rng.integers(2, 2 + 12, size=(9, 20)).astype(np.int32)
    got = DP.warp_by_disp([torch.from_numpy(plane)], torch.from_numpy(d0))[0]
    ref = RD._warp_by_disp([jnp.asarray(plane)], jnp.asarray(d0), 14)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("H,W,min_disp,speckle", [(64, 128, 0, 0), (67, 131, 4, 40)])
def test_fast_matches_the_reference(H, W, min_disp, speckle):
    """Even and odd sizes (the odd last row and column repeat), min_disp > 0
    (halved at the coarse level), with and without the speckle filter."""
    left, right = textured_pair(4 + H, H, W, 7)
    ref_cfg = RefConfig(num_disparities=16, min_disparity=min_disp, num_directions=5,
                        speckle_window_size=speckle, backend="xla")
    cfg = convert.sgbm_config(ref_cfg)
    (lt, rt), (lj, rj) = both(left, right)
    # The coarse level, bit-exact: d0 is its rounded double, so d0 is exact.
    cfg_h = ref_cfg.with_(num_disparities=16, min_disparity=min_disp // 2, speckle_window_size=0)
    ch = RD.sgbm_disparity(RD._box2(lj), RD._box2(rj), cfg_h)
    ph = DP.sgbm_disparity(DP.box2(lt), DP.box2(rt), convert.sgbm_config(cfg_h))
    for a, b in zip(ph, ch):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dr, vr = RD.sgbm_disparity_fast(lj, rj, ref_cfg)
    d, v = DP.sgbm_disparity_fast(lt, rt, cfg)
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    np.testing.assert_allclose(d.numpy(), np.asarray(dr), rtol=0, atol=FAST_ATOL)
    assert float(d.min()) >= min_disp and float(d.max()) <= min_disp + 15


def test_fast_refuses_a_coarse_level_with_no_disparity_column():
    """Width 32 at 16 disparities passes the full frame's width check, but
    the 16-pixel coarse level with 16 disparities has no column right of its
    margin: the port raises there rather than diverge."""
    left, right = textured_pair(5, 32, 32, 4)
    cfg = convert.sgbm_config(RefConfig(num_disparities=16, speckle_window_size=0))
    with pytest.raises(ValueError, match="half-resolution level"):
        DP.sgbm_disparity_fast(torch.from_numpy(left), torch.from_numpy(right), cfg)
