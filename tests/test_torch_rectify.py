"""Port vs JAX reference: rectification, remap, geometry, reprojection.

Tolerances: stereo_rectify R/P/Q in float64 to atol 1e-9; rectify_remap u8
within 1 LSB (the reference samples an identity-rotation rig as two banded
matmuls, the port always as a four-tap gather, so f32 sums differ in order);
3D points to rtol 1e-5 (the port sums the Q product in another order than
``v @ Q.T``); masks exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.ops import geometry as RG
from stereo_reconstruction_cv_tpu.ops import rectify as RR
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from remap_edge import edge_map

K_4K = np.array([[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]])
DIST = np.array([0.2090, -0.5576, -7.2e-6, 5.2e-4, 0.3812])

RIGS = {
    # The reference's 4K benchmark rig: identity rotation, 140 mm baseline.
    "identity": (K_4K, None, K_4K, None, np.eye(3), np.array([-0.14, 0.0, 0.0])),
    # Small rotation, vertical/forward baseline components, distortion.
    "rotated": (K_4K, DIST, K_4K * 1.01, DIST * 0.5,
                np.asarray(RG.rodrigues_to_matrix(jnp.asarray([0.01, 0.04, -0.02]))),
                np.array([-0.8, 0.05, 0.1])),
}


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float64))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _both(rig, size, alpha, new_size=None):
    K1, d1, K2, d2, R, T = RIGS[rig]
    ref = RR.stereo_rectify(_j(K1), _j(d1), _j(K2), _j(d2), size, _j(R), _j(T),
                            alpha=alpha, new_image_size=new_size)
    got = RC.stereo_rectify(_t(K1), _t(d1), _t(K2), _t(d2), size, _t(R), _t(T),
                            alpha=alpha, new_image_size=new_size)
    return ref, got


@pytest.mark.parametrize("rig,alpha,new_size", [
    ("identity", -1.0, None), ("identity", 0.0, None), ("identity", 1.0, None),
    ("rotated", 0.5, None), ("rotated", -1.0, (320, 200)), ("rotated", 1.0, (320, 200)),
])
def test_stereo_rectify_matches_reference(rig, alpha, new_size):
    ref, got = _both(rig, (640, 360), alpha, new_size)
    for name in ("R1", "R2", "P1", "P2", "Q"):
        g = getattr(got, name)
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-9, err_msg=name)


@pytest.mark.parametrize("rig", ["identity", "rotated"])
def test_rectify_remap_within_one_lsb(rig):
    H, W = 48, 64
    img = np.random.default_rng(0).integers(0, 256, (H, W), dtype=np.uint8)
    ref_r, _ = _both(rig, (W, H), 0.0)
    K1, d1 = RIGS[rig][0], RIGS[rig][1]
    R1, P1 = np.asarray(ref_r.R1), np.asarray(ref_r.P1)
    ref = np.asarray(RR.rectify_remap(jnp.asarray(img), _j(K1), _j(d1), _j(R1), _j(P1)))
    got = RC.rectify_remap(torch.from_numpy(img), _t(K1), _t(d1), _t(R1), _t(P1))
    assert got.dtype == torch.uint8 and got.shape == (H, W)
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.9


def test_remap_map_matches_reference():
    """The f32 inverse map itself, with rotation and distortion."""
    _, d1, _, _, R, _ = RIGS["rotated"]
    P = np.array([[60.0, 0, 31.5, 0], [0, 60.0, 23.5, 0], [0, 0, 1, 0]])
    K = K_4K * 64 / 3840
    K[2, 2] = 1.0
    ref = np.asarray(RR.rectify_map(_j(K), _j(d1), _j(R), _j(P), (64, 48)))
    got = RC.rectify_map(_t(K), _t(d1), _t(R), _t(P), (64, 48))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_rotations_and_distortion_match_reference():
    rng = np.random.default_rng(1)
    for rvec in (np.array([0.3, -0.2, 0.1]), np.array([0.0, 0.0, 0.0]), np.array([3.0, 0.1, 0.0])):
        R = RG.rodrigues_to_matrix(jnp.asarray(rvec))
        np.testing.assert_allclose(G.rodrigues_to_matrix(_t(rvec)).numpy(), np.asarray(R), atol=1e-12)
        np.testing.assert_allclose(G.matrix_to_rodrigues(_t(R)).numpy(),
                                   np.asarray(RG.matrix_to_rodrigues(R)), atol=1e-12)
    xy = rng.uniform(-0.4, 0.4, (20, 2))
    ref = RG.undistort_normalized(jnp.asarray(xy), jnp.asarray(DIST), num_iters=20)
    got = G.undistort_normalized(_t(xy), _t(DIST), num_iters=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)


def test_reproject_and_mask_match_reference():
    _, got_r = _both("identity", (96, 64), 0.0)
    Q = got_r.Q.numpy()
    rng = np.random.default_rng(2)
    disp = rng.uniform(0, 30, (64, 96)).astype(np.float32)
    disp[rng.random(disp.shape) < 0.2] = 0.0  # W = 0 rows of the reprojection
    ref = np.asarray(RG.reproject_image_to_3d(jnp.asarray(disp), jnp.asarray(Q, jnp.float32)))
    got = G.reproject_image_to_3d(torch.from_numpy(disp), torch.from_numpy(Q).float())
    assert got.dtype == torch.float32 and got.shape == (64, 96, 3)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    np.testing.assert_allclose(got.numpy()[finite], ref[finite], rtol=1e-5)
    mask_ref = np.asarray(RG.valid_point_mask(jnp.asarray(ref), jnp.asarray(disp)))
    np.testing.assert_array_equal(G.valid_point_mask(got, torch.from_numpy(disp)).numpy(), mask_ref)


def _remap_numpy(img, m):
    """The remap's formula in float32 numpy, one rounding an operation:
    bounds tested in float, so no coordinate is cast out of range."""
    H, W = img.shape[:2]
    x0, y0 = np.floor(m[..., 0]), np.floor(m[..., 1])
    fx, fy = m[..., 0] - x0, m[..., 1] - y0
    one = np.float32(1)
    acc = None
    for dx, dy, w in ((0, 0, (one - fx) * (one - fy)), (1, 0, fx * (one - fy)),
                      (0, 1, (one - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0.astype(np.float64) + dx, y0.astype(np.float64) + dy
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[np.clip(yi, 0, H - 1).astype(np.int64), np.clip(xi, 0, W - 1).astype(np.int64)]
        if img.ndim == 3:
            inb, w = inb[..., None], w[..., None]
        term = np.where(inb, v.astype(np.float32), np.float32(0)) * w
        acc = term if acc is None else acc + term
    return np.rint(acc).astype(img.dtype) if img.dtype == np.uint8 else acc


@pytest.mark.parametrize("dtype,channels,Wo", [
    (np.uint8, 1, 45), (np.uint8, 3, 44), (np.float32, 1, 44), (np.float32, 3, 45),
])
def test_plain_remap_equals_numpy_on_edge_maps_and_launches_nothing(monkeypatch, dtype,
                                                                     channels, Wo):
    """remap_bilinear on a CPU image is the plain version, bit for bit the
    float32 formula, and never loads the kernel library."""
    from stereo_reconstruction_cv_tpu_torch import _build
    from stereo_reconstruction_cv_tpu_torch.ops.cuda import remap as RK

    def no_library():
        raise AssertionError("a CPU remap loaded the kernel library")

    monkeypatch.setattr(_build, "kernels_library", no_library)
    H, W = 23, 31
    rng = np.random.default_rng(channels + Wo)
    shape = (H, W) if channels == 1 else (H, W, channels)
    img = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == np.uint8
           else rng.uniform(-50, 300, shape).astype(np.float32))
    m = edge_map(H, W, 37, Wo, Wo)
    before = dict(RK.launches)
    got = RC.remap_bilinear(torch.from_numpy(img), torch.from_numpy(m)).numpy()
    assert RK.launches == before == {"remap": before["remap"]}
    want = _remap_numpy(img, m)
    assert got.dtype == img.dtype and got.shape == (37, Wo, *shape[2:])
    if dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)
