"""Port vs JAX reference: calibration (chessboard detection, Zhang + LM,
the joint stereo LM).

Boards are rendered with numpy (supersampled, blurred, noisy; one straight,
one under a perspective warp); corner sets are projected with numpy through
a known K and distortion. The reference runs once a module (module-scoped
fixtures), torch on one thread. Tolerances: the saddle response within
1e-5 of its maximum; the NMS candidates the same ordered set; corners within
1e-3 px; homographies 1e-8; Zhang's K and the poses 1e-8 relative;
calibrate_camera's K and dist within 1e-6, its rms and mean error 1e-8
relative; calibrate_stereo's R and T within 1e-6, its rms 1e-8 relative
(on an even view count, where the median of the relative poses averages
two values).

Run as a script, the file holds the reference's calibrate_camera and
calibrate_stereo on detections the card saved
(``python -m stereo_reconstruction_cv_tpu_torch.tools.calib_4k --out F``)
to the card's own results in that file (JAX needed):

    python tests/test_torch_calib.py F.npz
"""

import json
import pathlib
import sys

if __name__ == "__main__":  # the comparison, run as a script from anywhere
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.calib import chessboard as RCB
from stereo_reconstruction_cv_tpu.calib import stereo as RST
from stereo_reconstruction_cv_tpu.calib import zhang as RZ
from stereo_reconstruction_cv_tpu.ops import geometry as RG
from stereo_reconstruction_cv_tpu_torch.calib import chessboard as CB
from stereo_reconstruction_cv_tpu_torch.calib import stereo as ST
from stereo_reconstruction_cv_tpu_torch.calib import zhang as Z
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G

K_TRUE = np.array([[2250.0, 0.0, 1920.0], [0.0, 2240.0, 1080.0], [0.0, 0.0, 1.0]])
DIST_TRUE = np.array([0.2, -0.55, -1e-5, 5e-4, 0.38])
SIZE = (3840, 2160)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WARP = np.array([[1.0, 0.06, 12.0], [-0.04, 0.98, 8.0], [1e-5, -2e-5, 1.0]])


def render_board(rng, cols=9, rows=7, square=40, margin=60, warp=True, ss=4, Hm=None):
    """(H, W) uint8 board of dark squares on a light ground, 4x4
    supersampled through the inverse of the homography Hm (WARP when warp,
    else the identity), Gaussian-blurred (sigma 1) and noisy (sigma 3); and
    its inner corners (pixel centres at integers)."""
    W = (cols + 1) * square + 2 * margin
    H = (rows + 1) * square + 2 * margin
    if Hm is None:
        Hm = WARP if warp else np.eye(3)
    o = (np.arange(ss) + 0.5) / ss - 0.5
    X, Y = np.meshgrid((np.arange(W)[:, None] + o).reshape(-1), (np.arange(H)[:, None] + o).reshape(-1))
    P = np.stack([X, Y, np.ones_like(X)], -1) @ np.linalg.inv(Hm).T
    u = (P[..., 0] / P[..., 2] + 0.5 - margin) / square
    v = (P[..., 1] / P[..., 2] + 0.5 - margin) / square
    inside = (u >= 0) & (u < cols + 1) & (v >= 0) & (v < rows + 1)
    dark = inside & ((np.floor(u) + np.floor(v)) % 2 == 0)
    ground = 160.0 if warp else 180.0  # the warp's border value
    img = np.where(dark, 30.0, np.where(inside, 180.0, ground)).reshape(H, ss, W, ss).mean((1, 3))
    k = np.exp(-0.5 * np.arange(-2, 3) ** 2.0)
    k /= k.sum()
    p = np.pad(img, ((2, 2), (0, 0)), mode="edge")
    img = sum(k[i] * p[i:i + H] for i in range(5))
    p = np.pad(img, ((0, 0), (2, 2)), mode="edge")
    img = sum(k[i] * p[:, i:i + W] for i in range(5))
    corners = np.array([[margin + (j + 1) * square - 0.5, margin + (i + 1) * square - 0.5]
                        for i in range(rows) for j in range(cols)])
    ch = np.hstack([corners, np.ones((len(corners), 1))]) @ Hm.T
    img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)
    return img, ch[:, :2] / ch[:, 2:]


@pytest.fixture(scope="module", params=[False, True], ids=["straight", "warped"])
def board(request):
    """A rendered board, and the reference's response, candidates and
    detection on it (detect_scale 2)."""
    img, truth = render_board(np.random.default_rng(0), warp=request.param)
    j = jnp.asarray(img)
    resp = np.asarray(RCB.saddle_response(j))
    cands, scores = RCB.nms_candidates(jnp.asarray(resp), 256, 4)
    found, corners = RCB.find_chessboard_corners(j, 9, 7, detect_scale=2)
    return {"img": img, "truth": truth, "resp": resp, "cands": np.asarray(cands),
            "scores": np.asarray(scores), "found": found, "corners": np.asarray(corners)}


def test_saddle_response_matches_reference(board):
    ours = CB.saddle_response(torch.from_numpy(board["img"])).numpy()
    assert ours.dtype == np.float32
    assert np.abs(ours - board["resp"]).max() <= 1e-5 * board["resp"].max()


def test_nms_candidates_match_reference(board):
    cands, scores = CB.nms_candidates(torch.from_numpy(board["resp"]), 256, 4)
    np.testing.assert_array_equal(cands.numpy(), board["cands"])
    np.testing.assert_array_equal(scores.numpy(), board["scores"])
    assert (board["scores"] > 0).sum() > 63


def test_corner_subpix_matches_reference(board):
    """From the truth moved up to 1.5 px, on the board cropped so that its
    top row of corners lies 6 px below the frame's top edge and its last
    column 5 px left of the right edge: those windows cross the border,
    where the bilinear indices clamp."""
    truth = board["truth"]
    y0 = int(np.floor(truth[:, 1].min())) - 6
    x1 = int(np.ceil(truth[:, 0].max())) + 5
    img = np.ascontiguousarray(board["img"][y0:, :x1])
    truth = truth - [0.0, y0]
    starts = truth + np.random.default_rng(1).uniform(-1.5, 1.5, truth.shape)
    ref = np.asarray(RCB.corner_subpix(jnp.asarray(img), jnp.asarray(starts, jnp.float32)))
    ours = CB.corner_subpix(torch.from_numpy(img), torch.from_numpy(starts.astype(np.float32)))
    assert ours.dtype == torch.float32
    assert np.abs(ours.numpy() - ref).max() < 1e-3
    inner = (truth[:, 1] > 12) & (truth[:, 0] < x1 - 12)
    assert np.abs(ref[inner] - truth[inner]).max() < 0.15


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
def test_find_chessboard_corners_matches_reference(board, rgb):
    img = board["img"]
    if rgb:  # distinct channels: the luma is the board + 1.761, rounded
        img = np.stack([img, np.clip(img.astype(int) + 3, 0, 255), img], -1).astype(np.uint8)
        found, ref = RCB.find_chessboard_corners(jnp.asarray(img), 9, 7, detect_scale=2)
        ref = np.asarray(ref)
    else:
        found, ref = board["found"], board["corners"]
    ok, ours = CB.find_chessboard_corners(torch.from_numpy(img), 9, 7, detect_scale=2)
    assert ok and found
    assert ours.dtype == torch.float32 and ours.shape == (63, 2)
    assert np.abs(ours.numpy() - ref).max() < 1e-3
    assert np.abs(ref - board["truth"]).max() < 0.5


def test_find_chessboard_corners_retries_and_gives_up():
    """A small board that detect_scale 4 misses is found by the retry at 2,
    with the corners a direct detection at 2 gives; a blank frame is (False,
    None), as the reference returns it."""
    img, truth = render_board(np.random.default_rng(2), square=18, margin=40, warp=False)
    t = torch.from_numpy(img)
    assert CB._detect_grid(t, 4, 9, 7, 256) is None
    ok, ours = CB.find_chessboard_corners(t, 9, 7, detect_scale=4)
    ok2, direct = CB.find_chessboard_corners(t, 9, 7, detect_scale=2)
    assert ok and ok2
    torch.testing.assert_close(ours, direct, rtol=0, atol=0)
    assert np.abs(ours.numpy() - truth).max() < 0.5
    blank = np.full((96, 128), 128, np.uint8)
    assert CB.find_chessboard_corners(torch.from_numpy(blank), 9, 7, detect_scale=2) == (False, None)
    assert RCB.find_chessboard_corners(jnp.asarray(blank), 9, 7, detect_scale=2) == (False, None)


def test_find_chessboard_corners_misses_what_the_reference_misses():
    """A board sheared by 0.7 (its lattice vectors 55 degrees apart) is
    outside the reference's lattice growth: both return (False, None)."""
    Hm = np.array([[0.8, 0.56, 10.0], [0.0, 0.8, 40.0], [0.0, 0.0, 1.0]])
    img, _ = render_board(np.random.default_rng(0), Hm=Hm)
    assert RCB.find_chessboard_corners(jnp.asarray(img), 9, 7, detect_scale=2) == (False, None)
    assert CB.find_chessboard_corners(torch.from_numpy(img), 9, 7, detect_scale=2) == (False, None)


# ---------------------------------------------------------------------------
# Zhang + LM, stereo
# ---------------------------------------------------------------------------

def _rodrigues(r):
    th = np.linalg.norm(r)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _project(obj, R, t, K, dist):
    cam = obj @ R.T + t
    x, y = cam[:, 0] / cam[:, 2], cam[:, 1] / cam[:, 2]
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


def _poses(rng, V, cols=9, rows=7):
    """V board poses (R, t) 12-25 units in front of the camera."""
    out = []
    for _ in range(V):
        t = np.array([rng.uniform(-2, 2) - cols / 2, rng.uniform(-2, 2) - rows / 2,
                      rng.uniform(12, 25)])
        out.append((_rodrigues(rng.normal(size=3) * np.array([0.3, 0.3, 0.5])), t))
    return out


def _views(rng, V, noise, R_rig=None, T_rig=None):
    """(obj (63, 3), corners (V, 63, 2)[, camera 2's corners]) of V poses."""
    obj = np.asarray(RZ.build_object_points(9, 7))
    poses = _poses(rng, V)
    img1 = np.stack([_project(obj, R, t, K_TRUE, DIST_TRUE) for R, t in poses])
    img1 += rng.normal(size=img1.shape) * noise
    if R_rig is None:
        return obj, img1
    img2 = np.stack([_project(obj, R_rig @ R, R_rig @ t + T_rig, K_TRUE, DIST_TRUE)
                     for R, t in poses])
    return obj, img1, img2 + rng.normal(size=img2.shape) * noise


def test_build_object_points_match_reference():
    ours = Z.build_object_points(9, 7, square=0.03)
    assert ours.dtype == torch.float64
    np.testing.assert_array_equal(ours.numpy(), np.asarray(RZ.build_object_points(9, 7, 0.03)))


def test_homography_dlt_matches_reference():
    rng = np.random.default_rng(3)
    obj, img = _views(rng, 4, 0.3)
    ref = np.asarray(jax.vmap(lambda v: RZ.homography_dlt(jnp.asarray(obj[:, :2]), v))(
        jnp.asarray(img)))
    ours = Z.homography_dlt(torch.from_numpy(obj[:, :2]), torch.from_numpy(img)).numpy()
    assert ours.shape == (4, 3, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-8 * np.abs(ref).max())
    one = Z.homography_dlt(torch.from_numpy(obj[:, :2]), torch.from_numpy(img[2])).numpy()
    np.testing.assert_allclose(one, ref[2], rtol=0, atol=1e-8 * np.abs(ref).max())


def test_zhang_intrinsics_and_extrinsics_match_reference():
    """Homographies K [r1 r2 t] of exact poses, one of them scaled by -1 (a
    target that would sit behind the camera), so the cheirality flip runs."""
    rng = np.random.default_rng(4)
    Hs = []
    for i, (R, t) in enumerate(_poses(rng, 6)):
        H = K_TRUE @ np.stack([R[:, 0], R[:, 1], t], 1) * rng.uniform(0.5, 2.0)
        Hs.append(-H if i == 2 else H)
    Hs = np.stack(Hs)
    K_ref = np.asarray(RZ.zhang_intrinsics(jnp.asarray(Hs), SIZE))
    K = Z.zhang_intrinsics(torch.from_numpy(Hs), SIZE)
    np.testing.assert_allclose(K.numpy(), K_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(K_ref, K_TRUE, rtol=1e-6, atol=1e-6)
    rv, tv = Z.extrinsics_from_homography(torch.from_numpy(Hs), K)
    r_ref, t_ref = (np.asarray(a) for a in jax.vmap(
        lambda H: RZ.extrinsics_from_homography(H, jnp.asarray(K_ref)))(jnp.asarray(Hs)))
    np.testing.assert_allclose(rv.numpy(), r_ref, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tv.numpy(), t_ref, rtol=1e-8, atol=1e-12)
    assert (t_ref[:, 2] > 0).all()
    one = Z.extrinsics_from_homography(torch.from_numpy(Hs[2]), K)
    np.testing.assert_allclose(one[1].numpy(), tv[2].numpy(), rtol=1e-12)


def test_rotation_helpers_batched_equal_unbatched():
    """The Rodrigues conversions over a batch equal them vector by vector
    and the reference's, near 0, pi and in general, and torch.func.jacfwd
    runs through them (the LM differentiates them batched)."""
    rng = np.random.default_rng(5)
    r = np.vstack([rng.normal(size=(6, 3)), [[1e-9, 0, 0], [0, 0, 0], [np.pi - 1e-7, 0, 0],
                                            [0, 0.5 * np.pi, 0]]])
    rt = torch.from_numpy(r)
    Rb = G.rodrigues_to_matrix(rt)
    back = G.matrix_to_rodrigues(Rb)
    for i in range(len(r)):
        np.testing.assert_allclose(Rb[i].numpy(), G.rodrigues_to_matrix(rt[i]).numpy(), atol=1e-15)
        np.testing.assert_allclose(back[i].numpy(), G.matrix_to_rodrigues(Rb[i]).numpy(), atol=1e-15)
        np.testing.assert_allclose(Rb[i].numpy(), np.asarray(RG.rodrigues_to_matrix(jnp.asarray(r[i]))),
                                   atol=1e-15)
    J = torch.func.jacfwd(lambda x: G.matrix_to_rodrigues(G.rodrigues_to_matrix(x)))(rt[:6])
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(torch.einsum("iaib->ab", J).numpy() / 6, np.eye(3), atol=1e-9)


@pytest.fixture(scope="module")
def mono():
    rng = np.random.default_rng(6)
    obj, img = _views(rng, 8, 0.3)
    ref = RZ.calibrate_camera(jnp.asarray(obj), jnp.asarray(img), SIZE)
    return obj, img, {k: np.asarray(getattr(ref, k)) for k in ref._fields}


def test_calibrate_camera_matches_reference(mono):
    obj, img, ref = mono
    res = Z.calibrate_camera(torch.from_numpy(obj), torch.from_numpy(img), SIZE)
    assert res.K.dtype == torch.float64
    np.testing.assert_allclose(res.K.numpy(), ref["K"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.dist.numpy(), ref["dist"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.rvecs.numpy(), ref["rvecs"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.tvecs.numpy(), ref["tvecs"], rtol=0, atol=1e-6)
    for k in ("rms", "mean_error", "per_view_error"):
        np.testing.assert_allclose(getattr(res, k).numpy(), ref[k], rtol=1e-8)
    assert abs(ref["K"][0, 0] / K_TRUE[0, 0] - 1) < 5e-3


def test_calibrate_camera_noiseless_recovers_the_truth():
    obj, img = _views(np.random.default_rng(7), 8, 0.0)
    res = Z.calibrate_camera(torch.from_numpy(obj), torch.from_numpy(img), SIZE)
    assert float(res.mean_error) < 0.02
    np.testing.assert_allclose(res.K.numpy(), K_TRUE, rtol=1e-3, atol=1e-3)


def test_stereo_median_averages_the_middle_pair():
    x = np.random.default_rng(8).normal(size=(6, 3))
    np.testing.assert_allclose(ST._median(torch.from_numpy(x)).numpy(),
                               np.asarray(jnp.median(jnp.asarray(x), axis=0)), rtol=1e-15)
    np.testing.assert_allclose(ST._median(torch.from_numpy(x[:5])).numpy(), np.median(x[:5], 0))


def test_calibrate_stereo_matches_reference():
    """V = 6 pairs (even: the initial R, T are two-value medians)."""
    rng = np.random.default_rng(9)
    R_rig = _rodrigues(np.array([0.01, 0.02, 0.005]))
    T_rig = np.array([-3.0, 0.1, 0.05])
    obj, img1, img2 = _views(rng, 6, 0.3, R_rig, T_rig)
    ref = RST.calibrate_stereo(jnp.asarray(obj), jnp.asarray(img1), jnp.asarray(img2), SIZE)
    res = ST.calibrate_stereo(torch.from_numpy(obj), torch.from_numpy(img1),
                              torch.from_numpy(img2), SIZE)
    for k in ("R", "T", "K1", "K2", "dist1", "dist2", "rvecs", "tvecs"):
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(res.rms), float(ref.rms), rtol=1e-8)
    np.testing.assert_allclose(res.R.numpy(), R_rig, atol=1e-3)


def compare_saved(path: str) -> dict:
    """The reference's calibrate_camera (all views) and calibrate_stereo (the
    pairs) on the corners in `path`, against the port's results saved beside
    them: the largest differences, K and dist relative to K's scale."""
    z = dict(np.load(path))
    obj, c1, c2 = z["obj"], z["corners1"], z["corners2"]
    size = tuple(int(v) for v in z["size"])
    mono = RZ.calibrate_camera(jnp.asarray(obj), jnp.asarray(np.concatenate([c1, c2])), size)
    rig = RST.calibrate_stereo(jnp.asarray(obj), jnp.asarray(c1), jnp.asarray(c2), size)
    out = {"views": int(len(c1) + len(c2)), "mean_error": [float(mono.mean_error), float(z["mean_error"])],
           "rms": [float(mono.rms), float(z["rms"])], "stereo_rms": [float(rig.rms), float(z["stereo_rms"])]}
    out["K_rel"] = float(np.abs(np.asarray(mono.K) - z["K"]).max() / np.abs(z["K"]).max())
    out["dist_abs"] = float(np.abs(np.asarray(mono.dist) - z["dist"]).max())
    out["stereo_R_abs"] = float(np.abs(np.asarray(rig.R) - z["R"]).max())
    out["stereo_T_abs"] = float(np.abs(np.asarray(rig.T) - z["T"]).max())
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(compare_saved(sys.argv[1])))
