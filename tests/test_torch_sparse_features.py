"""Port vs JAX reference: SIFT features, matching, and the sparse slice.

On a pair rendered by chip_smoke.py's ray caster (planes at 2.5-5 m, a known
rotation and baseline, 240x320): DoG keypoints compared as sets (top-k order
may differ on ties), descriptors of matched keypoints, kNN matching on the
reference's own descriptors, the resampling conventions the pyramid relies
on, and the slice: estimate_geometry and rectify_pair of both packages, each
with its own random stream, against each other and the truth. The reference
runs once for the file (a module-scoped fixture) with a reduced
PipelineConfig (1024 keypoints, 256 hypotheses) that both packages take;
its robust fits and pose recovery run under jax.jit, as its own tests run
them (tests/test_epipolar.py), for the fixture's duration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu import config as RC
from stereo_reconstruction_cv_tpu.ops import epipolar as REP
from stereo_reconstruction_cv_tpu.ops import features as RF
from stereo_reconstruction_cv_tpu.ops import matching as RM
from stereo_reconstruction_cv_tpu.ops import robust as RRB
from stereo_reconstruction_cv_tpu.ops import sift as RSIFT
from stereo_reconstruction_cv_tpu.pipeline import stages as RS
from stereo_reconstruction_cv_tpu_torch import convert
from stereo_reconstruction_cv_tpu_torch.ops import features as FT
from stereo_reconstruction_cv_tpu_torch.ops import matching as M
from stereo_reconstruction_cv_tpu_torch.ops import sift as SIFT
from stereo_reconstruction_cv_tpu_torch.pipeline import stages
from stereo_reconstruction_cv_tpu_torch.utils import synth

H, W = 240, 320
K = np.array([[200.0, 0.0, 160.0], [0.0, 200.0, 120.0], [0.0, 0.0, 1.0]])
R_TRUE = synth.rotation_about((0.2, 1.0, 0.1), 2.0)
T_TRUE = np.array([-0.3, 0.02, 0.01])
BASELINE = float(np.linalg.norm(T_TRUE))
CFG = RC.PipelineConfig(match=RC.MatchConfig(max_keypoints=1024),
                        robust=RC.RobustConfig(num_hypotheses=256))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensor ops run fastest on one thread here; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    left, right = synth.render_pair(K, R_TRUE, T_TRUE, H, W, seed=0)
    return left.numpy(), right.numpy()


@pytest.fixture(scope="module")
def ref(pair):
    """Every reference output of the file, computed once."""
    left, right = pair
    r = {"sift": RSIFT.detect_scale_space(jnp.asarray(left), 0.04, 1024)}
    r["fl"] = RF.detect_and_describe(jnp.asarray(left), 1024, 0.04)
    r["fr"] = RF.detect_and_describe(jnp.asarray(right), 1024, 0.04)
    d1, d2 = r["fl"].descriptors, r["fr"].descriptors
    m1, m2 = r["fl"].mask, r["fr"].mask
    r["ratio"] = RM.knn2_match(d1, d2, m1, m2, ratio=0.75)
    r["mutual"] = RM.knn2_match(d1, d2, m1, m2, ratio=0.7, mutual=True)
    r["learned"] = RM.match_learned(d1, d2, m1, m2, min_cossim=0.8)
    # rectify_pair estimates the geometry with estimate_geometry((imL,
    # imR), baseline, K, seed, cfg) and returns that dict as "geometry".
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RRB, "find_fundamental", jax.jit(
            RRB.find_fundamental, static_argnames=("method", "num_hypotheses", "threshold")))
        mp.setattr(RRB, "find_essential", jax.jit(
            RRB.find_essential, static_argnames=("threshold_px", "num_hypotheses", "solver")))
        mp.setattr(REP, "recover_pose", jax.jit(REP.recover_pose))
        r["rect"] = RS.rectify_pair((left, right), BASELINE, K, with_visualizations=False,
                                    pipeline_cfg=CFG)
    return {k: jax.tree_util.tree_map(np.asarray, v) if k != "rect" else v for k, v in r.items()}


def _nearest(a, b):
    """For each row of a (n, 2): (index of the nearest row of b, distance)."""
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    return d.argmin(1), d.min(1)


def test_detect_scale_space_matches_reference_as_sets(pair, ref):
    got = SIFT.detect_scale_space(torch.from_numpy(pair[0]), 0.04, 1024)
    want = ref["sift"]
    assert abs(int(got.num_detected) - int(want.num_detected)) <= 0.01 * int(want.num_detected)
    rv, pv = want.scores > 0, got.scores.numpy() > 0
    j, dist = _nearest(want.keypoints[rv], got.keypoints.numpy()[pv])
    sig = got.sigmas.numpy()[pv][j] / want.sigmas[rv] - 1
    score = got.scores.numpy()[pv][j] / want.scores[rv] - 1
    # Positions within 0.01 px and scores within 1e-4 relative. The scale
    # comes from the Newton step along the DoG's scale axis, which amplifies
    # the last-bit differences of the two frameworks' float32 blurs: 1e-4.
    same = (dist < 0.01) & (np.abs(score) <= 1e-4) & (np.abs(sig) <= 1e-4)
    assert same.mean() >= 0.98, (same.mean(), rv.sum())
    assert rv.sum() > 500


def test_descriptors_match_reference(pair, ref):
    got = FT.detect_and_describe(torch.from_numpy(pair[0]), 1024, 0.04)
    want = ref["fl"]
    rv, pv = want.mask, got.mask.numpy()
    j, dist = _nearest(want.keypoints[rv], got.keypoints.numpy()[pv])
    near = dist < 0.01
    l2 = np.linalg.norm(got.descriptors.numpy()[pv][j] - want.descriptors[rv], axis=-1)
    assert near.mean() >= 0.98 and (l2[near] <= 1e-3).mean() >= 0.98


def test_knn2_match_on_reference_descriptors(ref):
    fl, fr = ref["fl"], ref["fr"]
    args = [torch.from_numpy(np.array(a)) for a in (fl.descriptors, fr.descriptors, fl.mask, fr.mask)]
    for name, match in (("ratio", lambda *a: M.knn2_match(*a, ratio=0.75)),
                        ("mutual", lambda *a: M.knn2_match(*a, ratio=0.7, mutual=True)),
                        ("learned", lambda *a: M.match_learned(*a, min_cossim=0.8))):
        got, want = match(*args), ref[name]
        np.testing.assert_array_equal(got.mask.numpy(), want.mask)
        np.testing.assert_array_equal(got.indices.numpy()[want.mask], want.indices[want.mask])
        np.testing.assert_allclose(got.distance.numpy()[want.mask], want.distance[want.mask],
                                   rtol=1e-4, atol=1e-5)
    assert ref["mutual"].mask.sum() > 200


def test_pyramid_conventions_match_reference():
    """2x bilinear upsampling, the gradient and both blurs (edges replicated),
    at the image border included."""
    img = np.random.default_rng(4).random((13, 17)).astype(np.float32)
    t = torch.from_numpy(img)
    np.testing.assert_allclose(SIFT._upsample2(t).numpy(),
                               np.asarray(jax.image.resize(jnp.asarray(img), (26, 34), "linear")),
                               atol=2e-7)
    for got, want in zip(torch.gradient(t), jnp.gradient(jnp.asarray(img))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    for sigma in (0.7, 3.1):
        np.testing.assert_allclose(SIFT._blur(t, sigma).numpy(),
                                   np.asarray(RSIFT._blur(jnp.asarray(img), sigma)), atol=3e-7)
        np.testing.assert_allclose(FT._blur(t, sigma).numpy(),
                                   np.asarray(RF._blur(jnp.asarray(img), sigma)), atol=3e-7)


def test_harris_keypoints_are_local_maxima(pair):
    img = torch.from_numpy(pair[0][:96, :128])
    f = FT.detect_and_describe(img, 96, detector="harris")
    assert int(f.mask.sum()) > 20
    resp = FT._harris(FT._blur(img.float() / 255.0, 1.6), sigma_i=3.2)
    pad = torch.nn.functional.pad(resp, (4, 4, 4, 4), value=-torch.inf)
    for x, y in f.keypoints[:32].long().tolist():
        assert resp[y, x] >= pad[y:y + 9, x:x + 9].max()
    np.testing.assert_allclose(torch.linalg.norm(f.descriptors[f.mask], dim=-1).numpy(), 1, atol=1e-5)


def test_squared_distance_matrix_equals_a_float64_product():
    rng = np.random.default_rng(5)
    a = rng.random((300, 128)).astype(np.float32)
    b = rng.random((200, 128)).astype(np.float32)
    got = M.squared_distance_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _angle_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


def _dir_deg(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return np.degrees(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1)))


def test_slice_geometry_and_rectification_match_reference(pair, ref):
    cfg = convert.pipeline_config(CFG)
    geo = stages.estimate_geometry(pair, BASELINE, K, 0, cfg, device="cpu")
    rect = stages.rectify_pair(pair, BASELINE, K, with_visualizations=False,
                               pipeline_cfg=cfg, device="cpu")
    rrect = ref["rect"]
    rgeo = rrect["geometry"]
    for g in (geo, rect["geometry"]):
        R, t = g["Rotation Matrix"], g["Translation Vector"]
        assert _angle_deg(R, rgeo["Rotation Matrix"]) < 0.1 and _angle_deg(R, R_TRUE) < 0.1
        assert _dir_deg(t, rgeo["Translation Vector"]) < 2 and _dir_deg(t, T_TRUE) < 2
        assert abs(g["num_matches"] - rgeo["num_matches"]) <= 0.02 * rgeo["num_matches"]
        assert abs(g["num_inliers_E"] - rgeo["num_inliers_E"]) <= 0.05 * rgeo["num_inliers_E"]
    assert _dir_deg(rgeo["Translation Vector"], T_TRUE) < 2
    np.testing.assert_allclose(rect["Q"], rrect["Q"], rtol=1e-2, atol=1e-9)
    assert rect["epiline_mean_abs_slope"] < 0.02 and rrect["epiline_mean_abs_slope"] < 0.02
    for name in ("left_rectified", "right_rectified"):
        img = rect[name]
        assert img.dtype == torch.uint8 and tuple(img.shape) == (H, W)
