"""Port vs JAX reference: the sparse path's geometry (float64).

The camera helpers, DLT triangulation, the 8-point F and E solvers, the
decomposition and pose recovery, the batched 5-point solver and the robust
fits of F (LMedS) and E (5-point RANSAC) given the reference's own sample
indices. Inputs are synthetic two-view scenes drawn with
numpy.random.default_rng; the reference runs once for the file (a
module-scoped fixture), eagerly or under jax.jit as its own tests run it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_cv_tpu.ops import epipolar as REP
from stereo_reconstruction_cv_tpu.ops import fivepoint as RFP
from stereo_reconstruction_cv_tpu.ops import geometry as RG
from stereo_reconstruction_cv_tpu.ops import robust as RRB
from stereo_reconstruction_cv_tpu_torch.ops import epipolar as EP
from stereo_reconstruction_cv_tpu_torch.ops import fivepoint as FP
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops import robust as RB

K = np.array([[820.0, 0.0, 330.0], [0.0, 810.0, 245.0], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensor ops run fastest on one thread here; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotation(rng, max_deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    th = np.deg2rad(rng.uniform(-max_deg, max_deg))
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _scene(rng, n, noise_px=0.0, outliers=0.0, max_deg=8.0):
    """n points in front of two cameras x2 = R x1 + t: (pixels 1, pixels 2,
    X (n, 3), R, t); a share `outliers` of the right pixels is replaced by
    uniform ones."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    R = _rotation(rng, max_deg)
    t = np.array([-1.0, 0.1, 0.05]) + rng.normal(scale=0.1, size=3)

    def proj(P):
        x = P @ K.T
        return x[:, :2] / x[:, 2:]

    p1 = proj(X) + rng.normal(scale=noise_px, size=(n, 2))
    p2 = proj(X @ R.T + t) + rng.normal(scale=noise_px, size=(n, 2))
    bad = rng.random(n) < outliers
    p2[bad] = rng.uniform([0, 0], [660, 490], (int(bad.sum()), 2))
    return p1, p2, X, R, t


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _unit(M):
    """Unit Frobenius norm, largest-magnitude entry positive."""
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20)
    d = {}
    d["proj"] = (rng.normal(size=(30, 3)) + [0, 0, 6], rng.normal(scale=0.2, size=3),
                 rng.normal(size=3), np.array([0.05, -0.02, 0.001, 0.002, 0.01]))
    p1, p2, X, R, t = _scene(rng, 60, noise_px=0.5)
    d["noisy"] = (p1, p2, R, t)
    d["exact"] = _scene(rng, 40)
    d["weights"] = (rng.random(60) > 0.2).astype(np.float64) * rng.uniform(0.5, 1.5, 60)
    d["minimal"] = [_scene(rng, 5) for _ in range(20)]
    n1 = np.asarray(REP.pixel_to_normalized(jnp.asarray(p1), jnp.asarray(K)))
    n2 = np.asarray(REP.pixel_to_normalized(jnp.asarray(p2), jnp.asarray(K)))
    d["noisy_n"] = (n1, n2)
    # Robust fits: 200 correspondences, 30% outliers, 20 padded slots invalid.
    p1, p2, _, R, t = _scene(rng, 220, noise_px=0.3, outliers=0.3)
    mask = np.ones(220, bool)
    mask[200:] = False
    d["robust"] = (p1, p2, mask, R, t)
    return d


@pytest.fixture(scope="module")
def ref(data):
    """Every reference output of the file, computed once."""
    r = {}
    obj, rvec, tvec, dist = data["proj"]
    r["project"] = np.asarray(RG.project_points(*(jnp.asarray(a) for a in (obj, rvec, tvec, K, dist))))
    p1, p2, R, t = data["noisy"]
    F = REP.fundamental_from_essential(REP.essential_from_Rt(jnp.asarray(R), jnp.asarray(t)),
                                       jnp.asarray(K), jnp.asarray(K))
    r["F_true"] = np.asarray(F)
    j1, j2 = jnp.asarray(p1), jnp.asarray(p2)
    r["epilines"] = [np.asarray(RG.compute_epilines(j1, F, 1)), np.asarray(RG.compute_epilines(j2, F, 2))]
    r["epi_dist"] = np.asarray(RG.epipolar_distance(F, j1, j2))
    r["sampson"] = np.asarray(RG.sampson_error(F, j1, j2))
    P1 = np.hstack([K, np.zeros((3, 1))])
    P2 = K @ np.hstack([R, t[:, None]])
    r["P"] = (P1, P2)
    r["tri"] = np.asarray(RG.triangulate_to_3d(jnp.asarray(P1), jnp.asarray(P2), j1, j2))
    w = jnp.asarray(data["weights"])
    r["eight_point"] = np.asarray(REP.eight_point(j1, j2, weights=w))
    n1, n2 = (jnp.asarray(a) for a in data["noisy_n"])
    r["essential_8pt"] = np.asarray(REP.essential_8pt(n1, n2, weights=w))
    E = REP.essential_from_Rt(jnp.asarray(R), jnp.asarray(t))
    r["E_true"] = np.asarray(E)
    r["E_from_F"] = np.asarray(REP.essential_from_fundamental(F, jnp.asarray(K), jnp.asarray(K)))
    r["decompose"] = [np.asarray(a) for a in REP.decompose_essential(E)]
    Rr, tr, mr, vr = REP.recover_pose(E, n1, n2)
    r["pose"] = (np.asarray(Rr), np.asarray(tr), np.asarray(mr), float(vr))
    mn1 = np.stack([np.asarray(REP.pixel_to_normalized(jnp.asarray(s[0]), jnp.asarray(K))) for s in data["minimal"]])
    mn2 = np.stack([np.asarray(REP.pixel_to_normalized(jnp.asarray(s[1]), jnp.asarray(K))) for s in data["minimal"]])
    r["minimal_n"] = (mn1, mn2)
    Es, valid = jax.jit(jax.vmap(RFP.essential_5pt))(jnp.asarray(mn1), jnp.asarray(mn2))
    r["5pt"] = (np.asarray(Es), np.asarray(valid))
    # Robust fits with the reference's own draws: the same key gives
    # find_fundamental / find_essential the indices passed to the port.
    p1, p2, mask, _, _ = data["robust"]
    j1, j2, jm = jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask)
    kf, ke = jax.random.split(jax.random.PRNGKey(3))
    r["idx_F"] = np.asarray(RRB._sample_indices(kf, 220, jm, 256, 8))
    f = jax.jit(functools.partial(RRB.find_fundamental, method="lmeds", num_hypotheses=256))(kf, j1, j2, jm)
    r["lmeds_F"] = (np.asarray(f.model), np.asarray(f.inlier_mask), float(f.score))
    r["idx_E"] = np.asarray(RRB._sample_indices(ke, 220, f.inlier_mask, 64, 5))
    e = jax.jit(functools.partial(RRB.find_essential, num_hypotheses=512))(ke, j1, j2, jnp.asarray(K), f.inlier_mask)
    r["ransac_E"] = (np.asarray(e.model), np.asarray(e.inlier_mask))
    return r


def test_geometry_helpers_match_reference(data, ref):
    obj, rvec, tvec, dist = data["proj"]
    got = G.project_points(*(_t(a) for a in (obj, rvec, tvec, K, dist)))
    np.testing.assert_allclose(got.numpy(), ref["project"], rtol=1e-12)
    p1, p2, _, _ = data["noisy"]
    F = _t(ref["F_true"])
    for which, want in zip((1, 2), ref["epilines"]):
        got = G.compute_epilines(_t(p1 if which == 1 else p2), F, which)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(G.epipolar_distance(F, _t(p1), _t(p2)).numpy(), ref["epi_dist"], rtol=1e-12)
    np.testing.assert_allclose(G.sampson_error(F, _t(p1), _t(p2)).numpy(), ref["sampson"], rtol=1e-12)
    # Batched matrices give each matrix's row.
    batch = G.sampson_error(torch.stack([F, 2 * F]), _t(p1), _t(p2))
    np.testing.assert_allclose(batch[1].numpy(), ref["sampson"], rtol=1e-12)
    h = torch.tensor([[2.0, 4.0, 2.0], [1.0, 1.0, 0.0]], dtype=torch.float64)
    np.testing.assert_array_equal(G.from_homogeneous(h, eps=1e-30).numpy(),
                                  np.asarray(RG.from_homogeneous(jnp.asarray(h.numpy()), eps=1e-30)))


def test_triangulation_matches_reference_and_truth(data, ref):
    p1, p2, _, _ = data["noisy"]
    P1, P2 = (_t(P) for P in ref["P"])
    got = G.triangulate_to_3d(P1, P2, _t(p1), _t(p2)).numpy()
    np.testing.assert_allclose(got, ref["tri"], rtol=1e-6)
    e1, e2, X, R, t = data["exact"]
    P2e = _t(K @ np.hstack([R, t[:, None]]))
    exact = G.triangulate_to_3d(P1, P2e, _t(e1), _t(e2)).numpy()
    np.testing.assert_allclose(exact, X, rtol=1e-9)


def test_eight_point_solvers_match_reference(data, ref):
    p1, p2, _, _ = data["noisy"]
    w = _t(data["weights"])
    F = EP.eight_point(_t(p1), _t(p2), weights=w).numpy()
    np.testing.assert_allclose(_unit(F), _unit(ref["eight_point"]), atol=1e-8)
    assert abs(F[2, 2] - 1) < 1e-12 and abs(np.linalg.det(F)) < 1e-12 * np.abs(F).max() ** 3
    n1, n2 = (_t(a) for a in data["noisy_n"])
    E = EP.essential_8pt(n1, n2, weights=w).numpy()
    np.testing.assert_allclose(_unit(E), _unit(ref["essential_8pt"]), atol=1e-8)
    # A batch of problems solves each on its own.
    both = EP.eight_point(torch.stack([_t(p1), _t(p2)]), torch.stack([_t(p2), _t(p1)]),
                          weights=torch.stack([w, w]))
    np.testing.assert_allclose(both[0].numpy(), F, rtol=1e-9, atol=1e-12)


def test_essential_and_fundamental_conversions_match_reference(data, ref):
    _, _, R, t = data["noisy"]
    E = EP.essential_from_Rt(_t(R), _t(t))
    np.testing.assert_allclose(E.numpy(), ref["E_true"], rtol=1e-12, atol=1e-15)
    F = EP.fundamental_from_essential(E, _t(K), _t(K))
    np.testing.assert_allclose(F.numpy(), ref["F_true"], rtol=1e-9, atol=1e-12 * np.abs(ref["F_true"]).max())
    np.testing.assert_allclose(_unit(EP.essential_from_fundamental(_t(ref["F_true"]), _t(K), _t(K)).numpy()),
                               _unit(ref["E_from_F"]), atol=1e-10)


def test_decompose_and_recover_pose_match_reference(data, ref):
    E = _t(ref["E_true"])
    R1, R2, t = (a.numpy() for a in EP.decompose_essential(E))
    rR1, rR2, rt = ref["decompose"]
    # The pair of rotations and t up to sign are the decomposition's invariants.
    same = np.abs(R1 - rR1).max() < 1e-9
    np.testing.assert_allclose(R1 if same else R2, rR1, atol=1e-9)
    np.testing.assert_allclose(R2 if same else R1, rR2, atol=1e-9)
    np.testing.assert_allclose(t * np.sign(t @ rt), rt, atol=1e-9)
    n1, n2 = (_t(a) for a in data["noisy_n"])
    R, tt, mask, votes = EP.recover_pose(E, n1, n2)
    Rr, tr, mr, vr = ref["pose"]
    np.testing.assert_allclose(R.numpy(), Rr, atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), tr, atol=1e-9)
    assert int(mask.sum()) == int(mr.sum()) and float(votes) == vr
    np.testing.assert_allclose(R.numpy(), data["noisy"][2], atol=1e-9)  # E is exact


def test_five_point_roots_match_reference(ref):
    """The same roots: as many per problem, each candidate of one solver
    within 1e-8 of one of the other's up to sign. Where the reference's
    inverse iterations (null space, back-substitution) stop short, its
    candidate may sit up to 1e-6 away; then the port's exact null vectors
    must satisfy the five epipolar constraints 100x better."""
    (mn1, mn2), (rE, rvalid) = ref["minimal_n"], ref["5pt"]
    E, valid = FP.essential_5pt(_t(mn1), _t(mn2))
    E, valid = E.numpy(), valid.numpy()
    np.testing.assert_array_equal(valid.sum(1), rvalid.sum(1))
    assert valid.sum() >= 20

    def epipolar(Em, i):
        x1, x2 = np.c_[mn1[i], np.ones(5)], np.c_[mn2[i], np.ones(5)]
        return np.abs(np.einsum("ni,...ij,nj->...n", x2, Em, x1)).max(-1)

    far = 0
    for i in range(len(valid)):
        a, b = E[i][valid[i]], rE[i][rvalid[i]]
        assert (epipolar(a, i) < 1e-10).all()
        fa, fb = a.reshape(-1, 9), b.reshape(-1, 9)
        d = np.minimum(np.abs(fa[:, None] - fb[None]).max(-1), np.abs(fa[:, None] + fb[None]).max(-1))
        assert d.min(1).max() < 1e-6 and d.min(0).max() < 1e-6, d
        for jb in np.nonzero(d.min(0) >= 1e-8)[0]:
            ja = d[:, jb].argmin()
            assert epipolar(a[ja], i) * 100 < epipolar(b[jb], i)
            far += 1
    assert far <= 0.1 * valid.sum()


def _masks_agree(got, want, residual, thr2):
    """Equal inlier masks, except points within 1e-9 relative of the threshold."""
    diff = got != want
    assert (np.abs(residual[diff] - thr2) <= 1e-9 * thr2).all(), np.nonzero(diff)


def test_robust_fits_with_the_reference_samples_match(data, ref, monkeypatch):
    p1, p2, mask, R, t = data["robust"]
    draws = iter([ref["idx_F"], ref["idx_E"]])
    monkeypatch.setattr(RB, "sample_indices", lambda *a: _t(next(draws)))
    gen = torch.Generator()
    f = RB.find_fundamental(gen, _t(p1), _t(p2), _t(mask), method="lmeds", num_hypotheses=256)
    rF, rmask, rscore = ref["lmeds_F"]
    np.testing.assert_allclose(_unit(f.model.numpy()), _unit(rF), atol=1e-8)
    assert abs(float(f.score) - rscore) <= 1e-9 * abs(rscore)
    thr2 = float(RB._lmeds_sigma2(-f.score, _t(mask).sum(), 8))
    res = G.sampson_error(f.model, _t(p1), _t(p2)).numpy()
    _masks_agree(f.inlier_mask.numpy(), rmask, res, thr2)
    e = RB.find_essential(gen, _t(p1), _t(p2), _t(K), mask=f.inlier_mask, num_hypotheses=512)
    rE, rmaskE = ref["ransac_E"]
    np.testing.assert_allclose(_unit(e.model.numpy()), _unit(rE), atol=1e-8)
    n1, n2 = EP.pixel_to_normalized(_t(p1), _t(K)), EP.pixel_to_normalized(_t(p2), _t(K))
    thr2 = (1.0 / (0.5 * (K[0, 0] + K[1, 1]))) ** 2
    _masks_agree(e.inlier_mask.numpy(), rmaskE, G.sampson_error(e.model, n1, n2).numpy(), thr2)
    # The fits found the scene: its outliers are out, its pose is back, with
    # the 5-point solver and with the 8-point one.
    assert 0.6 * 200 < int(e.num_inliers) <= int(mask.sum())
    monkeypatch.undo()
    e8 = RB.find_essential(torch.Generator().manual_seed(0), _t(p1), _t(p2), _t(K),
                           mask=f.inlier_mask, solver="8pt")
    for E, bound_deg in ((e.model, 0.2), (e8.model, 0.5)):
        Rp, _, _, _ = EP.recover_pose(E, n1, n2, weights=e.inlier_mask.double())
        assert np.degrees(np.arccos(np.clip((np.trace(Rp.numpy() @ R.T) - 1) / 2, -1, 1))) < bound_deg


def test_sample_indices_draw_distinct_valid_points():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    gen = torch.Generator().manual_seed(1)
    idx = RB.sample_indices(gen, 50, mask, 300, 5)
    assert idx.shape == (300, 5) and bool(mask[idx].all())
    assert all(len(set(row.tolist())) == 5 for row in idx)
    # Every valid point is drawn, none more than chance allows.
    counts = torch.bincount(idx.reshape(-1), minlength=50)[mask]
    assert int(counts.min()) > 0 and int(counts.max()) < 3 * 300 * 5 / int(mask.sum())
