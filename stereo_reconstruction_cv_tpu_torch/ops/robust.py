"""Fixed-budget batched robust estimation (RANSAC / LMedS).

A port of ``stereo_reconstruction_cv_tpu/ops/robust.py``: cv2
findFundamentalMat(FM_LMEDS) and findEssentialMat(RANSAC, 0.999, 1 px) as
one batched pass, every hypothesis drawn, solved and scored at once:

    sample (M, k) indices -> batched minimal solver -> (M, 3, 3) models
    -> residuals (M, N) -> best score -> local refits.

Sampling is apart from fitting (``sample_indices`` then ``robust_fit(...,
idx)``), so that two implementations can be given the same samples. Shapes
are static: points come in fixed-size tensors with a validity mask, the
best model is chosen by ``argmax`` / ``argmin`` and selected with
``torch.where``, and no tensor is indexed by a boolean mask, so a fit on the
GPU never waits for the host on a data-dependent shape.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from stereo_reconstruction_cv_tpu_torch.ops import epipolar as EP
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops.fivepoint import essential_5pt


class RobustResult(NamedTuple):
    model: torch.Tensor        # (3, 3) best model (refit on its inliers)
    inlier_mask: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int
    score: torch.Tensor        # () inlier count (ransac) / -median (lmeds)


def sample_indices(generator: torch.Generator, num_points: int, mask: torch.Tensor,
                   num_hypotheses: int, k: int) -> torch.Tensor:
    """(M, k) distinct valid indices per hypothesis: the k largest of
    uniform keys, invalid points keyed -1. Any strictly increasing map of
    the keys picks the same sets, so this is the reference's Gumbel top-k
    draw (uniform k-subsets of the valid points), from `generator`'s stream."""
    keys = torch.rand((num_hypotheses, num_points), generator=generator,
                      dtype=torch.float64, device=mask.device)
    keys = torch.where(mask[None, :], keys, torch.full_like(keys, -1.0))
    return torch.topk(keys, k, dim=-1).indices


def _masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of each row over the valid entries (M, N) -> (M,); +inf
    where no entry is valid."""
    n_valid = mask.sum()
    v = torch.sort(torch.where(mask[None, :], values, torch.full_like(values, torch.inf)), dim=-1).values
    mid = torch.clamp(n_valid - 1, min=0) // 2
    hi_idx = torch.clamp(torch.minimum(mid + (1 - n_valid % 2), n_valid - 1), min=0)
    lo = v.index_select(1, mid.reshape(1))[:, 0]
    hi = v.index_select(1, hi_idx.reshape(1))[:, 0]
    return torch.where(n_valid > 0, 0.5 * (lo + hi), torch.full_like(lo, torch.inf))


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without the host read that indexing by
    a 0-d tensor makes."""
    return x.index_select(0, i.reshape(1))[0]


def _finite(r: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(r, nan=torch.inf, posinf=torch.inf)


def _lmeds_sigma2(med: torch.Tensor, n_valid: torch.Tensor, k: int) -> torch.Tensor:
    """OpenCV's LMedS inlier bound: (2.5 * 1.4826 * (1 + 5 / (n - k)) * sqrt(med))^2."""
    sigma = (2.5 * 1.4826 * (1.0 + 5.0 / torch.clamp(n_valid - k, min=1))
             * torch.sqrt(torch.clamp(med, min=0.0)))
    return torch.clamp(sigma, min=1e-12) ** 2


def robust_fit(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    idx: torch.Tensor,
    solver: Callable,
    residual_fn: Callable,
    refit: Callable,
    method: str = "ransac",
    threshold=1.0,
    lo_iters: int = 2,
    tiebreak_fn: Callable | None = None,
) -> RobustResult:
    """Generic fixed-budget robust fit over the samples `idx` (M, k).

    solver(s1 (M, k, 2), s2) -> models (M, 3, 3), or (models (M, R, 3, 3),
    valid (M, R)) for a multi-root minimal solver; residual_fn(models
    (..., 3, 3), pts1, pts2) -> squared residuals (..., N); refit(pts1, pts2,
    weights (N,)) -> (3, 3). method 'ransac' counts residuals under
    threshold^2; 'lmeds' minimises the median residual and takes inliers by
    OpenCV's 2.5-sigma rule. tiebreak_fn(models (K, 3, 3), pts1, pts2,
    mask) -> (K,) in [0, 1) ranks models of equal count under 'ransac'."""
    k = idx.shape[1]
    out = solver(pts1[idx], pts2[idx])
    if isinstance(out, tuple):
        models, model_ok = out
        models, model_ok = models.reshape(-1, 3, 3), model_ok.reshape(-1)
    else:
        models = out
        model_ok = torch.ones(models.shape[0], dtype=torch.bool, device=models.device)
    residuals = _finite(residual_fn(models, pts1, pts2))
    residuals = torch.where(model_ok[:, None], residuals, torch.full_like(residuals, torch.inf))
    dt = residuals.dtype

    n_valid = mask.sum()
    if method == "ransac":
        sel_thr2 = torch.as_tensor(threshold, dtype=dt, device=residuals.device) ** 2
        inlier = (residuals < sel_thr2) & mask[None, :]
        score = inlier.sum(-1).to(dt)
        if tiebreak_fn is not None:
            # The bonus (< 1) never outvotes an inlier, so only the K best
            # counts can win; ties in count keep the lower index first, as
            # a stable descending sort (the reference's top-k) does.
            K = min(32, models.shape[0])
            order = torch.sort(score, descending=True, stable=True)
            top_s, top_i = order.values[:K], order.indices[:K]
            bonus = tiebreak_fn(models[top_i], pts1, pts2, mask)
            bonus = torch.where(top_s >= top_s[0], bonus, torch.zeros_like(bonus))
            best = _pick(top_i, torch.argmax(top_s + bonus))
            score = score.index_add(0, top_i, bonus)
        else:
            best = torch.argmax(score)
        best_inliers = _pick(inlier, best)
        best_score = _pick(score, best)
    elif method == "lmeds":
        med = _masked_median(residuals, mask)
        best = torch.argmin(med)
        best_score = -_pick(med, best)
        sel_thr2 = _lmeds_sigma2(-best_score, n_valid, k)
        best_inliers = (_pick(residuals, best) < sel_thr2) & mask
    else:
        raise ValueError(f"unknown method {method!r}")

    # Local optimisation: refit on the inliers and keep the refit where it
    # loses none (it guards the degenerate refits).
    inliers, model = best_inliers, _pick(models, best)
    for _ in range(1 + lo_iters):
        refit_model = refit(pts1, pts2, inliers.to(pts1.dtype))
        inl_new = (_finite(residual_fn(refit_model, pts1, pts2)) < sel_thr2) & mask
        n_new = inl_new.sum().to(pts1.dtype)
        n_old = inliers.sum().to(pts1.dtype)
        if tiebreak_fn is not None:
            bonus = tiebreak_fn(torch.stack([refit_model, model]), pts1, pts2, mask)
            n_new, n_old = n_new + bonus[0], n_old + bonus[1]
        better = (n_new >= n_old) & (inliers.sum() >= k)
        model = torch.where(better, refit_model, model)
        inliers = torch.where(better, inl_new, inliers)
    return RobustResult(model, inliers, inliers.sum(), best_score)


def cheirality_fraction(E: torch.Tensor, npts1: torch.Tensor, npts2: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """0.999 x the largest share of valid correspondences with positive depth
    in both views over the four poses of each E (K, 3, 3) -> (K,), from the
    closed-form depths z1 = -(x2 x t).(x2 x R x1) / |x2 x R x1|^2: the
    RANSAC tiebreak that picks the true member of a planar-degenerate family."""
    R1, R2, t = EP.decompose_essential(E)
    x1, x2 = G.to_homogeneous(npts1), G.to_homogeneous(npts2)
    dt = npts1.dtype
    msum = mask.sum().to(dt) + 1e-30

    def frac(R, tt):
        Rx1 = x1 @ R.transpose(-1, -2)                                  # (K, N, 3)
        c1 = torch.linalg.cross(x2.expand_as(Rx1), Rx1)
        c2 = torch.linalg.cross(x2.expand_as(Rx1), tt[:, None, :].expand_as(Rx1))
        z1 = -(c2 * c1).sum(-1) / ((c1 * c1).sum(-1) + 1e-30)
        z2 = z1 * Rx1[..., 2] + tt[:, None, 2]
        return ((z1 > 0) & (z2 > 0) & mask).sum(-1).to(dt) / msum

    fr = torch.stack([frac(R1, t), frac(R1, -t), frac(R2, t), frac(R2, -t)])
    return 0.999 * fr.max(dim=0).values


def _eight_point_refit(p1, p2, w):
    return EP.eight_point(p1, p2, weights=w)


def _essential_refit(p1, p2, w):
    return EP.essential_8pt(p1, p2, weights=w)


def find_fundamental(generator: torch.Generator, pts1: torch.Tensor, pts2: torch.Tensor,
                     mask: torch.Tensor | None = None, method: str = "lmeds",
                     num_hypotheses: int = 512, threshold: float = 1.0) -> RobustResult:
    """Robust F (LMedS by default, cv2.FM_LMEDS); residual: squared Sampson
    distance in pixels."""
    if mask is None:
        mask = torch.ones(pts1.shape[0], dtype=torch.bool, device=pts1.device)
    idx = sample_indices(generator, pts1.shape[0], mask, num_hypotheses, 8)
    return robust_fit(pts1, pts2, mask, idx, EP.eight_point, G.sampson_error,
                      _eight_point_refit, method=method, threshold=threshold)


def find_essential(generator: torch.Generator, pts1: torch.Tensor, pts2: torch.Tensor,
                   K: torch.Tensor, mask: torch.Tensor | None = None,
                   threshold_px: float = 1.0, num_hypotheses: int = 512,
                   solver: str = "5pt") -> RobustResult:
    """Robust E by RANSAC on K-normalised coordinates (cv2.findEssentialMat
    with RANSAC): the pixel threshold over the mean focal length, the
    5-point solver (each sample's real roots all scored; num_hypotheses
    budgets candidates, so max(64, num_hypotheses // 8) samples are drawn)
    or solver='8pt', 8-point refits, the cheirality tiebreak."""
    if mask is None:
        mask = torch.ones(pts1.shape[0], dtype=torch.bool, device=pts1.device)
    n1 = EP.pixel_to_normalized(pts1, K)
    n2 = EP.pixel_to_normalized(pts2, K)
    thr = threshold_px / (0.5 * (K[0, 0] + K[1, 1]))
    if solver == "5pt":
        solve, k, num_hypotheses = essential_5pt, 5, max(64, num_hypotheses // 8)
    elif solver == "8pt":
        solve, k = EP.essential_8pt, 8
    else:
        raise ValueError(f"unknown essential solver {solver!r}")
    idx = sample_indices(generator, pts1.shape[0], mask, num_hypotheses, k)
    return robust_fit(n1, n2, mask, idx, solve, G.sampson_error, _essential_refit,
                      method="ransac", threshold=thr, tiebreak_fn=cheirality_fraction)
