"""Two-view epipolar solvers: 8-point F and E, decomposition, pose recovery.

Ports of ``stereo_reconstruction_cv_tpu/ops/epipolar.py`` (cv2
findFundamentalMat / findEssentialMat's solvers, decomposeEssentialMat,
recoverPose). The solvers are weighted and take leading batch dimensions
((..., N, 2) points, (..., N) weights), so the robust engine solves all its
hypotheses in one call. Every solve runs through Hartley normalisation.

The reference's LAPACK-free TPU helpers (``ops/linalg.py``: analytic 3x3
SVD, inverse iteration) become ``torch.linalg``: the null vectors come from
``eigh`` and ``svd``, whose signs are arbitrary; every consumer here cancels
the sign (a ratio, a dehomogenisation, a product of two factors).
"""

from __future__ import annotations

import torch

from stereo_reconstruction_cv_tpu_torch.ops import geometry as G


def normalize_points(pts: torch.Tensor, weights: torch.Tensor | None = None):
    """Hartley normalisation: centroid to the origin, mean distance sqrt(2).
    Returns (normalised points (..., N, 2), T (..., 3, 3)) with
    x_n = T @ x_h; weighted, so masked points do not move the frame."""
    if weights is None:
        weights = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    wsum = weights.sum(-1) + 1e-30
    centroid = (pts * weights[..., None]).sum(-2) / wsum[..., None]
    d = pts - centroid[..., None, :]
    mean_dist = (torch.linalg.norm(d, dim=-1) * weights).sum(-1) / wsum
    scale = (2.0 ** 0.5) / (mean_dist + 1e-30)
    z, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, z, -scale * centroid[..., 0]], -1),
                     torch.stack([z, scale, -scale * centroid[..., 1]], -1),
                     torch.stack([z, z, one], -1)], -2)
    return d * scale[..., None, None], T


def _design(p1n: torch.Tensor, p2n: torch.Tensor) -> torch.Tensor:
    """Rows of x2^T F x1 = 0 over vec(F): (..., N, 9)."""
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _weighted_null(pts1, pts2, weights):
    """The normalised frames and the unit 3x3 minimiser f of f^T A^T W A f."""
    if weights is None:
        weights = torch.ones(pts1.shape[:-1], dtype=pts1.dtype, device=pts1.device)
    p1n, T1 = normalize_points(pts1, weights)
    p2n, T2 = normalize_points(pts2, weights)
    A = _design(p1n, p2n)
    M = (A * weights[..., None]).transpose(-1, -2) @ A
    f = torch.linalg.eigh(M).eigenvectors[..., :, 0]
    return f.reshape(f.shape[:-1] + (3, 3)), T1, T2


def _rank2(M: torch.Tensor, equal: bool = False) -> torch.Tensor:
    """M's nearest rank-2 matrix: U diag(s0, s1, 0) V^T, or with s0 = s1 =
    their mean when `equal` (the essential manifold)."""
    U, s, Vh = torch.linalg.svd(M)
    s0, s1 = s[..., 0], s[..., 1]
    if equal:
        s0 = s1 = 0.5 * (s0 + s1)
    s = torch.stack([s0, s1, torch.zeros_like(s0)], -1)
    return (U * s[..., None, :]) @ Vh


def eight_point(pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor | None = None,
                enforce_rank2: bool = True) -> torch.Tensor:
    """Weighted normalised 8-point F with x2^T F x1 = 0, scaled so
    F[2, 2] = 1 where possible (cv2's convention). pts (..., N, 2), N >= 8."""
    F, T1, T2 = _weighted_null(pts1, pts2, weights)
    if enforce_rank2:
        F = _rank2(F)
    F = T2.transpose(-1, -2) @ F @ T1
    den = F[..., 2, 2]
    den = torch.where(den.abs() < 1e-12, torch.sign(den) + (den == 0), den)
    return F / den[..., None, None]


def essential_8pt(npts1: torch.Tensor, npts2: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """8-point E on K-normalised coordinates, projected onto the essential
    manifold; unit Frobenius norm."""
    e, T1, T2 = _weighted_null(npts1, npts2, weights)
    E = _rank2(T2.transpose(-1, -2) @ e @ T1, equal=True)
    return E / (torch.linalg.norm(E, dim=(-2, -1))[..., None, None] + 1e-30)


def skew(t: torch.Tensor) -> torch.Tensor:
    """[t]_x of t (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(t[..., 0])
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    return torch.stack([torch.stack([z, -tz, ty], -1), torch.stack([tz, z, -tx], -1),
                        torch.stack([-ty, tx, z], -1)], -2)


def essential_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R for x2 = R x1 + t (cv2's convention)."""
    return skew(t) @ R


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    return _rank2(K2.T @ F @ K1, equal=True)


def fundamental_from_essential(E: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(K2).T @ E @ torch.linalg.inv(K1)


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t) (cv2.decomposeEssentialMat); the four pose
    candidates are (R1, t), (R1, -t), (R2, t), (R2, -t)."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vh = Vh * torch.sign(torch.linalg.det(Vh))[..., None, None]
    # W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]: U W = (u1, -u0, u2), U W^T = (-u1, u0, u2).
    UW = torch.stack([U[..., 1], -U[..., 0], U[..., 2]], dim=-1)
    UWt = torch.stack([-U[..., 1], U[..., 0], U[..., 2]], dim=-1)
    return UW @ Vh, UWt @ Vh, U[..., :, 2]


def _cheirality(R: torch.Tensor, t: torch.Tensor, npts1: torch.Tensor,
                npts2: torch.Tensor) -> torch.Tensor:
    """(C, N) bool: point n triangulated in front of both cameras under pose
    candidate c (R (C, 3, 3), t (C, 3); P1 = [I|0], P2 = [R|t])."""
    P2 = torch.cat([R, t[..., None]], dim=-1)                          # (C, 3, 4)
    P1 = torch.eye(3, 4, dtype=R.dtype, device=R.device)
    x1, y1 = npts1[:, 0, None], npts1[:, 1, None]                      # (N, 1)
    x2, y2 = npts2[None, :, 0, None], npts2[None, :, 1, None]          # (1, N, 1)
    P2a, P2b, P2c = P2[:, None, 0], P2[:, None, 1], P2[:, None, 2]     # (C, 1, 4)
    r1 = torch.stack([x1 * P1[2] - P1[0], y1 * P1[2] - P1[1]], dim=-2)  # (N, 2, 4)
    r2 = torch.stack([x2 * P2c - P2a, y2 * P2c - P2b], dim=-2)          # (C, N, 2, 4)
    A = torch.cat([r1.expand_as(r2), r2], dim=-2)
    X = torch.linalg.svd(A).Vh[..., -1, :]
    w = X[..., 3:]
    X = X / torch.where(w.abs() < 1e-30, torch.full_like(w, 1e-30), w)
    z2 = (X * P2c).sum(-1)
    return (X[..., 2] > 0) & (z2 > 0) & (X[..., 2].abs() < 1e9)


def recover_pose(E: torch.Tensor, npts1: torch.Tensor, npts2: torch.Tensor,
                 weights: torch.Tensor | None = None):
    """The (R, t) of E with the best cheirality vote (cv2.recoverPose) on
    K-normalised points. Returns (R, unit t, good mask (N,), votes)."""
    if weights is None:
        weights = torch.ones(npts1.shape[:-1], dtype=npts1.dtype, device=npts1.device)
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    ok = _cheirality(Rs, ts, npts1, npts2)
    counts = (ok * weights).sum(-1)
    best = torch.argmax(counts).reshape(1)
    return (Rs.index_select(0, best)[0], ts.index_select(0, best)[0],
            ok.index_select(0, best)[0] & (weights > 0), counts.index_select(0, best)[0])


def pixel_to_normalized(pts: torch.Tensor, K: torch.Tensor,
                        dist: torch.Tensor | None = None) -> torch.Tensor:
    """Pixels -> K-normalised coordinates, undistorted when dist is given."""
    xy = torch.stack([(pts[..., 0] - K[0, 2]) / K[0, 0], (pts[..., 1] - K[1, 2]) / K[1, 1]], dim=-1)
    if dist is not None:
        xy = G.undistort_normalized(xy, dist)
    return xy
