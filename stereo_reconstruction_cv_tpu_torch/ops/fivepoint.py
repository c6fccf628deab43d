"""Batched 5-point essential solver (hidden-variable resultant).

A port of ``stereo_reconstruction_cv_tpu/ops/fivepoint.py`` with its method
kept, since the method decides which roots are found:

 1. The 5x9 epipolar constraint matrix Q has a 4-dimensional null space
    {E1..E4}. The basis is the reference's: its inverse iteration converges
    to the Gram-Schmidt orthonormalisation of its fixed start vectors
    projected onto the null space, which is computed here from the exact
    null space of ``torch.linalg.svd``.
 2. E(x, y, z) = x E1 + y E2 + z E3 + E4 must satisfy det E = 0 and
    2 E E^T E - tr(E E^T) E = 0: ten cubics in (x, y, z), whose coefficients
    over the 20 cubic monomials come from 20 fixed evaluation points and a
    float64 inverse Vandermonde.
 3. Grouped by the 10 monomials in (x, y), the system is M(z) m(x, y) = 0;
    real solutions need det M(z) = 0 (degree 10).
 4. With z = s / c on the circle (c, s) = (cos t, sin t), det M~(c, s) is
    scanned on a 256-point grid for sign changes and each of the first 10
    is bisected 42 times (the determinant by an unrolled partially pivoted
    LU, as the reference's).
 5. The null vector of M~ at a root (``torch.linalg.svd``) gives x c and
    y c; E = (x c) E1 + (y c) E2 + s E3 + c E4 is projected onto the
    essential manifold.

Every minimal problem of a batch solves at once; each returns up to 10
unit-norm candidates with a validity mask.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# The 10 monomials in (x, y) of degree <= 3, hidden-variable column order.
MONO_XY = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
# Highest z power of each column's coefficient polynomial.
Z_CAP = [3 - a - b for a, b in MONO_XY]
# The 20 cubic monomials (a, b, c), grouped by column.
MONOMIALS = [(a, b, c) for (a, b), cap in zip(MONO_XY, Z_CAP) for c in range(cap + 1)]
_COL_OFFSETS = np.cumsum([0] + [c + 1 for c in Z_CAP])

_N_GRID = 256          # sign-change scan over the root circle
_N_BISECT = 42         # bisection steps per root
MAX_ROOTS = 10
# The reference's null-space start vectors.
_NULL_START = np.random.default_rng(7).standard_normal((4, 9))


def _make_vinv():
    """Inverse of V[t, k] = monomial k at evaluation point t, for 20 fixed
    generic points (the reference's draw), in float64."""
    rng = np.random.default_rng(5)
    for _ in range(64):
        pts = rng.standard_normal((20, 3)) * 0.8
        V = np.stack([[x ** a * y ** b * z ** c for (a, b, c) in MONOMIALS] for x, y, z in pts])
        if np.linalg.cond(V) < 200.0:
            return np.linalg.inv(V), pts
    raise RuntimeError("could not find well-conditioned evaluation points")


_VINV, _EVAL_PTS = _make_vinv()
# Column j's coefficient of z^k sits at coefficient index _ZCO_INDEX[j, k];
# k > Z_CAP[j] points at an appended zero column (index 20). Its term is
# s^k c^(Z_CAP[j] - k) (_C_POWER clamped to 0 where the coefficient is 0).
_ZCO_INDEX = np.array([[_COL_OFFSETS[j] + k if k <= Z_CAP[j] else 20 for k in range(4)]
                       for j in range(10)])
_C_POWER = np.array([[max(Z_CAP[j] - k, 0) for k in range(4)] for j in range(10)])


@functools.lru_cache(maxsize=None)
def _constants(dtype, device):
    """(Vinv, evaluation points, null-space start vectors, _ZCO_INDEX,
    _C_POWER) as tensors on `device`, copied there once."""
    return (torch.as_tensor(_VINV, dtype=dtype).to(device),
            torch.as_tensor(_EVAL_PTS, dtype=dtype).to(device),
            torch.as_tensor(_NULL_START, dtype=dtype).to(device),
            torch.as_tensor(_ZCO_INDEX).to(device), torch.as_tensor(_C_POWER).to(device))


def _det3(E: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors."""
    return (E[..., 0, 0] * (E[..., 1, 1] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 1])
            - E[..., 0, 1] * (E[..., 1, 0] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 0])
            + E[..., 0, 2] * (E[..., 1, 0] * E[..., 2, 1] - E[..., 1, 1] * E[..., 2, 0]))


def _nullspace4_9(Q: torch.Tensor) -> torch.Tensor:
    """(M, 5, 9) -> (M, 4, 9): the reference's orthonormal null-space basis,
    Gram-Schmidt of its start vectors projected onto the exact null space."""
    N = torch.linalg.svd(Q, full_matrices=True).Vh[..., 5:, :]        # (M, 4, 9)
    X0 = _constants(Q.dtype, Q.device)[2]
    X = (X0 @ N.transpose(-1, -2)) @ N                                # (M, 4, 9)
    rows = []
    for i in range(4):
        v = X[..., i, :]
        for u in rows:
            v = v - (v * u).sum(-1, keepdim=True) * u
        rows.append(v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-30))
    return torch.stack(rows, dim=-2)


def _constraints(E: torch.Tensor) -> torch.Tensor:
    """The ten cubic invariants of an essential matrix:
    [det E, vec(2 E E^T E - tr(E E^T) E)]. (..., 3, 3) -> (..., 10)."""
    EEt = E @ E.transpose(-1, -2)
    tr = EEt.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    T = 2.0 * (EEt @ E) - tr * E
    return torch.cat([_det3(E)[..., None], T.reshape(T.shape[:-2] + (9,))], dim=-1)


def _det_lu(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., n, n) by an unrolled partially pivoted LU, the
    reference's elimination order (first maximum as the pivot)."""
    n = A.shape[-1]
    A = A.clone()
    det = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        col = torch.where(rows >= k, A[..., :, k].abs(), torch.full_like(A[..., :, k], -1.0))
        p = torch.argmax(col, dim=-1)
        onehot = (rows == p[..., None]).to(A.dtype)
        pivrow = (A * onehot[..., :, None]).sum(-2)
        rowk = A[..., k, :].clone()
        A[..., k, :] = pivrow
        A = A - onehot[..., :, None] * (pivrow - rowk)[..., None, :]
        det = det * torch.where(p == k, 1.0, -1.0).to(A.dtype)
        piv = A[..., k, k]
        det = det * piv
        safe = torch.where(piv.abs() < 1e-30, torch.ones_like(piv), piv)
        fac = torch.where(rows > k, A[..., :, k] / safe[..., None], torch.zeros_like(A[..., :, k]))
        A = A - fac[..., :, None] * A[..., k:k + 1, :]
    return det


def _m_tilde(zco: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The homogenised resultant matrix at z = s / c, column j times
    c^Z_CAP[j]. zco (M, 10, 10, 4) [row, column, z power]; c, s (M, P) ->
    (M, P, 10, 10)."""
    sp = torch.stack([torch.ones_like(s), s, s * s, s * s * s], dim=-1)   # (M, P, 4)
    cp = torch.stack([torch.ones_like(c), c, c * c, c * c * c], dim=-1)
    cpow = _constants(c.dtype, c.device)[4]                                # (10, 4)
    terms = sp[..., None, :] * cp[..., cpow]                               # (M, P, 10, 4)
    return torch.einsum("mrjk,mpjk->mprj", zco, terms)


def essential_5pt(npts1: torch.Tensor, npts2: torch.Tensor):
    """Minimal 5-point solves on K-normalised coordinates.

    npts1, npts2 (M, 5, 2) -> (E (M, 10, 3, 3) unit-norm candidates, valid
    (M, 10) bool): one slot per real root, invalid slots arbitrary."""
    dt, dev = npts1.dtype, npts1.device
    Vinv, ev, _, zco_index, _ = _constants(dt, dev)

    x1, y1 = npts1[..., 0], npts1[..., 1]
    x2, y2 = npts2[..., 0], npts2[..., 1]
    Q = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)                          # (M, 5, 9)
    B = _nullspace4_9(Q).reshape(Q.shape[0], 4, 3, 3)
    E1, E2, E3, E4 = B[:, 0, None], B[:, 1, None], B[:, 2, None], B[:, 3, None]

    # Coefficients of the ten cubics over the 20 monomials, from their
    # values at the evaluation points.
    Es = (ev[:, 0, None, None] * E1 + ev[:, 1, None, None] * E2
          + ev[:, 2, None, None] * E3 + E4)                                 # (M, 20, 3, 3)
    coeffs = (Vinv @ _constraints(Es)).transpose(-1, -2)                    # (M, 10, 20)
    coeffs = coeffs / (torch.linalg.norm(coeffs, dim=-1, keepdim=True) + 1e-30)
    coeffs = torch.cat([coeffs, torch.zeros_like(coeffs[..., :1])], dim=-1)
    zco = coeffs[..., zco_index]                                            # (M, 10, 10, 4)

    def g_of(theta):
        return _det_lu(_m_tilde(zco, torch.cos(theta), torch.sin(theta)))

    # Root scan: sign changes of det M~ on the open half circle; the first
    # MAX_ROOTS of them in grid order (a stable descending sort of
    # change * 2 - i * 1e-9, the reference's top-k).
    thetas = (torch.arange(_N_GRID, dtype=dt, device=dev) + 0.5) / _N_GRID * torch.pi - torch.pi / 2
    g = g_of(thetas.expand(Q.shape[0], _N_GRID))
    change = (g[:, :-1] * g[:, 1:]) < 0
    score = change.to(dt) * 2.0 - torch.arange(_N_GRID - 1, dtype=dt, device=dev) * 1e-9
    idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :MAX_ROOTS]
    valid = torch.gather(change, 1, idx)
    lo = thetas[idx]
    hi = thetas[torch.clamp(idx + 1, max=_N_GRID - 1)]
    glo = torch.gather(g, 1, idx)
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        gm = g_of(mid)
        right = (glo * gm) > 0
        lo = torch.where(right, mid, lo)
        glo = torch.where(right, gm, glo)
        hi = torch.where(right, hi, mid)
    troot = 0.5 * (lo + hi)
    c, s = torch.cos(troot), torch.sin(troot)

    # Back-substitution: m[j] ~ x^a y^b c^(3 - a - b), so m[7] / m[9] = x c
    # and m[8] / m[9] = y c.
    m = torch.linalg.svd(_m_tilde(zco, c, s)).Vh[..., -1, :]                # (M, 10, 10)
    den = m[..., 9]
    ok = den.abs() > 1e-7
    safe = torch.where(ok, den, torch.ones_like(den))
    a, b = (m[..., 7] / safe)[..., None, None], (m[..., 8] / safe)[..., None, None]
    E = a * E1 + b * E2 + s[..., None, None] * E3 + c[..., None, None] * E4
    U, sv, Vh = torch.linalg.svd(E)
    sm = 0.5 * (sv[..., 0] + sv[..., 1])
    proj = (U * torch.stack([sm, sm, torch.zeros_like(sm)], -1)[..., None, :]) @ Vh
    nrm = torch.linalg.norm(proj, dim=(-2, -1))
    return proj / (nrm[..., None, None] + 1e-30), valid & ok & (nrm > 1e-12)
