"""Descriptor matching: exact top-2 nearest neighbours and the ratio test.

A port of ``stereo_reconstruction_cv_tpu/ops/matching.py`` (cv2
FlannBasedMatcher.knnMatch(k=2) + Lowe's ratio test, exact instead of
approximate). Descriptors come padded to a fixed count with a validity mask,
and the outputs have that fixed count too.

The distances are one float32 matrix product; it relies on PyTorch's default
``float32_matmul_precision`` "highest" (no TF32 on a GPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MatchResult(NamedTuple):
    indices: torch.Tensor   # (N,) int32: best match in desc2 for each desc1
    distance: torch.Tensor  # (N,) best match distance
    second: torch.Tensor    # (N,) second-best distance
    mask: torch.Tensor      # (N,) bool: valid and passed the test


def squared_distance_matrix(d1: torch.Tensor, d2: torch.Tensor,
                            valid2: torch.Tensor | None = None) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) squared L2 distances, ||a||^2 + ||b||^2 - 2 a.b
    in float32, clamped at 0; invalid columns +inf."""
    d1, d2 = d1.to(torch.float32), d2.to(torch.float32)
    n1 = (d1 ** 2).sum(-1, keepdim=True)
    n2 = (d2 ** 2).sum(-1, keepdim=True)
    dist = torch.clamp(n1 + n2.T - 2.0 * (d1 @ d2.T), min=0.0)
    if valid2 is not None:
        dist = torch.where(valid2[None, :], dist, torch.full_like(dist, torch.inf))
    return dist


def _top2(dist: torch.Tensor):
    best_idx = torch.argmin(dist, dim=-1)
    best = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    second = dist.scatter(1, best_idx[:, None], torch.inf).min(dim=-1).values
    return best_idx, best, second


def _mutual(dist, best_idx, valid1):
    """Row i's best column has row i as its best row (invalid rows excluded)."""
    bdist = dist if valid1 is None else torch.where(valid1[:, None], dist, torch.full_like(dist, torch.inf))
    back = torch.argmin(bdist, dim=0)
    return back[best_idx] == torch.arange(dist.shape[0], device=dist.device)


def knn2_match(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor | None = None,
               valid2: torch.Tensor | None = None, ratio: float = 0.7,
               mutual: bool = False) -> MatchResult:
    """Exact k = 2 nearest neighbours with Lowe's ratio on L2 distances
    (0.7 on the geometry path, 0.75 on the inspection path); mutual=True
    adds a cross-check."""
    dist = squared_distance_matrix(d1, d2, valid2)
    best_idx, best, second = _top2(dist)
    ok = best < (ratio * ratio) * second
    if valid1 is not None:
        ok &= valid1
    ok &= torch.isfinite(best)
    if mutual:
        ok &= _mutual(dist, best_idx, valid1)
    return MatchResult(best_idx.to(torch.int32), torch.sqrt(best), torch.sqrt(second), ok)


def match_learned(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor | None = None,
                  valid2: torch.Tensor | None = None, min_cossim: float = 0.5) -> MatchResult:
    """Mutual nearest neighbours with a minimum cosine similarity, for
    L2-normalised learned descriptors (cossim = 1 - dist^2 / 2), whose
    near-duplicate second neighbours defeat the ratio test."""
    dist = squared_distance_matrix(d1, d2, valid2)
    best_idx, best, second = _top2(dist)
    ok = (1.0 - 0.5 * best) >= min_cossim
    if valid1 is not None:
        ok &= valid1
    ok &= torch.isfinite(best)
    ok &= _mutual(dist, best_idx, valid1)
    return MatchResult(best_idx.to(torch.int32), torch.sqrt(best), torch.sqrt(second), ok)


def gather_correspondences(kpts1: torch.Tensor, kpts2: torch.Tensor, match: MatchResult):
    """(pts1 (N, 2), pts2 (N, 2), mask): row i pairs kpts1[i] with
    kpts2[match.indices[i]]; mask selects the rows that passed."""
    return kpts1, kpts2[match.indices.long()], match.mask
