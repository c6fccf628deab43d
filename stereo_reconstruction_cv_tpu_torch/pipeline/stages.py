"""Stage functions: a raw pair -> two-view geometry -> rectification ->
disparity -> 3D points -> point-cloud file.

Ports of ``stereo_reconstruction_cv_tpu/pipeline/stages.py``:
``detect_match``, ``estimate_geometry``, ``rectify_pair``,
``triangulate_sparse`` (the sparse path; ``detect_match`` and
``estimate_geometry`` also with ``method="learned"``, the XFeat-style net of
``models/xfeat.py`` with its shipped weights) and ``disparity``,
``reconstruct``, ``export_point_cloud`` (PLY; the dense path). Each takes an explicit
``device`` and runs every step there; asking for CUDA where none is
available is an error, never a quiet move to the CPU. Images and disparity
maps stay on the device as tensors; the sparse stages return the
reference's dicts of numpy arrays (matrices, correspondences, counts), and
only the masked points cross to the host for the file.

Geometry runs in float64 (correspondences, F, E, pose, rectification,
triangulation), the image stages in float32. Random draws come from a
``torch.Generator`` on the device seeded with ``seed`` (F, then E), and the
rectification's verification uses ``seed + 1``, as the reference splits its
keys; the streams differ from JAX's, so results agree with the reference's
within the robust estimators' spread, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch import config as C
from stereo_reconstruction_cv_tpu_torch.io import image as IO
from stereo_reconstruction_cv_tpu_torch.io import ply as PLY
from stereo_reconstruction_cv_tpu_torch.models import checkpoint as CKPT
from stereo_reconstruction_cv_tpu_torch.models import xfeat as XF
from stereo_reconstruction_cv_tpu_torch.ops import disparity as DP
from stereo_reconstruction_cv_tpu_torch.ops import epipolar as EP
from stereo_reconstruction_cv_tpu_torch.ops import features as FT
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops import matching as M
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC
from stereo_reconstruction_cv_tpu_torch.ops import refine as RF
from stereo_reconstruction_cv_tpu_torch.ops import robust as RB


def resolve_device(device) -> torch.device:
    """torch.device(device), raising when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the host"
        )
    return dev


def _on(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def disparity(imgL, imgR, ndisp: int = 16, mindis: int = 0, device="cuda") -> torch.Tensor:
    """compute_disparity_map parity (cell 10): float map, invalid and
    non-positive pixels zeroed. Images: (H, W) or (H, W, 3) uint8."""
    dev = resolve_device(device)
    return DP.compute_disparity_map(_on(imgL, dev), _on(imgR, dev), ndisp, mindis)


def reconstruct(disparity_map, Q, device="cuda") -> torch.Tensor:
    """reconstruct_3D parity (cell 11): (H, W, 3) float32 point image."""
    dev = resolve_device(device)
    return G.reproject_image_to_3d(_on(disparity_map, dev, torch.float32),
                                   _on(Q, dev, torch.float32))


def export_point_cloud(path: str, points_3d, disparity_map, colors=None,
                       device="cuda") -> int:
    """Write the valid points (finite, disparity > 0) as PLY; returns N."""
    if path.endswith(".html"):
        raise NotImplementedError(
            "the HTML viewer export is not ported yet; write a .ply file"
        )
    dev = resolve_device(device)
    pts = _on(points_3d, dev)
    mask = G.valid_point_mask(pts, _on(disparity_map, dev))
    p = pts[mask].cpu().numpy()
    c = None
    if colors is not None:
        c = _on(colors, dev)[mask].cpu().numpy()
    return PLY.write_ply(path, p, c)


# ---------------------------------------------------------------------------
# The sparse path
# ---------------------------------------------------------------------------

def default_camera_matrix(cfg: C.RectifyConfig = C.DEFAULT.rectify) -> np.ndarray:
    """The reference's fallback K when no calibration is given."""
    return np.array([[cfg.default_fx, 0, cfg.default_cx], [0, cfg.default_fy, cfg.default_cy],
                     [0, 0, 1.0]])


def _refuse_unported(method: str = "classical", cache=None) -> None:
    if method not in ("classical", "learned"):
        raise ValueError(f"unknown matching method {method!r}")
    if cache is not None:
        raise NotImplementedError("the stage cache is not ported yet (ROADMAP A.15)")


def _load_pair(folder_or_pair, dev):
    """A pair folder's img1.jpg / img2.jpg, or an (imL, imR) pair, as (H, W)
    uint8 tensors on dev."""
    if isinstance(folder_or_pair, str):
        folder_or_pair = IO.load_stereo_pair(folder_or_pair)
    return tuple(_on(x, dev) for x in folder_or_pair)


def _camera(camera_matrix, dev) -> torch.Tensor:
    K = default_camera_matrix() if camera_matrix is None else camera_matrix
    return _on(np.asarray(K, np.float64), dev, torch.float64)


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


_XFEAT_CACHE: Dict = {}


def _xfeat_model(checkpoint: Optional[str], dev: torch.device) -> XF.XFeatNet:
    """The net with the weights of `checkpoint` (an .npz export; None: the
    shipped v4 weights) on `dev`, loaded once per (checkpoint, device)."""
    path = checkpoint or CKPT.default_checkpoint()
    key = (path, str(dev))
    if key not in _XFEAT_CACHE:
        _XFEAT_CACHE[key] = CKPT.load_model(path, dev)
    return _XFEAT_CACHE[key]


def _learned_features(img: torch.Tensor, max_keypoints: int, checkpoint: Optional[str]):
    """XFeat detection on one image, cropped to multiples of the 8-px cell."""
    H0, W0 = img.shape[0] // 8 * 8, img.shape[1] // 8 * 8
    return XF.detect(_xfeat_model(checkpoint, img.device), img[:H0, :W0], max_keypoints)


def _learned_features_pair(imL: torch.Tensor, imR: torch.Tensor, max_keypoints: int,
                           checkpoint: Optional[str]):
    """Pair detection with one B=2 forward; two forwards for unequal shapes."""
    if imR.shape != imL.shape:
        return (_learned_features(imL, max_keypoints, checkpoint),
                _learned_features(imR, max_keypoints, checkpoint))
    H0, W0 = imL.shape[0] // 8 * 8, imL.shape[1] // 8 * 8
    return XF.detect_pair(_xfeat_model(checkpoint, imL.device), imL[:H0, :W0], imR[:H0, :W0],
                          max_keypoints)


def detect_match(folder_or_pair, contrast_threshold: float = 0.04, ratio: float = 0.75,
                 max_keypoints: int = 2048, method: str = "classical",
                 model_checkpoint: Optional[str] = None, with_visualizations: bool = False,
                 device="cuda") -> Dict:
    """Keypoints, descriptors and matches, as numpy arrays and counts:
    SIFT with kNN matching and Lowe's ratio test (0.75 on this inspection
    path), or with method="learned" the XFeat net (model_checkpoint, an .npz
    export; None: the shipped weights) with mutual nearest neighbours of
    cosine similarity >= 0.5."""
    _refuse_unported(method)
    dev = resolve_device(device)
    imL, imR = _load_pair(folder_or_pair, dev)
    if method == "learned":
        fl, fr = _learned_features_pair(imL, imR, max_keypoints, model_checkpoint)
        mres = M.match_learned(fl.descriptors, fr.descriptors, fl.mask, fr.mask)
    else:
        fl = FT.detect_and_describe(imL, max_keypoints, contrast_threshold)
        fr = FT.detect_and_describe(imR, max_keypoints, contrast_threshold)
        mres = M.knn2_match(fl.descriptors, fr.descriptors, fl.mask, fr.mask, ratio=ratio)
    out = {
        "keypoints1": _numpy(fl.keypoints),
        "keypoints2": _numpy(fr.keypoints),
        "descriptors1": _numpy(fl.descriptors),
        "descriptors2": _numpy(fr.descriptors),
        "num_keypoints": (int(fl.mask.sum()), int(fr.mask.sum())),
        "match_indices": _numpy(mres.indices),
        "match_mask": _numpy(mres.mask),
        "num_good_matches": int(mres.mask.sum()),
    }
    if with_visualizations:
        from stereo_reconstruction_cv_tpu_torch.utils import draw as DR

        iL, iR = _numpy(imL), _numpy(imR)
        mL, mR = _numpy(fl.mask), _numpy(fr.mask)
        k1, k2, idx = out["keypoints1"], out["keypoints2"], out["match_indices"]
        good = [(i, int(idx[i])) for i in np.nonzero(out["match_mask"])[0]]
        all_m = [(i, int(idx[i])) for i in range(len(idx)) if mL[i]]
        out["Left Keypoints"] = DR.resize_nearest(DR.draw_keypoints(iL, k1[mL][:500]), (640, 360))
        out["Right Keypoints"] = DR.resize_nearest(DR.draw_keypoints(iR, k2[mR][:500]), (640, 360))
        out["All Matches"] = DR.resize_nearest(DR.draw_matches(iL, k1, iR, k2, all_m), (1280, 360))
        out["Good Matches"] = DR.resize_nearest(DR.draw_matches(iL, k1, iR, k2, good), (1280, 360))
    return out


def _downscale(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Box-average downscale of a uint8 image by an integer factor."""
    H, W = img.shape
    img = img[: H - H % factor, : W - W % factor]
    return (img.reshape(H // factor, factor, W // factor, factor).to(torch.float32)
            .mean((1, 3)).to(torch.uint8))


def _no_mark(stage: str) -> None:
    pass


def _match_for_geometry(imL: torch.Tensor, imR: torch.Tensor, cfg: C.MatchConfig,
                        max_dim: int = 2048, method: str = "classical",
                        checkpoint: Optional[str] = None,
                        mark: Callable[[str], None] = _no_mark):
    """Detect and match for the geometry path: frames above max_dim are
    detected at an integer downscale (coordinates scaled back). SIFT
    matches are mutual nearest neighbours that pass the ratio test; learned
    ones (method="learned") mutual nearest neighbours of cosine similarity
    >= cfg.learned_min_cossim, whose right points are then LK-refined
    against the full-resolution pair (cfg.lk_*). Returns float64 (pts1,
    pts2, mask, factor)."""
    factor = max(1, int(math.ceil(max(imL.shape) / max_dim)))
    dL = _downscale(imL, factor) if factor > 1 else imL
    dR = _downscale(imR, factor) if factor > 1 else imR
    if method == "learned":
        fl, fr = _learned_features_pair(dL, dR, cfg.max_keypoints, checkpoint)
        mark("detect")
        mres = M.match_learned(fl.descriptors, fr.descriptors, fl.mask, fr.mask,
                               min_cossim=cfg.learned_min_cossim)
    else:
        fl = FT.detect_and_describe(dL, cfg.max_keypoints, cfg.contrast_threshold)
        fr = FT.detect_and_describe(dR, cfg.max_keypoints, cfg.contrast_threshold)
        mark("detect")
        mres = M.knn2_match(fl.descriptors, fr.descriptors, fl.mask, fr.mask,
                            ratio=cfg.ratio_geometry, mutual=True)
    p1, p2, mask = M.gather_correspondences(fl.keypoints, fr.keypoints, mres)
    p1, p2 = p1.to(torch.float64) * factor, p2.to(torch.float64) * factor
    mark("match")
    if method == "learned" and cfg.lk_refine:
        # learned keypoints sit within ~0.5-1 px: align each right patch to
        # its left one at full resolution
        p2, _ = RF.refine_matches_lk(imL, imR, p1.to(torch.float32), p2.to(torch.float32),
                                     win=cfg.lk_win, iters=cfg.lk_iters)
        p2 = p2.to(torch.float64)
        mark("LK")
    return p1, p2, mask, factor


class _Geometry(NamedTuple):
    E: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor           # unit norm
    fres: RB.RobustResult
    eres: RB.RobustResult
    pts1: torch.Tensor
    pts2: torch.Tensor
    mask: torch.Tensor        # the matches


def _geometry(imL, imR, K, seed: int, cfg: C.PipelineConfig, mark, method: str = "classical",
              checkpoint: Optional[str] = None) -> _Geometry:
    """Match -> F (LMedS) -> E (5-point RANSAC on F's inliers) -> pose."""
    p1, p2, mask, factor = _match_for_geometry(imL, imR, cfg.match, method=method,
                                               checkpoint=checkpoint, mark=mark)
    gen = torch.Generator(device=K.device)
    gen.manual_seed(seed)
    fres = RB.find_fundamental(gen, p1, p2, mask=mask, method=cfg.robust.f_method,
                               num_hypotheses=cfg.robust.num_hypotheses)
    mark("F")
    # Keypoint noise grows with the detection downscale, so the threshold does.
    eres = RB.find_essential(gen, p1, p2, K, mask=fres.inlier_mask,
                             threshold_px=cfg.robust.e_threshold_px * factor,
                             num_hypotheses=2 * cfg.robust.num_hypotheses)
    mark("E")
    n1, n2 = EP.pixel_to_normalized(p1, K), EP.pixel_to_normalized(p2, K)
    R, t, _, _ = EP.recover_pose(eres.model, n1, n2, weights=eres.inlier_mask.to(n1.dtype))
    mark("pose")
    return _Geometry(eres.model, R, t, fres, eres, p1, p2, mask)


def _geometry_dict(g: _Geometry, baseline: float) -> Dict:
    return {
        "Essential Matrix": _numpy(g.E),
        "Rotation Matrix": _numpy(g.R),
        "Translation Vector": _numpy(g.t).reshape(3, 1),
        "F": _numpy(g.fres.model),
        "baseline": baseline,  # the metric scale; t is unit-norm
        "num_matches": int(g.mask.sum()),
        "num_inliers_F": int(g.fres.num_inliers),
        "num_inliers_E": int(g.eres.num_inliers),
        "pts1": _numpy(g.pts1),
        "pts2": _numpy(g.pts2),
        "inlier_mask": _numpy(g.eres.inlier_mask),
    }


def estimate_geometry(folder_or_pair, baseline: float = 0.1,
                      camera_matrix: Optional[np.ndarray] = None, seed: int = 0,
                      pipeline_cfg: C.PipelineConfig = C.DEFAULT, method: str = "classical",
                      checkpoint: Optional[str] = None, cache=None, device="cuda",
                      on_stage: Optional[Callable[[str], None]] = None) -> Dict:
    """Two-view geometry of a raw pair: SIFT-semantics matches (ratio 0.7,
    mutual), or with method="learned" the XFeat net's LK-refined matches
    (checkpoint: an .npz export; None: the shipped weights) -> F by LMedS
    -> E by 5-point RANSAC (p 0.999, 1 px) -> recoverPose. Returns the
    reference's dict ("Essential Matrix", "Rotation Matrix", "Translation
    Vector" (unit norm), F, counts, correspondences, E's inlier mask) as
    numpy. on_stage, when given, is called with "detect", "match", ("LK" on
    the learned path,) "F", "E" and "pose" as each ends (a timing hook; it
    may synchronise the device)."""
    _refuse_unported(method, cache)
    dev = resolve_device(device)
    imL, imR = _load_pair(folder_or_pair, dev)
    g = _geometry(imL, imR, _camera(camera_matrix, dev), seed, pipeline_cfg, on_stage or _no_mark,
                  method, checkpoint)
    return _geometry_dict(g, baseline)


def rectify_pair(folder_or_pair, baseline: float = 0.1,
                 camera_matrix: Optional[np.ndarray] = None, dist: Optional[np.ndarray] = None,
                 alpha: float = 1.0, seed: int = 0, with_visualizations: bool = True,
                 pipeline_cfg: C.PipelineConfig = C.DEFAULT, cache=None, device="cuda") -> Dict:
    """Estimate the geometry, rectify (Bouguet, alpha 1 by default) and
    remap both images, then re-match the rectified pair and fit F to check
    that its epilines are horizontal ("epiline_mean_abs_slope").

    The rectified images ("left_rectified", "right_rectified") are uint8
    tensors on the device, ready for the dense stages; R1, R2, P1, P2, Q,
    F_rectified and the nested "geometry" dict are numpy. dist (5
    coefficients) undistorts in the remap."""
    _refuse_unported(cache=cache)
    dev = resolve_device(device)
    imL, imR = _load_pair(folder_or_pair, dev)
    K = _camera(camera_matrix, dev)
    d = None if dist is None else _on(np.asarray(dist, np.float64).reshape(-1), dev, torch.float64)
    g = _geometry(imL, imR, K, seed, pipeline_cfg, _no_mark)
    geo = _geometry_dict(g, baseline)
    H, W = imL.shape
    rr = RC.stereo_rectify(K, d, K, d, (W, H), g.R, g.t * baseline, alpha=alpha)
    left = RC.rectify_remap(imL, K, d, rr.R1, rr.P1)
    right = RC.rectify_remap(imR, K, d, rr.R2, rr.P2)
    out = {"left_rectified": left, "right_rectified": right,
           **{k: _numpy(getattr(rr, k)) for k in ("R1", "R2", "P1", "P2", "Q")},
           "geometry": geo}
    # Verification: re-match the rectified pair, fit F, measure how far its
    # epilines are from horizontal.
    p1r, p2r, maskr, _ = _match_for_geometry(left, right, pipeline_cfg.match)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    fres = RB.find_fundamental(gen, p1r, p2r, mask=maskr)
    lines = G.compute_epilines(p1r, fres.model, 1)
    slopes = (lines[:, 0] / (lines[:, 1].abs() + 1e-9)).abs()
    inl = fres.inlier_mask
    n = inl.sum()
    mean_slope = torch.where(n > 0, (slopes * inl).sum() / n.clamp(min=1),
                             torch.full_like(slopes[0], math.inf))
    out["F_rectified"] = _numpy(fres.model)
    out["epiline_mean_abs_slope"] = float(mean_slope)
    if with_visualizations:
        from stereo_reconstruction_cv_tpu_torch.utils import draw as DR

        iL, iR, lr, rrt = (_numpy(x) for x in (imL, imR, left, right))
        sel = np.nonzero(geo["inlier_mask"])[0][:30]
        before = _numpy(G.compute_epilines(g.pts2[sel], g.fres.model, 2))
        vis1, vis2 = DR.draw_epilines(iL, iR, before, geo["pts1"][sel], geo["pts2"][sel])
        selr = np.nonzero(_numpy(inl))[0][:30]
        p1n, p2n = _numpy(p1r)[selr], _numpy(p2r)[selr]
        after = _numpy(G.compute_epilines(p2r[selr], fres.model, 2))
        vis3, vis4 = DR.draw_epilines(lr, rrt, after, p1n, p2n)
        out.update({"Left Epilines (before)": vis1, "Right Points (before)": vis2,
                    "Left Epilines (after)": vis3, "Right Points (after)": vis4})
    return out


def triangulate_sparse(folder_or_pair, camera_matrix: Optional[np.ndarray] = None,
                       baseline: float = 0.1, seed: int = 0,
                       pipeline_cfg: C.PipelineConfig = C.DEFAULT, device="cuda") -> Dict:
    """Sparse 3D points of the E inliers by DLT triangulation with
    P1 = K[I|0], P2 = K[R|t baseline]; valid: an inlier in front of camera
    1 with finite coordinates."""
    dev = resolve_device(device)
    imL, imR = _load_pair(folder_or_pair, dev)
    K = _camera(camera_matrix, dev)
    g = _geometry(imL, imR, K, seed, pipeline_cfg, _no_mark)
    P1 = K @ torch.eye(3, 4, dtype=K.dtype, device=dev)
    P2 = K @ torch.cat([g.R, (g.t * baseline)[:, None]], dim=1)
    pts3d = G.triangulate_to_3d(P1, P2, g.pts1, g.pts2)
    good = g.eres.inlier_mask & (pts3d[:, 2] > 0) & torch.isfinite(pts3d).all(-1)
    return {"points": _numpy(pts3d), "valid": _numpy(good), "num_points": int(good.sum()),
            "geometry": _geometry_dict(g, baseline)}
