"""Stage functions: chessboards -> calibration; a raw pair -> two-view
geometry -> rectification -> disparity -> 3D points -> point-cloud file.

Ports of ``stereo_reconstruction_cv_tpu/pipeline/stages.py``: ``calibrate``
and ``calibrate_stereo_rig`` (chessboard folders), ``detect_match``,
``estimate_geometry``, ``rectify_pair``, ``triangulate_sparse`` (the sparse
path; ``detect_match`` and ``estimate_geometry`` also with
``method="learned"``, the XFeat-style net of ``models/xfeat.py`` with its
shipped weights) and ``disparity``, ``reconstruct``, ``export_point_cloud``
(PLY, or the HTML viewer for a .html path; the dense path). Each takes an
explicit ``device`` and runs every step there; asking for CUDA where none is
available is an error, never a quiet move to the CPU. Images and disparity
maps stay on the device as tensors; the calibration and sparse stages return
the reference's dicts of numpy arrays (matrices, correspondences, counts),
and only the masked points cross to the host for the file.

Every public stage records its wall time (its device synchronised at the
end) and its scalar results into ``utils.profiling.METRICS`` (``cli
--metrics``). ``calibrate``, ``estimate_geometry``, ``rectify_pair`` and
``disparity`` take a ``pipeline.cache.StageCache``: a hit returns what the
miss computed, keyed as the reference keys it.

Geometry runs in float64 (correspondences, F, E, pose, rectification,
triangulation), the image stages in float32. Random draws come from a
``torch.Generator`` on the device seeded with ``seed`` (F, then E), and the
rectification's verification uses ``seed + 1``, as the reference splits its
keys; the streams differ from JAX's, so results agree with the reference's
within the robust estimators' spread, not bit for bit.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import math
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch import config as C
from stereo_reconstruction_cv_tpu_torch.calib import chessboard as CB
from stereo_reconstruction_cv_tpu_torch.calib import stereo as SCAL
from stereo_reconstruction_cv_tpu_torch.calib import zhang as Z
from stereo_reconstruction_cv_tpu_torch.errors import error_dict
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
from stereo_reconstruction_cv_tpu_torch.pipeline.cache import file_fingerprint
from stereo_reconstruction_cv_tpu_torch.utils.profiling import METRICS, stage_timer


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


def _observed(stage: str):
    """Record a stage's wall time (its device synchronised at exit) into
    METRICS, and the scalars of a dict it returns as '<stage>/<key>' (a
    tuple of numbers as '<stage>/<key>_<i>')."""

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            with stage_timer(stage, device=bound.arguments.get("device")):
                out = fn(*args, **kwargs)
            if isinstance(out, dict):
                for k, v in out.items():
                    if isinstance(v, (bool, int, float)):
                        METRICS.record(f"{stage}/{k}", v)
                    elif isinstance(v, tuple) and all(isinstance(x, (int, float)) for x in v):
                        for i, x in enumerate(v):
                            METRICS.record(f"{stage}/{k}_{i}", x)
            return out

        return wrapper

    return deco


def _content_hash(img) -> str:
    """sha1 of an image's bytes (a tensor's host copy), as the reference
    hashes its arrays."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return hashlib.sha1(np.ascontiguousarray(img)).hexdigest()


def _pair_cache_key(folder_or_pair, **params) -> Dict:
    """Cache key of a pair stage: the fingerprints of a folder's img1.jpg and
    img2.jpg, or the content hashes of an (imL, imR) pair, and every
    parameter that changes the stage's output."""
    if isinstance(folder_or_pair, str):
        fps = []
        for name in ("img1.jpg", "img2.jpg"):
            path = os.path.join(folder_or_pair, name)
            fps.append(file_fingerprint(path) if os.path.exists(path) else name)
        key = {"pair": fps}
    else:
        key = {"pair": [_content_hash(x) for x in folder_or_pair]}
    key.update(params)
    return key


@_observed("disparity")
def disparity(imgL, imgR, ndisp: int = 16, mindis: int = 0, cache=None,
              device="cuda") -> torch.Tensor:
    """compute_disparity_map parity (cell 10): float map, invalid and
    non-positive pixels zeroed. Images: (H, W) or (H, W, 3) uint8. cache: a
    StageCache keyed on the images' content and the SGBM parameters."""
    dev = resolve_device(device)
    ckey = None
    if cache is not None:
        ckey = _pair_cache_key((imgL, imgR), ndisp=ndisp, mindis=mindis)
        hit = cache.load("disparity", ckey)
        if hit is not None:
            return _on(hit["disparity"], dev)
    disp = DP.compute_disparity_map(_on(imgL, dev), _on(imgR, dev), ndisp, mindis)
    if cache is not None:
        cache.save("disparity", ckey, {"disparity": _numpy(disp)})
    return disp


@_observed("reconstruct")
def reconstruct(disparity_map, Q, device="cuda") -> torch.Tensor:
    """reconstruct_3D parity (cell 11): (H, W, 3) float32 point image."""
    dev = resolve_device(device)
    return G.reproject_image_to_3d(_on(disparity_map, dev, torch.float32).contiguous(),
                                   _on(Q, "cpu", torch.float32))


@_observed("export_point_cloud")
def export_point_cloud(path: str, points_3d, disparity_map, colors=None,
                       device="cuda") -> int:
    """Write the valid points (finite, disparity > 0): the standalone HTML
    viewer for a .html path, else PLY. Returns their number."""
    dev = resolve_device(device)
    pts = _on(points_3d, dev)
    mask = G.valid_point_mask(pts, _on(disparity_map, dev))
    p = pts[mask].cpu().numpy()
    c = None
    if colors is not None:
        c = _on(colors, dev)[mask].cpu().numpy()
    if path.endswith(".html"):
        from stereo_reconstruction_cv_tpu_torch.io import viewer as VW

        return VW.write_html_viewer(path, p, c)
    return PLY.write_ply(path, p, c)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _calib_results_tuple(out: Dict):
    """The reference's return shape (gui.py:75)."""
    return [
        ("Camera Matrix", out["K"]),
        ("Distortion Parameters", out["dist"]),
        ("Reprojection Error", float(out["mean_error"])),
    ]


@_observed("calibrate")
def calibrate(folder: str, chessboard: Tuple[int, int] = (9, 7), cache=None,
              save_corner_annotations: bool = False,
              annotation_dir: str = "chessboard_corners", device="cuda") -> Dict:
    """cam_calib parity (gui.py:27-75): find the chessboard in each *.jpg of
    `folder`, then Zhang + LM over the views where it was found. Returns K,
    dist, rvecs, tvecs, rms, mean_error (the reference's metric),
    per_view_error and num_images as numpy and numbers, and "results" in
    the reference's format; an error dict for no images or fewer than 3
    boards. cache: a StageCache keyed on the files' fingerprints.
    save_corner_annotations writes each found board's corners drawn on its
    image into annotation_dir."""
    files = IO.glob_calibration_images(folder)
    if not files:
        return error_dict(f"no *.jpg calibration images in {folder!r}", "data")
    dev = resolve_device(device)
    key = {"files": [file_fingerprint(f) for f in files]}
    if cache is not None:
        hit = cache.load("calibrate", key)
        if hit is not None:
            out = dict(hit)
            # scalars come back as 0-d arrays
            for k in ("rms", "mean_error"):
                out[k] = float(out[k])
            out["num_images"] = int(out["num_images"])
            out["results"] = _calib_results_tuple(out)
            return out
    cols, rows = chessboard
    pts, size = [], None
    for f in files:
        gray = IO.load_gray(f)
        found, corners = CB.find_chessboard_corners(_on(gray, dev), cols, rows)
        if not found:
            continue
        pts.append(corners)
        size = size or (gray.shape[1], gray.shape[0])
        if save_corner_annotations:
            from stereo_reconstruction_cv_tpu_torch.utils import draw as DR

            os.makedirs(annotation_dir, exist_ok=True)
            IO.save_image(os.path.join(annotation_dir, os.path.basename(f)),
                          DR.draw_keypoints(gray, _numpy(corners)))
    if len(pts) < 3:
        return error_dict(f"chessboard found in only {len(pts)} images", "calibration")
    res = Z.calibrate_camera(Z.build_object_points(cols, rows, device=dev), torch.stack(pts), size)
    out = {
        "K": _numpy(res.K),
        "dist": _numpy(res.dist),
        "rvecs": _numpy(res.rvecs),
        "tvecs": _numpy(res.tvecs),
        "rms": float(res.rms),
        "mean_error": float(res.mean_error),
        "per_view_error": _numpy(res.per_view_error),
        "num_images": len(pts),
    }
    if cache is not None:
        cache.save("calibrate", key, out)
    out["results"] = _calib_results_tuple(out)
    return out


@_observed("calibrate_stereo_rig")
def calibrate_stereo_rig(folder1: str, folder2: str, chessboard: Tuple[int, int] = (9, 7),
                         device="cuda") -> Dict:
    """Two-camera rig calibration from synchronised chessboard folders (the
    images paired by sorted name): the views where both cameras find the
    board calibrate K1, dist1, K2, dist2 and the rig's R, T jointly.
    Returns them as numpy with rms and num_pairs; an error dict for unequal
    or empty folders or fewer than 3 pairs."""
    f1 = IO.glob_calibration_images(folder1)
    f2 = IO.glob_calibration_images(folder2)
    if not f1 or not f2 or len(f1) != len(f2):
        return error_dict(f"need matching image counts ({len(f1)} vs {len(f2)})", "data")
    dev = resolve_device(device)
    cols, rows = chessboard
    p1, p2, size = [], [], None
    for a, b in zip(f1, f2):
        g1, g2 = IO.load_gray(a), IO.load_gray(b)
        size = (g1.shape[1], g1.shape[0])
        ok1, c1 = CB.find_chessboard_corners(_on(g1, dev), cols, rows)
        ok2, c2 = CB.find_chessboard_corners(_on(g2, dev), cols, rows)
        if ok1 and ok2:
            p1.append(c1)
            p2.append(c2)
    if len(p1) < 3:
        return error_dict(f"board found in both views for only {len(p1)} pairs", "calibration")
    res = SCAL.calibrate_stereo(Z.build_object_points(cols, rows, device=dev), torch.stack(p1),
                                torch.stack(p2), size)
    out = {k: _numpy(getattr(res, k)) for k in ("K1", "dist1", "K2", "dist2", "R", "T")}
    out.update(rms=float(res.rms), num_pairs=len(p1))
    return out


# ---------------------------------------------------------------------------
# The sparse path
# ---------------------------------------------------------------------------

def default_camera_matrix(cfg: C.RectifyConfig = C.DEFAULT.rectify) -> np.ndarray:
    """The reference's fallback K when no calibration is given."""
    return np.array([[cfg.default_fx, 0, cfg.default_cx], [0, cfg.default_fy, cfg.default_cy],
                     [0, 0, 1.0]])


def _check_method(method: str) -> None:
    if method not in ("classical", "learned"):
        raise ValueError(f"unknown matching method {method!r}")


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


@_observed("detect_match")
def detect_match(folder_or_pair, contrast_threshold: float = 0.04, ratio: float = 0.75,
                 max_keypoints: int = 2048, method: str = "classical",
                 model_checkpoint: Optional[str] = None, with_visualizations: bool = False,
                 device="cuda") -> Dict:
    """Keypoints, descriptors and matches, as numpy arrays and counts:
    SIFT with kNN matching and Lowe's ratio test (0.75 on this inspection
    path), or with method="learned" the XFeat net (model_checkpoint, an .npz
    export; None: the shipped weights) with mutual nearest neighbours of
    cosine similarity >= 0.5."""
    _check_method(method)
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


@_observed("estimate_geometry")
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
    may synchronise the device). cache: a StageCache keyed on the pair, K,
    seed, method, checkpoint and baseline."""
    _check_method(method)
    dev = resolve_device(device)
    ckey = None
    if cache is not None:
        K = default_camera_matrix() if camera_matrix is None else np.asarray(camera_matrix)
        ckey = _pair_cache_key(folder_or_pair, K=K.tolist(), seed=seed, method=method,
                               checkpoint=checkpoint, baseline=baseline)
        hit = cache.load("geometry", ckey)
        if hit is not None:
            return _geometry_from_cache(hit)
    imL, imR = _load_pair(folder_or_pair, dev)
    g = _geometry(imL, imR, _camera(camera_matrix, dev), seed, pipeline_cfg, on_stage or _no_mark,
                  method, checkpoint)
    out = _geometry_dict(g, baseline)
    if cache is not None:
        cache.save("geometry", ckey, out)
    return out


def _geometry_from_cache(hit: Dict) -> Dict:
    """A cached geometry dict with its scalars back to Python numbers."""
    out = dict(hit)
    out["baseline"] = float(out["baseline"])
    for k in ("num_matches", "num_inliers_F", "num_inliers_E"):
        out[k] = int(out[k])
    return out


@_observed("rectify_pair")
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
    coefficients) undistorts in the remap. cache: a StageCache keyed on the
    pair, K, dist, alpha, seed, baseline and the visualisation flag; a hit
    puts the rectified images back on the device."""
    dev = resolve_device(device)
    ckey = None
    if cache is not None:
        K = default_camera_matrix() if camera_matrix is None else np.asarray(camera_matrix)
        ckey = _pair_cache_key(folder_or_pair, K=K.tolist(),
                               dist=None if dist is None else np.asarray(dist).tolist(),
                               alpha=alpha, seed=seed, baseline=baseline,
                               vis=bool(with_visualizations))
        hit = cache.load("rectify", ckey)
        if hit is not None:
            out = {k: v for k, v in hit.items() if not k.startswith("geo ")}
            out["geometry"] = _geometry_from_cache(
                {k[len("geo "):]: v for k, v in hit.items() if k.startswith("geo ")})
            out["epiline_mean_abs_slope"] = float(out["epiline_mean_abs_slope"])
            for k in ("left_rectified", "right_rectified"):
                out[k] = _on(out[k], dev)
            return out
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
    if cache is not None:
        flat = {k: _numpy(v) if isinstance(v, torch.Tensor) else v
                for k, v in out.items() if k != "geometry"}
        flat.update({f"geo {k}": v for k, v in geo.items()})
        cache.save("rectify", ckey, flat)
    return out


@_observed("triangulate_sparse")
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
