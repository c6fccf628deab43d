"""Command-line interface of the port.

  match        pair folder -> keypoints and ratio-test matches (.npz);
               --learned: the XFeat net's mutual matches
  geometry     pair folder -> E, R, unit T (F by LMedS, E by 5-point RANSAC);
               --learned: from the XFeat net's LK-refined matches
  rectify      pair folder -> rectified pair, epiline overlays, rectification.npz
  triangulate  pair folder -> sparse PLY of the E inliers
  disparity    rectified pair folder -> disparity.npy (+ disparity_jet.png)
  reconstruct  pair folder -> dense PLY: geometry, rectification, SGBM and
               reprojection; with --rectification RECT.npz the pair is taken
               as rectified already and Q comes from the file

A pair folder holds img1.jpg (left) and img2.jpg (right). --calibration
reads K (and, for rectify --undistort, dist) from an .npz; without it the
reference's fallback K is used. --learned runs the net with the shipped
weights (models/weights/xfeat_v4.npz), or with --model W.npz, an export of
another reference checkpoint (tests/test_torch_xfeat.py). Every verb runs on
--device (default cuda). The reference's --cache, --viewer and --metrics are
not ported yet (ROADMAP A.15) and are refused with exit code 2.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from stereo_reconstruction_cv_tpu_torch.models.checkpoint import CheckpointFormatError


def _load_K(args):
    if args.calibration:
        with np.load(args.calibration) as z:
            return z["K"]
    return None


def _load_dist(args):
    if args.calibration:
        with np.load(args.calibration) as z:
            if "dist" in z:
                return z["dist"]
    return None


def _refuse_viewer(args) -> None:
    if args.viewer:
        raise NotImplementedError("the HTML viewer (--viewer) is not ported yet (ROADMAP A.15)")


def _method(args) -> str:
    return "learned" if args.learned else "classical"


def cmd_match(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    out = stages.detect_match(args.pair, contrast_threshold=args.contrast_threshold,
                              method=_method(args), model_checkpoint=args.model,
                              device=args.device)
    print(f"keypoints: left={out['num_keypoints'][0]} right={out['num_keypoints'][1]}")
    print(f"good matches (ratio 0.75): {out['num_good_matches']}")
    if args.save:
        np.savez(args.save, **{k: v for k, v in out.items() if isinstance(v, np.ndarray)})
        print(f"saved matches to {args.save}")
    return 0


def cmd_geometry(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    out = stages.estimate_geometry(args.pair, baseline=args.baseline, camera_matrix=_load_K(args),
                                   method=_method(args), checkpoint=args.model, cache=args.cache,
                                   device=args.device)
    for k in ("Essential Matrix", "Rotation Matrix", "Translation Vector"):
        print(f"\n== {k} ==\n{out[k]}")
    print(f"\nmatches: {out['num_matches']}  F inliers: {out['num_inliers_F']}  "
          f"E inliers: {out['num_inliers_E']}")
    return 0


def cmd_rectify(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.io.image import save_image
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    out = stages.rectify_pair(args.pair, baseline=args.baseline, camera_matrix=_load_K(args),
                              dist=_load_dist(args) if args.undistort else None,
                              cache=args.cache, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    for name in ("left_rectified", "right_rectified"):
        save_image(os.path.join(args.outdir, name + ".jpg"), out[name].cpu().numpy())
    for key in ("Left Epilines (before)", "Right Points (before)",
                "Left Epilines (after)", "Right Points (after)"):
        fname = key.lower().replace(" ", "_").replace("(", "").replace(")", "") + ".png"
        save_image(os.path.join(args.outdir, fname), out[key])
    np.savez(os.path.join(args.outdir, "rectification.npz"),
             **{k: out[k] for k in ("R1", "R2", "P1", "P2", "Q")})
    print("Q:\n", out["Q"])
    print(f"epiline mean |slope| after rectification: {out['epiline_mean_abs_slope']:.5f}")
    print(f"artifacts written to {args.outdir}/")
    return 0


def cmd_triangulate(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.io.ply import write_ply
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    _refuse_viewer(args)
    out = stages.triangulate_sparse(args.pair, camera_matrix=_load_K(args),
                                    baseline=args.baseline, device=args.device)
    n = write_ply(args.output, out["points"][out["valid"]])
    print(f"triangulated {n} points -> {args.output}")
    return 0


def cmd_disparity(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.io.image import load_stereo_pair, save_image
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages
    from stereo_reconstruction_cv_tpu_torch.utils.draw import colormap_jet

    imL, imR = load_stereo_pair(args.pair)
    disp = stages.disparity(imL, imR, ndisp=args.ndisp, mindis=args.mindisp,
                            device=args.device).cpu().numpy()
    os.makedirs(args.outdir, exist_ok=True)
    np.save(os.path.join(args.outdir, "disparity.npy"), disp)
    save_image(os.path.join(args.outdir, "disparity_jet.png"), colormap_jet(disp))
    print(f"disparity range [{disp.min():.2f}, {disp.max():.2f}] -> {args.outdir}/")
    return 0


def cmd_reconstruct(args) -> int:
    from stereo_reconstruction_cv_tpu_torch import convert
    from stereo_reconstruction_cv_tpu_torch.io.image import load_rgb, load_stereo_pair
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    _refuse_viewer(args)
    if args.rectification:
        if args.cache:
            raise NotImplementedError("the stage cache (--cache) is not ported yet (ROADMAP A.15)")
        Q = convert.from_reference_rectification(args.rectification).Q
        imL, imR = load_stereo_pair(args.pair)
    else:
        rect = stages.rectify_pair(args.pair, baseline=args.baseline, camera_matrix=_load_K(args),
                                   with_visualizations=False, cache=args.cache, device=args.device)
        imL, imR, Q = rect["left_rectified"], rect["right_rectified"], rect["Q"]
    disp = stages.disparity(imL, imR, ndisp=args.ndisp, mindis=args.mindisp, device=args.device)
    pts = stages.reconstruct(disp, Q, device=args.device)
    rgb = load_rgb(os.path.join(args.pair, "img1.jpg"))
    colors = rgb if rgb.shape[:2] == tuple(disp.shape) else None
    n = stages.export_point_cloud(args.output, pts, disp, colors, device=args.device)
    print(f"wrote {n} points -> {args.output}")
    return 0


def _validate_reference_ranges(args) -> None:
    """The reference GUI's input checks: a bad value warns and falls back to
    the default (baseline > 0, else 0.1; contrast threshold in [0, 0.1],
    else 0.04)."""
    if getattr(args, "baseline", None) is not None and args.baseline <= 0:
        print(f"Invalid baseline value: {args.baseline}. Baseline must be positive. "
              "Using default (0.1).", file=sys.stderr)
        args.baseline = 0.1
    ct = getattr(args, "contrast_threshold", None)
    if ct is not None and not (0 <= ct <= 0.1):
        print(f"Invalid contrast threshold: {ct}. Contrast threshold must be between 0 "
              "and 0.1. Using default (0.04).", file=sys.stderr)
        args.contrast_threshold = 0.04


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stereo-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metrics", default=None, metavar="OUT.json",
                   help="per-stage metrics (not ported yet: ROADMAP A.15)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def verb(name, fn, help_, rig=True, cache=False, learned=False, viewer=False):
        v = sub.add_parser(name, help=help_)
        v.add_argument("pair")
        if rig:
            v.add_argument("--baseline", type=float, default=0.1)
            v.add_argument("--calibration", default=None, help=".npz with K (and dist)")
        if cache:
            v.add_argument("--cache", nargs="?", const=".stereo_tpu_cache", default=None,
                           metavar="DIR", help="stage cache (not ported yet: ROADMAP A.15)")
        if learned:
            v.add_argument("--learned", action="store_true", help="XFeat-style matcher")
            v.add_argument("--model", default=None, metavar="W.npz",
                           help="weights for --learned, an .npz export (default: shipped v4)")
        if viewer:
            v.add_argument("--viewer", default=None,
                           help="HTML viewer (not ported yet: ROADMAP A.15)")
        v.add_argument("--device", default="cuda", help="torch device (default: cuda)")
        v.set_defaults(fn=fn)
        return v

    m = verb("match", cmd_match, "feature detection and ratio-test matching", rig=False,
             learned=True)
    m.add_argument("--contrast-threshold", type=float, default=0.04)
    m.add_argument("--save", default=None)

    verb("geometry", cmd_geometry, "E, R, T of a raw pair", cache=True, learned=True)

    r = verb("rectify", cmd_rectify, "two-view rectification", cache=True)
    r.add_argument("--undistort", action="store_true",
                   help="apply the calibration's distortion in the remap")
    r.add_argument("--outdir", default="rectify_out")

    t = verb("triangulate", cmd_triangulate, "sparse reconstruction", viewer=True)
    t.add_argument("--output", default="sparse_cloud.ply")

    d = verb("disparity", cmd_disparity, "dense disparity of a rectified pair", rig=False)
    d.add_argument("--ndisp", type=int, default=16)
    d.add_argument("--mindisp", type=int, default=0)
    d.add_argument("--outdir", default="disparity_out")

    rc = verb("reconstruct", cmd_reconstruct, "pair -> dense point cloud", cache=True, viewer=True)
    rc.add_argument("--rectification", default=None,
                    help="rectification.npz with Q; the pair is then taken as rectified")
    rc.add_argument("--ndisp", type=int, default=64)
    rc.add_argument("--mindisp", type=int, default=0)
    rc.add_argument("--output", default="point_cloud.ply")

    args = p.parse_args(argv)
    _validate_reference_ranges(args)
    try:
        if args.metrics:
            raise NotImplementedError("per-stage metrics (--metrics) are not ported yet "
                                      "(ROADMAP A.15)")
        return args.fn(args)
    except (NotImplementedError, CheckpointFormatError) as e:
        print(e, file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
