"""Command-line interface of the port.

  calibrate    chessboard folder (*.jpg) -> K, dist, reprojection error;
               --save OUT.npz keeps K, dist, rvecs, tvecs
  stereo-calibrate  two synchronised chessboard folders -> K1, dist1, K2,
               dist2 and the rig's R, T
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
  report       pair folder -> one HTML page of every stage's images and
               numbers, the point-cloud viewer and the stage metrics
  view         PLY -> standalone HTML point-cloud viewer
  bench        the benchmark suite: one JSON line per BASELINE metric of
               CONFIGS (default 2 1 4 3 5, the headline again last); exits 1
               if a config failed. --decoder names config 5's JPEG decoder,
               --scale shrinks every frame (a quick run on the CPU)
  train-features  image folders (*.jpg) -> self-supervised XFeat training
               (random crops, homographic pairs, warmup-cosine Adam);
               --output W writes W.npz, which --model serves. Without a
               folder: the reference's calibration boards and pairs d1-d3
               under reference/ (absent from the repository: exits 1)

A pair folder holds img1.jpg (left) and img2.jpg (right). --calibration
reads K (and, for rectify --undistort, dist) from an .npz; without it the
reference's fallback K is used. --learned runs the net with the shipped
weights (models/weights/xfeat_v4.npz), or with --model W.npz, an export of
another reference checkpoint (tests/test_torch_xfeat.py). --cache [DIR]
keeps and reuses stage results (default .stereo_tpu_cache), --viewer
OUT.html also writes the cloud as the HTML viewer, and --metrics OUT.json
(before the verb) writes the stages' times and counts after it. Every verb
but view (a file conversion on the host) runs on --device (default cuda).
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


def _stage_cache(args):
    """--cache [DIR] -> a StageCache (None without the flag)."""
    if not getattr(args, "cache", None):
        return None
    from stereo_reconstruction_cv_tpu_torch.pipeline.cache import StageCache

    return StageCache(args.cache)


def _print_named(results) -> None:
    for name, value in results:
        print(f"\n== {name} ==")
        print(value)


def cmd_calibrate(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    out = stages.calibrate(args.folder, tuple(args.chessboard), device=args.device)
    if "error" in out:
        print(out["error"], file=sys.stderr)
        return 1
    _print_named(out["results"])
    print(f"\nRMS: {out['rms']:.4f}  images used: {out['num_images']}")
    if args.save:
        np.savez(args.save, K=out["K"], dist=out["dist"], rvecs=out["rvecs"], tvecs=out["tvecs"])
        print(f"saved calibration to {args.save}")
    return 0


def cmd_stereo_calibrate(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    out = stages.calibrate_stereo_rig(args.folder1, args.folder2, tuple(args.chessboard),
                                      device=args.device)
    if "error" in out:
        print(out["error"], file=sys.stderr)
        return 1
    keys = ("K1", "dist1", "K2", "dist2", "R", "T")
    for k in keys:
        print(f"\n== {k} ==\n{out[k]}")
    print(f"\nrms: {out['rms']:.4f}  pairs used: {out['num_pairs']}")
    if args.save:
        np.savez(args.save, **{k: out[k] for k in keys})
        print(f"saved rig calibration to {args.save}")
    return 0


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
                                   method=_method(args), checkpoint=args.model,
                                   cache=_stage_cache(args), device=args.device)
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
                              cache=_stage_cache(args), device=args.device)
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

    out = stages.triangulate_sparse(args.pair, camera_matrix=_load_K(args),
                                    baseline=args.baseline, device=args.device)
    pts = out["points"][out["valid"]]
    n = write_ply(args.output, pts)
    print(f"triangulated {n} points -> {args.output}")
    if args.viewer:
        from stereo_reconstruction_cv_tpu_torch.io.viewer import write_html_viewer

        write_html_viewer(args.viewer, pts)
        print(f"viewer -> {args.viewer}")
    return 0


def cmd_disparity(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.io.image import load_stereo_pair, save_image
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages
    from stereo_reconstruction_cv_tpu_torch.utils.draw import colormap_jet

    imL, imR = load_stereo_pair(args.pair)
    disp = stages.disparity(imL, imR, ndisp=args.ndisp, mindis=args.mindisp,
                            cache=_stage_cache(args), device=args.device).cpu().numpy()
    os.makedirs(args.outdir, exist_ok=True)
    np.save(os.path.join(args.outdir, "disparity.npy"), disp)
    save_image(os.path.join(args.outdir, "disparity_jet.png"), colormap_jet(disp))
    print(f"disparity range [{disp.min():.2f}, {disp.max():.2f}] -> {args.outdir}/")
    return 0


def cmd_reconstruct(args) -> int:
    from stereo_reconstruction_cv_tpu_torch import convert
    from stereo_reconstruction_cv_tpu_torch.io.image import load_rgb, load_stereo_pair
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages

    cache = _stage_cache(args)
    if args.rectification:
        Q = convert.from_reference_rectification(args.rectification).Q
        imL, imR = load_stereo_pair(args.pair)
    else:
        rect = stages.rectify_pair(args.pair, baseline=args.baseline, camera_matrix=_load_K(args),
                                   with_visualizations=False, cache=cache, device=args.device)
        imL, imR, Q = rect["left_rectified"], rect["right_rectified"], rect["Q"]
    disp = stages.disparity(imL, imR, ndisp=args.ndisp, mindis=args.mindisp, cache=cache,
                            device=args.device)
    pts = stages.reconstruct(disp, Q, device=args.device)
    rgb = load_rgb(os.path.join(args.pair, "img1.jpg"))
    colors = rgb if rgb.shape[:2] == tuple(disp.shape) else None
    n = stages.export_point_cloud(args.output, pts, disp, colors, device=args.device)
    print(f"wrote {n} points -> {args.output}")
    if args.viewer:
        stages.export_point_cloud(args.viewer, pts, disp, colors, device=args.device)
        print(f"viewer -> {args.viewer}")
    return 0


def cmd_report(args) -> int:
    """Every stage's images and numbers on one self-contained HTML page."""
    import tempfile

    from stereo_reconstruction_cv_tpu_torch.io.report import ReportBuilder
    from stereo_reconstruction_cv_tpu_torch.pipeline import stages
    from stereo_reconstruction_cv_tpu_torch.utils.draw import colormap_jet
    from stereo_reconstruction_cv_tpu_torch.utils.profiling import METRICS

    rb = ReportBuilder(f"stereo-tpu report — {args.pair}")
    rb.section("Feature detection & matching (Tab 3)")
    m = stages.detect_match(args.pair, with_visualizations=True, device=args.device)
    rb.text(f"keypoints: left={m['num_keypoints'][0]} right={m['num_keypoints'][1]}; "
            f"good matches (ratio 0.75): {m['num_good_matches']}")
    rb.images([(k, m[k]) for k in ("Left Keypoints", "Right Keypoints", "Good Matches")])

    rb.section("Rectification + geometry (Tabs 2/4)")
    # rectify_pair estimates the geometry and returns it: one robust pass
    # serves both sections
    r = stages.rectify_pair(args.pair, baseline=args.baseline, camera_matrix=_load_K(args),
                            device=args.device)
    g = r["geometry"]
    rb.pre("Essential Matrix:\n%s\n\nRotation Matrix:\n%s\n\nTranslation Vector:\n%s\n\n"
           "matches %d  F inliers %d  E inliers %d"
           % (g["Essential Matrix"], g["Rotation Matrix"], g["Translation Vector"].ravel(),
              g["num_matches"], g["num_inliers_F"], g["num_inliers_E"]))
    rb.pre("Q:\n%s\nepiline mean |slope| after rectification: %.5f"
           % (r["Q"], r["epiline_mean_abs_slope"]))
    rb.images([(k, r[k]) for k in ("Left Epilines (before)", "Right Points (before)",
                                   "Left Epilines (after)", "Right Points (after)")])

    rb.section("Dense disparity (Tab 6)")
    disp = stages.disparity(r["left_rectified"], r["right_rectified"], ndisp=args.ndisp,
                            device=args.device)
    d = disp.cpu().numpy()
    rb.text(f"disparity range [{float(d.min()):.2f}, {float(d.max()):.2f}] "
            f"at {args.ndisp} disparities")
    rb.images([("Disparity (jet)", colormap_jet(d))])

    rb.section("3D reconstruction (point cloud)")
    pts = stages.reconstruct(disp, r["Q"], device=args.device)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "cloud.html")
        n = stages.export_point_cloud(path, pts, disp, device=args.device)
        rb.text(f"{n} valid points — drag to orbit, wheel to zoom")
        rb.viewer(path)

    rb.section("Pipeline metrics")
    summary = METRICS.summary()
    rb.pre("\n".join(f"{k}: {summary[k]:.4f}" if isinstance(summary[k], float)
                      else f"{k}: {summary[k]}" for k in sorted(summary)))
    rb.write(args.output)
    print(f"report -> {args.output}")
    return 0


def cmd_view(args) -> int:
    """PLY -> standalone interactive HTML viewer."""
    from stereo_reconstruction_cv_tpu_torch.io.ply import read_ply
    from stereo_reconstruction_cv_tpu_torch.io.viewer import write_html_viewer

    pts, colors = read_ply(args.cloud)
    n = write_html_viewer(args.output, pts, colors, max_points=args.max_points)
    print(f"viewer with {n} points -> {args.output}")
    return 0


def cmd_bench(args) -> int:
    from stereo_reconstruction_cv_tpu_torch import benchmarks

    return benchmarks.main(args.configs, device=args.device, decoder=args.decoder,
                           scale=args.scale)


def cmd_train_features(args) -> int:
    from stereo_reconstruction_cv_tpu_torch.models import xfeat_train as XT

    try:
        XT.train(folders=args.folder or list(XT.DEFAULT_FOLDERS), steps=args.steps,
                 batch=args.batch, crop=args.size, lr=args.lr, output=args.output,
                 max_images=args.max_images, device=args.device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
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
                   help="write the stages' times and counts to this JSON file after the verb")
    sub = p.add_subparsers(dest="cmd", required=True)

    def verb(name, fn, help_, rig=True, cache=False, learned=False, viewer=False,
             inputs=("pair",)):
        v = sub.add_parser(name, help=help_)
        for name_ in inputs:
            v.add_argument(name_)
        if rig:
            v.add_argument("--baseline", type=float, default=0.1)
            v.add_argument("--calibration", default=None, help=".npz with K (and dist)")
        if cache:
            v.add_argument("--cache", nargs="?", const=".stereo_tpu_cache", default=None,
                           metavar="DIR", help="keep and reuse stage results (StageCache)")
        if learned:
            v.add_argument("--learned", action="store_true", help="XFeat-style matcher")
            v.add_argument("--model", default=None, metavar="W.npz",
                           help="weights for --learned, an .npz export (default: shipped v4)")
        if viewer:
            v.add_argument("--viewer", default=None, metavar="OUT.html",
                           help="also write an HTML viewer")
        v.add_argument("--device", default="cuda", help="torch device (default: cuda)")
        v.set_defaults(fn=fn)
        return v

    for name, fn, help_, inputs in (
            ("calibrate", cmd_calibrate, "chessboard camera calibration", ("folder",)),
            ("stereo-calibrate", cmd_stereo_calibrate, "two-camera rig calibration",
             ("folder1", "folder2"))):
        c = verb(name, fn, help_, rig=False, inputs=inputs)
        c.add_argument("--chessboard", type=int, nargs=2, default=[9, 7], metavar=("COLS", "ROWS"))
        c.add_argument("--save", default=None, metavar="OUT.npz")

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

    d = verb("disparity", cmd_disparity, "dense disparity of a rectified pair", rig=False,
             cache=True)
    d.add_argument("--ndisp", type=int, default=16)
    d.add_argument("--mindisp", type=int, default=0)
    d.add_argument("--outdir", default="disparity_out")

    rc = verb("reconstruct", cmd_reconstruct, "pair -> dense point cloud", cache=True, viewer=True)
    rc.add_argument("--rectification", default=None,
                    help="rectification.npz with Q; the pair is then taken as rectified")
    rc.add_argument("--ndisp", type=int, default=64)
    rc.add_argument("--mindisp", type=int, default=0)
    rc.add_argument("--output", default="point_cloud.ply")

    rp = verb("report", cmd_report, "full-pipeline HTML report")
    rp.add_argument("--ndisp", type=int, default=64)
    rp.add_argument("--output", default="stereo_report.html")

    b = verb("bench", cmd_bench, "the benchmark suite (BASELINE configs 1-5)", rig=False,
             inputs=())
    b.add_argument("configs", nargs="*", type=int, choices=range(1, 6), metavar="CONFIG",
                   help="configs to run, in order (default: 2 1 4 3 5)")
    b.add_argument("--decoder", default="nvjpeg", choices=("libjpeg", "nvjpeg"),
                   help="config 5's JPEG decoder (default: nvjpeg)")
    b.add_argument("--scale", type=float, default=1.0,
                   help="frame sizes times this (default 1: the reference's sizes)")

    tf = verb("train-features", cmd_train_features, "self-supervised XFeat training", rig=False,
              inputs=())
    tf.add_argument("folder", nargs="*",
                    help="image folders (default: the reference's boards and d1-d3 under reference/)")
    tf.add_argument("--steps", type=int, default=5000)
    tf.add_argument("--size", type=int, default=256, help="crop size")
    tf.add_argument("--batch", type=int, default=16)
    tf.add_argument("--lr", type=float, default=2e-3)
    tf.add_argument("--max-images", type=int, default=64)
    tf.add_argument("--output", default="xfeat_ckpt", help="weights file (.npz appended)")

    v = sub.add_parser("view", help="PLY -> standalone HTML viewer")
    v.add_argument("cloud")
    v.add_argument("output", nargs="?", default="cloud_viewer.html")
    v.add_argument("--max-points", type=int, default=2_000_000)
    v.set_defaults(fn=cmd_view)

    args = p.parse_args(argv)
    _validate_reference_ranges(args)
    try:
        rc_ = args.fn(args)
    except (NotImplementedError, CheckpointFormatError) as e:
        print(e, file=sys.stderr)
        return 2
    if args.metrics:
        from stereo_reconstruction_cv_tpu_torch.utils.profiling import METRICS

        with open(args.metrics, "w") as f:
            f.write(METRICS.dump() + "\n")
        print(f"metrics -> {args.metrics}")
    return rc_


if __name__ == "__main__":
    sys.exit(main())
