"""Command-line interface of the port: the dense verbs.

  disparity    pair folder -> disparity.npy (+ disparity_jet.png)
  reconstruct  pair folder + rectification.npz -> PLY point cloud

A pair folder holds img1.jpg (left) and img2.jpg (right), already rectified;
the rectification comes from the reference's ``stereo-tpu rectify`` verb
(``rectification.npz`` with Q). Runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


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

    if not args.rectification:
        print(
            "reconstruct needs --rectification RECT.npz (Q from the reference's "
            "`stereo-tpu rectify`): estimating the geometry from the pair comes "
            "with the sparse path, which is not ported yet",
            file=sys.stderr,
        )
        return 2
    Q = convert.from_reference_rectification(args.rectification).Q
    imL, imR = load_stereo_pair(args.pair)
    disp = stages.disparity(imL, imR, ndisp=args.ndisp, mindis=args.mindisp,
                            device=args.device)
    pts = stages.reconstruct(disp, Q, device=args.device)
    colors = None
    p1 = os.path.join(args.pair, "img1.jpg")
    rgb = load_rgb(p1)
    if rgb.shape[:2] == tuple(disp.shape):
        colors = rgb
    n = stages.export_point_cloud(args.output, pts, disp, colors, device=args.device)
    print(f"wrote {n} points -> {args.output}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stereo-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("disparity", help="dense disparity of a rectified pair")
    d.add_argument("pair")
    d.add_argument("--ndisp", type=int, default=16)
    d.add_argument("--mindisp", type=int, default=0)
    d.add_argument("--outdir", default="disparity_out")
    d.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    d.set_defaults(fn=cmd_disparity)

    rc = sub.add_parser("reconstruct", help="rectified pair -> dense point cloud")
    rc.add_argument("pair")
    rc.add_argument("--rectification", default=None,
                    help="rectification.npz with Q (required)")
    rc.add_argument("--ndisp", type=int, default=64)
    rc.add_argument("--mindisp", type=int, default=0)
    rc.add_argument("--output", default="point_cloud.ply")
    rc.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    rc.set_defaults(fn=cmd_reconstruct)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
