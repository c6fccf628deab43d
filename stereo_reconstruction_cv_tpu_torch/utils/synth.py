"""Synthetic scenes and calibration boards, rendered on any device.

The data of the port's end-to-end checks and benchmarks (``chip_smoke.py``,
``benchmarks.py``, the tests), made from seeds with no file read:

- ``render_pair``: a stereo pair of a ray-cast scene of textured planes at
  2.5-5 m (``SCENE_PLANES``) for a rig x2 = R x1 + T; ``scene_hit`` gives
  the true depth along any ray;
- ``calibration_set``: views of a 9 x 7 chessboard in ``CALIB_POSES`` poses,
  seen by both cameras of the rig ``SCENE_AXIS``, ``SCENE_DEG``,
  ``SCENE_T`` with distortion ``CALIB_DIST``, with their true corners;
  ``calibrate_set`` detects and calibrates them, timing each stage.

``K_4K`` and ``BASELINE_M`` are the reference's calibration anchor of its 4K
rig and its baseline (``stereo_reconstruction_cv_tpu/benchmarks.py:44-48``);
``rectified_rig`` is the rectified rig of its dense and learned benchmarks.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from stereo_reconstruction_cv_tpu_torch.calib import chessboard as CB
from stereo_reconstruction_cv_tpu_torch.calib import stereo as SCAL
from stereo_reconstruction_cv_tpu_torch.calib import zhang as Z
from stereo_reconstruction_cv_tpu_torch.ops import geometry as G
from stereo_reconstruction_cv_tpu_torch.ops import rectify as RC

SEED = 0
# Reference calibration anchor of the 4K rig and its 140 mm baseline.
K_4K = np.array([[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]])
BASELINE_M = 0.140
# The raw rig of the scene: x2 = R x1 + T, R SCENE_DEG degrees about SCENE_AXIS.
SCENE_AXIS, SCENE_DEG = (0.3, 1.0, 0.2), 1.2
SCENE_T = (-BASELINE_M, 0.004, -0.003)


# The synthetic scene: planes in camera 1's frame (x right, y down,
# z forward, metres), each (centre, normal, half extents along its two in-plane
# axes; None for an unbounded plane). Depths 2.5-5 m, no two parallel, so no
# single homography explains the pair.
SCENE_PLANES = (
    ((0.0, 0.0, 5.0), (0.12, -0.08, -1.0), None),
    ((-0.9, -0.25, 2.9), (0.35, 0.1, -1.0), (1.1, 0.8)),
    ((1.0, 0.35, 3.7), (-0.3, 0.2, -1.0), (1.3, 0.9)),
    ((0.1, 0.9, 4.2), (0.05, 0.6, -1.0), (1.5, 0.6)),
)


def _plane_frames(dtype, device):
    """(centres (P, 3), unit normals (P, 3), in-plane axes (P, 2, 3),
    half extents (P, 2), inf where unbounded)."""
    c = torch.tensor([p[0] for p in SCENE_PLANES], dtype=dtype, device=device)
    n = torch.tensor([p[1] for p in SCENE_PLANES], dtype=dtype, device=device)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device).expand_as(n)
    e1 = torch.linalg.cross(up, n)
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(n, e1)
    ext = torch.tensor([p[2] if p[2] is not None else (math.inf, math.inf) for p in SCENE_PLANES],
                       dtype=dtype, device=device)
    return c, n, torch.stack([e1, e2], dim=1), ext


def scene_hit(origin, dirs):
    """First hit of rays origin + t dirs (dirs (..., 3)) with the scene:
    (t (...,), plane index (...,), in-plane coordinates (..., 2))."""
    c, n, axes, ext = _plane_frames(dirs.dtype, dirs.device)
    o = torch.as_tensor(origin, dtype=dirs.dtype, device=dirs.device)
    denom = dirs @ n.T                                   # (..., P)
    t = ((c - o) * n).sum(-1) / denom                    # (..., P)
    hit = o + t[..., None] * dirs[..., None, :]          # (..., P, 3)
    ab = torch.einsum("...pk,pjk->...pj", hit - c, axes)  # (..., P, 2)
    inside = (ab.abs() <= ext).all(-1) & (t > 0)
    t = torch.where(inside, t, torch.full_like(t, math.inf))
    tmin, idx = t.min(dim=-1)
    ab = torch.gather(ab, -2, idx[..., None, None].expand(*idx.shape, 1, 2))[..., 0, :]
    return tmin, idx, ab


def _hash01(i, j, salt):
    """Uniform [0, 1) per integer lattice point (int64 i, j >= 0), the same
    on every device: 31-bit multiply-xorshift rounds, no overflow."""
    m = 0x7FFFFFFF
    h = (i * 0x2545F491 + j * 0x6C8E9CF5 + salt * 0x1B873593) & m
    for k in (0x5BD1E995, 0x27D4EB2F, 0x165667B1):
        h = ((h ^ (h >> 15)) * k) & m
    h = h ^ (h >> 13)
    return (h & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def _value_noise(a, b, salt):
    """Bilinear value noise at lattice coordinates (a, b) (float64)."""
    a = a + 4096.0
    b = b + 4096.0
    i0, j0 = torch.floor(a), torch.floor(b)
    fa, fb = (a - i0).to(torch.float32), (b - j0).to(torch.float32)
    i0, j0 = i0.to(torch.int64), j0.to(torch.int64)
    v00 = _hash01(i0, j0, salt)
    v10 = _hash01(i0 + 1, j0, salt)
    v01 = _hash01(i0, j0 + 1, salt)
    v11 = _hash01(i0 + 1, j0 + 1, salt)
    return (v00 * (1 - fa) * (1 - fb) + v10 * fa * (1 - fb)
            + v01 * (1 - fa) * fb + v11 * fa * fb)


def render_view(K, R, C, H, W, texel, seed, device):
    """(H, W) uint8 view of the scene from a camera with intrinsics K,
    rotation R (world -> camera) and centre C, point-sampled: textures of
    value noise at lattice pitches texel x (1, 3, 9, 27) metres."""
    dt = torch.float64
    Kt = torch.as_tensor(K, dtype=dt, device=device)
    Rt = torch.as_tensor(R, dtype=dt, device=device)
    v, u = torch.meshgrid(torch.arange(H, dtype=dt, device=device),
                          torch.arange(W, dtype=dt, device=device), indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    dirs = pix @ torch.linalg.inv(Kt).T @ Rt          # camera rays in the world frame
    _, idx, ab = scene_hit(C, dirs)
    img = torch.zeros((H, W), dtype=torch.float32, device=device)
    for level, weight in enumerate((0.35, 0.3, 0.2, 0.15)):
        pitch = texel * 3.0 ** level
        img += weight * _value_noise(ab[..., 0] / pitch, ab[..., 1] / pitch,
                                     idx + 16 * level + 64 * seed)
    return torch.round(255.0 * (0.1 + 0.8 * img)).clamp(0, 255).to(torch.uint8)


def render_pair(K, R, T, H, W, seed=0, device="cpu"):
    """Left and right (H, W) uint8 views of the scene for the rig x2 = R x1 + T
    (camera 1 at the origin), texel about 1.5 px at 3 m."""
    K = np.asarray(K, np.float64)
    texel = 1.5 * 3.0 / K[0, 0]
    C2 = -np.asarray(R, np.float64).T @ np.asarray(T, np.float64).reshape(3)
    left = render_view(K, np.eye(3), np.zeros(3), H, W, texel, seed, device)
    right = render_view(K, R, C2, H, W, texel, seed, device)
    return left, right


def rectified_rig(size, alpha: float = 0.0, K=None):
    """The reference's rectified rig (its benchmarks.py:91): intrinsics K
    (K_4K scaled to the width (W, H) = size unless given) for both cameras,
    R = I, T = (-BASELINE_M, 0, 0) -> (K as a float64 tensor, the
    stereo_rectify result at `alpha`)."""
    W, H = size
    if K is None:
        K = K_4K.copy()
        K[:2] *= W / 3840.0
    Kt = torch.as_tensor(np.asarray(K), dtype=torch.float64)
    res = RC.stereo_rectify(Kt, None, Kt, None, (W, H), torch.eye(3, dtype=torch.float64),
                            torch.tensor([-BASELINE_M, 0.0, 0.0], dtype=torch.float64),
                            alpha=alpha)
    return Kt, res


def rotation_about(axis, degrees):
    """Rotation matrix of `degrees` about the unit direction of `axis`."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(degrees)
    Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def pose_errors(R, t, R_true, T_true):
    """(rotation error, translation direction error) of a pose, in degrees."""
    r = np.degrees(np.arccos(np.clip((np.trace(R @ R_true.T) - 1) / 2, -1, 1)))
    t = np.asarray(t, np.float64).ravel()
    c = t @ T_true / (np.linalg.norm(t) * np.linalg.norm(T_true))
    return float(r), float(np.degrees(np.arccos(np.clip(c, -1, 1))))


# The calibration set: CALIB_POSES board poses, each seen by both cameras
# of the raw rig (K_4K, x2 = R x1 + T), both with distortion
# CALIB_DIST; a board of 9 x 7 inner corners, CALIB_SQUARE m squares and a
# one-square white margin, whose checker spans CALIB_SPAN of the frame's
# width, tilted up to CALIB_TILT_DEG about x and y (and z by 0.7 of it),
# placed where both cameras see it whole. Views are point-sampled
# CALIB_SS x CALIB_SS per pixel, blurred and noisy.
CALIB_POSES = 22
CALIB_DIST = (0.2, -0.55, -1e-5, 5e-4, 0.38)
CALIB_COLS, CALIB_ROWS, CALIB_SQUARE = 9, 7, 0.03
CALIB_SPAN = (0.2, 0.45)
CALIB_TILT_DEG = 30.0
CALIB_SS = 4
CALIB_BLUR, CALIB_NOISE = 0.8, 2.0  # Gaussian sigma (px) and noise sigma (grey levels)


def board_poses(n, K, W, H, seed=SEED, border=24):
    """n board poses (R, t), board -> camera 1, each one whose board and
    margin both cameras of the raw rig see whole, `border` px inside the
    frame (rejection sampling from a seeded generator)."""
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    rng = np.random.default_rng(seed)
    R_rig, T_rig = rotation_about(SCENE_AXIS, SCENE_DEG), np.array(SCENE_T)
    s, c, r = CALIB_SQUARE, CALIB_COLS, CALIB_ROWS
    a, b = np.linspace(-2, c + 1, 4 * (c + 3)) * s, np.linspace(-2, r + 1, 4 * (r + 3)) * s
    edge = np.concatenate([np.stack([a, np.full_like(a, b[0])], 1), np.stack([a, np.full_like(a, b[-1])], 1),
                           np.stack([np.full_like(b, a[0]), b], 1), np.stack([np.full_like(b, a[-1]), b], 1)])
    edge = np.concatenate([edge, np.zeros((len(edge), 1))], 1)
    centre = np.array([(c - 1) / 2 * s, (r - 1) / 2 * s, 0.0])
    tilt = np.radians(CALIB_TILT_DEG) * np.array([1.0, 1.0, 0.7])
    poses = []
    while len(poses) < n:
        z = (c + 1) * s * K[0, 0] / (rng.uniform(*CALIB_SPAN) * W)
        rv = rng.uniform(-1, 1, 3) * tilt
        R = rotation_about(rv, np.degrees(np.linalg.norm(rv)))
        mid = np.array([-T_rig[0] / 2 + rng.uniform(-0.45, 0.45) * z * W / (2 * K[0, 0]),
                        rng.uniform(-0.4, 0.4) * z * H / (2 * K[1, 1]), z])
        t = mid - R @ centre
        ok = True
        for Rc, tc in ((R, t), (R_rig @ R, R_rig @ t + T_rig)):
            px = G.project_points(f64(edge), G.matrix_to_rodrigues(f64(Rc)), f64(tc), f64(K),
                                  f64(CALIB_DIST)).numpy()
            depth = edge @ Rc[2] + tc[2]
            ok &= bool((depth > 0).all() and (px >= border).all() and (px[:, 0] < W - border).all()
                       and (px[:, 1] < H - border).all())
        if ok:
            poses.append((R, t))
    return poses


def render_board(K, R, t, H, W, seed, device, ss=CALIB_SS, chunk=270):
    """(H, W) uint8 view of the board at pose (R, t) (board -> camera) by a
    camera with intrinsics K and distortion CALIB_DIST: each of ss x ss
    samples a pixel is undistorted (the port's undistort_normalized),
    ray-cast onto the board plane and shaded (dark and light squares, the
    white margin, a grey ground), their mean blurred by a Gaussian of
    CALIB_BLUR px, plus Gaussian noise of CALIB_NOISE from `seed`. Rows go
    in chunks of `chunk`, float32."""
    f32 = dict(dtype=torch.float32, device=device)
    Rt = torch.as_tensor(np.asarray(R).T, **f32)            # camera -> board
    ob = -(Rt @ torch.as_tensor(np.asarray(t), **f32))      # camera centre on the board
    dist = torch.as_tensor(CALIB_DIST, **f32)
    o = (torch.arange(ss, **f32) + 0.5) / ss - 0.5
    xs = ((torch.arange(W, **f32)[:, None] + o).reshape(-1) - float(K[0, 2])) / float(K[0, 0])
    img = torch.empty((H, W), **f32)
    for y0 in range(0, H, chunk):
        n = min(chunk, H - y0)
        ys = ((torch.arange(y0, y0 + n, **f32)[:, None] + o).reshape(-1) - float(K[1, 2])) / float(K[1, 1])
        xd = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None]), dim=-1)
        xy = G.undistort_normalized(xd, dist)
        d = xy[..., 0:1] * Rt[:, 0] + xy[..., 1:2] * Rt[:, 1] + Rt[:, 2]  # rays on the board
        lam = -ob[2] / d[..., 2]
        u = (ob[0] + lam * d[..., 0]) / CALIB_SQUARE
        v = (ob[1] + lam * d[..., 1]) / CALIB_SQUARE
        front = lam > 0
        checker = front & (u >= -1) & (u < CALIB_COLS) & (v >= -1) & (v < CALIB_ROWS)
        board = front & (u >= -2) & (u < CALIB_COLS + 1) & (v >= -2) & (v < CALIB_ROWS + 1)
        dark = checker & ((torch.floor(u) + torch.floor(v)) % 2 == 0)
        val = torch.where(dark, 35.0, torch.where(board, 215.0, 110.0))
        img[y0:y0 + n] = val.reshape(n, ss, W, ss).mean((1, 3))
    r = int(math.ceil(3 * CALIB_BLUR))
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, **f32) / CALIB_BLUR) ** 2)
    k = k / k.sum()
    p = torch.nn.functional.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    img = sum(k[i] * p[i:i + H] for i in range(2 * r + 1))
    img = sum(k[i] * img[:, i:i + W] for i in range(2 * r + 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    img = img + CALIB_NOISE * torch.randn((H, W), generator=gen, **f32)
    return torch.round(img).clamp(0, 255).to(torch.uint8)


def calibration_set(device, H=2160, W=3840, n=CALIB_POSES, ss=CALIB_SS):
    """The calibration set: for each of n poses, both cameras' views (uint8
    (H, W) on `device`, ss x ss samples a pixel) and their true corners
    (project_points of the object grid, float64); the rig's K (K_4K scaled
    to W), R and T."""
    K = K_4K.copy()
    K[:2] *= W / 3840.0
    R_rig, T_rig = rotation_about(SCENE_AXIS, SCENE_DEG), np.array(SCENE_T)
    obj = Z.build_object_points(CALIB_COLS, CALIB_ROWS, CALIB_SQUARE)
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    views, truth = ([], []), ([], [])
    for i, (R, t) in enumerate(board_poses(n, K, W, H)):
        for cam, (Rc, tc) in enumerate(((R, t), (R_rig @ R, R_rig @ t + T_rig))):
            views[cam].append(render_board(K, Rc, tc, H, W, seed=2 * i + cam, device=device,
                                           ss=ss))
            rv = G.matrix_to_rodrigues(f64(Rc))
            truth[cam].append(G.project_points(obj, rv, f64(tc), f64(K), f64(CALIB_DIST)))
    return {"views": views, "truth": tuple(torch.stack(x) for x in truth), "obj": obj, "K": K,
            "R": R_rig, "T": T_rig, "size": (W, H)}


def calibrate_set(cs, sync=lambda: None, stereo: bool = True):
    """Detection in every view, calibrate_camera on all views, and with
    `stereo` calibrate_stereo on the pairs, each stage timed (sync() at its
    end): the corners of both cameras (V, N, 2), the results (rig None
    without `stereo`), the seconds, and the views where no board was
    found."""
    t0 = time.perf_counter()
    corners, missed = ([], []), []
    for cam in (0, 1):
        for i, img in enumerate(cs["views"][cam]):
            found, c = CB.find_chessboard_corners(img, CALIB_COLS, CALIB_ROWS)
            if not found:
                missed.append((cam, i))
            corners[cam].append(c)
    sync()
    t1 = time.perf_counter()
    if missed:
        return {"missed": missed, "detect_s": t1 - t0}
    c1, c2 = torch.stack(corners[0]), torch.stack(corners[1])
    obj = cs["obj"].to(c1.device)
    mono = Z.calibrate_camera(obj, torch.cat([c1, c2]), cs["size"])
    sync()
    t2 = time.perf_counter()
    rig = SCAL.calibrate_stereo(obj, c1, c2, cs["size"]) if stereo else None
    sync()
    t3 = time.perf_counter()
    return {"missed": missed, "corners": (c1, c2), "mono": mono, "rig": rig,
            "detect_s": t1 - t0, "lm_s": t2 - t1, "stereo_s": t3 - t2}
