"""The benchmark's scene and rigs: a frozen copy of the port's renderer.

A stereo pair of a ray-cast scene of four textured planes at 2.5-5 m, with
occlusion edges, rendered on any device from an integer texture seed (the
port's ``utils/synth.py`` ``render_pair`` as of its first benchmark, copied
here so that the yardstick cannot move with the program). The rigs come
from a configuration's ``rig`` group (``rig``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Planes in camera 1's frame (x right, y down, z forward, metres): centre,
# normal, half extents along the two in-plane axes (None: unbounded).
SCENE_PLANES = (
    ((0.0, 0.0, 5.0), (0.12, -0.08, -1.0), None),
    ((-0.9, -0.25, 2.9), (0.35, 0.1, -1.0), (1.1, 0.8)),
    ((1.0, 0.35, 3.7), (-0.3, 0.2, -1.0), (1.3, 0.9)),
    ((0.1, 0.9, 4.2), (0.05, 0.6, -1.0), (1.5, 0.6)),
)


def rotation_about(axis, degrees) -> np.ndarray:
    """Rotation matrix of `degrees` about the unit direction of `axis`."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(degrees)
    Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _plane_frames(dtype, device):
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
    """First hit of rays origin + t dirs with the scene: (t, plane index,
    in-plane coordinates (..., 2))."""
    c, n, axes, ext = _plane_frames(dirs.dtype, dirs.device)
    o = torch.as_tensor(origin, dtype=dirs.dtype, device=dirs.device)
    denom = dirs @ n.T
    t = ((c - o) * n).sum(-1) / denom
    hit = o + t[..., None] * dirs[..., None, :]
    ab = torch.einsum("...pk,pjk->...pj", hit - c, axes)
    inside = (ab.abs() <= ext).all(-1) & (t > 0)
    t = torch.where(inside, t, torch.full_like(t, math.inf))
    tmin, idx = t.min(dim=-1)
    ab = torch.gather(ab, -2, idx[..., None, None].expand(*idx.shape, 1, 2))[..., 0, :]
    return tmin, idx, ab


def _hash01(i, j, salt):
    """Uniform [0, 1) per lattice point, the same on every device."""
    m = 0x7FFFFFFF
    h = (i * 0x2545F491 + j * 0x6C8E9CF5 + salt * 0x1B873593) & m
    for k in (0x5BD1E995, 0x27D4EB2F, 0x165667B1):
        h = ((h ^ (h >> 15)) * k) & m
    h = h ^ (h >> 13)
    return (h & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def _value_noise(a, b, salt):
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
    """(H, W) uint8 view from a camera with intrinsics K, rotation R (world
    -> camera) and centre C: value-noise textures at pitches texel x (1, 3,
    9, 27) metres."""
    dt = torch.float64
    Kt = torch.as_tensor(K, dtype=dt, device=device)
    Rt = torch.as_tensor(R, dtype=dt, device=device)
    v, u = torch.meshgrid(torch.arange(H, dtype=dt, device=device),
                          torch.arange(W, dtype=dt, device=device), indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    dirs = pix @ torch.linalg.inv(Kt).T @ Rt
    _, idx, ab = scene_hit(C, dirs)
    img = torch.zeros((H, W), dtype=torch.float32, device=device)
    for level, weight in enumerate((0.35, 0.3, 0.2, 0.15)):
        pitch = texel * 3.0 ** level
        img += weight * _value_noise(ab[..., 0] / pitch, ab[..., 1] / pitch,
                                     idx + 16 * level + 64 * seed)
    return torch.round(255.0 * (0.1 + 0.8 * img)).clamp(0, 255).to(torch.uint8)


def render_pair(K, R, T, H, W, seed, device):
    """Left and right (H, W) uint8 views for the rig x2 = R x1 + T (camera 1
    at the origin). `seed` must lie in [0, 2**20): it salts the textures."""
    if not 0 <= seed < 1 << 20:
        raise ValueError(f"texture seed {seed} outside [0, 2**20)")
    K = np.asarray(K, np.float64)
    texel = 1.5 * 3.0 / K[0, 0]
    C2 = -np.asarray(R, np.float64).T @ np.asarray(T, np.float64).reshape(3)
    left = render_view(K, np.eye(3), np.zeros(3), H, W, texel, seed, device)
    right = render_view(K, R, C2, H, W, texel, seed, device)
    return left, right


def rig(config: dict, kind: str):
    """(K (3, 3) float64 at the configuration's width, R, T) of its `kind`
    of rig, x2 = R x1 + T: "raw" (the second camera turned raw_deg about
    raw_axis and offset by raw_T, so rectification has work to do) or
    "rectified" (R = I, T = (-baseline_m, 0, 0))."""
    r = config["rig"]
    K = np.array(r["K"], np.float64)
    K[:2] *= config["width"] / r["K_width"]
    if kind == "raw":
        return K, rotation_about(r["raw_axis"], r["raw_deg"]), np.array(r["raw_T"], np.float64)
    if kind == "rectified":
        return K, np.eye(3), np.array([-r["baseline_m"], 0.0, 0.0])
    raise ValueError(f"rig {kind!r}: 'raw' or 'rectified'")


def texture_seeds(seed: int, n: int) -> list:
    """n distinct texture seeds in [0, 2**20) drawn from a run's seed (any
    integer; it is taken modulo 2**64)."""
    rng = np.random.default_rng(seed % (1 << 64))
    return [int(s) for s in rng.choice(1 << 20, size=n, replace=False)]
