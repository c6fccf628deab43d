"""PLY point-cloud writer and reader (a copy of ``stereo_reconstruction_cv_tpu/io/ply.py``).

Binary little-endian by default, ASCII optional for debugging; the reader
reads what the writer writes. The writer's bytes equal the reference's for
the same cloud.
"""

from __future__ import annotations

import numpy as np

_REC_RGB = [("xyz", np.float32, 3), ("rgb", np.uint8, 3)]


def write_ply(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> int:
    """Write (N, 3) float points (+ optional (N, 3) uint8 colors). Returns N."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header += [f"element vertex {n}", "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(n, dtype=_REC_RGB)
                rec["xyz"] = points
                rec["rgb"] = colors
                f.write(rec.tobytes())
            else:
                f.write(points.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
                if has_color:
                    row += f" {colors[i, 0]} {colors[i, 1]} {colors[i, 2]}"
                f.write((row + "\n").encode())
    return n


def read_ply(path: str):
    """Read a file written by write_ply. Returns (points, colors or None)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header if h.startswith("element vertex"))
        binary = any("binary" in h for h in header)
        has_color = any("uchar red" in h for h in header)
        if binary:
            if has_color:
                rec = np.frombuffer(f.read(n * 15), dtype=_REC_RGB)
                return rec["xyz"].copy(), rec["rgb"].copy()
            pts = np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3)
            return pts.copy(), None
        rows = [f.readline().decode().split() for _ in range(n)]
        arr = np.asarray(rows, np.float64)
        pts = arr[:, :3].astype(np.float32)
        cols = arr[:, 3:6].astype(np.uint8) if has_color else None
        return pts, cols
