"""Standalone HTML point-cloud viewer (a copy of ``stereo_reconstruction_cv_tpu/io/viewer.py``).

One self-contained .html file, the points embedded as base64 and drawn by an
inline WebGL renderer with orbit, zoom and pan, which any browser opens
without network: the headless stand-in for the reference's Open3D window.
The bytes equal the reference's for the same points.
"""

from __future__ import annotations

import base64
import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>stereo-tpu point cloud</title>
<style>
  html, body { margin: 0; height: 100%; overflow: hidden; background: #111; }
  canvas { width: 100%; height: 100%; display: block; }
  #hud { position: fixed; top: 8px; left: 10px; color: #9a9a9a;
         font: 12px monospace; user-select: none; }
</style>
</head>
<body>
<canvas id="c"></canvas>
<div id="hud">__NPOINTS__ points — drag: orbit, wheel: zoom, shift-drag: pan</div>
<script>
const B64_XYZ = "__B64_XYZ__";
const B64_RGB = "__B64_RGB__";
const N = __NPOINTS__;
function decode(b64) {
  const s = atob(b64), a = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) a[i] = s.charCodeAt(i);
  return a;
}
const xyz = new Float32Array(decode(B64_XYZ).buffer);
const rgb = B64_RGB.length ? decode(B64_RGB) : null;

// Bounds -> center + radius for camera framing.
let mn = [1e30, 1e30, 1e30], mx = [-1e30, -1e30, -1e30];
for (let i = 0; i < N; i++)
  for (let k = 0; k < 3; k++) {
    const v = xyz[3 * i + k];
    if (v < mn[k]) mn[k] = v;
    if (v > mx[k]) mx[k] = v;
  }
const center = [(mn[0]+mx[0])/2, (mn[1]+mx[1])/2, (mn[2]+mx[2])/2];
let radius = Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2]) / 2;
if (!(radius > 0)) radius = 1;  // empty/degenerate cloud: sane default frame

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
const vs = `
attribute vec3 p; attribute vec3 col; uniform mat4 mvp; uniform float ps;
varying vec3 vc;
void main() {
  gl_Position = mvp * vec4(p, 1.0);
  gl_PointSize = max(ps / max(gl_Position.w, 0.0001), 1.0);
  vc = col;
}`;
const fs = `
precision mediump float; varying vec3 vc;
void main() { gl_FragColor = vec4(vc, 1.0); }`;
function shader(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s); return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);

const posBuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, posBuf);
gl.bufferData(gl.ARRAY_BUFFER, xyz, gl.STATIC_DRAW);
const locP = gl.getAttribLocation(prog, "p");
gl.enableVertexAttribArray(locP);
gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);

const colBuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, colBuf);
if (rgb) gl.bufferData(gl.ARRAY_BUFFER, rgb, gl.STATIC_DRAW);
else {
  const white = new Uint8Array(3 * N).fill(220);
  gl.bufferData(gl.ARRAY_BUFFER, white, gl.STATIC_DRAW);
}
const locC = gl.getAttribLocation(prog, "col");
gl.enableVertexAttribArray(locC);
gl.vertexAttribPointer(locC, 3, gl.UNSIGNED_BYTE, true, 0, 0);

const uMVP = gl.getUniformLocation(prog, "mvp");
const uPS = gl.getUniformLocation(prog, "ps");

// Minimal mat4 helpers (column-major).
function mul(a, b) {
  const o = new Float32Array(16);
  for (let c = 0; c < 4; c++) for (let r = 0; r < 4; r++) {
    let s = 0;
    for (let k = 0; k < 4; k++) s += a[k*4+r] * b[c*4+k];
    o[c*4+r] = s;
  }
  return o;
}
function persp(fov, aspect, near, far) {
  const f = 1 / Math.tan(fov / 2), o = new Float32Array(16);
  o[0] = f / aspect; o[5] = f;
  o[10] = (far + near) / (near - far); o[11] = -1;
  o[14] = 2 * far * near / (near - far);
  return o;
}

let theta = 0.5, phi = 1.2, dist = 2.5 * radius;
let panX = 0, panY = 0, drag = null;
canvas.addEventListener("mousedown", e => drag = {x: e.clientX, y: e.clientY, shift: e.shiftKey});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (drag.shift) { panX -= dx * dist * 0.001; panY += dy * dist * 0.001; }
  else { theta -= dx * 0.006; phi = Math.min(3.1, Math.max(0.05, phi - dy * 0.006)); }
  drag = {x: e.clientX, y: e.clientY, shift: drag.shift};
});
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.pow(1.1, e.deltaY > 0 ? 1 : -1);
}, {passive: false});

function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) { canvas.width = w; canvas.height = h; }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.066, 0.066, 0.066, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);

  const eye = [
    dist * Math.sin(phi) * Math.cos(theta),
    dist * Math.cos(phi),
    dist * Math.sin(phi) * Math.sin(theta),
  ];
  // lookAt(eye + pan, origin + pan), then translate by -center.
  const zax = eye.map((v, i) => v / dist);
  const up = [0, 1, 0];
  const xax = [up[1]*zax[2]-up[2]*zax[1], up[2]*zax[0]-up[0]*zax[2], up[0]*zax[1]-up[1]*zax[0]];
  const xl = Math.hypot(...xax); xax.forEach((v, i) => xax[i] = v / xl);
  const yax = [zax[1]*xax[2]-zax[2]*xax[1], zax[2]*xax[0]-zax[0]*xax[2], zax[0]*xax[1]-zax[1]*xax[0]];
  const view = new Float32Array([
    xax[0], yax[0], zax[0], 0,
    xax[1], yax[1], zax[1], 0,
    xax[2], yax[2], zax[2], 0,
    -(xax[0]*eye[0]+xax[1]*eye[1]+xax[2]*eye[2]) - panX,
    -(yax[0]*eye[0]+yax[1]*eye[1]+yax[2]*eye[2]) - panY,
    -(zax[0]*eye[0]+zax[1]*eye[1]+zax[2]*eye[2]), 1,
  ]);
  const model = new Float32Array([
    1,0,0,0, 0,1,0,0, 0,0,1,0, -center[0], -center[1], -center[2], 1,
  ]);
  const proj = persp(0.9, w / h, radius * 0.01, radius * 100);
  gl.uniformMatrix4fv(uMVP, false, mul(proj, mul(view, model)));
  gl.uniform1f(uPS, h * 0.02);
  gl.drawArrays(gl.POINTS, 0, N);
  requestAnimationFrame(draw);
}
requestAnimationFrame(draw);
</script>
</body>
</html>
"""


def write_html_viewer(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    max_points: int = 2_000_000,
    seed: int = 0,
) -> int:
    """Write a standalone interactive viewer HTML. Returns points written.

    points: (N, 3) float; colors: optional (N, 3) uint8/float [0,255].
    Clouds above max_points are uniformly subsampled (deterministic) to
    bound the file size (~15 bytes/point)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    if colors is not None:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
    if n > max_points:
        idx = np.random.default_rng(seed).choice(n, max_points, replace=False)
        idx.sort()
        points = points[idx]
        colors = colors[idx] if colors is not None else None
        n = max_points
    b64_xyz = base64.b64encode(np.ascontiguousarray(points, "<f4").tobytes()).decode()
    b64_rgb = (
        base64.b64encode(np.ascontiguousarray(colors).tobytes()).decode()
        if colors is not None
        else ""
    )
    html = (
        _TEMPLATE.replace("__NPOINTS__", json.dumps(n))
        .replace("__B64_XYZ__", b64_xyz)
        .replace("__B64_RGB__", b64_rgb)
    )
    with open(path, "w") as f:
        f.write(html)
    return n


def read_html_viewer(path: str):
    """Recover (points, colors) from a write_html_viewer file (tests)."""
    with open(path) as f:
        html = f.read()

    def grab(name):
        key = f'const {name} = "'
        i = html.index(key) + len(key)
        return html[i : html.index('"', i)]

    pts = np.frombuffer(base64.b64decode(grab("B64_XYZ")), "<f4").reshape(-1, 3)
    rgb_b64 = grab("B64_RGB")
    colors = (
        np.frombuffer(base64.b64decode(rgb_b64), np.uint8).reshape(-1, 3)
        if rgb_b64
        else None
    )
    return pts, colors
