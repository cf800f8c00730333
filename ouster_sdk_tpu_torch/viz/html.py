"""Self-contained interactive HTML point-cloud export.

The reference's PointViz is an interactive GLFW/OpenGL window
(ref: ouster_viz/src/point_viz.cpp) — impossible headless. This module
gives users real interactivity anyway: one HTML file with the points
embedded (base64 f32 positions + u8 colors) and a dependency-free WebGL
orbit viewer (drag = orbit, shift-drag = pan, wheel = dolly), mirroring
the reference camera controls (ref: ouster_viz/src/camera.cpp orbit/
dolly). Open the file in any browser.
"""

from __future__ import annotations

import base64
import json
from typing import Optional

import numpy as np

from .core import colorize

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 html,body{{margin:0;height:100%;overflow:hidden;background:#07080a}}
 canvas{{width:100%;height:100%;display:block}}
 #hud{{position:fixed;left:10px;top:8px;color:#9aa;font:12px monospace;
      user-select:none;pointer-events:none}}
</style></head><body>
<canvas id="c"></canvas><div id="hud">{title} — {npts} pts ·
 drag orbit · shift-drag pan · wheel dolly · R reset</div>
<script>
"use strict";
const POS_B64 = "{pos_b64}";
const COL_B64 = "{col_b64}";
const N = {npts};
function decode(b64, T) {{
  const raw = atob(b64); const buf = new ArrayBuffer(raw.length);
  const view = new Uint8Array(buf);
  for (let i = 0; i < raw.length; i++) view[i] = raw.charCodeAt(i);
  return new T(buf);
}}
const LINE_POS_B64 = "{line_pos_b64}";
const LINE_COL_B64 = "{line_col_b64}";
const NL = {n_lines};
const pos = decode(POS_B64, Float32Array);
const col = decode(COL_B64, Uint8Array);
const lpos = NL ? decode(LINE_POS_B64, Float32Array) : new Float32Array(0);
const lcol = NL ? decode(LINE_COL_B64, Uint8Array) : new Uint8Array(0);
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
const vs = `attribute vec3 p; attribute vec3 c; uniform mat4 mvp;
 uniform float ps; varying vec3 vc;
 void main(){{ gl_Position = mvp*vec4(p,1.0); gl_PointSize = ps;
   vc = c; }}`;
const fs = `precision mediump float; varying vec3 vc;
 void main(){{ gl_FragColor = vec4(vc,1.0); }}`;
function sh(t, src) {{ const s = gl.createShader(t);
  gl.shaderSource(s, src); gl.compileShader(s); return s; }}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
function makeBuf(data) {{
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW); return b;
}}
const posBuf = makeBuf(pos), colBuf = makeBuf(col);
const lposBuf = NL ? makeBuf(lpos) : null;
const lcolBuf = NL ? makeBuf(lcol) : null;
const locP = gl.getAttribLocation(prog, "p");
const locC = gl.getAttribLocation(prog, "c");
gl.enableVertexAttribArray(locP);
gl.enableVertexAttribArray(locC);
function bind(pb, cb) {{
  gl.bindBuffer(gl.ARRAY_BUFFER, pb);
  gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, cb);
  gl.vertexAttribPointer(locC, 3, gl.UNSIGNED_BYTE, true, 0, 0);
}}
const uMvp = gl.getUniformLocation(prog, "mvp");
const uPs = gl.getUniformLocation(prog, "ps");
// camera state (orbit around target), reference-like defaults
let yaw = -1.0, pitch = 0.5, dist = {dist}, tgt = [{cx},{cy},{cz}];
const dist0 = dist, tgt0 = tgt.slice();
function mat() {{
  const cw = canvas.clientWidth, ch = canvas.clientHeight;
  canvas.width = cw * devicePixelRatio; canvas.height = ch * devicePixelRatio;
  gl.viewport(0, 0, canvas.width, canvas.height);
  const aspect = cw / ch, f = 1 / Math.tan(0.4), near = 0.05, far = dist*40+100;
  const P = [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
             0,0,2*far*near/(near-far),0];
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const cy_ = Math.cos(yaw), sy = Math.sin(yaw);
  const eye = [tgt[0]+dist*cp*cy_, tgt[1]+dist*cp*sy, tgt[2]+dist*sp];
  const zl = norm3(sub(eye, tgt));
  const xl = norm3(cross([0,0,1], zl));
  const yl = cross(zl, xl);
  const V = [xl[0],yl[0],zl[0],0, xl[1],yl[1],zl[1],0,
             xl[2],yl[2],zl[2],0,
             -dot(xl,eye),-dot(yl,eye),-dot(zl,eye),1];
  return mul4(P, V);
}}
function sub(a,b){{return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}}
function dot(a,b){{return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}}
function cross(a,b){{return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
                             a[0]*b[1]-a[1]*b[0]];}}
function norm3(a){{const l=Math.hypot(a[0],a[1],a[2])||1;
  return [a[0]/l,a[1]/l,a[2]/l];}}
function mul4(A,B){{const o=new Array(16).fill(0);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
    o[j*4+i]+=A[k*4+i]*B[j*4+k]; return o;}}
function draw() {{
  gl.clearColor(0.03,0.03,0.04,1); gl.clear(gl.COLOR_BUFFER_BIT);
  gl.uniformMatrix4fv(uMvp, false, new Float32Array(mat()));
  gl.uniform1f(uPs, {point_size} * devicePixelRatio);
  bind(posBuf, colBuf);
  gl.drawArrays(gl.POINTS, 0, N);
  if (NL) {{
    bind(lposBuf, lcolBuf);
    gl.drawArrays(gl.LINES, 0, NL * 2);
  }}
}}
let dragging = false, panning = false, lx = 0, ly = 0;
canvas.addEventListener("mousedown", e => {{ dragging = true;
  panning = e.shiftKey; lx = e.clientX; ly = e.clientY; }});
window.addEventListener("mouseup", () => dragging = false);
window.addEventListener("mousemove", e => {{
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly; lx = e.clientX; ly = e.clientY;
  if (panning) {{
    const s = dist * 0.002;
    tgt[0] += s * (dx * Math.sin(yaw) + dy * Math.cos(yaw) * Math.sin(pitch));
    tgt[1] += s * (-dx * Math.cos(yaw) + dy * Math.sin(yaw) * Math.sin(pitch));
    tgt[2] += s * dy * Math.cos(pitch);
  }} else {{
    yaw -= dx * 0.005;
    pitch = Math.min(1.55, Math.max(-1.55, pitch + dy * 0.005));
  }}
  requestAnimationFrame(draw);
}});
canvas.addEventListener("wheel", e => {{ e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001); requestAnimationFrame(draw); }},
  {{passive: false}});
window.addEventListener("keydown", e => {{ if (e.key === "r" ||
  e.key === "R") {{ dist = dist0; tgt = tgt0.slice(); yaw = -1.0;
  pitch = 0.5; requestAnimationFrame(draw); }} }});
window.addEventListener("resize", () => requestAnimationFrame(draw));
draw();
</script></body></html>
"""


def export_html(path: str, points: np.ndarray,
                key: Optional[np.ndarray] = None,
                palette: str = "viridis", point_size: float = 2.0,
                title: str = "ouster_sdk_tpu point cloud",
                max_points: int = 2_000_000,
                lines: Optional[np.ndarray] = None,
                line_colors: Optional[np.ndarray] = None) -> str:
    """Write a single self-contained interactive HTML viewer for (N, 3)
    points. `key` (N,) colors via the named palette (percentile
    normalized, like the reference's AutoExposure-driven cloud keys);
    without a key, points are colored by height. `lines` (M, 2, 3)
    segments render as GL_LINES colored by `line_colors` (M, 3) u8
    (trajectories, constraint links)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if key is not None:
        key = np.asarray(key, dtype=np.float64).reshape(-1)
        if key.shape[0] != pts.shape[0]:
            raise ValueError("key length must match point count")
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[sel]
        key = key[sel] if key is not None else None
    if key is None:
        key = pts[:, 2].astype(np.float64)
    lo, hi = (np.percentile(key, [2, 98]) if key.size else (0.0, 1.0))
    k = np.clip((key - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    colors = colorize(k.astype(np.float32), palette)
    segs = np.zeros((0, 2, 3), dtype=np.float32) if lines is None else \
        np.asarray(lines, dtype=np.float32).reshape(-1, 2, 3)
    if line_colors is None:
        seg_cols = np.full((len(segs), 3), 255, dtype=np.uint8)
    else:
        seg_cols = np.asarray(line_colors, dtype=np.uint8).reshape(-1, 3)
        if len(seg_cols) != len(segs):
            raise ValueError("line_colors length must match lines")
    # one color per segment -> per vertex
    seg_vcols = np.repeat(seg_cols, 2, axis=0)

    anchor = np.concatenate([pts, segs.reshape(-1, 3)]) \
        if len(segs) else pts
    center = anchor.mean(axis=0) if len(anchor) else np.zeros(3)
    spread = float(np.percentile(
        np.linalg.norm(anchor - center, axis=1), 90)) \
        if len(anchor) else 10.0
    html = _TEMPLATE.format(
        title=title, npts=len(pts),
        pos_b64=base64.b64encode(np.ascontiguousarray(pts).tobytes()
                                 ).decode(),
        col_b64=base64.b64encode(np.ascontiguousarray(colors).tobytes()
                                 ).decode(),
        n_lines=len(segs),
        line_pos_b64=base64.b64encode(
            np.ascontiguousarray(segs).tobytes()).decode(),
        line_col_b64=base64.b64encode(
            np.ascontiguousarray(seg_vcols).tobytes()).decode(),
        dist=json.dumps(round(max(spread * 2.0, 1.0), 3)),
        cx=round(float(center[0]), 3), cy=round(float(center[1]), 3),
        cz=round(float(center[2]), 3),
        point_size=json.dumps(point_size))
    with open(path, "w") as f:
        f.write(html)
    return path
