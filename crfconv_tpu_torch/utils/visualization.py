"""Offline point-cloud visualization.

Counterpart of ``crfconv_tpu/utils/visualization.py`` (the same files, byte
for byte) and functional counterpart of the reference's mayavi room
renderer (utils/visualization.py:26-75): reassemble full rooms from saved
block indices and render RGB / ground-truth / prediction colorings as a
colored PLY (viewable in MeshLab/CloudCompare), a self-contained WebGL
page or, where matplotlib is installed, a PNG scatter. The reassembly
logic is the load-bearing part.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from crfconv_tpu_torch.data.ply import write_ply

# 13-class S3DIS palette (uint8 RGB)
S3DIS_PALETTE = np.array(
    [
        [233, 229, 107], [95, 156, 196], [179, 116, 81], [241, 149, 131],
        [81, 163, 148], [77, 174, 84], [108, 135, 75], [41, 49, 101],
        [79, 79, 76], [223, 52, 52], [89, 47, 95], [81, 109, 114],
        [233, 233, 229],
    ],
    dtype=np.uint8,
)


def assemble_room(
    blocks: Sequence[Dict[str, np.ndarray]],
    num_points: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reassemble a room from overlapping blocks.

    Each block dict carries ``pos [n,3]``, ``indices [n]`` (original room
    point ids) and per-point values (``pred``/``y``).  Later blocks
    overwrite earlier ones on overlap, as the reference's index-based
    reassembly does (utils/visualization.py:26-36).

    Returns (positions [N,3], filled_mask [N]).
    """
    n = num_points or (max(int(b["indices"].max()) for b in blocks) + 1)
    pos = np.zeros((n, 3), np.float32)
    filled = np.zeros(n, bool)
    for b in blocks:
        idx = np.asarray(b["indices"], np.int64)
        pos[idx] = b["pos"]
        filled[idx] = True
    return pos, filled


def assemble_values(
    blocks: Sequence[Dict[str, np.ndarray]],
    key: str,
    num_points: Optional[int] = None,
) -> np.ndarray:
    n = num_points or (max(int(b["indices"].max()) for b in blocks) + 1)
    first = np.asarray(blocks[0][key])
    out = np.zeros((n,) + first.shape[1:], first.dtype)
    for b in blocks:
        out[np.asarray(b["indices"], np.int64)] = b[key]
    return out


def labels_to_colors(
    labels: np.ndarray, palette: np.ndarray = S3DIS_PALETTE
) -> np.ndarray:
    labels = np.clip(np.asarray(labels, np.int64), 0, len(palette) - 1)
    return palette[labels]


def export_colored_ply(
    filename: str,
    pos: np.ndarray,
    labels: Optional[np.ndarray] = None,
    rgb: Optional[np.ndarray] = None,
    palette: np.ndarray = S3DIS_PALETTE,
) -> str:
    """Write a colored PLY (labels → palette colors, or raw rgb)."""
    if rgb is None:
        if labels is None:
            raise ValueError("need labels or rgb")
        rgb = labels_to_colors(labels, palette)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    write_ply(filename, [np.asarray(pos, np.float32), rgb],
              ["x", "y", "z", "r", "g", "b"])
    return filename


def render_png(
    filename: str,
    pos: np.ndarray,
    labels: Optional[np.ndarray] = None,
    rgb: Optional[np.ndarray] = None,
    palette: np.ndarray = S3DIS_PALETTE,
    max_points: int = 200_000,
    elev: float = 35.0,
    azim: float = -60.0,
) -> str:
    """Top-down-ish 3-D scatter render to PNG via matplotlib (headless)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos = np.asarray(pos)
    if rgb is None:
        rgb = labels_to_colors(labels, palette)
    rgb = np.asarray(rgb, np.float64)
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    if pos.shape[0] > max_points:
        sel = np.random.default_rng(0).permutation(pos.shape[0])[:max_points]
        pos, rgb = pos[sel], rgb[sel]
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=rgb, s=0.3, linewidths=0)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    fig.savefig(filename, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return filename


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin:0; overflow:hidden; background:#111; color:#ddd;
        font-family:monospace }
 #hud { position:fixed; top:8px; left:8px; z-index:2; user-select:none }
 canvas { display:block }
</style></head>
<body>
<div id="hud">__TITLE__ — drag: rotate · wheel: zoom · shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
// Self-contained WebGL point-cloud viewer (no external libraries): the
// interactive counterpart of the reference's mayavi window
// (utils/visualization.py:39-75), shippable from a headless box.
const PTS = new Float32Array([__POS__]);
const COL = new Uint8Array([__COL__]);
const N = PTS.length / 3;
const cv = document.getElementById("c");
const gl = cv.getContext("webgl");
const vs = `attribute vec3 p; attribute vec3 c; uniform mat4 mvp;
 uniform float ps; varying vec3 vc;
 void main(){ gl_Position = mvp*vec4(p,1.0); gl_PointSize = ps; vc = c; }`;
const fs = `precision mediump float; varying vec3 vc;
 void main(){ gl_FragColor = vec4(vc,1.0); }`;
function sh(t, s){ const o = gl.createShader(t); gl.shaderSource(o, s);
 gl.compileShader(o); return o; }
const pr = gl.createProgram();
gl.attachShader(pr, sh(gl.VERTEX_SHADER, vs));
gl.attachShader(pr, sh(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(pr); gl.useProgram(pr);
function buf(data, loc, norm){ const b = gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER, b); gl.bufferData(gl.ARRAY_BUFFER, data,
 gl.STATIC_DRAW); gl.enableVertexAttribArray(loc);
 gl.vertexAttribPointer(loc, 3, norm ? gl.UNSIGNED_BYTE : gl.FLOAT,
 norm, 0, 0); }
buf(PTS, gl.getAttribLocation(pr, "p"), false);
buf(COL, gl.getAttribLocation(pr, "c"), true);
const uMVP = gl.getUniformLocation(pr, "mvp");
const uPS = gl.getUniformLocation(pr, "ps");
let cx=0, cy=0, cz=0, r=0;
for (let i=0;i<N;i++){ cx+=PTS[3*i]; cy+=PTS[3*i+1]; cz+=PTS[3*i+2]; }
cx/=N; cy/=N; cz/=N;
for (let i=0;i<N;i++){ const dx=PTS[3*i]-cx, dy=PTS[3*i+1]-cy,
 dz=PTS[3*i+2]-cz; r=Math.max(r, dx*dx+dy*dy+dz*dz); }
r = Math.sqrt(r) || 1;
let yaw=0.6, pitch=0.5, dist=2.5*r, panX=0, panY=0, drag=0, lx=0, ly=0;
cv.onmousedown = e => { drag = e.shiftKey ? 2 : 1; lx=e.clientX; ly=e.clientY; };
window.onmouseup = () => drag=0;
window.onmousemove = e => { if(!drag) return;
 const dx=e.clientX-lx, dy=e.clientY-ly; lx=e.clientX; ly=e.clientY;
 if (drag===1){ yaw+=dx*0.005; pitch=Math.min(1.55,Math.max(-1.55,
  pitch+dy*0.005)); } else { panX-=dx*dist*0.001; panY+=dy*dist*0.001; } };
cv.onwheel = e => { dist*=Math.exp(e.deltaY*0.001); e.preventDefault(); };
function mul(a,b){ const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k]; o[i*4+j]=s;} return o; }
function draw(){
 const w=innerWidth, h=innerHeight;
 if (cv.width!==w||cv.height!==h){ cv.width=w; cv.height=h;
  gl.viewport(0,0,w,h); }
 const f=1/Math.tan(0.4), a=w/h, zn=0.01*r, zf=100*r;
 const P=[f/a,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1,
          0,0,2*zf*zn/(zn-zf),0];
 const cp=Math.cos(pitch), sp=Math.sin(pitch),
       cyw=Math.cos(yaw), syw=Math.sin(yaw);
 const ex=cx+dist*cp*syw, ey=cy+dist*sp, ez=cz+dist*cp*cyw;
 let zx=ex-cx, zy=ey-cy, zz=ez-cz;
 const zl=Math.hypot(zx,zy,zz); zx/=zl; zy/=zl; zz/=zl;
 let xx=zz, xy_=0, xz=-zx;       // up = +y
 const xl=Math.hypot(xx,xy_,xz)||1; xx/=xl; xz/=xl;
 const yx=zy*xz-zz*xy_, yy=zz*xx-zx*xz, yz=zx*xy_-zy*xx;
 const V=[xx,yx,zx,0, xy_,yy,zy,0, xz,yz,zz,0,
  -(xx*ex+xy_*ey+xz*ez)+panX, -(yx*ex+yy*ey+yz*ez)+panY,
  -(zx*ex+zy*ey+zz*ez), 1];
 gl.uniformMatrix4fv(uMVP, false, mul(P, V));
 gl.uniform1f(uPS, Math.max(1.5, 600*r/(dist*Math.sqrt(N)/Math.sqrt(h))));
 gl.clearColor(0.067,0.067,0.067,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);
 gl.drawArrays(gl.POINTS, 0, N);
 requestAnimationFrame(draw);
}
draw();
</script></body></html>
"""


def export_html(
    filename: str,
    pos: np.ndarray,
    labels: Optional[np.ndarray] = None,
    rgb: Optional[np.ndarray] = None,
    palette: np.ndarray = S3DIS_PALETTE,
    max_points: int = 500_000,
    title: str = "crfconv_tpu point cloud",
) -> str:
    """Interactive 3-D viewer as ONE self-contained HTML file.

    The functional replacement for the reference's interactive mayavi
    window (utils/visualization.py:39-75) on a headless machine: points
    and colors are embedded in a dependency-free WebGL page (orbit /
    zoom / pan), openable in any browser.  ``labels`` are colored via
    ``palette``; pass ``rgb`` (uint8 or 0-1 float) to color directly.
    """
    pos = np.asarray(pos, np.float32)
    if rgb is None:
        rgb = labels_to_colors(labels, palette)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = (
            np.clip(rgb * (255.0 if rgb.max() <= 1.0 else 1.0), 0, 255)
        ).astype(np.uint8)
    if pos.shape[0] > max_points:
        sel = np.random.default_rng(0).permutation(pos.shape[0])[:max_points]
        pos, rgb = pos[sel], rgb[sel]
    pos_js = ",".join(f"{v:.4g}" for v in pos.reshape(-1))
    col_js = ",".join(str(int(v)) for v in rgb.reshape(-1))
    html = (
        _HTML_TEMPLATE
        .replace("__TITLE__", title)
        .replace("__POS__", pos_js)
        .replace("__COL__", col_js)
    )
    d = os.path.dirname(os.path.abspath(filename))
    os.makedirs(d, exist_ok=True)
    with open(filename, "w") as f:
        f.write(html)
    return filename
