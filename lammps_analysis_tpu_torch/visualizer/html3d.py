"""Self-contained interactive 3-D viewers (canvas and vanilla JS).

A copy of ``lammps_analysis_tpu/visualizer/html3d.py``, the counterpart of the
reference's open3d SDF viewer (``mdsuite/visualizer/d3_data_visualizer.py:39-208``)
and znvis trajectory viewer (``znvis_visualizer.py:41-140``): one HTML file,
orthographic point clouds with drag-to-rotate and wheel zoom, a frame player
for trajectories, categorical species colors in fixed slot order with a
legend, and a sequential single-hue ramp for scalar-valued clouds (SDF
intensity). No external assets.
"""

from __future__ import annotations

import html
import json
import logging
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

#: categorical slots, fixed order (never cycled); light-mode values
_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#767676"]

_CSS = """
body { margin:0; font-family: system-ui, sans-serif; background:#fcfcfb;
  color:#0b0b0b; }
@media (prefers-color-scheme: dark) {
  body { background:#1a1a19; color:#ffffff; } .legend { color:#c3c2b7; } }
h1 { font-size:15px; margin:10px 14px 4px; }
.legend { font-size:12px; margin:0 14px 6px; color:#52514e; }
.legend span.chip { display:inline-block; width:10px; height:10px;
  border-radius:5px; margin:0 4px 0 12px; vertical-align:-1px; }
canvas { display:block; margin:0 auto; touch-action:none; cursor:grab; }
.bar { text-align:center; margin:6px; }
button { font:inherit; padding:2px 12px; }
input[type=range] { width:300px; vertical-align:middle; }
"""

_JS = """
const D = window.VIZ_DATA, cv = document.getElementById('c'),
  ctx = cv.getContext('2d'), W = cv.width, H = cv.height;
let rotX = -1.1, rotZ = 0.6, zoom = 1.0, frame = 0, playing = false;
const allPts = D.frames.flat(2).filter((_, i) => i % 3 === 0);
const center = D.center, scale0 = D.scale;
function project(p, sin1, cos1, sin2, cos2) {
  const x = p[0] - center[0], y = p[1] - center[1], z = p[2] - center[2];
  const x1 = x * cos2 - y * sin2, y1 = x * sin2 + y * cos2;
  const y2 = y1 * cos1 - z * sin1, z2 = y1 * sin1 + z * cos1;
  return [x1, y2, z2];
}
function draw() {
  ctx.clearRect(0, 0, W, H);
  const s = Math.sin(rotX), c = Math.cos(rotX),
    s2 = Math.sin(rotZ), c2 = Math.cos(rotZ),
    k = zoom * Math.min(W, H) * 0.42 / scale0,
    pts = [];
  const fr = D.frames[frame];
  for (let g = 0; g < fr.length; g++) {
    const grp = fr[g], col = D.colors[g], vals = D.values && D.values[g];
    for (let i = 0; i < grp.length; i++) {
      const q = project(grp[i], s, c, s2, c2);
      pts.push([q[0] * k + W / 2, H / 2 - q[1] * k, q[2],
                vals ? vals[i] : -1, col]);
    }
  }
  pts.sort((a, b) => a[2] - b[2]);
  for (const p of pts) {
    if (p[3] >= 0) {  // sequential ramp: light -> dark single hue
      const t = p[3];
      ctx.fillStyle = `rgb(${Math.round(214-160*t)},${Math.round(230-122*t)},`
        + `${Math.round(248-100*t)})`;
    } else ctx.fillStyle = p[4];
    ctx.beginPath();
    ctx.arc(p[0], p[1], D.radius * zoom, 0, 6.283);
    ctx.fill();
  }
}
let dragging = false, lx = 0, ly = 0;
cv.addEventListener('pointerdown', e => {
  dragging = true; lx = e.clientX; ly = e.clientY;
  cv.setPointerCapture(e.pointerId); });
cv.addEventListener('pointermove', e => {
  if (!dragging) return;
  rotZ += (e.clientX - lx) * 0.008; rotX += (e.clientY - ly) * 0.008;
  lx = e.clientX; ly = e.clientY; draw(); });
cv.addEventListener('pointerup', () => { dragging = false; });
cv.addEventListener('wheel', e => {
  e.preventDefault();
  zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw(); }, {passive: false});
const slider = document.getElementById('f'),
  lbl = document.getElementById('fl'),
  btn = document.getElementById('play');
function setFrame(i) {
  frame = i; if (slider) slider.value = i;
  if (lbl) lbl.textContent = D.frame_labels[i];
  draw();
}
if (slider) slider.addEventListener('input', () => setFrame(+slider.value));
if (btn) {
  let timer = null;
  btn.addEventListener('click', () => {
    playing = !playing;
    btn.textContent = playing ? 'Pause' : 'Play';
    if (playing) timer = setInterval(
      () => setFrame((frame + 1) % D.frames.length), 120);
    else clearInterval(timer);
  });
}
setFrame(0);
"""


def write_html_3d(
    frames: Sequence[Sequence[Tuple[str, np.ndarray]]],
    out_path,
    title: str = "trajectory",
    values: Optional[Sequence[np.ndarray]] = None,
    frame_labels: Optional[List[str]] = None,
    max_points: int = 20000,
    radius: float = 2.2,
) -> pathlib.Path:
    """Write an interactive 3-D point-cloud HTML.

    ``frames`` is a list of frames; each frame is a list of
    ``(species_name, (N, 3) points)`` groups. ``values`` (optional, one
    array per group of frame 0's layout, normalised 0..1) switches the
    coloring to a sequential single-hue ramp (scalar magnitude, e.g. SDF
    intensity) instead of categorical species colors.
    """
    species_names = [name for name, _ in frames[0]]
    # downsample uniformly if huge (interactivity over completeness; noted)
    stride = 1
    total = sum(len(np.asarray(p)) for _, p in frames[0])
    if total > max_points:
        stride = -(-total // max_points)
        log.info("3-D viewer downsampling by %d (%d points)", stride, total)

    frame_data = []
    for fr in frames:
        frame_data.append(
            [np.asarray(p)[::stride].round(4).tolist() for _, p in fr]
        )
    vals_data = None
    if values is not None:
        v = [np.asarray(x, dtype=float)[::stride] for x in values]
        lo = min(float(x.min()) for x in v if x.size)
        hi = max(float(x.max()) for x in v if x.size)
        span = (hi - lo) or 1.0
        vals_data = [((x - lo) / span).round(4).tolist() for x in v]

    pts0 = np.concatenate(
        [np.asarray(p)[::stride] for _, p in frames[0]], axis=0
    )
    center = pts0.mean(axis=0)
    scale = float(np.abs(pts0 - center).max()) or 1.0

    data = {
        "frames": frame_data,
        "values": vals_data,
        "colors": [_SERIES[i % len(_SERIES)] for i in range(len(species_names))],
        "center": center.round(5).tolist(),
        "scale": scale,
        "radius": radius,
        "frame_labels": frame_labels
        or [f"frame {i}" for i in range(len(frames))],
    }
    legend = "".join(
        f'<span class="chip" style="background:{_SERIES[i % len(_SERIES)]}">'
        f"</span>{html.escape(name)}"
        for i, name in enumerate(species_names)
    )
    player = ""
    if len(frames) > 1:
        player = (
            '<div class="bar"><button id="play">Play</button> '
            f'<input type="range" id="f" min="0" max="{len(frames) - 1}" '
            'value="0"> <span id="fl"></span></div>'
        )
    else:
        player = '<div class="bar"><span id="fl"></span></div>'
    doc = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{_CSS}</style></head>"
        f"<body><h1>{html.escape(title)}</h1>"
        f'<div class="legend">drag to rotate, wheel to zoom{legend}</div>'
        f"{player}"
        '<canvas id="c" width="900" height="640"></canvas>'
        f"<script>window.VIZ_DATA = {json.dumps(data)};{_JS}</script>"
        "</body></html>"
    )
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(doc)
    log.info("wrote %s", out_path)
    return out_path
