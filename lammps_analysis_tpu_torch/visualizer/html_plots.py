"""Self-contained interactive HTML result plots.

A copy of ``lammps_analysis_tpu/visualizer/html_plots.py``: one
``figures/<title>.html`` per computation, plain inline SVG and vanilla JS
(crosshair and nearest-point tooltip per panel, light and dark schemes, a
collapsible data table), no external assets; the counterpart of the
reference's bokeh HTML (``mdsuite/visualizer/d2_data_visualization.py:36-140``).
One series per panel (the subject name is the panel title), so identity never
rides on color; values stay in text tokens; the grid is recessive. It needs
nothing beyond the standard library and numpy, so it is the plot that a
machine without matplotlib writes.
"""

from __future__ import annotations

import html
import json
import logging
import pathlib
from typing import List

import numpy as np

log = logging.getLogger(__name__)

_CSS = """
.viz-root { color-scheme: light;
  --surface-1:#fcfcfb; --text-primary:#0b0b0b; --text-secondary:#52514e;
  --grid:#e4e3df; --series-1:#2a78d6;
  font-family: system-ui, -apple-system, sans-serif;
  background: var(--surface-1); color: var(--text-primary);
  padding: 16px; }
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root { color-scheme: dark;
    --surface-1:#1a1a19; --text-primary:#ffffff; --text-secondary:#c3c2b7;
    --grid:#34332f; --series-1:#3987e5; } }
:root[data-theme="dark"] .viz-root { color-scheme: dark;
  --surface-1:#1a1a19; --text-primary:#ffffff; --text-secondary:#c3c2b7;
  --grid:#34332f; --series-1:#3987e5; }
.viz-root h1 { font-size: 16px; font-weight: 600; margin: 0 0 12px; }
.viz-grid { display: flex; flex-wrap: wrap; gap: 16px; }
.panel { position: relative; }
.panel h2 { font-size: 13px; font-weight: 600; margin: 0 0 4px; }
.panel svg { display: block; }
.panel .tip { position: absolute; pointer-events: none; display: none;
  background: var(--surface-1); border: 1px solid var(--grid);
  border-radius: 4px; padding: 4px 8px; font-size: 12px;
  color: var(--text-primary); white-space: nowrap; box-shadow: 0 1px 4px
  rgba(0,0,0,.15); }
.panel .tip .muted { color: var(--text-secondary); }
details { margin-top: 16px; font-size: 12px; }
summary { cursor: pointer; color: var(--text-secondary); }
table { border-collapse: collapse; margin-top: 8px; }
td, th { border: 1px solid var(--grid); padding: 2px 8px;
  font-variant-numeric: tabular-nums; }
"""

_JS = """
function fmt(v){ if(!isFinite(v)) return String(v);
  const a=Math.abs(v); if(a!==0&&(a<1e-3||a>=1e5)) return v.toExponential(3);
  return +v.toPrecision(5)+''; }
function ticks(lo,hi,n){ const span=hi-lo||1,
  step0=Math.pow(10,Math.floor(Math.log10(span/n))),
  err=span/n/step0, step=step0*(err>=7.5?10:err>=3.5?5:err>=1.5?2:1),
  out=[]; for(let v=Math.ceil(lo/step)*step; v<=hi+1e-12*span; v+=step)
  out.push(v); return out; }
function panel(el, data){
  const W=520,H=300,m={l:64,r:12,t:8,b:36},
    iw=W-m.l-m.r, ih=H-m.t-m.b,
    xs=data.x, ys=data.y,
    xlo=Math.min(...xs), xhi=Math.max(...xs),
    ylo=Math.min(...ys), yhi=Math.max(...ys),
    ypad=(yhi-ylo||1)*0.05,
    X=v=>m.l+(v-xlo)/((xhi-xlo)||1)*iw,
    Y=v=>m.t+ih-(v-(ylo-ypad))/((yhi-ylo+2*ypad)||1)*ih,
    ns='http://www.w3.org/2000/svg',
    svg=document.createElementNS(ns,'svg');
  svg.setAttribute('viewBox',`0 0 ${W} ${H}`);
  svg.setAttribute('width',W); svg.setAttribute('height',H);
  function add(tag,attrs,parent){ const e=document.createElementNS(ns,tag);
    for(const k in attrs) e.setAttribute(k,attrs[k]);
    (parent||svg).appendChild(e); return e; }
  for(const t of ticks(ylo-ypad,yhi+ypad,5)){
    add('line',{x1:m.l,x2:W-m.r,y1:Y(t),y2:Y(t),
      stroke:'var(--grid)','stroke-width':1});
    const lb=add('text',{x:m.l-6,y:Y(t)+4,'text-anchor':'end',
      'font-size':11,fill:'var(--text-secondary)'}); lb.textContent=fmt(t);
  }
  for(const t of ticks(xlo,xhi,6)){
    add('line',{x1:X(t),x2:X(t),y1:m.t+ih,y2:m.t+ih+4,
      stroke:'var(--grid)','stroke-width':1});
    const lb=add('text',{x:X(t),y:m.t+ih+16,'text-anchor':'middle',
      'font-size':11,fill:'var(--text-secondary)'}); lb.textContent=fmt(t);
  }
  const xl=add('text',{x:m.l+iw/2,y:H-4,'text-anchor':'middle',
    'font-size':11,fill:'var(--text-secondary)'}); xl.textContent=data.xlabel;
  const yl=add('text',{x:12,y:m.t+ih/2,'font-size':11,
    fill:'var(--text-secondary)',
    transform:`rotate(-90 12 ${m.t+ih/2})`,'text-anchor':'middle'});
  yl.textContent=data.ylabel;
  let dpath='';
  for(let i=0;i<xs.length;i++)
    dpath+=(i?'L':'M')+X(xs[i]).toFixed(2)+' '+Y(ys[i]).toFixed(2);
  add('path',{d:dpath,fill:'none',stroke:'var(--series-1)',
    'stroke-width':2,'stroke-linejoin':'round'});
  const cross=add('line',{y1:m.t,y2:m.t+ih,stroke:'var(--text-secondary)',
    'stroke-width':1,'stroke-dasharray':'3 3',visibility:'hidden'});
  const dot=add('circle',{r:4,fill:'var(--series-1)',
    stroke:'var(--surface-1)','stroke-width':2,visibility:'hidden'});
  const tip=el.querySelector('.tip');
  svg.addEventListener('mousemove',ev=>{
    const r=svg.getBoundingClientRect(),
      px=(ev.clientX-r.left)*W/r.width,
      xv=xlo+(px-m.l)/iw*((xhi-xlo)||1);
    let best=0,bd=1/0;
    for(let i=0;i<xs.length;i++){const d=Math.abs(xs[i]-xv);
      if(d<bd){bd=d;best=i;}}
    cross.setAttribute('x1',X(xs[best]));
    cross.setAttribute('x2',X(xs[best]));
    cross.setAttribute('visibility','visible');
    dot.setAttribute('cx',X(xs[best])); dot.setAttribute('cy',Y(ys[best]));
    dot.setAttribute('visibility','visible');
    tip.style.display='block';
    tip.innerHTML='<span class="muted">'+data.xlabel+'</span> '+fmt(xs[best])
      +'<br><span class="muted">'+data.ylabel+'</span> '+fmt(ys[best]);
    const tx=X(xs[best])*r.width/W+12;
    tip.style.left=Math.min(tx,r.width-tip.offsetWidth-4)+'px';
    tip.style.top=(Y(ys[best])*r.height/H-36)+'px';
  });
  svg.addEventListener('mouseleave',()=>{
    cross.setAttribute('visibility','hidden');
    dot.setAttribute('visibility','hidden');
    tip.style.display='none';});
  el.insertBefore(svg, tip);
}
for(const el of document.querySelectorAll('.panel'))
  panel(el, JSON.parse(el.dataset.series));
"""


def write_html_plot(
    computation,
    series_keys: List[str],
    out_dir,
    title: str = "analysis",
) -> pathlib.Path:
    """Write a self-contained interactive HTML grid plot; returns the path."""
    if len(series_keys) < 2:
        raise ValueError("need at least x and y series keys to plot")
    x_key, y_key = series_keys[0], series_keys[1]
    subjects = [
        s
        for s in computation.keys()
        if x_key in computation[s] and y_key in computation[s]
    ]
    if not subjects:
        raise ValueError(f"No subjects with series ({x_key}, {y_key}) to plot")

    panels = []
    tables = []
    for subject in subjects:
        data = computation[subject]
        x = np.asarray(data[x_key], dtype=float)
        y = np.asarray(data[y_key], dtype=float)
        m = min(len(x), len(y))
        x, y = x[:m], y[:m]
        finite = np.isfinite(x) & np.isfinite(y)
        series = json.dumps(
            {
                "x": x[finite].tolist(),
                "y": y[finite].tolist(),
                "xlabel": x_key,
                "ylabel": y_key,
            }
        )
        panels.append(
            f'<div class="panel" data-series=\'{html.escape(series)}\'>'
            f"<h2>{html.escape(str(subject))}</h2>"
            '<div class="tip"></div></div>'
        )
        rows = "".join(
            f"<tr><td>{xi:.6g}</td><td>{yi:.6g}</td></tr>"
            for xi, yi in zip(x[finite][:2000], y[finite][:2000])
        )
        tables.append(
            f"<h3>{html.escape(str(subject))}</h3>"
            f"<table><tr><th>{html.escape(x_key)}</th>"
            f"<th>{html.escape(y_key)}</th></tr>{rows}</table>"
        )

    doc = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title>"
        f"<style>{_CSS}</style></head>"
        f"<body class='viz-root'><h1>{html.escape(title)}</h1>"
        f"<div class='viz-grid'>{''.join(panels)}</div>"
        "<details><summary>Data table</summary>"
        f"{''.join(tables)}</details>"
        f"<script>{_JS}</script></body></html>"
    )
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{title}.html"
    path.write_text(doc)
    log.info("wrote %s", path)
    return path
