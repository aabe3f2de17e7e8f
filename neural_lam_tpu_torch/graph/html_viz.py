"""Interactive 3D graph visualization as a standalone HTML file.

Counterpart of neural_lam_tpu/graph/html_viz.py, page for page. The
reference renders its graphs with plotly and supports saving the
interactive figure to html (ref: neural_lam/plot_graph.py:19-210 and the
`--save` flag). The page here needs no plotly and no network (a
CDN-backed page would render blank on a machine without one): node
positions and edge segments are embedded as base64 float32 buffers and
drawn by ~100 lines of inline canvas JavaScript (drag to rotate, wheel
to zoom, checkboxes to toggle each edge/point set). It needs numpy
alone.
"""

from __future__ import annotations

import base64
import json

import numpy as np

_COLORS = {
    "blue": "#2a5fc4", "green": "#2d9c46", "purple": "#8344c4",
    "orange": "#e8882a", "red": "#d43a3a", "black": "#333333",
}
_MESH_LEVEL_COLORS = ["#c23ab0", "#3ab8c2", "#c2a13a", "#6a3ac2"]


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype=np.float32).tobytes()
    ).decode("ascii")


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; font:13px sans-serif; background:#fafafa; }}
 #panel {{ position:fixed; top:8px; left:8px; background:#fff;
          border:1px solid #ccc; border-radius:6px; padding:8px 12px; }}
 #panel label {{ display:block; cursor:pointer; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="panel"><b>{title}</b><br/>drag: rotate &middot; wheel: zoom
{controls}</div>
<canvas id="c"></canvas>
<script>
const SETS = {sets_json};
function decode(b64) {{
  const bin = atob(b64);
  const buf = new Float32Array(bin.length / 4);
  const dv = new DataView(new ArrayBuffer(4));
  for (let i = 0; i < buf.length; i++) {{
    for (let j = 0; j < 4; j++) dv.setUint8(j, bin.charCodeAt(i*4+j));
    buf[i] = dv.getFloat32(0, true);
  }}
  return buf;
}}
for (const s of SETS) s.xyz = decode(s.data);
// center + scale
let mn = [1e30,1e30,1e30], mx = [-1e30,-1e30,-1e30];
for (const s of SETS)
  for (let i = 0; i < s.xyz.length; i += 3)
    for (let d = 0; d < 3; d++) {{
      mn[d] = Math.min(mn[d], s.xyz[i+d]); mx[d] = Math.max(mx[d], s.xyz[i+d]);
    }}
const ctr = [0,1,2].map(d => (mn[d]+mx[d])/2);
const ext = Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2]) || 1;
let yaw = 0.5, pitch = 1.0, zoom = 1.0;
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
function draw() {{
  cv.width = window.innerWidth; cv.height = window.innerHeight;
  const W = cv.width, H = cv.height, S = Math.min(W, H) * 0.8 * zoom / ext;
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  ctx.clearRect(0, 0, W, H);
  function px(x, y, z) {{
    x -= ctr[0]; y -= ctr[1]; z -= ctr[2];
    const x1 = cy*x + sy*y, y1 = -sy*x + cy*y;
    const y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;
    return [W/2 + x1*S, H/2 + y2*S, z2];
  }}
  for (const s of SETS) {{
    if (!document.getElementById("cb_" + s.id).checked) continue;
    ctx.strokeStyle = s.color; ctx.fillStyle = s.color;
    ctx.lineWidth = s.width || 1; ctx.globalAlpha = s.alpha;
    const a = s.xyz;
    if (s.kind === "edges") {{
      ctx.beginPath();
      for (let i = 0; i < a.length; i += 6) {{
        const p = px(a[i], a[i+1], a[i+2]), q = px(a[i+3], a[i+4], a[i+5]);
        ctx.moveTo(p[0], p[1]); ctx.lineTo(q[0], q[1]);
      }}
      ctx.stroke();
    }} else {{
      const r = s.size || 2;
      for (let i = 0; i < a.length; i += 3) {{
        const p = px(a[i], a[i+1], a[i+2]);
        ctx.fillRect(p[0]-r/2, p[1]-r/2, r, r);
      }}
    }}
  }}
  ctx.globalAlpha = 1;
}}
let dragging = false, lx = 0, ly = 0;
cv.addEventListener("mousedown", e => {{ dragging = true; lx = e.clientX; ly = e.clientY; }});
window.addEventListener("mouseup", () => dragging = false);
window.addEventListener("mousemove", e => {{
  if (!dragging) return;
  yaw += (e.clientX - lx) * 0.01; pitch += (e.clientY - ly) * 0.01;
  pitch = Math.max(0, Math.min(Math.PI, pitch));
  lx = e.clientX; ly = e.clientY; requestAnimationFrame(draw);
}});
cv.addEventListener("wheel", e => {{
  zoom *= Math.exp(-e.deltaY * 0.001); e.preventDefault();
  requestAnimationFrame(draw);
}}, {{passive: false}});
window.addEventListener("resize", draw);
for (const s of SETS)
  document.getElementById("cb_" + s.id)
    .addEventListener("change", () => requestAnimationFrame(draw));
draw();
</script></body></html>
"""


def save_interactive_html(point_sets, edge_sets, path, title="Graph"):
    """Write the standalone interactive page for a `graph_scene(...)`
    result (see plot_graph.graph_scene)."""
    sets, controls = [], []
    mesh_lev = 0
    for i, es in enumerate(edge_sets):
        sets.append(dict(
            id=f"e{i}", kind="edges", color=_COLORS.get(es["color"], "#888"),
            width=max(0.4, es["width"]), alpha=0.5, data=_b64(es["segs"]),
        ))
        controls.append((f"e{i}", es["name"], sets[-1]["color"]))
    for i, ps in enumerate(point_sets):
        color = _COLORS.get(ps["color"])
        if color is None:
            color = _MESH_LEVEL_COLORS[mesh_lev % len(_MESH_LEVEL_COLORS)]
            mesh_lev += 1
        sets.append(dict(
            id=f"p{i}", kind="points", color=color, size=ps["size"] + 1,
            alpha=0.8, data=_b64(ps["pos"]),
        ))
        controls.append((f"p{i}", ps["name"], color))

    control_html = "".join(
        f'<label><input type="checkbox" id="cb_{cid}" checked/>'
        f'<span style="color:{color}">&#9632;</span> {name}</label>'
        for cid, name, color in controls
    )
    html = _PAGE.format(
        title=title, controls=control_html, sets_json=json.dumps(sets)
    )
    with open(path, "w") as f:
        f.write(html)
    return path
