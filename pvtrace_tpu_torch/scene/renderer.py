"""Scene and ray-path visualisation.

The reference renders interactively through meshcat/ZMQ
(``pvtrace/scene/renderer.py``). meshcat is not a dependency here; this
renderer produces a **self-contained interactive HTML file** (inline
JavaScript orthographic projection, no external assets) with the scene
wireframe and wavelength-coloured ray paths, plus the same public API
surface (`render`, `add_ray_path`, `add_history`, `remove`, `vis`).
A ``MeshcatRenderer`` alias keeps reference scripts importable.
"""
import json
import os
import tempfile
import webbrowser
from collections import deque

import numpy as np

from pvtrace_tpu_torch.light.utils import wavelength_to_rgb


def _edges_box(size):
    x, y, z = [s / 2.0 for s in size]
    corners = [
        (-x, -y, -z), (x, -y, -z), (x, y, -z), (-x, y, -z),
        (-x, -y, z), (x, -y, z), (x, y, z), (-x, y, z),
    ]
    idx = [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    return [(corners[a], corners[b]) for a, b in idx]


def _edges_sphere(radius, n=24):
    out = []
    ts = np.linspace(0, 2 * np.pi, n + 1)
    for axis in range(3):
        pts = []
        for t in ts:
            p = [0.0, 0.0, 0.0]
            p[(axis + 1) % 3] = radius * np.cos(t)
            p[(axis + 2) % 3] = radius * np.sin(t)
            pts.append(tuple(p))
        out.extend(zip(pts[:-1], pts[1:]))
    return out


def _edges_cylinder(length, radius, n=24):
    out = []
    ts = np.linspace(0, 2 * np.pi, n + 1)
    for z in (-length / 2, length / 2):
        pts = [(radius * np.cos(t), radius * np.sin(t), z) for t in ts]
        out.extend(zip(pts[:-1], pts[1:]))
    for t in ts[:-1:6]:
        out.append(
            (
                (radius * np.cos(t), radius * np.sin(t), -length / 2),
                (radius * np.cos(t), radius * np.sin(t), length / 2),
            )
        )
    return out


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pvtrace_tpu scene</title>
<style>body{margin:0;background:#111;color:#ccc;font-family:sans-serif}
#c{display:block}#hud{position:fixed;top:8px;left:8px;font-size:12px}</style>
</head><body>
<div id="hud">drag: rotate &middot; wheel: zoom</div>
<canvas id="c"></canvas>
<script>
const SEGMENTS = __SEGMENTS__;
const RAYS = __RAYS__;
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let yaw = 0.7, pitch = 0.5, zoom = 1.0;
function resize(){canvas.width=innerWidth;canvas.height=innerHeight;draw();}
addEventListener('resize', resize);
let drag=false,lx=0,ly=0;
canvas.addEventListener('mousedown',e=>{drag=true;lx=e.clientX;ly=e.clientY;});
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{if(!drag)return;yaw+=(e.clientX-lx)*.01;
pitch+=(e.clientY-ly)*.01;lx=e.clientX;ly=e.clientY;draw();});
canvas.addEventListener('wheel',e=>{zoom*=e.deltaY<0?1.1:0.9;draw();});
function project(p){
  const [x,y,z]=p;
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const x1=cy*x+sy*y, y1=-sy*x+cy*y;
  const y2=cp*y1-sp*z, z2=sp*y1+cp*z;
  const s=zoom*Math.min(canvas.width,canvas.height)*0.35/__SCALE__;
  return [canvas.width/2+x1*s, canvas.height/2-z2*s];
}
function draw(){
  ctx.fillStyle='#111';ctx.fillRect(0,0,canvas.width,canvas.height);
  ctx.lineWidth=1;
  for(const seg of SEGMENTS){
    ctx.strokeStyle='#445';
    ctx.beginPath();
    const a=project(seg[0]),b=project(seg[1]);
    ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
  }
  for(const ray of RAYS){
    ctx.strokeStyle=ray.color;
    ctx.beginPath();
    let first=true;
    for(const p of ray.points){
      const q=project(p);
      if(first){ctx.moveTo(q[0],q[1]);first=false;}else ctx.lineTo(q[0],q[1]);
    }
    ctx.stroke();
  }
}
resize();
</script></body></html>
"""


class SceneRenderer:
    """Static HTML scene renderer with meshcat-like API."""

    def __init__(self, max_histories=50, open_browser=False, **kwargs):
        self.segments = []
        self.rays = deque(maxlen=max_histories * 64 if max_histories else None)
        self._scene_scale = 1.0
        self.open_browser = open_browser
        self._path = None

    # -- meshcat-compatible API ---------------------------------------

    @property
    def vis(self):
        return self

    def render(self, scene):
        """Collect wireframe segments for every geometry node."""
        from pvtrace_tpu_torch.geometry.box import Box
        from pvtrace_tpu_torch.geometry.cylinder import Cylinder
        from pvtrace_tpu_torch.geometry.mesh import Mesh
        from pvtrace_tpu_torch.geometry.sphere import Sphere

        root = scene.root
        extent = 1.0
        for node in root.iter_preorder():
            geometry = node.geometry
            if geometry is None:
                continue
            if isinstance(geometry, Box):
                edges = _edges_box(geometry._size)
                extent = max(extent, float(np.max(geometry._size)) / 2)
            elif isinstance(geometry, Sphere):
                edges = _edges_sphere(geometry.radius)
                extent = max(extent, geometry.radius)
            elif isinstance(geometry, Cylinder):
                edges = _edges_cylinder(geometry.length, geometry.radius)
                extent = max(extent, max(geometry.length, geometry.radius))
            elif isinstance(geometry, Mesh):
                edges = []
                v = geometry.vertices
                for face in geometry.faces:
                    for a, b in ((0, 1), (1, 2), (2, 0)):
                        edges.append((tuple(v[face[a]]), tuple(v[face[b]])))
                extent = max(extent, float(np.abs(v).max()))
            else:
                continue
            for a, b in edges:
                wa = node.point_to_node(a, root)
                wb = node.point_to_node(b, root)
                self.segments.append([list(wa), list(wb)])
        # Scale to a mid-sized node, not the huge world box
        self._scene_scale = extent
        return self

    def add_ray_path(self, rays):
        """Add a polyline for a sequence of Ray objects."""
        if not rays:
            return
        wavelength = rays[0].wavelength or 555.0
        r, g, b = wavelength_to_rgb(wavelength)
        color = "#%02x%02x%02x" % (int(r * 255), int(g * 255), int(b * 255))
        points = [list(ray.position) for ray in rays]
        self.rays.append({"color": color, "points": points})

    def add_history(self, history, **kwargs):
        """Add a traced history [(Ray, Event)] or [(Ray, Event, meta)]."""
        rays = [item[0] for item in history]
        self.add_ray_path(rays)

    def remove(self, scene=None):
        self.segments = []
        self.rays.clear()

    # -- output --------------------------------------------------------

    def to_html(self):
        scale = max(self._scene_scale, 1e-6)
        html = _HTML_TEMPLATE.replace(
            "__SEGMENTS__", json.dumps(self.segments)
        ).replace("__RAYS__", json.dumps(list(self.rays))).replace(
            "__SCALE__", repr(float(scale))
        )
        return html

    def save(self, path=None):
        if path is None:
            fd, path = tempfile.mkstemp(suffix=".html", prefix="pvtrace_tpu_")
            os.close(fd)
        with open(path, "w") as fh:
            fh.write(self.to_html())
        self._path = path
        if self.open_browser:
            webbrowser.open("file://" + path)
        return path


# Alias so reference scripts importing MeshcatRenderer keep working
MeshcatRenderer = SceneRenderer
