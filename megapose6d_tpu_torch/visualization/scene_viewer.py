"""Interactive 3D scene viewer: one self-contained WebGL HTML file.

Counterpart of `megapose6d_tpu/visualization/scene_viewer.py`, with the
port's own copy of its HTML/JS template, so that the same inputs write
the same file. The reference's meshcat workflow needs a running ZMQ bridge
and a served frontend; this writes one `.html` (an inline WebGL2
renderer, no external assets) that renders:

  - vertex-coloured meshes posed by 4x4 world-from-object transforms,
  - RGB axes gizmos ("frames") for poses (e.g. ground truth vs estimate),
  - wireframe bounding boxes,
  - point clouds (e.g. back-projected depth),
  - camera frusta from K / resolution / TWC,

with orbit / pan / zoom mouse controls and per-object visibility toggles.

    viewer = SceneViewer()
    viewer.add_mesh("obj", verts, faces, colors=..., TWO=pose_gt)
    viewer.add_frame("pred", pose_est)
    viewer.add_camera("cam", K, (H, W), TWC=np.eye(4))
    viewer.write_html("scene.html")
"""

from __future__ import annotations

import base64
import json
from html import escape as html_escape
from pathlib import Path

import numpy as np


def _b64(arr: np.ndarray, dtype) -> dict:
    a = np.ascontiguousarray(np.asarray(arr, dtype=dtype))
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def get_pointcloud(
    depth: np.ndarray,
    K: np.ndarray,
    max_points: int = 100_000,
    return_pixels: bool = False,
):
    """Back-project a depth image to camera-frame points
    (meshcat_utils.py:get_pointcloud:278-300).

    With `return_pixels=True` also returns the (v, u) pixel coordinates
    of each returned point — subsampling keeps them paired, so callers
    can look up per-point colors without misalignment."""
    depth = np.asarray(depth)
    if depth.ndim == 3:
        depth = depth[..., 0]
    vs, us = np.nonzero(depth > 0)
    zs = depth[vs, us]
    xs = (us - K[0, 2]) * zs / K[0, 0]
    ys = (vs - K[1, 2]) * zs / K[1, 1]
    pts = np.stack([xs, ys, zs], axis=-1)
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(
            len(pts), max_points, replace=False
        )
        pts, vs, us = pts[idx], vs[idx], us[idx]
    pts = pts.astype(np.float32)
    return (pts, vs, us) if return_pixels else pts


class SceneViewer:
    """Collects scene nodes, then writes a standalone HTML viewer."""

    def __init__(self, title: str = "megapose6d_tpu scene"):
        self.title = title
        self.nodes: list[dict] = []

    # -- nodes ---------------------------------------------------------

    def add_mesh(
        self,
        name: str,
        vertices: np.ndarray,
        faces: np.ndarray,
        colors: np.ndarray | None = None,
        TWO: np.ndarray | None = None,
        color: tuple = (0.7, 0.7, 0.75),
        opacity: float = 1.0,
    ) -> None:
        """meshcat_utils.py:visualize_mesh:78-103 (trimesh -> geometry)."""
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        if colors is None:
            colors = np.tile(
                np.asarray(color, np.float32), (len(vertices), 1)
            )
        colors = np.asarray(colors, np.float32).reshape(-1, 3)
        if colors.max() > 1.0 + 1e-6:
            colors = colors / 255.0
        self.nodes.append(
            {
                "type": "mesh",
                "name": name,
                "vertices": _b64(vertices, np.float32),
                "faces": _b64(np.asarray(faces).reshape(-1, 3), np.uint32),
                "colors": _b64(colors, np.float32),
                "pose": np.asarray(
                    np.eye(4) if TWO is None else TWO, np.float32
                ).tolist(),
                "opacity": float(opacity),
            }
        )

    def add_frame(
        self, name: str, T: np.ndarray, length: float = 0.1,
        radius: float = 0.0,
    ) -> None:
        """RGB axes triad at pose T (meshcat_utils.py:make_frame:148-195)."""
        del radius  # line-based triad; kept for API parity
        self.nodes.append(
            {
                "type": "frame",
                "name": name,
                "pose": np.asarray(T, np.float32).tolist(),
                "length": float(length),
            }
        )

    def add_bbox(
        self,
        name: str,
        dims: np.ndarray,
        T: np.ndarray | None = None,
        color: tuple = (0.0, 1.0, 0.0),
    ) -> None:
        """Wireframe box of extents `dims` centered at T
        (meshcat_utils.py:visualize_bbox:250-268)."""
        self.nodes.append(
            {
                "type": "bbox",
                "name": name,
                "dims": [float(d) for d in np.asarray(dims).reshape(3)],
                "pose": np.asarray(
                    np.eye(4) if T is None else T, np.float32
                ).tolist(),
                "color": [float(c) for c in color],
            }
        )

    def add_pointcloud(
        self,
        name: str,
        points: np.ndarray,
        colors: np.ndarray | None = None,
        T: np.ndarray | None = None,
        point_size: float = 2.0,
    ) -> None:
        """meshcat_utils.py:visualize_pointcloud:217-247."""
        points = np.asarray(points, np.float32).reshape(-1, 3)
        if colors is None:
            colors = np.tile(
                np.float32([0.85, 0.85, 0.85]), (len(points), 1)
            )
        colors = np.asarray(colors, np.float32).reshape(-1, 3)
        if colors.max() > 1.0 + 1e-6:
            colors = colors / 255.0
        self.nodes.append(
            {
                "type": "points",
                "name": name,
                "points": _b64(points, np.float32),
                "colors": _b64(colors, np.float32),
                "pose": np.asarray(
                    np.eye(4) if T is None else T, np.float32
                ).tolist(),
                "size": float(point_size),
            }
        )

    def add_camera(
        self,
        name: str,
        K: np.ndarray,
        resolution: tuple,
        TWC: np.ndarray | None = None,
        scale: float = 0.15,
        color: tuple = (1.0, 0.8, 0.0),
    ) -> None:
        """Camera frustum wireframe from intrinsics (the camera-pose
        context meshcat scenes carry implicitly)."""
        K = np.asarray(K, np.float64)
        h, w = resolution
        corners_px = np.array(
            [[0, 0], [w, 0], [w, h], [0, h]], np.float64
        )
        rays = np.concatenate(
            [
                (corners_px - K[[0, 1], [2, 2]]) / K[[0, 1], [0, 1]],
                np.ones((4, 1)),
            ],
            axis=1,
        )
        self.nodes.append(
            {
                "type": "camera",
                "name": name,
                "rays": (rays * scale).astype(np.float32).tolist(),
                "pose": np.asarray(
                    np.eye(4) if TWC is None else TWC, np.float32
                ).tolist(),
                "color": [float(c) for c in color],
            }
        )

    # -- high-level helpers -------------------------------------------

    def add_scene_observation(
        self, obs, mesh_for_label, max_points: int = 60_000
    ) -> None:
        """Populate from a SceneObservation: GT meshes + depth point cloud
        + camera (MeshcatSceneViewer.visualize_scene:79-99 analog).
        `mesh_for_label(label) -> (vertices, faces, colors|None)`."""
        for obj in obs.object_datas or []:
            verts, faces, colors = mesh_for_label(obj.label)
            self.add_mesh(
                f"gt/{obj.label}", verts, faces, colors=colors, TWO=obj.TWO
            )
            self.add_frame(f"gt_frame/{obj.label}", obj.TWO, length=0.05)
        if obs.depth is not None and obs.camera_data is not None:
            pts, vs, us = get_pointcloud(
                obs.depth, obs.camera_data.K, max_points=max_points,
                return_pixels=True,
            )
            TWC = (
                obs.camera_data.TWC
                if obs.camera_data.TWC is not None
                else np.eye(4)
            )
            rgb = None
            if obs.rgb is not None:
                rgb = obs.rgb[vs, us] / 255.0
            self.add_pointcloud("depth", pts, colors=rgb, T=TWC)
        if obs.camera_data is not None:
            TWC = (
                obs.camera_data.TWC
                if obs.camera_data.TWC is not None
                else np.eye(4)
            )
            self.add_camera(
                "camera",
                obs.camera_data.K,
                obs.camera_data.resolution,
                TWC=TWC,
            )

    def add_pose_estimates(
        self, estimates, mesh_for_label, prefix: str = "pred"
    ) -> None:
        """Overlay estimated poses (a `TensorCollection` with a `label`
        column and `poses [N, 4, 4]`) as semi-transparent meshes and
        frames."""
        labels = list(estimates.infos["label"])
        poses = estimates.poses
        poses = poses.detach().cpu().numpy() if hasattr(poses, "detach") else np.asarray(poses)
        for i, (label, pose) in enumerate(zip(labels, poses)):
            verts, faces, _ = mesh_for_label(label)
            tint = np.tile(np.float32([1.0, 0.35, 0.2]), (len(verts), 1))
            self.add_mesh(
                f"{prefix}/{i}_{label}",
                verts,
                faces,
                colors=tint,
                TWO=pose,
                opacity=0.55,
            )
            self.add_frame(f"{prefix}_frame/{i}_{label}", pose, length=0.05)

    # -- output --------------------------------------------------------

    def write_html(self, path: str | Path) -> Path:
        path = Path(path)
        payload = json.dumps({"title": self.title, "nodes": self.nodes})
        # The payload rides in a <script type="application/json"> block —
        # immune to quote/backslash content in titles or node names; the
        # only sequence that could terminate the block is "</script>",
        # prevented by the (JSON-legal) "<\/" escape.
        html = (
            _HTML_TEMPLATE.replace(
                "__TITLE__", html_escape(self.title)
            ).replace("__SCENE_JSON__", payload.replace("</", "<\\/"))
        )
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(html)
        return path


_HTML_TEMPLATE = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>__TITLE__</title>
<style>
 body { margin:0; overflow:hidden; background:#15171c;
        font-family:system-ui,sans-serif; }
 #panel { position:absolute; top:8px; left:8px; color:#dde;
          background:rgba(20,22,28,.8); padding:8px 12px;
          border-radius:6px; font-size:12px; max-height:92vh;
          overflow:auto; }
 #panel label { display:block; cursor:pointer; white-space:nowrap; }
 #hint { position:absolute; bottom:8px; left:8px; color:#889;
         font-size:11px; }
 canvas { display:block; }
</style>
</head>
<body>
<canvas id="c"></canvas>
<div id="panel"></div>
<div id="hint">drag: orbit &middot; shift-drag / right-drag: pan &middot;
wheel: zoom</div>
<script type="application/json" id="scene-data">__SCENE_JSON__</script>
<script>
"use strict";
const SCENE = JSON.parse(
  document.getElementById("scene-data").textContent
);

function decode(b) {
  const raw = atob(b.data), n = raw.length;
  const bytes = new Uint8Array(n);
  for (let i = 0; i < n; i++) bytes[i] = raw.charCodeAt(i);
  if (b.dtype === "float32") return new Float32Array(bytes.buffer);
  if (b.dtype === "uint32") return new Uint32Array(bytes.buffer);
  throw new Error("dtype " + b.dtype);
}

// ---- tiny column-major mat4 library ----
function ident() { return [1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1]; }
function mul(a, b) {
  const o = new Array(16).fill(0);
  for (let c = 0; c < 4; c++) for (let r = 0; r < 4; r++)
    for (let k = 0; k < 4; k++) o[c*4+r] += a[k*4+r] * b[c*4+k];
  return o;
}
function fromRowMajor(m) {   // m: [[..4],[..4],[..4],[..4]]
  const o = new Array(16);
  for (let r = 0; r < 4; r++) for (let c = 0; c < 4; c++)
    o[c*4+r] = m[r][c];
  return o;
}
function perspective(fovy, aspect, near, far) {
  const f = 1 / Math.tan(fovy / 2), nf = 1 / (near - far);
  return [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1,
          0,0,2*far*near*nf,0];
}
function lookAt(eye, at, up) {
  const z = norm3(sub3(eye, at)), x = norm3(cross3(up, z)),
        y = cross3(z, x);
  return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
          -dot3(x,eye), -dot3(y,eye), -dot3(z,eye), 1];
}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function add3(a,b){return [a[0]+b[0],a[1]+b[1],a[2]+b[2]];}
function scale3(a,s){return [a[0]*s,a[1]*s,a[2]*s];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2],
                             a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
                  return [a[0]/l,a[1]/l,a[2]/l];}

// ---- GL setup ----
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl2", {antialias: true});
const VS = `#version 300 es
layout(location=0) in vec3 pos;
layout(location=1) in vec3 col;
uniform mat4 mvp, model;
uniform float psize;
out vec3 vcol; out vec3 vpos;
void main() {
  gl_Position = mvp * model * vec4(pos, 1.0);
  gl_PointSize = psize;
  vcol = col;
  vpos = (model * vec4(pos, 1.0)).xyz;
}`;
const FS = `#version 300 es
precision highp float;
in vec3 vcol; in vec3 vpos;
uniform float opacity;
uniform int shade;
out vec4 frag;
void main() {
  vec3 c = vcol;
  if (shade == 1) {
    vec3 n = normalize(cross(dFdx(vpos), dFdy(vpos)));
    float l = 0.45 + 0.55 * abs(n.z);
    c *= l;
  }
  frag = vec4(c, opacity);
}`;
function compile(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw new Error(gl.getShaderInfoLog(s));
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, compile(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, compile(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
gl.useProgram(prog);
const U = {
  mvp: gl.getUniformLocation(prog, "mvp"),
  model: gl.getUniformLocation(prog, "model"),
  opacity: gl.getUniformLocation(prog, "opacity"),
  shade: gl.getUniformLocation(prog, "shade"),
  psize: gl.getUniformLocation(prog, "psize"),
};

function makeVao(positions, colors, indices) {
  const vao = gl.createVertexArray();
  gl.bindVertexArray(vao);
  const pb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, pb);
  gl.bufferData(gl.ARRAY_BUFFER, positions, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(0);
  gl.vertexAttribPointer(0, 3, gl.FLOAT, false, 0, 0);
  const cb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, cb);
  gl.bufferData(gl.ARRAY_BUFFER, colors, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(1);
  gl.vertexAttribPointer(1, 3, gl.FLOAT, false, 0, 0);
  let count = positions.length / 3;
  if (indices) {
    const ib = gl.createBuffer();
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ib);
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, indices, gl.STATIC_DRAW);
    count = indices.length;
  }
  gl.bindVertexArray(null);
  return {vao, count, indexed: !!indices};
}

function linesVao(segs, color) {   // segs: flat [x0,y0,z0,x1,y1,z1,...]
  const pos = new Float32Array(segs);
  const col = new Float32Array(pos.length);
  for (let i = 0; i < pos.length; i += 3) {
    col[i] = color[0]; col[i+1] = color[1]; col[i+2] = color[2];
  }
  return makeVao(pos, col, null);
}

// ---- build draw list ----
const draws = [];   // {name, mode, vao, model, opacity, shade, size}
let bboxMin = [1e9,1e9,1e9], bboxMax = [-1e9,-1e9,-1e9];
function grow(p) {
  for (let i = 0; i < 3; i++) {
    bboxMin[i] = Math.min(bboxMin[i], p[i]);
    bboxMax[i] = Math.max(bboxMax[i], p[i]);
  }
}
for (const node of SCENE.nodes) {
  const model = fromRowMajor(node.pose);
  if (node.type === "mesh") {
    const v = decode(node.vertices), c = decode(node.colors),
          f = decode(node.faces);
    for (let i = 0; i < v.length; i += Math.max(3, 3*((v.length/3/64)|0)))
      grow(applyPose(node.pose, [v[i], v[i+1], v[i+2]]));
    draws.push({name: node.name, mode: gl.TRIANGLES,
                geo: makeVao(v, c, f), model,
                opacity: node.opacity, shade: 1, size: 1});
  } else if (node.type === "points") {
    const v = decode(node.points), c = decode(node.colors);
    for (let i = 0; i < v.length; i += Math.max(3, 3*((v.length/3/64)|0)))
      grow(applyPose(node.pose, [v[i], v[i+1], v[i+2]]));
    draws.push({name: node.name, mode: gl.POINTS,
                geo: makeVao(v, c, null), model,
                opacity: 1, shade: 0, size: node.size});
  } else if (node.type === "frame") {
    const L = node.length;
    for (const axis of [[0,[1,0,0],[0.9,0.2,0.2]],
                        [1,[0,1,0],[0.2,0.85,0.2]],
                        [2,[0,0,1],[0.25,0.45,1]]]) {
      const d = axis[1];
      draws.push({name: node.name, mode: gl.LINES,
                  geo: linesVao([0,0,0, d[0]*L, d[1]*L, d[2]*L], axis[2]),
                  model, opacity: 1, shade: 0, size: 1});
    }
    grow(applyPose(node.pose, [0,0,0]));
  } else if (node.type === "bbox") {
    const [dx,dy,dz] = node.dims.map(d => d/2);
    const corners = [];
    for (const sx of [-1,1]) for (const sy of [-1,1])
      for (const sz of [-1,1]) corners.push([sx*dx, sy*dy, sz*dz]);
    const edges = [[0,1],[0,2],[1,3],[2,3],[4,5],[4,6],[5,7],[6,7],
                   [0,4],[1,5],[2,6],[3,7]];
    const segs = [];
    for (const [a,b] of edges) segs.push(...corners[a], ...corners[b]);
    draws.push({name: node.name, mode: gl.LINES,
                geo: linesVao(segs, node.color), model,
                opacity: 1, shade: 0, size: 1});
    grow(applyPose(node.pose, [0,0,0]));
  } else if (node.type === "camera") {
    const segs = [];
    for (const r of node.rays) segs.push(0,0,0, r[0], r[1], r[2]);
    for (let i = 0; i < 4; i++) {
      const a = node.rays[i], b = node.rays[(i+1)%4];
      segs.push(a[0],a[1],a[2], b[0],b[1],b[2]);
    }
    draws.push({name: node.name, mode: gl.LINES,
                geo: linesVao(segs, node.color), model,
                opacity: 1, shade: 0, size: 1});
    grow(applyPose(node.pose, [0,0,0]));
  }
}
function applyPose(m, p) {
  return [m[0][0]*p[0]+m[0][1]*p[1]+m[0][2]*p[2]+m[0][3],
          m[1][0]*p[0]+m[1][1]*p[1]+m[1][2]*p[2]+m[1][3],
          m[2][0]*p[0]+m[2][1]*p[1]+m[2][2]*p[2]+m[2][3]];
}

// ---- visibility panel ----
const visible = {};
const panel = document.getElementById("panel");
{
  const names = [...new Set(draws.map(d => d.name))];
  for (const n of names) {
    visible[n] = true;
    const lab = document.createElement("label");
    const cb = document.createElement("input");
    cb.type = "checkbox"; cb.checked = true;
    cb.onchange = () => { visible[n] = cb.checked; render(); };
    lab.appendChild(cb);
    lab.appendChild(document.createTextNode(" " + n));
    panel.appendChild(lab);
  }
}

// ---- camera state ----
const center = scale3(add3(bboxMin, bboxMax), 0.5);
let radius = Math.max(0.25,
  1.8 * Math.hypot(...sub3(bboxMax, bboxMin)) / 2);
let theta = -1.2, phi = 1.0;
let panOff = [0, 0, 0];
function eyePos() {
  return add3(add3(center, panOff),
    [radius*Math.sin(phi)*Math.cos(theta),
     radius*Math.cos(phi),
     radius*Math.sin(phi)*Math.sin(theta)]);
}

let dragging = 0;
canvas.addEventListener("mousedown", e => {
  dragging = (e.button === 2 || e.shiftKey) ? 2 : 1;
});
window.addEventListener("mouseup", () => dragging = 0);
canvas.addEventListener("contextmenu", e => e.preventDefault());
window.addEventListener("mousemove", e => {
  if (!dragging) return;
  if (dragging === 1) {
    theta += e.movementX * 0.008;
    phi = Math.min(3.1, Math.max(0.05, phi - e.movementY * 0.008));
  } else {
    const s = radius * 0.0015;
    const fwd = norm3(sub3(add3(center, panOff), eyePos()));
    const rightv = norm3(cross3(fwd, [0,1,0]));
    const upv = cross3(rightv, fwd);
    panOff = add3(panOff, add3(scale3(rightv, -e.movementX*s),
                               scale3(upv, e.movementY*s)));
  }
  render();
});
canvas.addEventListener("wheel", e => {
  radius *= Math.exp(e.deltaY * 0.001);
  render(); e.preventDefault();
}, {passive: false});

function resize() {
  canvas.width = innerWidth * devicePixelRatio;
  canvas.height = innerHeight * devicePixelRatio;
  canvas.style.width = innerWidth + "px";
  canvas.style.height = innerHeight + "px";
  gl.viewport(0, 0, canvas.width, canvas.height);
  render();
}
window.addEventListener("resize", resize);

function render() {
  gl.clearColor(0.082, 0.090, 0.11, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  gl.enable(gl.BLEND);
  gl.blendFunc(gl.SRC_ALPHA, gl.ONE_MINUS_SRC_ALPHA);
  const proj = perspective(0.9, canvas.width / canvas.height,
                           0.001, 1000);
  const view = lookAt(eyePos(), add3(center, panOff), [0, 1, 0]);
  const vp = mul(proj, view);
  gl.uniformMatrix4fv(U.mvp, false, new Float32Array(vp));
  const sorted = [...draws].sort((a, b) => b.opacity - a.opacity);
  for (const d of sorted) {
    if (!visible[d.name]) continue;
    gl.uniformMatrix4fv(U.model, false, new Float32Array(d.model));
    gl.uniform1f(U.opacity, d.opacity);
    gl.uniform1i(U.shade, d.shade);
    gl.uniform1f(U.psize, d.size * devicePixelRatio);
    gl.depthMask(d.opacity >= 1.0);
    gl.bindVertexArray(d.geo.vao);
    if (d.geo.indexed)
      gl.drawElements(d.mode, d.geo.count, gl.UNSIGNED_INT, 0);
    else
      gl.drawArrays(d.mode, 0, d.geo.count);
  }
  gl.depthMask(true);
  gl.bindVertexArray(null);
}
resize();
</script>
</body>
</html>
"""
