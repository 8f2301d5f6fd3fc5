/* pvtrace_tpu studio frontend.
 *
 * Hand-written viewport (canvas 2D, orbit camera, wireframe geometry,
 * wavelength-coloured ray paths), YAML editor, inspector panels and
 * live recorder plots. Results stream over Server-Sent Events.
 */
"use strict";

// ---------------------------------------------------------------- state

const state = {
  scene: null,        // payload from the server
  paths: [],          // sampled ray polylines from the current run
  selected: null,     // selected node name
  running: false,
  histMeta: null,     // histogram metadata for the current run
  recorders: null,    // latest recorder tallies
  gizmo: null,        // live drag-to-move state {name, world}
};

const $ = (id) => document.getElementById(id);

// ---------------------------------------------------------------- api

async function api(method, url, body) {
  const response = await fetch(url, {
    method,
    headers: { "Content-Type": "application/json" },
    body: body === undefined ? undefined : JSON.stringify(body),
  });
  const data = await response.json();
  if (!response.ok) throw new Error(data.error || response.statusText);
  return data;
}

async function applyDocument(text) {
  const error = $("editor-error");
  error.textContent = "";
  try {
    const data = await api("PUT", "/api/document", { text });
    state.scene = data.scene;
    state.paths = [];
    fitCameraToScene();
    renderAll();
  } catch (exception) {
    error.textContent = exception.message;
  }
}

async function patch(payload) {
  const error = $("editor-error");
  error.textContent = "";
  try {
    const data = await api("POST", "/api/patch", payload);
    state.scene = data.scene;
    setEditorValue(data.text);
    renderAll();
  } catch (exception) {
    error.textContent = exception.message;
  }
}

// ---------------------------------------------------------------- math

function mat4Apply(m, p) {
  // m: row-major 16-array, p: [x, y, z] -> transformed point
  return [
    m[0] * p[0] + m[1] * p[1] + m[2] * p[2] + m[3],
    m[4] * p[0] + m[5] * p[1] + m[6] * p[2] + m[7],
    m[8] * p[0] + m[9] * p[1] + m[10] * p[2] + m[11],
  ];
}

function wavelengthToRGB(nm) {
  // Visible-spectrum approximation (matches pvtrace_tpu.light.utils).
  let r = 0, g = 0, b = 0;
  if (nm < 380) { r = 0.3; b = 0.6; }
  else if (nm < 440) { r = -(nm - 440) / 60; b = 1; }
  else if (nm < 490) { g = (nm - 440) / 50; b = 1; }
  else if (nm < 510) { g = 1; b = -(nm - 510) / 20; }
  else if (nm < 580) { r = (nm - 510) / 70; g = 1; }
  else if (nm < 645) { r = 1; g = -(nm - 645) / 65; }
  else if (nm <= 780) { r = 1; }
  else { r = 0.5; }
  const k = 255;
  return `rgb(${Math.round(r * k)},${Math.round(g * k)},${Math.round(b * k)})`;
}

// Wireframe edge lists in the local frame ---------------------------------

function circlePoints(radius, z, n, axis) {
  const points = [];
  for (let i = 0; i <= n; i++) {
    const t = (2 * Math.PI * i) / n;
    const u = radius * Math.cos(t), v = radius * Math.sin(t);
    if (axis === "z") points.push([u, v, z]);
    else if (axis === "y") points.push([u, z, v]);
    else points.push([z, u, v]);
  }
  return points;
}

function polylineEdges(points) {
  const edges = [];
  for (let i = 0; i + 1 < points.length; i++) edges.push([points[i], points[i + 1]]);
  return edges;
}

function geometryEdges(node) {
  const p = node.params;
  if (node.type === "box" || node.type === "mesh") {
    // Meshes render as their bounding box (server sends extents).
    const [a, b, c] = [p[0] / 2, p[1] / 2, p[2] / 2];
    const v = [];
    for (const sx of [-1, 1]) for (const sy of [-1, 1]) for (const sz of [-1, 1])
      v.push([sx * a, sy * b, sz * c]);
    const index = [[0,1],[2,3],[4,5],[6,7],[0,2],[1,3],[4,6],[5,7],[0,4],[1,5],[2,6],[3,7]];
    return index.map(([i, j]) => [v[i], v[j]]);
  }
  if (node.type === "sphere") {
    const r = p[0];
    let edges = [];
    for (const axis of ["x", "y", "z"])
      edges = edges.concat(polylineEdges(circlePoints(r, 0, 32, axis)));
    edges = edges.concat(polylineEdges(circlePoints(r * 0.7071, r * 0.7071, 32, "z")));
    edges = edges.concat(polylineEdges(circlePoints(r * 0.7071, -r * 0.7071, 32, "z")));
    return edges;
  }
  if (node.type === "cylinder") {
    const [length, r] = [p[0], p[1]];
    let edges = [];
    edges = edges.concat(polylineEdges(circlePoints(r, length / 2, 32, "z")));
    edges = edges.concat(polylineEdges(circlePoints(r, -length / 2, 32, "z")));
    for (const t of [0, Math.PI / 2, Math.PI, (3 * Math.PI) / 2]) {
      const x = r * Math.cos(t), y = r * Math.sin(t);
      edges.push([[x, y, -length / 2], [x, y, length / 2]]);
    }
    return edges;
  }
  return [];
}

// ---------------------------------------------------------------- camera

const camera = { yaw: 0.7, pitch: 0.5, dist: 20, target: [0, 0, 0], fov: 500 };

function cameraBasis() {
  const cy = Math.cos(camera.yaw), sy = Math.sin(camera.yaw);
  const cp = Math.cos(camera.pitch), sp = Math.sin(camera.pitch);
  // Z-up world; camera looks at target.
  const forward = [cp * cy, cp * sy, sp];        // target -> camera
  const right = [-sy, cy, 0];
  const up = [-sp * cy, -sp * sy, cp];
  return { forward, right, up };
}

function project(point, width, height) {
  const { forward, right, up } = cameraBasis();
  const eye = [
    camera.target[0] + forward[0] * camera.dist,
    camera.target[1] + forward[1] * camera.dist,
    camera.target[2] + forward[2] * camera.dist,
  ];
  const d = [point[0] - eye[0], point[1] - eye[1], point[2] - eye[2]];
  const z = -(d[0] * forward[0] + d[1] * forward[1] + d[2] * forward[2]);
  if (z <= 0.05) return null; // behind the camera
  const x = d[0] * right[0] + d[1] * right[1] + d[2] * right[2];
  const y = d[0] * up[0] + d[1] * up[1] + d[2] * up[2];
  const s = camera.fov / z;
  return [width / 2 + x * s, height / 2 - y * s, z];
}

function fitCameraToScene() {
  if (!state.scene) return;
  let radius = 1;
  for (const node of state.scene.nodes) {
    if (node.root) continue; // world container is usually huge
    const extent = Math.max(...node.params.map(Math.abs), 0.5);
    const center = mat4Apply(node.matrix, [0, 0, 0]);
    radius = Math.max(radius, Math.hypot(...center) + extent);
  }
  camera.dist = radius * 3.2;
}

// ---------------------------------------------------------------- webgl
//
// Solid depth-tested rendering: shaded translucent geometry (true
// triangle soup for mesh nodes), wavelength-coloured ray paths occluded
// by geometry, and recorder heatmaps uploaded as textures painted onto
// geometry faces. The 2D canvas on top keeps axes, wireframe outlines
// and the drag gizmo (and is the full fallback when WebGL is absent).

const glState = {
  gl: null,
  solid: null,
  line: null,
  tex: null,
  meshes: new Map(),   // node name -> {buffer, count, key}
  textures: new Map(), // recorder/hist key -> {tex, na, nb, stamp}
};

function compileProgram(gl, vsSource, fsSource, attribs) {
  const make = (type, source) => {
    const shader = gl.createShader(type);
    gl.shaderSource(shader, source);
    gl.compileShader(shader);
    if (!gl.getShaderParameter(shader, gl.COMPILE_STATUS))
      throw new Error(gl.getShaderInfoLog(shader));
    return shader;
  };
  const program = gl.createProgram();
  gl.attachShader(program, make(gl.VERTEX_SHADER, vsSource));
  gl.attachShader(program, make(gl.FRAGMENT_SHADER, fsSource));
  gl.linkProgram(program);
  if (!gl.getProgramParameter(program, gl.LINK_STATUS))
    throw new Error(gl.getProgramInfoLog(program));
  const handles = { program };
  for (const name of attribs) handles[name] = gl.getAttribLocation(program, name);
  return handles;
}

function initGL() {
  const canvas = $("viewport-gl");
  let gl = null;
  try {
    gl = canvas.getContext("webgl", { antialias: true, premultipliedAlpha: false });
  } catch (e) { gl = null; }
  if (!gl) return;
  glState.gl = gl;
  glState.solid = compileProgram(gl, `
    attribute vec3 aPos; attribute vec3 aNrm;
    uniform mat4 uMVP; uniform mat3 uNormal;
    varying vec3 vNrm;
    void main() { gl_Position = uMVP * vec4(aPos, 1.0); vNrm = uNormal * aNrm; }
  `, `
    precision mediump float;
    uniform vec4 uColor; uniform vec3 uLight;
    varying vec3 vNrm;
    void main() {
      float d = abs(dot(normalize(vNrm), uLight));
      gl_FragColor = vec4(uColor.rgb * (0.4 + 0.6 * d), uColor.a);
    }
  `, ["aPos", "aNrm"]);
  glState.line = compileProgram(gl, `
    attribute vec3 aPos; attribute vec3 aCol;
    uniform mat4 uMVP; varying vec3 vCol;
    void main() { gl_Position = uMVP * vec4(aPos, 1.0); vCol = aCol; }
  `, `
    precision mediump float; varying vec3 vCol; uniform float uAlpha;
    void main() { gl_FragColor = vec4(vCol, uAlpha); }
  `, ["aPos", "aCol"]);
  glState.tex = compileProgram(gl, `
    attribute vec3 aPos; attribute vec2 aUV;
    uniform mat4 uMVP; varying vec2 vUV;
    void main() { gl_Position = uMVP * vec4(aPos, 1.0); vUV = aUV; }
  `, `
    precision mediump float; uniform sampler2D uTex; varying vec2 vUV;
    void main() {
      vec4 t = texture2D(uTex, vUV);
      if (t.a < 0.01) discard;
      gl_FragColor = t;
    }
  `, ["aPos", "aUV"]);
}

// column-major 4x4 helpers
function matMul(a, b) {
  const out = new Float32Array(16);
  for (let c = 0; c < 4; c++)
    for (let r = 0; r < 4; r++) {
      let s = 0;
      for (let k = 0; k < 4; k++) s += a[k * 4 + r] * b[c * 4 + k];
      out[c * 4 + r] = s;
    }
  return out;
}

function modelMatrixCM(rowMajor16) {
  const m = rowMajor16;
  return new Float32Array([
    m[0], m[4], m[8], m[12],
    m[1], m[5], m[9], m[13],
    m[2], m[6], m[10], m[14],
    m[3], m[7], m[11], m[15],
  ]);
}

function viewProjMatrix(width, height) {
  const { forward, right, up } = cameraBasis();
  const eye = [
    camera.target[0] + forward[0] * camera.dist,
    camera.target[1] + forward[1] * camera.dist,
    camera.target[2] + forward[2] * camera.dist,
  ];
  const dot = (v) => -(v[0] * eye[0] + v[1] * eye[1] + v[2] * eye[2]);
  // camera looks along -forward; view rows are right/up/forward
  const view = new Float32Array([
    right[0], up[0], forward[0], 0,
    right[1], up[1], forward[1], 0,
    right[2], up[2], forward[2], 0,
    dot(right), dot(up), dot(forward), 1,
  ]);
  const zn = camera.dist * 0.01, zf = camera.dist * 60;
  const proj = new Float32Array(16);
  proj[0] = (2 * camera.fov) / width;
  proj[5] = (2 * camera.fov) / height;
  proj[10] = -(zf + zn) / (zf - zn);
  proj[11] = -1;
  proj[14] = (-2 * zf * zn) / (zf - zn);
  return { vp: matMul(proj, view), eye };
}

// Triangle tessellation (positions + per-vertex normals, local frame)

function pushTri(out, a, b, c, n) {
  for (const p of [a, b, c]) out.push(p[0], p[1], p[2], n[0], n[1], n[2]);
}

function faceNormal(a, b, c) {
  const u = [b[0] - a[0], b[1] - a[1], b[2] - a[2]];
  const v = [c[0] - a[0], c[1] - a[1], c[2] - a[2]];
  const n = [
    u[1] * v[2] - u[2] * v[1],
    u[2] * v[0] - u[0] * v[2],
    u[0] * v[1] - u[1] * v[0],
  ];
  const m = Math.hypot(...n) || 1;
  return [n[0] / m, n[1] / m, n[2] / m];
}

function tessellate(node) {
  const p = node.params;
  const out = [];
  if (node.type === "mesh" && node.triangles) {
    for (let t = 0; t + 8 < node.triangles.length; t += 9) {
      const a = node.triangles.slice(t, t + 3);
      const b = node.triangles.slice(t + 3, t + 6);
      const c = node.triangles.slice(t + 6, t + 9);
      pushTri(out, a, b, c, faceNormal(a, b, c));
    }
    return out;
  }
  if (node.type === "box" || node.type === "mesh") {
    const [a, b, c] = [p[0] / 2, p[1] / 2, p[2] / 2];
    const faces = [
      [[1, 0, 0], [[a,-b,-c],[a,b,-c],[a,b,c],[a,-b,c]]],
      [[-1, 0, 0], [[-a,-b,-c],[-a,-b,c],[-a,b,c],[-a,b,-c]]],
      [[0, 1, 0], [[-a,b,-c],[-a,b,c],[a,b,c],[a,b,-c]]],
      [[0, -1, 0], [[-a,-b,-c],[a,-b,-c],[a,-b,c],[-a,-b,c]]],
      [[0, 0, 1], [[-a,-b,c],[a,-b,c],[a,b,c],[-a,b,c]]],
      [[0, 0, -1], [[-a,-b,-c],[-a,b,-c],[a,b,-c],[a,-b,-c]]],
    ];
    for (const [n, q] of faces) {
      pushTri(out, q[0], q[1], q[2], n);
      pushTri(out, q[0], q[2], q[3], n);
    }
    return out;
  }
  if (node.type === "sphere") {
    const r = p[0], LAT = 16, LON = 24;
    const at = (i, j) => {
      const th = (Math.PI * i) / LAT, ph = (2 * Math.PI * j) / LON;
      return [
        r * Math.sin(th) * Math.cos(ph),
        r * Math.sin(th) * Math.sin(ph),
        r * Math.cos(th),
      ];
    };
    for (let i = 0; i < LAT; i++)
      for (let j = 0; j < LON; j++) {
        const q = [at(i, j), at(i + 1, j), at(i + 1, j + 1), at(i, j + 1)];
        const nrm = (v) => { const m = Math.hypot(...v) || 1; return [v[0]/m, v[1]/m, v[2]/m]; };
        out.push(
          ...q[0], ...nrm(q[0]), ...q[1], ...nrm(q[1]), ...q[2], ...nrm(q[2]),
          ...q[0], ...nrm(q[0]), ...q[2], ...nrm(q[2]), ...q[3], ...nrm(q[3]),
        );
      }
    return out;
  }
  if (node.type === "cylinder") {
    const [length, r] = [p[0], p[1]], N = 32, h = length / 2;
    for (let j = 0; j < N; j++) {
      const t0 = (2 * Math.PI * j) / N, t1 = (2 * Math.PI * (j + 1)) / N;
      const x0 = Math.cos(t0), y0 = Math.sin(t0);
      const x1 = Math.cos(t1), y1 = Math.sin(t1);
      const q = [
        [r * x0, r * y0, -h], [r * x1, r * y1, -h],
        [r * x1, r * y1, h], [r * x0, r * y0, h],
      ];
      out.push(
        ...q[0], x0, y0, 0, ...q[1], x1, y1, 0, ...q[2], x1, y1, 0,
        ...q[0], x0, y0, 0, ...q[2], x1, y1, 0, ...q[3], x0, y0, 0,
      );
      pushTri(out, [0, 0, h], [r * x0, r * y0, h], [r * x1, r * y1, h], [0, 0, 1]);
      pushTri(out, [0, 0, -h], [r * x1, r * y1, -h], [r * x0, r * y0, -h], [0, 0, -1]);
    }
    return out;
  }
  return out;
}

function nodeMesh(gl, node) {
  const key = JSON.stringify([node.type, node.params,
                              node.triangles ? node.triangles.length : 0]);
  let entry = glState.meshes.get(node.name);
  if (!entry || entry.key !== key) {
    const data = new Float32Array(tessellate(node));
    const buffer = (entry && entry.buffer) || gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, buffer);
    gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW);
    entry = { buffer, count: data.length / 6, key };
    glState.meshes.set(node.name, entry);
  }
  return entry;
}

function heatmapTexture(gl, key, hist, entry) {
  const [na, nb] = entry.shape;
  let cached = glState.textures.get(key);
  if (!cached) {
    cached = { tex: gl.createTexture(), stamp: null };
    glState.textures.set(key, cached);
  }
  const stamp = entry.values.reduce((s, v) => s + v, 0);
  if (cached.stamp !== stamp) {
    const peak = Math.max(1, ...entry.values);
    const rgba = new Uint8Array(na * nb * 4);
    for (let i = 0; i < na; i++)
      for (let j = 0; j < nb; j++) {
        const value = entry.values[i * nb + j];
        const k = (i * nb + j) * 4;
        if (value) {
          const [r, g, b] = heatColor(value / peak);
          rgba[k] = r; rgba[k + 1] = g; rgba[k + 2] = b; rgba[k + 3] = 217;
        }
      }
    gl.bindTexture(gl.TEXTURE_2D, cached.tex);
    gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, nb, na, 0, gl.RGBA,
                  gl.UNSIGNED_BYTE, rgba);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.NEAREST);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.NEAREST);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE);
    cached.stamp = stamp;
  }
  return cached.tex;
}

function drawGLHeatmaps(gl, vp) {
  if (!state.histMeta || !state.recorders) return;
  const handles = glState.tex;
  gl.useProgram(handles.program);
  const buffer = gl.createBuffer();
  for (const [name, meta] of Object.entries(state.histMeta)) {
    if (!meta.facet) continue;
    const tallies = state.recorders[name];
    const node = state.scene.nodes.find((n) => n.name === meta.node);
    if (!tallies || !node || node.type !== "box") continue;
    meta.histograms.forEach((hist, index) => {
      if (hist.kind !== "heatmap") return;
      const axisA = POSITION_AXES[hist.prop_a];
      const axisB = POSITION_AXES[hist.prop_b];
      if (axisA === undefined || axisB === undefined) return;
      const entry = tallies.histograms[index];
      if (!entry) return;
      const fixedAxis = meta.facet.findIndex((v) => Math.abs(v) > 0.5);
      if (fixedAxis < 0 || fixedAxis === axisA || fixedAxis === axisB) return;
      const lift = 1.002;
      const offset = meta.facet[fixedAxis] * (node.params[fixedAxis] / 2) * lift;
      const loA = hist.edges_a[0], hiA = hist.edges_a[hist.edges_a.length - 1];
      const loB = hist.edges_b[0], hiB = hist.edges_b[hist.edges_b.length - 1];
      const corner = (a, b, u, v) => {
        const local = [0, 0, 0];
        local[axisA] = a; local[axisB] = b; local[fixedAxis] = offset;
        const w = mat4Apply(node.matrix, local);
        return [w[0], w[1], w[2], u, v];
      };
      const c00 = corner(loA, loB, 0, 0), c01 = corner(loA, hiB, 1, 0);
      const c11 = corner(hiA, hiB, 1, 1), c10 = corner(hiA, loB, 0, 1);
      const verts = new Float32Array([
        ...c00, ...c10, ...c11, ...c00, ...c11, ...c01,
      ]);
      gl.bindBuffer(gl.ARRAY_BUFFER, buffer);
      gl.bufferData(gl.ARRAY_BUFFER, verts, gl.DYNAMIC_DRAW);
      gl.enableVertexAttribArray(handles.aPos);
      gl.vertexAttribPointer(handles.aPos, 3, gl.FLOAT, false, 20, 0);
      gl.enableVertexAttribArray(handles.aUV);
      gl.vertexAttribPointer(handles.aUV, 2, gl.FLOAT, false, 20, 12);
      gl.uniformMatrix4fv(
        gl.getUniformLocation(handles.program, "uMVP"), false, vp);
      gl.bindTexture(gl.TEXTURE_2D,
                     heatmapTexture(gl, `${name}:${index}`, hist, entry));
      gl.uniform1i(gl.getUniformLocation(handles.program, "uTex"), 0);
      gl.drawArrays(gl.TRIANGLES, 0, 6);
    });
  }
  gl.deleteBuffer(buffer);
}

function drawGLPaths(gl, vp) {
  if (!state.paths.length) return;
  const handles = glState.line;
  gl.useProgram(handles.program);
  const verts = [];
  for (const path of state.paths) {
    for (let i = 0; i + 1 < path.points.length; i++) {
      const rgb = wavelengthToRGB(path.wavelengths[i + 1])
        .match(/\d+/g).map((v) => v / 255);
      verts.push(...path.points[i], ...rgb, ...path.points[i + 1], ...rgb);
    }
  }
  const buffer = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, buffer);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(verts), gl.DYNAMIC_DRAW);
  gl.enableVertexAttribArray(handles.aPos);
  gl.vertexAttribPointer(handles.aPos, 3, gl.FLOAT, false, 24, 0);
  gl.enableVertexAttribArray(handles.aCol);
  gl.vertexAttribPointer(handles.aCol, 3, gl.FLOAT, false, 24, 12);
  gl.uniformMatrix4fv(gl.getUniformLocation(handles.program, "uMVP"), false, vp);
  gl.uniform1f(gl.getUniformLocation(handles.program, "uAlpha"), 0.8);
  gl.drawArrays(gl.LINES, 0, verts.length / 6);
  gl.deleteBuffer(buffer);
}

function drawGLScene() {
  const gl = glState.gl;
  if (!gl || !state.scene) return;
  const canvas = $("viewport-gl");
  const rect = canvas.parentElement.getBoundingClientRect();
  if (canvas.width !== rect.width || canvas.height !== rect.height) {
    canvas.width = rect.width;
    canvas.height = rect.height;
  }
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0, 0, 0, 0);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  gl.enable(gl.BLEND);
  gl.blendFunc(gl.SRC_ALPHA, gl.ONE_MINUS_SRC_ALPHA);

  const { vp, eye } = viewProjMatrix(canvas.width, canvas.height);

  // ray paths write depth so geometry in front occludes correctly
  gl.depthMask(true);
  drawGLPaths(gl, vp);

  // translucent shaded geometry, far-to-near, no depth writes
  gl.depthMask(false);
  const handles = glState.solid;
  gl.useProgram(handles.program);
  const nodes = state.scene.nodes
    .filter((n) => !n.root && n.params.some((v) => v > 0))
    .map((n) => {
      const c = mat4Apply(n.matrix, [0, 0, 0]);
      return { n, d: Math.hypot(c[0] - eye[0], c[1] - eye[1], c[2] - eye[2]) };
    })
    .sort((a, b) => b.d - a.d);
  for (const { n: node } of nodes) {
    const entry = nodeMesh(gl, node);
    if (!entry.count) continue;
    gl.bindBuffer(gl.ARRAY_BUFFER, entry.buffer);
    gl.enableVertexAttribArray(handles.aPos);
    gl.vertexAttribPointer(handles.aPos, 3, gl.FLOAT, false, 24, 0);
    gl.enableVertexAttribArray(handles.aNrm);
    gl.vertexAttribPointer(handles.aNrm, 3, gl.FLOAT, false, 24, 12);
    const model = modelMatrixCM(node.matrix);
    gl.uniformMatrix4fv(
      gl.getUniformLocation(handles.program, "uMVP"), false,
      matMul(vp, model));
    const m = node.matrix;
    gl.uniformMatrix3fv(
      gl.getUniformLocation(handles.program, "uNormal"), false,
      new Float32Array([m[0], m[4], m[8], m[1], m[5], m[9], m[2], m[6], m[10]]));
    const selected = node.name === state.selected;
    gl.uniform4f(
      gl.getUniformLocation(handles.program, "uColor"),
      selected ? 0.30 : 0.55, selected ? 0.64 : 0.62, selected ? 1.0 : 0.72,
      node.type === "mesh" ? 0.30 : 0.22);
    gl.uniform3f(
      gl.getUniformLocation(handles.program, "uLight"), 0.4, 0.25, 0.88);
    gl.drawArrays(gl.TRIANGLES, 0, entry.count);
  }

  drawGLHeatmaps(gl, vp);
  gl.depthMask(true);
}

// ---------------------------------------------------------------- viewport

function drawViewport() {
  drawGLScene();
  drawOverlay();
}

function drawOverlay() {
  const canvas = $("viewport");
  const rect = canvas.parentElement.getBoundingClientRect();
  if (canvas.width !== rect.width || canvas.height !== rect.height) {
    canvas.width = rect.width;
    canvas.height = rect.height;
  }
  const context = canvas.getContext("2d");
  const { width, height } = canvas;
  context.clearRect(0, 0, width, height);

  const line = (a, b, style, lineWidth) => {
    const pa = project(a, width, height), pb = project(b, width, height);
    if (!pa || !pb) return;
    context.strokeStyle = style;
    context.lineWidth = lineWidth || 1;
    context.beginPath();
    context.moveTo(pa[0], pa[1]);
    context.lineTo(pb[0], pb[1]);
    context.stroke();
  };

  // axes
  line([0, 0, 0], [1, 0, 0], "#7a3030", 1.5);
  line([0, 0, 0], [0, 1, 0], "#2f6b2f", 1.5);
  line([0, 0, 0], [0, 0, 1], "#2d5e95", 1.5);

  // WebGL draws shaded geometry, depth-tested ray paths and heatmap
  // face textures underneath; without it the 2D canvas covers both.
  if (!glState.gl) {
    drawFaceHeatmaps(context, width, height);
    context.globalAlpha = 0.75;
    for (const path of state.paths) {
      for (let i = 0; i + 1 < path.points.length; i++) {
        line(path.points[i], path.points[i + 1],
             wavelengthToRGB(path.wavelengths[i + 1]), 1);
      }
    }
    context.globalAlpha = 1;
  }

  if (!state.scene) return;
  for (const node of state.scene.nodes) {
    const selected = node.name === state.selected;
    const style = selected ? "#4da3ff" : node.root ? "#3a4150" : "#9aa3b0";
    for (const [a, b] of geometryEdges(node))
      line(mat4Apply(node.matrix, a), mat4Apply(node.matrix, b), style,
           selected ? 1.8 : 1);
  }
  for (const light of state.scene.lights) {
    const origin = mat4Apply(light.matrix, [0, 0, 0]);
    const tip = mat4Apply(light.matrix, [0, 0, -1]);
    line(origin, tip, "#ffd75e", 2);
    const p = project(origin, width, height);
    if (p) {
      context.fillStyle = "#ffd75e";
      context.beginPath();
      context.arc(p[0], p[1], 4, 0, 2 * Math.PI);
      context.fill();
    }
  }

  drawGizmo(context, width, height);
}

// Transform gizmo: a handle at the selected node's origin. Dragging it
// moves the node in the camera-parallel plane through its origin and
// posts an `op: move` patch (the server converts the world position to
// the parent frame and round-trips the YAML document).

function selectedNode() {
  if (!state.scene || !state.selected) return null;
  const node = state.scene.nodes.find((n) => n.name === state.selected);
  return node && !node.root ? node : null;
}

function nodeOrigin(node) {
  return [node.matrix[3], node.matrix[7], node.matrix[11]];
}

function drawGizmo(context, width, height) {
  const node = selectedNode();
  if (!node) return;
  const origin = nodeOrigin(node);
  const p = project(origin, width, height);
  if (!p) return;
  context.strokeStyle = state.gizmo ? "#ffb14d" : "#4da3ff";
  context.lineWidth = 2;
  context.beginPath();
  context.arc(p[0], p[1], GIZMO_RADIUS, 0, 2 * Math.PI);
  context.stroke();
  context.beginPath();
  context.moveTo(p[0] - GIZMO_RADIUS - 4, p[1]);
  context.lineTo(p[0] + GIZMO_RADIUS + 4, p[1]);
  context.moveTo(p[0], p[1] - GIZMO_RADIUS - 4);
  context.lineTo(p[0], p[1] + GIZMO_RADIUS + 4);
  context.stroke();
}

const GIZMO_RADIUS = 10;

function gizmoHit(node, clientX, clientY, canvas) {
  const rect = canvas.getBoundingClientRect();
  const p = project(nodeOrigin(node), canvas.width, canvas.height);
  if (!p) return null;
  const dx = clientX - rect.left - p[0];
  const dy = clientY - rect.top - p[1];
  if (Math.hypot(dx, dy) > GIZMO_RADIUS + 6) return null;
  return { depth: p[2] };
}

function gizmoDrag(dx, dy, depth) {
  // Screen delta -> world delta in the camera-parallel plane at depth.
  const { right, up } = cameraBasis();
  const k = depth / camera.fov;
  const node = selectedNode();
  if (!node) return;
  for (let i = 0; i < 3; i++) {
    const d = (dx * right[i] - dy * up[i]) * k;
    state.gizmo.world[i] += d;
  }
  // Live preview: shift the node's matrix translation.
  node.matrix[3] = state.gizmo.world[0];
  node.matrix[7] = state.gizmo.world[1];
  node.matrix[11] = state.gizmo.world[2];
}

// Recorder heatmaps painted on geometry faces: a facet-filtered
// escaping recorder with a 2D position heatmap colours its box face by
// bin count during live runs (viridis, peak-normalised per recorder).

const POSITION_AXES = { x: 0, y: 1, z: 2 };

function drawFaceHeatmaps(context, width, height) {
  if (!state.scene || !state.histMeta || !state.recorders) return;
  for (const [name, meta] of Object.entries(state.histMeta)) {
    if (!meta.facet) continue;
    const tallies = state.recorders[name];
    const node = state.scene.nodes.find((n) => n.name === meta.node);
    if (!tallies || !node || node.type !== "box") continue;
    meta.histograms.forEach((hist, index) => {
      if (hist.kind !== "heatmap") return;
      const axisA = POSITION_AXES[hist.prop_a];
      const axisB = POSITION_AXES[hist.prop_b];
      if (axisA === undefined || axisB === undefined) return;
      const entry = tallies.histograms[index];
      if (!entry) return;
      paintFace(context, width, height, node, meta.facet, hist, entry,
                axisA, axisB);
    });
  }
}

function paintFace(context, width, height, node, facet, hist, entry,
                   axisA, axisB) {
  // The fixed local coordinate: the face the facet normal points out of.
  const fixedAxis = facet.findIndex((v) => Math.abs(v) > 0.5);
  if (fixedAxis < 0 || fixedAxis === axisA || fixedAxis === axisB) return;
  const offset = facet[fixedAxis] * (node.params[fixedAxis] / 2);
  const [na, nb] = entry.shape;
  const peak = Math.max(1, ...entry.values);
  const corner = (a, b) => {
    const local = [0, 0, 0];
    local[axisA] = a;
    local[axisB] = b;
    local[fixedAxis] = offset;
    return project(mat4Apply(node.matrix, local), width, height);
  };
  context.globalAlpha = 0.85;
  for (let i = 0; i < na; i++) {
    for (let j = 0; j < nb; j++) {
      const value = entry.values[i * nb + j];
      if (!value) continue;
      const quad = [
        corner(hist.edges_a[i], hist.edges_b[j]),
        corner(hist.edges_a[i + 1], hist.edges_b[j]),
        corner(hist.edges_a[i + 1], hist.edges_b[j + 1]),
        corner(hist.edges_a[i], hist.edges_b[j + 1]),
      ];
      if (quad.some((p) => !p)) continue;
      const [r, g, b] = heatColor(value / peak);
      context.fillStyle = `rgb(${r},${g},${b})`;
      context.beginPath();
      context.moveTo(quad[0][0], quad[0][1]);
      for (let k = 1; k < 4; k++) context.lineTo(quad[k][0], quad[k][1]);
      context.closePath();
      context.fill();
    }
  }
  context.globalAlpha = 1;
}

function setupViewportControls() {
  const canvas = $("viewport");
  let dragging = null;
  canvas.addEventListener("mousedown", (event) => {
    const node = selectedNode();
    const hit = node && gizmoHit(node, event.clientX, event.clientY, canvas);
    if (hit) {
      state.gizmo = {
        name: node.name,
        world: nodeOrigin(node),
        depth: hit.depth,
      };
      dragging = { x: event.clientX, y: event.clientY, gizmo: true };
      drawViewport();
      return;
    }
    dragging = { x: event.clientX, y: event.clientY, pan: event.shiftKey };
  });
  window.addEventListener("mouseup", () => {
    if (state.gizmo) {
      const { name, world } = state.gizmo;
      state.gizmo = null;
      patch({ op: "move", node: name, world_position: world });
    }
    dragging = null;
  });
  window.addEventListener("mousemove", (event) => {
    if (!dragging) return;
    const dx = event.clientX - dragging.x;
    const dy = event.clientY - dragging.y;
    dragging.x = event.clientX;
    dragging.y = event.clientY;
    if (dragging.gizmo && state.gizmo) {
      gizmoDrag(dx, dy, state.gizmo.depth);
    } else if (dragging.pan) {
      const { right, up } = cameraBasis();
      const k = camera.dist / camera.fov;
      for (let i = 0; i < 3; i++)
        camera.target[i] += (-dx * right[i] + dy * up[i]) * k;
    } else {
      camera.yaw -= dx * 0.008;
      camera.pitch = Math.min(1.5, Math.max(-1.5, camera.pitch + dy * 0.008));
    }
    drawViewport();
  });
  canvas.addEventListener("wheel", (event) => {
    event.preventDefault();
    camera.dist *= Math.exp(event.deltaY * 0.0012);
    drawViewport();
  }, { passive: false });
  new ResizeObserver(drawViewport).observe(canvas.parentElement);
}

// ---------------------------------------------------------------- inspector

function nodeRow(node) {
  const row = document.createElement("div");
  row.className = "node-row" + (node.name === state.selected ? " selected" : "");

  const name = document.createElement("div");
  name.className = "name";
  name.textContent = node.name + (node.root ? " (root)" : "");
  name.onclick = () => {
    state.selected = node.name === state.selected ? null : node.name;
    renderAll();
  };
  row.appendChild(name);

  const meta = document.createElement("div");
  meta.className = "meta";
  meta.textContent = `${node.type} · n=${node.refractive_index.toFixed(3)}`;
  row.appendChild(meta);

  if (node.name === state.selected && !node.root) {
    const location = (node.spec && node.spec.location) || [0, 0, 0];
    const edit = document.createElement("div");
    edit.className = "vec-edit";
    const inputs = location.map((v) => {
      const input = document.createElement("input");
      input.type = "number";
      input.step = "0.1";
      input.value = v;
      edit.appendChild(input);
      return input;
    });
    const moveButton = document.createElement("button");
    moveButton.textContent = "move";
    moveButton.onclick = () =>
      patch({
        op: "set",
        path: ["nodes", node.name, "location"],
        value: inputs.map((i) => parseFloat(i.value) || 0),
      });
    edit.appendChild(moveButton);
    row.appendChild(edit);

    const actions = document.createElement("div");
    actions.className = "actions";
    const addRecorder = document.createElement("button");
    addRecorder.textContent = "+ recorder";
    addRecorder.onclick = () => patch({ op: "add-recorder", node: node.name });
    actions.appendChild(addRecorder);
    if (node.type === "box") {
      const faces = document.createElement("button");
      faces.textContent = "+ face heatmaps";
      faces.onclick = () => patch({ op: "add-face-recorders", node: node.name });
      actions.appendChild(faces);
    }
    const remove = document.createElement("button");
    remove.textContent = "delete";
    remove.onclick = () => patch({ op: "delete-node", node: node.name });
    actions.appendChild(remove);
    row.appendChild(actions);
  }
  return row;
}

function recorderRow(recorder) {
  const row = document.createElement("div");
  row.className = "rec-row";
  const name = document.createElement("div");
  name.textContent = recorder.name + (recorder.auto ? " (auto)" : "");
  row.appendChild(name);
  const meta = document.createElement("div");
  meta.className = "meta";
  const facet = recorder.facet ? ` · facet [${recorder.facet}]` : "";
  meta.textContent = `${recorder.event} @ ${recorder.node}${facet}`;
  row.appendChild(meta);
  if (!recorder.auto) {
    const actions = document.createElement("div");
    actions.className = "actions";
    const remove = document.createElement("button");
    remove.textContent = "delete";
    remove.onclick = () => patch({ op: "delete-recorder", recorder: recorder.name });
    actions.appendChild(remove);
    row.appendChild(actions);
  }
  return row;
}

function renderInspector() {
  const nodes = $("nodes");
  const recorders = $("recorders");
  nodes.textContent = "";
  recorders.textContent = "";
  if (!state.scene) return;
  for (const node of state.scene.nodes) nodes.appendChild(nodeRow(node));
  for (const recorder of state.scene.recorders)
    recorders.appendChild(recorderRow(recorder));
}

// ---------------------------------------------------------------- plots

const VIRIDIS = [
  [68, 1, 84], [71, 44, 122], [59, 81, 139], [44, 113, 142], [33, 144, 141],
  [39, 173, 129], [92, 200, 99], [170, 220, 50], [253, 231, 37],
];

function heatColor(t) {
  const x = Math.min(0.9999, Math.max(0, t)) * (VIRIDIS.length - 1);
  const i = Math.floor(x), f = x - i;
  const a = VIRIDIS[i], b = VIRIDIS[i + 1];
  return [
    Math.round(a[0] + (b[0] - a[0]) * f),
    Math.round(a[1] + (b[1] - a[1]) * f),
    Math.round(a[2] + (b[2] - a[2]) * f),
  ];
}

function drawPlots() {
  const container = $("plots");
  container.textContent = "";
  if (!state.histMeta || !state.recorders) return;
  for (const [name, meta] of Object.entries(state.histMeta)) {
    const tallies = state.recorders[name];
    if (!tallies) continue;
    meta.histograms.forEach((hist, index) => {
      const entry = tallies.histograms[index];
      if (!entry) return;
      const plot = document.createElement("div");
      plot.className = "plot";
      const title = document.createElement("div");
      title.className = "title";
      title.textContent = `${name} · ${tallies.rays} rays`;
      plot.appendChild(title);
      const canvas = document.createElement("canvas");
      canvas.width = 220;
      canvas.height = 140;
      plot.appendChild(canvas);
      const context = canvas.getContext("2d");
      if (hist.kind === "heatmap") {
        const [na, nb] = entry.shape;
        const peak = Math.max(1, ...entry.values);
        const image = context.createImageData(nb, na);
        for (let i = 0; i < na; i++)
          for (let j = 0; j < nb; j++) {
            const value = entry.values[i * nb + j];
            const [r, g, b] = heatColor(value / peak);
            // flip vertically: histogram row 0 is the low edge
            const k = ((na - 1 - i) * nb + j) * 4;
            image.data[k] = r; image.data[k + 1] = g;
            image.data[k + 2] = b; image.data[k + 3] = 255;
          }
        const off = document.createElement("canvas");
        off.width = nb; off.height = na;
        off.getContext("2d").putImageData(image, 0, 0);
        context.imageSmoothingEnabled = false;
        context.drawImage(off, 0, 0, canvas.width, canvas.height);
      } else {
        const values = entry.values;
        const peak = Math.max(1, ...values);
        const barWidth = canvas.width / values.length;
        const isWavelength = hist.prop === "wavelength";
        for (let i = 0; i < values.length; i++) {
          const h = (values[i] / peak) * (canvas.height - 8);
          context.fillStyle = isWavelength
            ? wavelengthToRGB((hist.edges[i] + hist.edges[i + 1]) / 2)
            : "#4da3ff";
          context.fillRect(i * barWidth, canvas.height - h, barWidth - 0.5, h);
        }
      }
      container.appendChild(plot);
    });
  }
}

// ---------------------------------------------------------------- run

let eventSource = null;

function setRunning(running) {
  state.running = running;
  $("run").disabled = running;
  $("stop").disabled = !running;
}

function run() {
  if (!state.scene) return;
  const params = new URLSearchParams({
    rays: $("rays").value,
    bundle: $("bundle").value,
    record_every: "1000",
    max_paths: "200",
  });
  if ($("seed").value) params.set("seed", $("seed").value);
  attachRunStream(`/api/run?${params}`);
}

// Shared SSE consumer: `run()` drives /api/run; CLI `simulate --watch`
// pushes the same message stream through /api/watch.
function attachRunStream(url) {
  state.paths = [];
  setRunning(true);
  eventSource = new EventSource(url);
  eventSource.onmessage = (event) => {
    const message = JSON.parse(event.data);
    if (message.type === "started") {
      state.histMeta = message.histograms;
      state.recorders = null;
    } else if (message.type === "bundle") {
      state.recorders = message.recorders;
      if (message.paths.length) state.paths.push(...message.paths);
      $("rate").textContent =
        `${Math.round(message.rays_per_second).toLocaleString()} rays/s`;
      $("progress").textContent =
        `${message.traced.toLocaleString()} / ${message.total.toLocaleString()}`;
      drawViewport();
      drawPlots();
    } else if (message.type === "done") {
      eventSource.close();
      eventSource = null;
      setRunning(false);
      $("status").textContent =
        `done in ${message.elapsed.toFixed(2)} s`;
    }
  };
  eventSource.onerror = () => {
    if (eventSource) eventSource.close();
    eventSource = null;
    setRunning(false);
  };
}

async function stop() {
  await api("POST", "/api/stop", {});
}

// ---------------------------------------------------------------- editor
//
// Syntax-highlighted YAML editing without vendoring an editor (the
// reference ships CodeMirror): a <pre> under the transparent textarea
// renders the tokenised document; input/scroll keep the two in sync.

function escapeHTML(text) {
  return text
    .replace(/&/g, "&amp;")
    .replace(/</g, "&lt;")
    .replace(/>/g, "&gt;");
}

function spanToken(cls, text) {
  return `<span class="tok-${cls}">${escapeHTML(text)}</span>`;
}

function splitUnquotedComment(line) {
  // First '#' outside quotes starts the comment.
  let quote = null;
  for (let i = 0; i < line.length; i++) {
    const c = line[i];
    if (quote) {
      if (c === quote) quote = null;
    } else if (c === '"' || c === "'") {
      quote = c;
    } else if (c === "#" &&
               (i === 0 || line[i - 1] === " " || line[i - 1] === "\t")) {
      // YAML: '#' starts a comment only after whitespace or at line
      // start ('url: http://x#frag' is one scalar).
      return [line.slice(0, i), line.slice(i)];
    }
  }
  return [line, ""];
}

function isNumberToken(token) {
  if (!token.length) return false;
  let i = 0;
  if (token[0] === "-" || token[0] === "+") i = 1;
  let digits = 0;
  for (; i < token.length; i++) {
    const c = token[i];
    if (c >= "0" && c <= "9") digits++;
    else if (c !== "." && c !== "e" && c !== "E" && c !== "-" && c !== "+")
      return false;
  }
  return digits > 0;
}

function highlightScalars(text) {
  // Strings, numbers, booleans/null and flow punctuation in a value.
  let out = "";
  let i = 0;
  while (i < text.length) {
    const c = text[i];
    if (c === '"' || c === "'") {
      let j = i + 1;
      while (j < text.length && text[j] !== c) j++;
      out += spanToken("str", text.slice(i, j + 1));
      i = j + 1;
      continue;
    }
    if ("[]{},:".indexOf(c) >= 0) {
      out += spanToken("punct", c);
      i += 1;
      continue;
    }
    let j = i;
    while (j < text.length && '[]{},:"\''.indexOf(text[j]) < 0) j++;
    const chunk = text.slice(i, j);
    const token = chunk.trim();
    if (!token.length) out += escapeHTML(chunk);
    else if (isNumberToken(token)) {
      const at = chunk.indexOf(token);
      out += escapeHTML(chunk.slice(0, at));
      out += spanToken("num", token);
      out += escapeHTML(chunk.slice(at + token.length));
    } else if (token === "true" || token === "false" || token === "null" ||
               token === "yes" || token === "no") {
      const at = chunk.indexOf(token);
      out += escapeHTML(chunk.slice(0, at));
      out += spanToken("bool", token);
      out += escapeHTML(chunk.slice(at + token.length));
    } else {
      out += escapeHTML(chunk);
    }
    i = j;
  }
  return out;
}

function highlightLine(line) {
  const [code, comment] = splitUnquotedComment(line);
  let out = "";
  let rest = code;
  // leading indentation and list dashes
  let i = 0;
  while (i < rest.length && (rest[i] === " " || rest[i] === "\t")) i++;
  out += escapeHTML(rest.slice(0, i));
  rest = rest.slice(i);
  while (rest.startsWith("- ")) {
    out += spanToken("dash", "-") + " ";
    rest = rest.slice(2);
  }
  // `key:` — an unquoted prefix ending in ':' followed by space/EOL
  let keyEnd = -1;
  for (let j = 0; j < rest.length; j++) {
    const c = rest[j];
    if (c === ":" && (j + 1 >= rest.length || rest[j + 1] === " ")) {
      keyEnd = j;
      break;
    }
    if (c === '"' || c === "'" || c === "[" || c === "{") break;
  }
  if (keyEnd >= 0) {
    out += spanToken("key", rest.slice(0, keyEnd)) + spanToken("punct", ":");
    rest = rest.slice(keyEnd + 1);
  }
  out += highlightScalars(rest);
  if (comment.length) out += spanToken("comment", comment);
  return out;
}

function refreshEditorHighlight() {
  const editor = $("editor");
  const target = $("editor-highlight");
  const lines = editor.value.split("\n");
  const html = [];
  for (const line of lines) html.push(highlightLine(line));
  target.innerHTML = html.join("\n") + "\n";
  syncEditorScroll();
}

function syncEditorScroll() {
  const editor = $("editor");
  const target = $("editor-highlight");
  target.scrollTop = editor.scrollTop || 0;
  target.scrollLeft = editor.scrollLeft || 0;
}

function setEditorValue(text) {
  $("editor").value = text;
  refreshEditorHighlight();
}

// ---------------------------------------------------------------- boot

function renderAll() {
  drawViewport();
  renderInspector();
}

async function boot() {
  initGL();
  setupViewportControls();
  $("apply").onclick = () => applyDocument($("editor").value);
  $("editor").addEventListener("keydown", (event) => {
    if ((event.ctrlKey || event.metaKey) && event.key === "Enter")
      applyDocument($("editor").value);
  });
  $("editor").addEventListener("input", refreshEditorHighlight);
  $("editor").addEventListener("scroll", syncEditorScroll);
  $("run").onclick = run;
  $("stop").onclick = stop;
  $("save").onclick = async () => {
    try {
      const data = await api("POST", "/api/save", {});
      $("status").textContent = `saved ${data.saved}`;
    } catch (exception) {
      $("status").textContent = exception.message;
    }
  };
  for (const button of document.querySelectorAll("[data-add]"))
    button.onclick = () => patch({ op: "add-node", kind: button.dataset.add });
  document.querySelector("[data-add-component]").onclick = () =>
    patch({ op: "add-component" });

  const data = await api("GET", "/api/document");
  setEditorValue(data.text);
  if (data.text) await applyDocument(data.text);

  // CLI `simulate --watch` live view: subscribe to the broadcast feed.
  if (new URLSearchParams(location.search).get("watch"))
    attachRunStream("/api/watch");
}

boot();
