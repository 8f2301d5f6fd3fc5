"""HTTP backend for the port's studio.

Port of ``pvtrace_tpu.studio.server``: the same document, patches and
Server-Sent Events, over the port's parser and engine. A live run
streams ``simulate_stream`` on the server's `device` (``create_server``
and ``main``: "cuda", the hand-written kernels on the card, by default;
"cpu" for the eager twin), which must exist when the server is built. A
run of 0 rays sends ``started`` and then ``done``, as the JAX package's
empty stream does.

Parity: reference ``pvtrace/studio/server.py`` — the scene document
(YAML text) is the single source of truth; the frontend edits the
document, the server validates/parses/compiles it and returns a
geometry payload for the 3D viewport, applies structured GUI edits
(``/api/patch``), and streams engine results (recorder tallies and
sampled ray paths) live during a run.

Transport redesign: the reference uses FastAPI + uvicorn + a websocket.
Here the server is a stdlib ``ThreadingHTTPServer`` and the live run
streams over Server-Sent Events (``GET /api/run`` with
``text/event-stream``), which the browser consumes with ``EventSource``
— no third-party web framework required. Patches preserve user
comments and formatting like the reference's ruamel round-trip
(``server.py:330-471``), but via span-based text splices located with
yaml.compose source marks (``studio.yamledit``); list values are
emitted in flow style like hand-written scene files.
"""
import io
import json
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import yaml

from pvtrace_tpu_torch.studio import yamledit

from pvtrace_tpu_torch import engine
from pvtrace_tpu_torch.engine.api import require_device
from pvtrace_tpu_torch.cli.parse import auto_recorders, parse as parse_scene_file
from pvtrace_tpu_torch.engine.recorder import Heatmap

STATIC = Path(__file__).resolve().parent / "static"

GEOM_NAMES = {0: "box", 1: "sphere", 2: "cylinder", 3: "mesh"}


class _FlowList(list):
    """Lists dumped inline ([x, y, z]) like hand-written scene files."""


def _represent_flow_list(dumper, data):
    return dumper.represent_sequence(
        "tag:yaml.org,2002:seq", data, flow_style=True
    )


yaml.SafeDumper.add_representer(_FlowList, _represent_flow_list)


def _flow(value):
    if isinstance(value, list):
        return _FlowList(value)
    return value


def _unique_name(existing, stem):
    index = 1
    while f"{stem}-{index}" in existing:
        index += 1
    return f"{stem}-{index}"


class Studio:
    """Holds the current document and its parsed scene."""

    def __init__(self, document="", document_path=None):
        self.document = document
        self.document_path = document_path
        self.scene = None
        self.spec = None
        self.compiled = None

    def apply(self, text):
        """Validate and parse a new document; returns the scene payload."""
        spec = yaml.safe_load(io.StringIO(text))
        if not isinstance(spec, dict):
            raise ValueError("Document is not a YAML mapping.")

        # parse() validates against the JSON schema and resolves data
        # files relative to the document, so write the text next to the
        # opened file (or the cwd) before parsing.
        directory = (
            os.path.dirname(self.document_path)
            if self.document_path
            else os.getcwd()
        )
        with tempfile.NamedTemporaryFile(
            "w", suffix=".yml", delete=False, dir=directory
        ) as fp:
            fp.write(text)
            path = fp.name
        try:
            scene = parse_scene_file(path)
        finally:
            os.unlink(path)

        compiled = engine.compile_scene(scene)  # raises if unsupported

        self.document = text
        self.scene = scene
        self.spec = spec
        self.compiled = compiled
        return self.scene_payload(compiled)

    def scene_payload(self, compiled):
        """Geometry description for the canvas viewport."""
        node_specs = self.spec.get("nodes", {}) if self.spec else {}
        nodes = []
        for i, name in enumerate(compiled.node_names):
            params = np.asarray(compiled.geom_params[i]).tolist()
            triangles = None
            if i in compiled.mesh_data:
                # Real triangle soup for the WebGL viewport, plus
                # bounding-box extents in the params slot (wireframe
                # overlay + camera fitting).
                v0, e1, e2, _ = compiled.mesh_data[i]
                tri = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # [T, 3, 3]
                triangles = tri.ravel().tolist()
                verts = tri.reshape(-1, 3)
                half = np.max(np.abs(verts), axis=0)
                params = (2.0 * half).tolist() + [0.0]
            nodes.append(
                {
                    "name": name,
                    "type": GEOM_NAMES[int(compiled.geom_type[i])],
                    "params": params,
                    "triangles": triangles,
                    # Row-major 4x4 local -> world
                    "matrix": np.asarray(
                        compiled.local_to_world[i]
                    ).ravel().tolist(),
                    "root": i == compiled.root_id,
                    "refractive_index": float(compiled.refractive_index[i]),
                    "spec": node_specs.get(name, {}),
                }
            )
        lights = []
        for node in self.scene.root.iter_preorder():
            if node.light is not None:
                matrix = np.asarray(node.transformation_to(self.scene.root))
                lights.append(
                    {
                        "name": node.name,
                        "matrix": matrix.ravel().tolist(),
                        "spec": node_specs.get(node.name, {}),
                    }
                )
        recorders = []
        explicit = set(self.spec.get("recorders") or {}) if self.spec else set()
        for node in self.scene.root.iter_preorder():
            auto_names = set()
            node_spec = node_specs.get(node.name, {})
            if node_spec.get("record"):
                auto_names = set(auto_recorders(node.name, node_spec))
            for recorder in getattr(node, "recorders", []):
                histograms = []
                for hist in recorder.histograms:
                    if isinstance(hist, Heatmap):
                        histograms.append(
                            {
                                "kind": "heatmap",
                                "prop_a": hist.a.prop,
                                "prop_b": hist.b.prop,
                                "range_a": [hist.a.start, hist.a.stop, hist.a.bins],
                                "range_b": [hist.b.start, hist.b.stop, hist.b.bins],
                            }
                        )
                    else:
                        histograms.append(
                            {
                                "kind": "hist",
                                "prop": hist.prop,
                                "range": [hist.start, hist.stop, hist.bins],
                            }
                        )
                recorders.append(
                    {
                        "name": recorder.name,
                        "node": node.name,
                        "event": recorder.event,
                        "facet": list(recorder.facet) if recorder.facet else None,
                        "histograms": histograms,
                        "auto": recorder.name in auto_names
                        and recorder.name not in explicit,
                    }
                )
        return {
            "nodes": nodes,
            "lights": lights,
            "recorders": recorders,
            "spec": self.spec,
        }


# Node snippets inserted by the add-object toolbar
SNIPPETS = {
    "box": {
        "location": [0.0, 0.0, 0.0],
        "box": {"size": [1.0, 1.0, 1.0], "material": {"refractive-index": 1.5}},
    },
    "sphere": {
        "location": [0.0, 0.0, 0.0],
        "sphere": {"radius": 0.5, "material": {"refractive-index": 1.5}},
    },
    "cylinder": {
        "location": [0.0, 0.0, 0.0],
        "cylinder": {
            "length": 1.0,
            "radius": 0.5,
            "material": {"refractive-index": 1.5},
        },
    },
    "light": {
        "location": [0.0, 0.0, 2.0],
        "direction": [0.0, 0.0, -1.0],
        "light": {
            "wavelength": 555,
            "mask": {"direction": {"cone": {"half-angle": 20}}},
        },
    },
}


def patch_document(studio, payload):
    """Returns new document text for a structured edit; does not apply it.

    Parity: reference ``studio/server.py:_patch`` — the same operation
    vocabulary (set / move / add-node / add-recorder / add-face-recorders
    / add-component / delete-component / update-recorder /
    delete-recorder / delete-node) AND the same comment preservation:
    where the reference round-trips with ruamel, every operation here is
    expressed as span-based text splices (``studio.yamledit``) located
    with yaml.compose source marks, so user comments, blank lines, key
    order and quoting outside the edited spans survive GUI edits.
    """
    text = studio.document
    data = yaml.safe_load(io.StringIO(text))
    if not isinstance(data, dict):
        raise ValueError("Document is not a YAML mapping.")
    operation = payload["op"]

    if operation == "set":
        return yamledit.set_value(text, payload["path"], payload["value"])

    elif operation == "move":
        # World position from the viewport; location is relative to the
        # parent node, so convert through the scene graph.
        name = payload["node"]
        world = payload["world_position"]
        nodes = {n.name: n for n in studio.scene.root.iter_preorder()}
        if name not in nodes:
            raise ValueError(f"Unknown node {name!r}")
        node = nodes[name]
        if node.parent is None:
            raise ValueError("Cannot move the root node.")
        local = studio.scene.root.point_to_node(tuple(world), node.parent)
        return yamledit.set_value(
            text, ["nodes", name, "location"],
            [round(float(v), 6) for v in local],
        )

    elif operation == "add-node":
        kind = payload["kind"]
        if kind not in SNIPPETS:
            raise ValueError(f"Unknown object kind {kind!r}")
        import copy

        name = _unique_name(data.get("nodes", {}), kind)
        return yamledit.set_value(
            text, ["nodes", name], copy.deepcopy(SNIPPETS[kind])
        )

    elif operation == "add-recorder":
        node = payload["node"]
        if node not in data.get("nodes", {}):
            raise ValueError(f"Unknown node {node!r}")
        name = _unique_name(data.get("recorders") or {}, f"{node}-escaping")
        return yamledit.set_value(text, ["recorders", name], {
            "node": node,
            "event": "escaping",
            "histograms": {"wavelength": [400, 900, 80]},
        })

    elif operation == "add-face-recorders":
        # One escaping recorder with a position heatmap per box face
        node = payload["node"]
        node_spec = data.get("nodes", {}).get(node)
        if not node_spec or "box" not in node_spec:
            raise ValueError("Face recorders require a box node.")
        size = [float(v) for v in node_spec["box"]["size"]]
        half = [s / 2.0 for s in size]
        axes = "xyz"
        faces = [
            ("top", [0, 0, 1]),
            ("bottom", [0, 0, -1]),
            ("east", [1, 0, 0]),
            ("west", [-1, 0, 0]),
            ("north", [0, 1, 0]),
            ("south", [0, -1, 0]),
        ]
        recorders = data.get("recorders") or {}
        for label, facet in faces:
            name = f"{node}-{label}"
            if name in recorders:
                continue
            axis = [i for i, v in enumerate(facet) if v != 0][0]
            u_axis, v_axis = [i for i in range(3) if i != axis]
            bins_u = max(10, min(60, int(size[u_axis] * 10)))
            bins_v = max(10, min(60, int(size[v_axis] * 10)))
            text = yamledit.set_value(text, ["recorders", name], {
                "node": node,
                "event": "escaping",
                "facet": facet,
                "histograms": {
                    "position": [
                        axes[u_axis],
                        axes[v_axis],
                        [-half[u_axis], half[u_axis], bins_u],
                        [-half[v_axis], half[v_axis], bins_v],
                    ],
                },
            })
        return text

    elif operation == "add-component":
        name = _unique_name(data.get("components") or {}, "absorber")
        return yamledit.set_value(
            text, ["components", name], {"absorber": {"coefficient": 1.0}}
        )

    elif operation == "delete-component":
        name = payload["component"]
        if name not in (data.get("components") or {}):
            raise KeyError(name)
        text = yamledit.delete_key(text, ["components", name])
        for node_name, node_spec in (data.get("nodes") or {}).items():
            for geom in ("box", "sphere", "cylinder", "mesh"):
                material = node_spec.get(geom, {}).get("material", {})
                if name in (material.get("components") or []):
                    text = yamledit.set_value(
                        text,
                        ["nodes", node_name, geom, "material", "components"],
                        [c for c in material["components"] if c != name],
                    )
        return text

    elif operation == "update-recorder":
        # Edits to auto recorders (from record: true) materialise them
        # into the document first, then apply the changes.
        name = payload["recorder"]
        if name not in (data.get("recorders") or {}):
            text = yamledit.set_value(
                text, ["recorders", name], _recorder_to_spec(studio, name)
            )
        for key, value in payload["changes"].items():
            if key not in ("event", "facet", "atol"):
                raise ValueError(f"Cannot update recorder key {key!r}")
            text = yamledit.set_value(text, ["recorders", name, key], value)
        return text

    elif operation == "delete-recorder":
        if payload["recorder"] in (data.get("recorders") or {}):
            return yamledit.delete_key(
                text, ["recorders", payload["recorder"]]
            )
        raise ValueError(
            "This recorder comes from record: true on its node; "
            "set record: false to remove the automatic set."
        )

    elif operation == "delete-node":
        name = payload["node"]
        if name not in (data.get("nodes") or {}):
            raise KeyError(name)
        text = yamledit.delete_key(text, ["nodes", name])
        for rec_name, spec in list((data.get("recorders") or {}).items()):
            if spec.get("node") == name:
                text = yamledit.delete_key(text, ["recorders", rec_name])
        return text

    raise ValueError(f"Unknown operation {operation!r}")


def _recorder_to_spec(studio, name):
    """Serialise a live Recorder object back into a recorders entry."""
    for node in studio.scene.root.iter_preorder():
        for recorder in getattr(node, "recorders", []):
            if recorder.name != name:
                continue
            histograms = {}
            for hist in recorder.histograms:
                if isinstance(hist, Heatmap):
                    histograms["position"] = _flow(
                        [
                            hist.a.prop,
                            hist.b.prop,
                            _flow([hist.a.start, hist.a.stop, hist.a.bins]),
                            _flow([hist.b.start, hist.b.stop, hist.b.bins]),
                        ]
                    )
                else:
                    histograms[hist.prop] = _flow(
                        [hist.start, hist.stop, hist.bins]
                    )
            spec = {"node": node.name, "event": recorder.event}
            if recorder.facet is not None:
                spec["facet"] = _flow(list(recorder.facet))
            spec["histograms"] = histograms
            return spec
    raise ValueError(f"Unknown recorder {name!r}")


def _histogram_meta(compiled):
    """Static histogram descriptions sent once per run."""
    meta = {}
    for r, spec in enumerate(compiled.recorder_specs):
        entries = []
        start = compiled.rec_hist_start[r]
        for h, hist in enumerate(spec.histograms):
            row = compiled.hist_specs[start + h]
            offset = int(row[9])
            if isinstance(hist, Heatmap):
                entries.append(
                    {
                        "kind": "heatmap",
                        "offset": offset,
                        "prop_a": hist.a.prop,
                        "prop_b": hist.b.prop,
                        "edges_a": np.linspace(
                            hist.a.start, hist.a.stop, hist.a.bins + 1
                        ).tolist(),
                        "edges_b": np.linspace(
                            hist.b.start, hist.b.stop, hist.b.bins + 1
                        ).tolist(),
                    }
                )
            else:
                entries.append(
                    {
                        "kind": "hist",
                        "offset": offset,
                        "prop": hist.prop,
                        "edges": np.linspace(
                            hist.start, hist.stop, hist.bins + 1
                        ).tolist(),
                    }
                )
        meta[spec.name] = {
            "event": spec.event,
            "node": compiled.node_names[int(compiled.rec_node[r])],
            "facet": list(spec.facet) if spec.facet else None,
            "histograms": entries,
        }
    return meta


def _recorder_payload(compiled, distinct, crossings, sums, bins):
    payload = {}
    for r, spec in enumerate(compiled.recorder_specs):
        entries = []
        start = compiled.rec_hist_start[r]
        for h, hist in enumerate(spec.histograms):
            row = compiled.hist_specs[start + h]
            offset = int(row[9])
            if isinstance(hist, Heatmap):
                size = hist.a.bins * hist.b.bins
                values = bins[offset : offset + size]
                entries.append(
                    {
                        "values": values.tolist(),
                        "shape": [hist.a.bins, hist.b.bins],
                    }
                )
            else:
                entries.append(
                    {"values": bins[offset : offset + hist.bins].tolist()}
                )
        n = max(int(distinct[r]), 1)
        payload[spec.name] = {
            "rays": int(distinct[r]),
            "crossings": int(crossings[r]),
            "mean_wavelength": float(sums[r, 0, 0] / n),
            "mean_angle": float(sums[r, 1, 0] / n),
            "histograms": entries,
        }
    return payload


def _extract_paths(result, limit):
    """Sampled ray paths as polylines for the viewport."""
    d = result.data
    paths = []
    for j in range(min(result.num_recorded, limit)):
        count = int(d["counts"][j])
        if count < 2:
            continue
        points = d["position"][j, :count]
        # Per-vertex wavelength so luminescent re-emission changes the
        # path colour at the absorption point.
        wavelengths = d["wavelength"][j, :count]
        paths.append(
            {
                "points": np.round(np.asarray(points, dtype=float), 6).tolist(),
                "wavelengths": np.round(
                    np.asarray(wavelengths, dtype=float), 2
                ).tolist(),
            }
        )
    return paths


def create_server(document_path=None, host="127.0.0.1", port=8567, device="cuda"):
    """Build (but do not start) the studio HTTP server; its runs trace on
    `device`."""
    device = require_device(device)
    text = ""
    if document_path:
        text = Path(document_path).read_text()
    studio = Studio(text, document_path=document_path)
    if text:
        try:
            studio.apply(text)
        except Exception:
            pass  # surface errors when the UI applies the document

    stop_flag = threading.Event()
    run_lock = threading.Lock()
    # Watch mode (CLI `simulate --watch`): an external producer pushes
    # started/bundle/done messages; every connected /api/watch client
    # receives them over SSE.
    watch_clients = []
    watch_lock = threading.Lock()

    def watch_broadcast(message):
        with watch_lock:
            clients = list(watch_clients)
        for client in clients:
            client.put(message)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # -- helpers ---------------------------------------------------

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            if length == 0:
                return {}
            return json.loads(self.rfile.read(length))

        def _file(self, path, content_type):
            try:
                body = path.read_bytes()
            except OSError:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            # The studio changes frequently during development; without
            # revalidation the browser serves stale assets after updates.
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # -- routes ----------------------------------------------------

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            route = parsed.path
            if route == "/":
                self._file(STATIC / "index.html", "text/html; charset=utf-8")
            elif route.startswith("/static/"):
                name = os.path.basename(route)
                content_type = {
                    ".js": "application/javascript",
                    ".css": "text/css",
                    ".html": "text/html",
                }.get(os.path.splitext(name)[1], "application/octet-stream")
                self._file(STATIC / name, content_type)
            elif route == "/api/document":
                self._json({"text": studio.document})
            elif route == "/api/run":
                self._run_sse(dict(urllib.parse.parse_qsl(parsed.query)))
            elif route == "/api/watch":
                self._watch_sse()
            else:
                self.send_error(404)

        def do_PUT(self):
            if self.path == "/api/document":
                payload = self._read_json()
                try:
                    scene = studio.apply(payload["text"])
                except Exception as exception:
                    self._json({"error": str(exception)}, status=422)
                    return
                self._json({"scene": scene})
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path == "/api/patch":
                payload = self._read_json()
                try:
                    text = patch_document(studio, payload)
                    scene = studio.apply(text)
                except Exception as exception:
                    self._json({"error": str(exception)}, status=422)
                    return
                self._json({"scene": scene, "text": text})
            elif self.path == "/api/save":
                if not document_path:
                    self._json({"error": "No file was opened."}, status=422)
                    return
                Path(document_path).write_text(studio.document)
                self._json({"saved": str(document_path)})
            elif self.path == "/api/upload":
                # Save a data file (e.g. an absorption spectrum CSV) next
                # to the scene document so the YAML can reference it.
                if not document_path:
                    self._json({"error": "No file was opened."}, status=422)
                    return
                payload = self._read_json()
                name = os.path.basename(payload.get("name", ""))
                if not name or not name.lower().endswith((".csv", ".txt")):
                    self._json(
                        {"error": "Only .csv or .txt files."}, status=422
                    )
                    return
                target = Path(document_path).parent / name
                target.write_text(payload["content"])
                self._json({"saved": name})
            elif self.path == "/api/stop":
                stop_flag.set()
                self._json({"stopping": True})
            else:
                self.send_error(404)

        # -- live run (Server-Sent Events) ------------------------------

        def _sse(self, obj):
            data = json.dumps(obj)
            self.wfile.write(f"data: {data}\n\n".encode())
            self.wfile.flush()

        def _watch_sse(self):
            """Relay externally produced run messages (CLI --watch)."""
            import queue as queue_module

            client = queue_module.Queue()
            with watch_lock:
                watch_clients.append(client)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                while True:
                    try:
                        message = client.get(timeout=30.0)
                    except queue_module.Empty:
                        self._sse({"type": "ping"})
                        continue
                    self._sse(message)
                    if message.get("type") == "done":
                        break
            except BrokenPipeError:
                pass
            finally:
                with watch_lock:
                    if client in watch_clients:
                        watch_clients.remove(client)

        def _run_sse(self, params):
            if studio.scene is None:
                self.send_error(409, "Apply a scene first.")
                return
            if not run_lock.acquire(blocking=False):
                self.send_error(409, "A run is already in progress.")
                return
            try:
                stop_flag.clear()
                num_rays = int(params.get("rays", 100000))
                bundle = int(params.get("bundle", 25000))
                seed = params.get("seed")
                seed = int(seed) if seed not in (None, "", "null") else None
                record_every = int(params.get("record_every", 1000))
                max_paths = int(params.get("max_paths", 200))

                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()

                compiled = engine.compile_scene(studio.scene)
                self._sse(
                    {
                        "type": "started",
                        "total": num_rays,
                        "histograms": _histogram_meta(compiled),
                    }
                )

                n_rec = len(compiled.recorder_names)
                distinct = np.zeros(n_rec, dtype=np.int64)
                crossings = np.zeros(n_rec, dtype=np.int64)
                sums = np.zeros((n_rec, 4, 2), dtype=np.float64)
                bins = np.zeros(int(compiled.total_bins), dtype=np.int64)
                sent_paths = 0
                tic = time.perf_counter()

                # The port's simulate_stream refuses a budget of 0 when
                # called; the JAX package's yields nothing.
                stream = engine.simulate_stream(
                    studio.scene,
                    num_rays,
                    bundle=bundle,
                    seed=seed,
                    record_every=record_every,
                    device=device,
                ) if num_rays > 0 else ()
                for result, traced in stream:
                    if stop_flag.is_set():
                        break
                    distinct += result.data["rec_distinct"]
                    crossings += result.data["rec_crossings"]
                    sums += result.data["rec_sums"].reshape(n_rec, 4, 2)
                    bins += result.data["rec_bins"]

                    paths = []
                    if sent_paths < max_paths:
                        paths = _extract_paths(result, max_paths - sent_paths)
                        sent_paths += len(paths)

                    elapsed = time.perf_counter() - tic
                    self._sse(
                        {
                            "type": "bundle",
                            "traced": traced,
                            "total": num_rays,
                            "rays_per_second": traced / elapsed
                            if elapsed > 0
                            else 0,
                            "recorders": _recorder_payload(
                                compiled, distinct, crossings, sums, bins
                            ),
                            "paths": paths,
                        }
                    )
                self._sse(
                    {"type": "done", "elapsed": time.perf_counter() - tic}
                )
            except BrokenPipeError:
                pass  # browser closed the EventSource
            finally:
                run_lock.release()

    server = ThreadingHTTPServer((host, port), Handler)
    server.studio = studio  # exposed for tests
    server.watch_broadcast = watch_broadcast  # CLI --watch producer hook
    return server


def main(document_path=None, host="127.0.0.1", port=8567, open_browser=True, device="cuda"):
    server = create_server(document_path, host, port, device=device)
    if open_browser:
        import webbrowser

        threading.Timer(
            1.0,
            webbrowser.open,
            args=(f"http://{host}:{server.server_address[1]}",),
        ).start()
    print(f"pvtrace_tpu_torch studio ({device}) on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
