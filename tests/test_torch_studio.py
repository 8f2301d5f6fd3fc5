"""The port's studio (``pvtrace_tpu_torch.studio``) against the JAX
package's.

* the cases of ``tests/test_studio.py`` on the port's server, with
  ``device="cpu"`` (the eager twin);
* the same document and patches give the same text and scene payload in
  both packages, as JSON;
* ``/api/run`` at RUN (rays, bundles, record_every, seed), the port's
  ``simulate_stream`` wrapped here to pass ``dtype=np.float64`` as the
  JAX server traces float64 under the tests' x64: the same ``started``
  histograms, and the last bundle's recorder integers within PARTED of
  the JAX server's (a photon that parts by an ulp moves at most one
  count of each), their mean wavelength and angle within what PARTED
  photons can move them;
* the watch broadcast, and a run of 0 rays: ``started`` then ``done``;
* ``static/*`` byte for byte the JAX package's, so that
  ``tests/test_frontend.py``, which runs ``app.js`` against the JAX
  server, covers both copies;
* the cases of ``tests/test_yamledit.py`` over both packages'
  ``yamledit`` and ``patch_document``.

The JAX package is imported inside the fixtures and tests that use it,
so that the ``gpu`` tests run on the card with ``--noconftest``:
``python -m pytest --noconftest tests/test_torch_studio.py -m gpu``.
"""
import contextlib
import functools
import importlib
import json
import os
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import yaml

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import pvtrace_tpu_torch.studio.server as studio_server  # noqa: E402
from pvtrace_tpu_torch import engine  # noqa: E402
from pvtrace_tpu_torch.studio.client import recorder_ints, sse_messages  # noqa: E402

cap_threads()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")


ROOT = Path(__file__).resolve().parents[1]
DATA = os.path.join(os.path.dirname(__file__), "data")
DOCUMENT = os.path.join(DATA, "lsc_scene_studio.yml")
RUN = "rays=2000&bundle=1000&record_every=50&max_paths=20&seed=11"
PARTED = 2
PACKAGES = ("pvtrace_tpu", "pvtrace_tpu_torch")


@contextlib.contextmanager
def serving(module, document=DOCUMENT, **kwargs):
    """A started studio server of `module` (either package's
    ``studio.server``) on an ephemeral port: (base URL, server)."""
    httpd = module.create_server(document, host="127.0.0.1", port=0, **kwargs)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d" % httpd.server_address[1], httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)


@pytest.fixture(scope="module")
def server():
    with serving(studio_server, device="cpu") as served:
        yield served


def request(base, method, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as response:
            return response.status, json.loads(response.read())
    except urllib.error.HTTPError as error:
        return error.code, json.loads(error.read())


def run_messages(base, query):
    """The messages of one ``/api/run?query`` until ``done``."""
    return sse_messages(f"{base}/api/run?{query}")


# -- tests/test_studio.py on the port's server --------------------------------


def test_document_roundtrip_and_payload(server):
    base, httpd = server
    status, data = request(base, "GET", "/api/document")
    assert status == 200
    text = data["text"]
    assert "lsc" in text
    status, data = request(base, "PUT", "/api/document", {"text": text})
    assert status == 200
    payload = data["scene"]
    assert {"world", "lsc"} <= {node["name"] for node in payload["nodes"]}
    lsc = next(n for n in payload["nodes"] if n["name"] == "lsc")
    assert lsc["type"] == "box" and len(lsc["matrix"]) == 16
    assert payload["lights"] and payload["recorders"]
    assert any(r["auto"] for r in payload["recorders"])
    assert type(httpd.studio.scene).__module__ == "pvtrace_tpu_torch.scene.scene"


def test_invalid_document_is_rejected(server):
    base, _ = server
    status, data = request(base, "PUT", "/api/document", {"text": "version: '1.0'\nnodes: {}"})
    assert status == 422 and "error" in data


def test_patch_add_and_delete_node(server):
    base, _ = server
    status, data = request(base, "POST", "/api/patch", {"op": "add-node", "kind": "sphere"})
    assert status == 200 and "sphere-1" in data["text"]
    assert any(n["name"] == "sphere-1" for n in data["scene"]["nodes"])
    status, data = request(base, "POST", "/api/patch", {"op": "delete-node", "node": "sphere-1"})
    assert status == 200
    assert not any(n["name"] == "sphere-1" for n in data["scene"]["nodes"])


def test_patch_set_location_and_move(server):
    base, httpd = server
    status, data = request(base, "POST", "/api/patch", {
        "op": "set", "path": ["nodes", "lsc", "location"], "value": [0.0, 0.0, 0.5]})
    assert status == 200
    lsc = next(n for n in data["scene"]["nodes"] if n["name"] == "lsc")
    assert abs(lsc["matrix"][11] - 0.5) < 1e-9
    status, data = request(base, "POST", "/api/patch", {
        "op": "move", "node": "lsc", "world_position": [0.0, 0.0, 0.0]})
    assert status == 200
    assert httpd.studio.spec["nodes"]["lsc"]["location"] == [0.0, 0.0, 0.0]


def test_patch_recorders_and_components(server):
    base, httpd = server
    status, _ = request(base, "POST", "/api/patch", {"op": "add-recorder", "node": "lsc"})
    assert status == 200 and "lsc-escaping-1" in httpd.studio.spec["recorders"]
    status, _ = request(base, "POST", "/api/patch", {"op": "add-face-recorders", "node": "lsc"})
    assert status == 200
    for label in ("top", "bottom", "east", "west", "north", "south"):
        assert f"lsc-{label}" in httpd.studio.spec["recorders"]
    top = httpd.studio.spec["recorders"]["lsc-top"]
    assert top["facet"] == [0, 0, 1] and "position" in top["histograms"]
    status, _ = request(base, "POST", "/api/patch", {
        "op": "update-recorder", "recorder": "lsc-top", "changes": {"atol": 1e-3}})
    assert status == 200 and httpd.studio.spec["recorders"]["lsc-top"]["atol"] == 1e-3
    status, _ = request(base, "POST", "/api/patch", {"op": "delete-recorder",
                                                     "recorder": "lsc-top"})
    assert status == 200 and "lsc-top" not in httpd.studio.spec["recorders"]
    status, _ = request(base, "POST", "/api/patch", {"op": "add-component"})
    assert status == 200 and "absorber-1" in httpd.studio.spec["components"]
    status, _ = request(base, "POST", "/api/patch", {"op": "delete-component",
                                                     "component": "absorber-1"})
    assert status == 200 and "absorber-1" not in httpd.studio.spec.get("components", {})


def test_patch_unknown_operation(server):
    base, _ = server
    status, _ = request(base, "POST", "/api/patch", {"op": "explode"})
    assert status == 422


def test_run_streams_bundles_and_paths(server):
    base, _ = server
    eager = engine.tracer.eager_runs
    messages = run_messages(base, "rays=2000&bundle=1000&record_every=50&max_paths=20")
    kinds = [m["type"] for m in messages]
    assert kinds == ["started", "bundle", "bundle", "done"]
    final = messages[-2]
    assert final["traced"] == 2000 and final["rays_per_second"] > 0
    assert any(r["rays"] > 0 for r in final["recorders"].values())
    paths = [p for m in messages[1:-1] for p in m["paths"]]
    assert paths and len(paths[0]["points"]) == len(paths[0]["wavelengths"])
    assert len(paths[0]["points"][0]) == 3
    assert engine.tracer.eager_runs == eager + 2


def test_run_of_no_rays_sends_started_then_done(server):
    """The JAX package's empty stream for a budget of 0; the port's
    simulate_stream refuses one, so the server does not call it."""
    base, _ = server
    eager = engine.tracer.eager_runs
    messages = run_messages(base, "rays=0")
    assert [m["type"] for m in messages] == ["started", "done"]
    assert messages[0]["total"] == 0 and messages[0]["histograms"]
    assert engine.tracer.eager_runs == eager


def test_second_run_while_one_goes_gets_409(monkeypatch):
    """The run lock: a second ``/api/run`` while a run streams is refused
    with 409, as in the JAX package, and the first run completes."""
    entered, release = threading.Event(), threading.Event()
    stream = engine.simulate_stream

    def held(*args, **kwargs):
        entered.set()
        assert release.wait(60)
        yield from stream(*args, **kwargs)

    monkeypatch.setattr(engine, "simulate_stream", held)
    with serving(studio_server, device="cpu") as (base, _):
        first = []
        thread = threading.Thread(target=lambda: first.extend(run_messages(base, "rays=200")))
        thread.start()
        assert entered.wait(60)
        with pytest.raises(urllib.error.HTTPError) as refused:
            run_messages(base, "rays=200")
        release.set()
        thread.join(timeout=120)
    assert refused.value.code == 409
    assert [m["type"] for m in first] == ["started", "bundle", "done"]


def test_histogram_meta_carries_facets():
    with serving(studio_server, device="cpu") as (base, httpd):
        status, _ = request(base, "POST", "/api/patch", {"op": "add-face-recorders",
                                                         "node": "lsc"})
        assert status == 200
        compiled = engine.compile_scene(httpd.studio.scene)
    meta = studio_server._histogram_meta(compiled)
    faceted = [m for m in meta.values() if m["facet"]]
    assert faceted
    heatmaps = [h for m in faceted for h in m["histograms"] if h["kind"] == "heatmap"]
    assert heatmaps
    for h in heatmaps:
        assert h["prop_a"] in ("x", "y", "z") and "edges_a" in h and "edges_b" in h


def test_mesh_triangles_in_scene_payload():
    from pvtrace_tpu_torch import Material, Node, Scene, Sphere
    from pvtrace_tpu_torch.geometry.mesh import Mesh

    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    world = Node(name="world",
                 geometry=Sphere(radius=5.0, material=Material(refractive_index=1.0)))
    Node(name="tetra", parent=world,
         geometry=Mesh((v, f), material=Material(refractive_index=1.5)))
    studio = studio_server.Studio()
    studio.scene = Scene(world)
    studio.spec = {}
    payload = studio.scene_payload(engine.compile_scene(studio.scene))
    tetra = next(n for n in payload["nodes"] if n["name"] == "tetra")
    assert tetra["type"] == "mesh" and len(tetra["triangles"]) == 4 * 9
    assert next(n for n in payload["nodes"] if n["name"] == "world")["triangles"] is None


def test_watch_sse_broadcast(server):
    base, httpd = server
    messages = []

    def consume():
        with urllib.request.urlopen(f"{base}/api/watch", timeout=10) as response:
            for raw in response:
                line = raw.decode().strip()
                if line.startswith("data: "):
                    messages.append(json.loads(line[6:]))
                    if messages[-1].get("type") == "done":
                        break

    thread = threading.Thread(target=consume, daemon=True)
    thread.start()
    time.sleep(0.5)
    httpd.watch_broadcast({"type": "started", "total": 10, "histograms": {}})
    httpd.watch_broadcast({"type": "bundle", "traced": 10, "total": 10, "rays_per_second": 1.0,
                           "recorders": {}, "paths": []})
    httpd.watch_broadcast({"type": "done", "elapsed": 0.1})
    thread.join(timeout=10)
    assert [m["type"] for m in messages] == ["started", "bundle", "done"]


@pytest.mark.parametrize("name", ["index.html", "app.js", "app.css"])
def test_static_files_are_the_jax_packages(name, server):
    base, _ = server
    port = ROOT / "pvtrace_tpu_torch" / "studio" / "static" / name
    assert port.read_bytes() == (ROOT / "pvtrace_tpu" / "studio" / "static" / name).read_bytes()
    assert studio_server.STATIC / name == port
    path = "/" if name == "index.html" else f"/static/{name}"
    with urllib.request.urlopen(base + path) as response:
        assert response.read() == port.read_bytes()


def test_frontend_watch_mode():
    source = (studio_server.STATIC / "app.js").read_text()
    assert 'attachRunStream("/api/watch")' in source and 'get("watch")' in source


def test_without_cuda_the_default_device_raises(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        studio_server.create_server(DOCUMENT, port=0)


# -- the same document, patches and runs in both packages -------------------


PATCHES = {
    "set radius": {"op": "set", "path": ["nodes", "world", "sphere", "radius"], "value": 14.0},
    "move": {"op": "move", "node": "lsc", "world_position": [0.2, 0.0, 0.75]},
    "add sphere": {"op": "add-node", "kind": "sphere"},
    "add cylinder": {"op": "add-node", "kind": "cylinder"},
    "add light": {"op": "add-node", "kind": "light"},
    "add recorder": {"op": "add-recorder", "node": "lsc"},
    "face recorders": {"op": "add-face-recorders", "node": "lsc"},
    "add component": {"op": "add-component"},
    "delete component": {"op": "delete-component", "component": "background"},
    "update recorder": {"op": "update-recorder", "recorder": "lsc-top",
                        "changes": {"atol": 1e-3}},
    "delete node": {"op": "delete-node", "node": "green-laser"},
}


@pytest.mark.parametrize("name", sorted(PATCHES))
def test_patch_gives_the_jax_packages_text_and_scene(name):
    import pvtrace_tpu.studio.server as jax_server

    document = Path(DOCUMENT).read_text()
    out = {}
    for module in (jax_server, studio_server):
        studio = module.Studio(document, document_path=DOCUMENT)
        first = studio.apply(document)
        text = module.patch_document(studio, PATCHES[name])
        out[module] = (json.dumps(first), text, json.dumps(studio.apply(text)))
    assert out[studio_server] == out[jax_server]
    assert out[studio_server][1] != document


@pytest.fixture(scope="module")
def jax_run():
    import pvtrace_tpu.studio.server as jax_server

    with serving(jax_server) as (base, _):
        return run_messages(base, RUN)


def test_run_matches_the_jax_servers(jax_run):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "simulate_stream",
                   functools.partial(engine.simulate_stream, dtype=np.float64))
        with serving(studio_server, device="cpu") as (base, _):
            got = run_messages(base, RUN)
    assert [m["type"] for m in got] == [m["type"] for m in jax_run] == \
        ["started", "bundle", "bundle", "done"]
    assert got[0] == jax_run[0]
    assert [(m["traced"], len(m["paths"])) for m in got[1:-1]] == \
        [(m["traced"], len(m["paths"])) for m in jax_run[1:-1]]
    assert got[1]["paths"]
    last, ref = got[-2]["recorders"], jax_run[-2]["recorders"]
    assert sorted(last) == sorted(ref)
    for name in ref:
        mine, want = recorder_ints({name: last[name]})[name], recorder_ints({name: ref[name]})[name]
        assert abs(mine[0] - want[0]) <= PARTED and abs(mine[1] - want[1]) <= PARTED, name
        for a, b in zip(mine[2], want[2]):
            assert np.abs(np.asarray(a) - np.asarray(b)).sum() <= 2 * PARTED, name
        rays = max(want[0], 1)
        # A mean moves by at most PARTED photons' range over the rays:
        # 1000 nm of wavelength, pi of angle.
        for key, span in (("mean_wavelength", 1000.0), ("mean_angle", np.pi)):
            allow = PARTED * span / rays + 1e-9 * abs(ref[name][key])
            assert abs(last[name][key] - ref[name][key]) <= allow, (name, key)
    assert sum(r["rays"] for r in ref.values()) > 0


# -- tests/test_yamledit.py over both packages --------------------------------


YAML_DOC = """\
# my scene file
version: "1.0"  # spec version
nodes:
  # the world sphere
  world:
    sphere:
      radius: 10.0   # world radius
      material: {refractive_index: 1.0}
  lsc:  # the concentrator
    box:
      size: [5, 5, 1]
      material:
        refractive_index: 1.5
        components: [dye]
    location: [0, 0, 0]  # sits at origin
components:
  dye:
    absorber:
      coefficient: 5.0
"""
COMMENTS = ("# my scene file", "# spec version", "# the world sphere", "# world radius",
            "# the concentrator")
STUDIO_COMMENTS = ("# scene spec version", "# --- geometry ---", "# --- materials ---")
FLOW_DOC = (
    "nodes:\n"
    "  world:\n"
    "    sphere:\n"
    "      radius: 10.0\n"
    "      material: {refractive_index: 1.0, color: red}  # inline\n"
)
FLOW_PATH = ["nodes", "world", "sphere", "material"]


def assert_comments(text, *extra):
    for comment in COMMENTS + extra:
        assert comment in text, comment


@pytest.fixture(params=PACKAGES)
def yamledit(request):
    return importlib.import_module(f"{request.param}.studio.yamledit")


def test_set_scalar_keeps_line_comment(yamledit):
    text = yamledit.set_value(YAML_DOC, ["nodes", "world", "sphere", "radius"], 12.5)
    assert "radius: 12.5   # world radius" in text
    assert_comments(text, "# sits at origin")
    assert yamledit.get_value(text, ["nodes", "world", "sphere", "radius"]) == 12.5


def test_set_flow_list_keeps_trailing_comment(yamledit):
    text = yamledit.set_value(YAML_DOC, ["nodes", "lsc", "location"], [1.0, 2.0, 3.5])
    assert "location: [1.0, 2.0, 3.5]  # sits at origin" in text
    assert_comments(text)


def test_set_inside_flow_mapping(yamledit):
    text = yamledit.set_value(
        YAML_DOC, ["nodes", "world", "sphere", "material", "refractive_index"], 1.33)
    assert "{refractive_index: 1.33}" in text
    assert_comments(text, "# sits at origin")


def test_create_missing_section_and_nested_keys(yamledit):
    text = yamledit.set_value(YAML_DOC, ["recorders", "top"], {
        "node": "lsc", "event": "escaping", "histograms": {"wavelength": [400, 900, 80]}})
    assert yamledit.get_value(text, ["recorders", "top", "histograms", "wavelength"]) == \
        [400, 900, 80]
    assert_comments(text, "# sits at origin")
    text = yamledit.set_value(text, ["recorders", "top", "atol"], 1e-3)
    assert yamledit.get_value(text, ["recorders", "top", "atol"]) == 1e-3


def test_delete_key_and_refill_empty_section(yamledit):
    text = yamledit.delete_key(YAML_DOC, ["components", "dye"])
    assert yamledit.get_value(text, ["components"]) == {}
    assert_comments(text, "# sits at origin")
    text = yamledit.set_value(text, ["components", "abs-1"], {"absorber": {"coefficient": 1.0}})
    assert yamledit.get_value(text, ["components", "abs-1", "absorber", "coefficient"]) == 1.0
    assert_comments(text)


def test_delete_one_of_many(yamledit):
    text = yamledit.delete_key(YAML_DOC, ["nodes", "lsc"])
    nodes = yamledit.get_value(text, ["nodes"])
    assert "lsc" not in nodes and "world" in nodes
    assert "# the world sphere" in text


def test_delete_missing_raises(yamledit):
    with pytest.raises(KeyError):
        yamledit.delete_key(YAML_DOC, ["nodes", "nope"])


def test_replace_non_mapping_leaf_with_nested_spec(yamledit):
    text = yamledit.set_value(YAML_DOC, ["nodes", "lsc", "location", "x"], 1.0)
    assert yamledit.get_value(text, ["nodes", "lsc", "location"]) == {"x": 1.0}
    assert_comments(text)


def test_flow_insert_keeps_siblings(yamledit):
    text = yamledit.set_value(FLOW_DOC, FLOW_PATH + ["absorption"], 0.5)
    assert yamledit.get_value(text, FLOW_PATH) == {
        "refractive_index": 1.0, "color": "red", "absorption": 0.5}
    assert "# inline" in text


def test_flow_insert_dict_value_stays_inline(yamledit):
    text = yamledit.set_value(FLOW_DOC, FLOW_PATH + ["extra"], {"a": 1.0})
    assert yamledit.get_value(text, FLOW_PATH + ["extra"]) == {"a": 1.0}


def test_flow_replace_dict_value_stays_inline(yamledit):
    text = yamledit.set_value(FLOW_DOC, FLOW_PATH, {"refractive_index": 1.5})
    assert yamledit.get_value(text, FLOW_PATH) == {"refractive_index": 1.5}
    assert yamledit.get_value(text, FLOW_PATH[:-1] + ["radius"]) == 10.0


def test_flow_delete_middle_key_keeps_siblings(yamledit):
    text = yamledit.delete_key(FLOW_DOC, FLOW_PATH + ["refractive_index"])
    assert yamledit.get_value(text, FLOW_PATH) == {"color": "red"}
    assert "# inline" in text


def test_flow_delete_last_key_keeps_siblings(yamledit):
    text = yamledit.delete_key(FLOW_DOC, FLOW_PATH + ["color"])
    assert yamledit.get_value(text, FLOW_PATH) == {"refractive_index": 1.0}


def test_flow_delete_only_key_leaves_inline_empty_mapping(yamledit):
    doc = FLOW_DOC.replace("{refractive_index: 1.0, color: red}", "{refractive_index: 1.0}")
    text = yamledit.delete_key(doc, FLOW_PATH + ["refractive_index"])
    assert yamledit.get_value(text, FLOW_PATH) == {}
    assert yamledit.get_value(text, FLOW_PATH[:-1] + ["radius"]) == 10.0


def test_dict_nested_in_list_inside_flow_mapping(yamledit):
    text = yamledit.set_value("m: {a: 1}\n", ["m", "b"], {"layers": [{"t": 1.0, "n": 2.0}]})
    assert yaml.safe_load(text)["m"] == {"a": 1, "b": {"layers": [{"t": 1.0, "n": 2.0}]}}


def test_insert_after_trailing_comma(yamledit):
    text = yamledit.set_value("m: {a: 1,}\n", ["m", "b"], 2.0)
    assert yaml.safe_load(text)["m"] == {"a": 1, "b": 2.0}


def test_dict_in_list_in_block_context(yamledit):
    text = yamledit.set_value("top: 1\n", ["items"], [{"k": 1.0}, {"k": 2.0}])
    assert yaml.safe_load(text)["items"] == [{"k": 1.0}, {"k": 2.0}]


@pytest.fixture(scope="module", params=PACKAGES)
def commented(request):
    """Either package's server module and a Studio on the standard test
    scene with user comments added (``tests/test_yamledit.py``)."""
    module = importlib.import_module(f"{request.param}.studio.server")
    document = Path(DOCUMENT).read_text()
    document = document.replace('version: "1.0"', 'version: "1.0"  # scene spec version')
    document = document.replace("\nnodes:", "\n# --- geometry ---\nnodes:", 1)
    document = document.replace("    location: [0, 0, 0.5]",
                                "    location: [0, 0, 0.5]  # half a slab above the table")
    document = document.replace("\ncomponents:", "\n# --- materials ---\ncomponents:", 1)
    studio = module.Studio(document, document_path=DOCUMENT)
    studio.apply(document)
    return module, studio


def test_gizmo_move_keeps_comments(commented):
    module, studio = commented
    text = module.patch_document(studio, {"op": "move", "node": "lsc",
                                          "world_position": [0.2, 0.0, 0.75]})
    for comment in STUDIO_COMMENTS + ("# half a slab above the table",):
        assert comment in text
    assert yaml.safe_load(text)["nodes"]["lsc"]["location"] == [0.2, 0.0, 0.75]
    studio.apply(text)


def test_set_add_update_delete_cycle_keeps_comments(commented):
    module, studio = commented
    for patch in (
        {"op": "set", "path": ["nodes", "world", "sphere", "radius"], "value": 14.0},
        {"op": "add-recorder", "node": "lsc"},
        {"op": "update-recorder", "recorder": "lsc-escaping-1", "changes": {"atol": 1e-3}},
        {"op": "add-component"},
        {"op": "delete-component", "component": "absorber-1"},
        {"op": "delete-recorder", "recorder": "lsc-escaping-1"},
    ):
        studio.apply(module.patch_document(studio, patch))
    for comment in STUDIO_COMMENTS + ("# half a slab above the table",):
        assert comment in studio.document
    spec = yaml.safe_load(studio.document)
    assert spec["nodes"]["world"]["sphere"]["radius"] == 14.0
    assert "absorber-1" not in (spec.get("components") or {})
    assert "lsc-escaping-1" not in (spec.get("recorders") or {})


def test_add_and_delete_node_keeps_comments(commented):
    module, studio = commented
    text = module.patch_document(studio, {"op": "add-node", "kind": "sphere"})
    assert yaml.safe_load(text)["nodes"]["sphere-1"]
    studio.apply(text)
    text = module.patch_document(studio, {"op": "delete-node", "node": "sphere-1"})
    assert "sphere-1" not in yaml.safe_load(text)["nodes"]
    for comment in STUDIO_COMMENTS:
        assert comment in text
    studio.apply(text)


def test_delete_component_rewrites_node_lists(commented):
    module, studio = commented
    text = module.patch_document(studio, {"op": "delete-component", "component": "background"})
    spec = yaml.safe_load(text)
    assert "background" not in spec["components"]
    assert spec["nodes"]["lsc"]["box"]["material"]["components"] == ["my-lumogen-dye"]
    for comment in STUDIO_COMMENTS:
        assert comment in text


# -- on the card ---------------------------------------------------------------


@pytest.mark.gpu
def test_studio_on_the_card_matches_the_cpu_twin(card):
    """``/api/run`` of 2^12 rays in bundles of 2^10 at record_every=1000
    on the card (pvt_trace with recorders and the log, pvt_log_pack)
    against a server on the CPU (float32 both, the same seed). A photon
    that parts between the two moves at most one count of each integer,
    and at most TOL = max(20, 0.2 % of n) photons may part
    (``check_trace``'s allowance): each recorder's rays and crossings
    within TOL, each histogram's total within TOL and its bins within an
    L1 distance of 2 * TOL (a count moved from one bin to another is 2),
    so that bins filled in the wrong place fail however sparse they are."""
    from pvtrace_tpu_torch import kernels

    n = 4096
    query = f"rays={n}&bundle=1024&record_every=1000&seed=5"
    kernels.reset()
    with serving(studio_server) as (base, _):
        card = run_messages(base, query)
    assert kernels.launches["pvt_trace_log"] == 4 and kernels.launches["pvt_log_pack"] == 4
    with serving(studio_server, device="cpu") as (base, _):
        cpu = run_messages(base, query)
    tol = max(20, n // 500)
    got, ref = recorder_ints(card[-2]["recorders"]), recorder_ints(cpu[-2]["recorders"])
    assert sorted(got) == sorted(ref)
    assert sum(r[0] for r in ref.values()) > 0
    for name in ref:
        assert abs(got[name][0] - ref[name][0]) <= tol, name
        assert abs(got[name][1] - ref[name][1]) <= tol, name
        assert len(got[name][2]) == len(ref[name][2]), name
        for a, b in zip(got[name][2], ref[name][2]):
            a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
            assert a.shape == b.shape, name
            assert abs(int(a.sum()) - int(b.sum())) <= tol, name
            assert int(np.abs(a - b).sum()) <= 2 * tol, name
