"""Touching and coincident surfaces: the reference's goldens on the port.

The port's counterpart of the JAX package's
``tests/test_touching_engine.py``: the same scenes (``scenes.touching_scene``,
three unit glass boxes stacked with coincident faces, and
``scenes.embedded_scene``) and crafted start rays through the bundle form
of the trace with ``record_every=1``, in float32 and float64, through the
eager twin (``kernels.trace`` on the CPU) and through the g++ host build
of the device code (``trace_photon``, ``kernels/host.py``):

* the first boundary event after each start point carries the container
  the reference's ``find_container`` resolves (the GENERATE row logs -1 by
  design);
* interior touching faces between equal-index boxes have R = 0, so their
  crossings are deterministic TRANSMITs with the exact (container,
  adjacent) pair and position;
* fully transmitted photons reproduce the reference's golden path, z =
  -0.5, 0.5, 1.5, 2.5, then the world's exit, event for event, and the
  oracle agrees on the same ray;
* with unequal indices the interior faces still resolve their pair.
"""
import ctypes

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.algorithm import photon_tracer  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, physics, rng, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import host  # noqa: E402
from pvtrace_tpu_torch.light.event import Event  # noqa: E402
from pvtrace_tpu_torch.light.ray import Ray  # noqa: E402
from pvtrace_tpu_torch.scenes import embedded_scene, touching_scene  # noqa: E402

cap_threads()
KIND, HIT, CONTAINER, ADJACENT = 0, 1, 2, 3
DTYPES = {"float32": torch.float32, "float64": torch.float64}
ROUTES = ("twin", "host")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """tracer.cuh built for the host, float32 and float64 (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return {torch.float32: host.build_library(tmp_path_factory.mktemp("h32")),
            torch.float64: host.build_library(tmp_path_factory.mktemp("h64"), f64=True)}


@pytest.fixture(params=[(d, r) for d in DTYPES for r in ROUTES],
                ids=[f"{d}-{r}" for d in DTYPES for r in ROUTES])
def trace(request, host_libs):
    """engine_trace(scene, starts, directions) of the case: (node index of
    each name, log ints, log floats, counts, the position tolerance)."""
    dtype, route = DTYPES[request.param[0]], request.param[1]

    def run(scene, starts, directions, seed=2, wavelength=555.0):
        compiled = compile_scene(scene)
        st = tables.scene_tensors(compiled, dtype=dtype)
        n = len(starts)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        bundle = torch.from_numpy(tracer.bundle_rows(
            np.asarray(starts, float), np.asarray(directions, float), np.full(n, wavelength),
            np_dtype))
        words = rng.key_words(seed)
        if route == "twin":
            _, _, _, log = kernels.trace(st, words, n, record_every=1, bundle=bundle)
        else:
            log, desc = kernels.empty_log(n, 1, 128, 0, "cpu", dtype=dtype)
            fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
            host_libs[dtype].h_trace_bundle(
                ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), words[0], words[1], 0,
                n, ctypes.byref(desc), fates.data_ptr(),
                ctypes.byref(kernels._Bundle(bundle.data_ptr(), n, 0)))
            assert int(fates.sum()) == n
        idx = {name: i for i, name in enumerate(compiled.node_names)}
        atol = 1e-4 if dtype == torch.float32 else 1e-9
        return idx, log["ints"].numpy(), log["floats"].double().numpy(), \
            log["counts"].numpy(), atol

    return run


def test_container_inference_touching_starts(trace):
    starts = [(0.0, 0.0, z) for z in (-1.0, -0.4, 0.6, 1.6, 2.6)]
    expected = ["world", "box1", "box2", "box3", "world"]
    idx, ints, _, counts, _ = trace(touching_scene(), starts, [(0.0, 0.0, 1.0)] * len(starts))
    for j, name in enumerate(expected):
        assert Event(ints[j, 0, KIND]) == Event.GENERATE
        assert int(counts[j]) >= 2
        assert ints[j, 1, CONTAINER] == idx[name], (j, name, ints[j, 1, CONTAINER])


def test_container_inference_embedded_starts(trace):
    starts = [(0.0, 0.0, -1.0), (0.0, 0.0, -0.4), (0.0, 0.0, 0.6)]
    expected = [("world", "box"), ("box", "world"), ("world", None)]
    idx, ints, _, counts, _ = trace(embedded_scene(), starts, [(0.0, 0.0, 1.0)] * len(starts))
    for j, (container, adjacent) in enumerate(expected):
        assert Event(ints[j, 0, KIND]) == Event.GENERATE
        assert int(counts[j]) >= 2
        assert ints[j, 1, CONTAINER] == idx[container], j
        if adjacent is not None:
            assert ints[j, 1, ADJACENT] == idx[adjacent], j
        else:
            assert Event(ints[j, 1, KIND]) == Event.EXIT


def _upward_crossings(ints, floats, counts, atol, faces):
    """(photon, record, face z) of every TRANSMIT or REFLECT moving +z at
    one of `faces`."""
    out = []
    for j in range(len(counts)):
        for k in range(int(counts[j])):
            if Event(ints[j, k, KIND]) not in (Event.TRANSMIT, Event.REFLECT):
                continue
            for z0 in faces:
                if abs(floats[j, k, 2] - z0) < atol and floats[j, k, 5] > 0.0:
                    out.append((j, k, z0))
    return out


def test_interior_coincident_faces_are_deterministic(trace):
    B = 200
    idx, ints, floats, counts, atol = trace(touching_scene(), [(0.0, 0.0, -1.0)] * B,
                                            [(0.0, 0.0, 1.0)] * B)
    inner = {0.5: (idx["box1"], idx["box2"]), 1.5: (idx["box2"], idx["box3"])}
    crossings = _upward_crossings(ints, floats, counts, atol, inner)
    for j, k, z0 in crossings:
        assert Event(ints[j, k, KIND]) == Event.TRANSMIT, (j, k, z0)
        assert (ints[j, k, CONTAINER], ints[j, k, ADJACENT]) == inner[z0], (j, k, z0)
    assert len(crossings) > 200


GOLDEN_Z = [-1.0, -0.5, 0.5, 1.5, 2.5, 10.0]
GOLDEN_EVENTS = [Event.GENERATE, Event.TRANSMIT, Event.TRANSMIT, Event.TRANSMIT,
                 Event.TRANSMIT, Event.EXIT]


def test_golden_transmit_path(trace):
    B = 100
    idx, ints, floats, counts, atol = trace(touching_scene(), [(0.0, 0.0, -1.0)] * B,
                                            [(0.0, 0.0, 1.0)] * B)
    pairs = [None, ("world", "box1"), ("box1", "box2"), ("box2", "box3"), ("box3", "world"),
             None]
    golden = 0
    for j in range(B):
        n = int(counts[j])
        if [Event(ints[j, k, KIND]) for k in range(n)] != GOLDEN_EVENTS:
            continue  # reflected at an air/glass coin: stochastic
        golden += 1
        for k in range(n):
            assert abs(floats[j, k, 2] - GOLDEN_Z[k]) < (atol if k < n - 1 else 1e-3), (j, k)
            assert abs(floats[j, k, 0]) < 1e-3 and abs(floats[j, k, 1]) < 1e-3
            if pairs[k] is not None:
                assert ints[j, k, CONTAINER] == idx[pairs[k][0]]
                assert ints[j, k, ADJACENT] == idx[pairs[k][1]]
    # P(full transmit) = 0.96^2, about 0.92
    assert golden > 70


def test_unequal_indices_still_resolve_adjacency(trace):
    B = 200
    idx, ints, floats, counts, atol = trace(touching_scene(n1=1.5, n2=1.8, n3=1.3),
                                            [(0.0, 0.0, -1.0)] * B, [(0.0, 0.0, 1.0)] * B)
    inner = {0.5: (idx["box1"], idx["box2"]), 1.5: (idx["box2"], idx["box3"])}
    crossings = _upward_crossings(ints, floats, counts, atol, inner)
    for j, k, z0 in crossings:
        assert (ints[j, k, CONTAINER], ints[j, k, ADJACENT]) == inner[z0], (j, k, z0)
    assert len(crossings) > 100


def test_oracle_agrees_on_golden_path():
    """The port's oracle takes the golden path on the same start ray, and
    its records' (container, adjacent) pairs and positions are the
    engine's golden ones (``test_golden_transmit_path``)."""
    scene = touching_scene()
    np.random.seed(0)
    ray = Ray(position=(0.0, 0.0, -1.0), direction=(0.0, 0.0, 1.0), wavelength=555.0)
    for _ in range(20):
        history = list(photon_tracer.step_forward(scene, ray))
        if [e for _, e, _ in history] == GOLDEN_EVENTS:
            break
    else:
        pytest.fail("the oracle never took the 92% path")
    np.testing.assert_allclose([r.position[2] for r, _, _ in history[:5]], GOLDEN_Z[:5],
                               atol=1e-9)
    assert [(m["container"], m["adjacent"]) for _, _, m in history[1:5]] == [
        ("world", "box1"), ("box1", "box2"), ("box2", "box3"), ("box3", "world")]
