"""K8's host-bundle entry: scenes whose lights are emitted on the host.

Lights that the compilers cannot lower to device samplers (a histogram
spectrum, a custom position or direction callable) are emitted on the
host by ``engine/emit.py::emit_bundle`` from the global ``np.random``
stream and traced as a bundle, without regeneration
(``pvtrace_tpu/engine/api.py:494-513``, ``tracer.py::trace_bundle``).
Both packages draw the same bundle after the same ``np.random.seed``, so
in float64 the port's ``simulate`` of such a scene agrees with the JAX
package's photon for photon, up to the rare photon an ulp flips: fates,
recorder integers and the event log (``ULP_PHOTONS``, ``RTOL``), score
sums within ``test_torch_score.py``'s allowance. Each JAX run is one
compile, shared by the tests of its scene through a module fixture.

Without JAX: the twin fed its own device emission as a bundle equals the
device-emitted run bit for bit; ``trace_photon``'s bundle start, built for
the host (``kernels/host.py``), agrees with the twin's; device emission
and a bad bundle are refused.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu.engine.emit import emit_bundle as jax_emit_bundle  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, eventlog, rng, score, simulate  # noqa: E402
from pvtrace_tpu_torch.engine import tables, tracer  # noqa: E402
from pvtrace_tpu_torch.engine.emit import emit_bundle  # noqa: E402
from pvtrace_tpu_torch.kernels import check, host  # noqa: E402
from pvtrace_tpu_torch.scenes import api, lsc_slab, lsc_slab_host, lsc_slab_recorders, tetrahedron  # noqa: E402

torch.set_num_threads(1)
ULP_PHOTONS = 4
RTOL = 1e-9
SCORE_RTOL = 1e-9
N_SMALL = 2 ** 11
N_SLAB = 2 ** 11


def host_light_scene(ns=None):
    """A lamp whose direction is a python function, in an empty world."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=5.0, material=p.Material(refractive_index=1.0)))
    p.Node(name="lamp", light=p.Light(direction=lambda: (0.0, 0.0, 1.0)), parent=world)
    return p.Scene(world)


def mesh_host_light_scene(ns=None):
    """The tetrahedron lit by a lamp whose direction is a python function."""
    p = api(ns)
    scene = tetrahedron(ns)
    lamp = next(n for n in scene.root.iter_preorder() if n.name == "lamp")
    lamp.light = p.Light(direction=lambda: (0.0, 0.0, 1.0))
    return scene


def custom_scene(ns=None):
    """``tests/test_parallel.py``'s ball under a lamp whose position is a
    bare callable."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=12.0, material=p.Material(refractive_index=1.0)))
    p.Node(name="ball", geometry=p.Sphere(radius=1.0, material=p.Material(refractive_index=1.5)),
           parent=world)
    light = p.Node(name="light", parent=world, light=p.Light(
        wavelength=p.ConstantWavelengthMask(555.0), position=lambda: (0.05, 0.0, 0.0)))
    light.translate((0.0, 0.0, -3.0))
    return p.Scene(world)


def slab_host_recorders(ns=None):
    """``lsc_slab_host`` with three recorders on the slab: light escaping
    the top face (a 40-bin wavelength histogram), escaping anywhere, and
    entering the top face."""
    p = api(ns)
    scene = lsc_slab_host(ns)
    slab = next(n for n in scene.root.iter_preorder() if n.name == "lsc")
    slab.recorders = [
        p.Recorder("top", event="escaping", facet=(0, 0, 1),
                   histograms=[p.Histogram("wavelength", 400.0, 800.0, 40)]),
        p.Recorder("out", event="escaping"),
        p.Recorder("in", event="entering", facet=(0, 0, 1)),
    ]
    return scene


SMALL = {"host-light": host_light_scene, "mesh-host-light": mesh_host_light_scene,
         "custom": custom_scene}
SLAB_RUN = dict(seed=5, record_every=1, max_events=128, score=True, dtype=np.float64)


def _pair(make, n, np_seed, **kwargs):
    """(JAX data, port data, port tallies) of `make` from both packages,
    each after ``np.random.seed(np_seed)``."""
    np.random.seed(np_seed)
    ref = jax_engine.simulate(make(pvtrace_tpu), n, **kwargs)
    seen = {}
    trace = tracer.trace

    def spy(*args, **kw):
        out = trace(*args, **kw)
        seen["tallies"] = out[2]
        return out

    tracer.trace = spy
    try:
        np.random.seed(np_seed)
        got = simulate(make(), n, device="cpu", **kwargs)
    finally:
        tracer.trace = trace
    return ref, got, seen["tallies"]


@pytest.fixture(scope="module")
def small_runs():
    """{scene: (JAX result, port result)} of the three small host-lit
    scenes, float64, record_every=0."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_api, "_TRACER_CACHE", {})
        return {name: _pair(make, N_SMALL, 11, seed=3, record_every=0, dtype=np.float64)[:2]
                for name, make in SMALL.items()}


@pytest.fixture(scope="module")
def slab_run():
    """(JAX data, port data, port tallies) of ``slab_host_recorders`` with
    the event log of every photon and score channels, float64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
        mp.setattr(jax_api, "_TRACER_CACHE", {})
        ref, got, tallies = _pair(slab_host_recorders, N_SLAB, 13, **SLAB_RUN)
    return ref.data, got.data, tallies


def test_histogram_lamp_needs_host_emission():
    assert not compile_scene(lsc_slab_host()).lights_supported
    assert not jax_engine.compile_scene(lsc_slab_host(pvtrace_tpu)).lights_supported
    assert compile_scene(lsc_slab()).lights_supported


@pytest.mark.parametrize("make", [lsc_slab_host, host_light_scene, custom_scene],
                         ids=["histogram-lamp", "direction-callable", "position-callable"])
def test_emit_bundle_draws_the_jax_bundle(make):
    """The port's copy of ``emit_bundle`` draws the JAX package's arrays
    from the same ``np.random`` state, bulk samplers and per-ray ones."""
    np.random.seed(4)
    ref = jax_emit_bundle(make(pvtrace_tpu), 500)
    np.random.seed(4)
    got = emit_bundle(make(), 500)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == ref[3]


@pytest.mark.parametrize("scene", list(SMALL))
def test_host_lit_scenes_match_jax(small_runs, scene):
    ref, got = small_runs[scene]
    a, b = np.asarray(ref.data["fates"], np.int64), got.data["fates"]
    assert a.sum() == b.sum() == N_SMALL
    assert np.abs(a - b).max() <= ULP_PHOTONS, (b.tolist(), a.tolist())
    assert got.data["steps"] > 0
    assert list(got.sources) == list(ref.sources)


def test_slab_host_fates_and_recorders_match_jax(slab_run):
    ref, got, _ = slab_run
    a, b = np.asarray(ref["fates"], np.int64), got["fates"]
    assert b.sum() == N_SLAB and b[4] > 0 and b[7] > 0
    assert np.abs(a - b).max() <= ULP_PHOTONS, (b.tolist(), a.tolist())
    for key in ("rec_distinct", "rec_crossings", "rec_bins"):
        assert np.abs(got[key] - np.asarray(ref[key])).max() <= ULP_PHOTONS, key
    assert got["rec_distinct"].min() > 0
    np.testing.assert_allclose(got["rec_sums"], np.asarray(ref["rec_sums"]), rtol=1e-6)


def test_slab_host_log_matches_jax(slab_run):
    """The log photon by photon: every photon's records equal the JAX
    package's (ints) and within RTOL (floats), but for the photons an ulp
    parts."""
    ref, got, _ = slab_run
    ints = np.stack([got[k] for k in eventlog.LOG_INTS], -1)
    ref_ints = np.stack([np.asarray(ref[k]) for k in eventlog.LOG_INTS], -1)
    assert ints.shape == ref_ints.shape == (N_SLAB, 128, eventlog.LOG_I)
    parted = (ints != ref_ints).reshape(N_SLAB, -1).any(1)
    assert parted.sum() <= ULP_PHOTONS
    np.testing.assert_array_equal(got["counts"][~parted], np.asarray(ref["counts"])[~parted])
    for key in eventlog.LOG_VECS + eventlog.LOG_SCALARS:
        r = np.asarray(ref[key])[~parted]
        np.testing.assert_allclose(got[key][~parted], r, rtol=RTOL,
                                   atol=1e-12 * np.abs(r).max(), err_msg=key)
    assert (got["kind"][:, 0] == 0).all()  # every photon starts with GENERATE


def test_slab_host_scores_match_jax(slab_run):
    """fate_scores and rec_scores to 1e-9 of each channel's sum of |score|
    with equal fates, else within the parted photons at twice the largest
    |score| (``test_torch_score.py``'s allowance)."""
    ref, got, tallies = slab_run
    differing = int(np.abs(np.asarray(ref["fates"]) - got["fates"]).sum())
    smax = tallies["score_max"].numpy()
    for name, abs_name in (("fate_scores", "fate_abs"), ("rec_scores", "rec_abs")):
        r, g = np.asarray(ref[name]), got[name]
        assert g.shape == r.shape and g.dtype == np.float64, name
        S = tallies[abs_name][:r.shape[0]].numpy()
        allow = SCORE_RTOL * S.sum(0) if differing == 0 else differing * 2.0 * smax
        assert (np.abs(g - r) <= allow).all(), (name, np.abs(g - r).max(), differing)
        assert np.abs(g).sum() > 0, name


def _own_emission(st, seed, n, offset):
    s = tracer.initial_state(st, seed, offset + torch.arange(n))
    return torch.stack([s[k] for k in tracer.BUNDLE_ROWS])


@pytest.mark.parametrize("score_on", [False, True], ids=["tallies", "score"])
def test_twin_fed_its_own_emission_is_bit_equal(score_on):
    """The device-emitted twin run and the twin started from a bundle of
    the same photons' emission (same seed, ids from 40): fates, recorder
    tallies and score sums bit for bit."""
    st = tables.scene_tensors(compile_scene(lsc_slab_recorders(4)), dtype=torch.float64)
    seed, n = rng.key_words(8), 600
    bundle = _own_emission(st, seed, n, 40)
    a = tracer.trace_eager(st, seed, n, index_offset=40, score=score_on)
    b = tracer.trace_eager(st, seed, n, index_offset=40, score=score_on, bundle=bundle,
                           lanes=64)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    names = ["distinct", "cross", "bins", "sums"] + (["fate_scores", "rec_scores"] * score_on)
    for name in names:
        assert torch.equal(a[2][name], b[2][name]), name


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


def _host_bundle(make, n, np_seed=2):
    """float32 scene tensors of `make()` and its host bundle [7, n]."""
    scene = make()
    st = tables.scene_tensors(compile_scene(scene), dtype=torch.float32)
    np.random.seed(np_seed)
    pos, d, wav, _ = emit_bundle(scene, n)
    return st, torch.from_numpy(tracer.bundle_rows(pos, d, wav, np.float32))


@pytest.mark.parametrize("make", [lsc_slab_host, mesh_host_light_scene],
                         ids=["slab-host", "mesh-host-light"])
def test_bundle_start_device_code_matches_twin_on_host(host_lib, make):
    """``trace_photon`` started from the bundle (``load_one``), built for
    the host, against the twin started from it: fates within 2 photons,
    from photon id 9."""
    n, offset = 4096, 9
    st, bundle = _host_bundle(make, n)
    assert st["meta"]["n_lights"] == 0
    seed = rng.key_words(5)
    fates = torch.zeros(11, dtype=torch.int64)
    _, no_log = kernels.empty_log(n, 0, 128, offset, "cpu")
    desc = kernels._Bundle(bundle.data_ptr(), n, offset)
    host_lib.h_trace_bundle(ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed[0],
                            seed[1], offset, offset + n, ctypes.byref(no_log), fates.data_ptr(),
                            ctypes.byref(desc))
    ref, _, _, _ = tracer.trace_eager(st, seed, n, index_offset=offset, bundle=bundle)
    assert int(fates.sum()) == n
    assert int((fates - ref).abs().sum()) <= 2, (fates.tolist(), ref.tolist())


def test_bundle_start_scores_device_code_matches_twin_on_host(host_lib):
    """``trace_photon`` with scores and recorders from the bundle (built
    for the host) against the twin photon by photon
    (``check.compare_score_records``, at most 2 photons parted)."""
    n = 4096
    st, bundle = _host_bundle(slab_host_recorders, n)
    seed = rng.key_words(6)
    CH, R = score.n_channels(st), max(st["meta"]["n_rec"], 1)
    _, no_log = kernels.empty_log(n, 0, 128, 0, "cpu")
    fates = torch.zeros(11, dtype=torch.int64)
    cross, bins = torch.zeros(R, dtype=torch.int64), torch.zeros(
        max(st["meta"]["total_bins"], 1), dtype=torch.int64)
    distinct, sums, sums64 = (torch.zeros(R, dtype=torch.int32), torch.zeros(8 * R),
                              torch.zeros(8 * R, dtype=torch.float64))
    row = torch.zeros(CH)
    fate_scores = torch.zeros((2, 11, CH), dtype=torch.float64)
    rec_scores = torch.zeros((2, R, CH), dtype=torch.float64)
    photon = torch.zeros((CH + 2, n))
    photon[CH] = -1.0
    desc = kernels._Bundle(bundle.data_ptr(), n, 0)
    host_lib.h_trace_score_bundle(
        ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed[0], seed[1], 0, n,
        ctypes.byref(no_log), fates.data_ptr(), cross.data_ptr(), sums.data_ptr(),
        distinct.data_ptr(), bins.data_ptr(), sums64.data_ptr(), row.data_ptr(), CH,
        st["meta"]["n_comps"], fate_scores.data_ptr(), rec_scores.data_ptr(), photon.data_ptr(),
        None, None, 0, ctypes.byref(desc),
    )
    ref, _, t, _ = tracer.trace_eager(st, seed, n, score=True, per_photon=True, bundle=bundle)
    assert int((fates - ref).abs().sum()) <= 2, (fates.tolist(), ref.tolist())
    assert int((distinct.long() - t["distinct"]).abs().max()) <= 2
    got = {"fate_scores": fate_scores[0], "fate_abs": fate_scores[1],
           "rec_scores": rec_scores[0], "rec_abs": rec_scores[1],
           "photon_scores": photon[:CH], "photon_fate": photon[CH].long(),
           "photon_steps": photon[CH + 1].long()}
    rep = check.compare_score_records(got, t, fates, n, 2)
    assert rep["record_used"] <= 1.0


@pytest.mark.parametrize("entry", ["initial_state", "kernels.emit", "kernels.trace",
                                   "trace-score"])
def test_device_emission_refuses_host_lit_scene(entry):
    """A host-lit scene's tensors have no light rows: every device-emission
    entry refuses them, none gives way to another path."""
    st = tables.scene_tensors(compile_scene(lsc_slab_host()), dtype=torch.float64)
    assert st["meta"]["n_lights"] == 0 and st["light_f"].shape[0] == 0
    seed = rng.key_words(1)
    calls = {
        "initial_state": lambda: tracer.initial_state(st, seed, torch.arange(4)),
        "kernels.emit": lambda: kernels.emit(st, seed, 0, 4),
        "kernels.trace": lambda: kernels.trace(st, seed, 4),
        "trace-score": lambda: tracer.trace(st, seed, 4, score=True),
    }
    with pytest.raises(ValueError, match="host emission"):
        calls[entry]()


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_bad_bundle_raises(bad):
    st = tables.scene_tensors(compile_scene(lsc_slab_host()), dtype=torch.float64)
    bundle = {
        "shape": torch.zeros((3, 10), dtype=torch.float64),
        "dtype": torch.zeros((7, 10), dtype=torch.float32),
        "device": torch.zeros((7, 10), dtype=torch.float64, device="meta"),
    }[bad]
    with pytest.raises(ValueError, match="bundle"):
        kernels.trace(st, rng.key_words(1), 10, bundle=bundle)


def test_host_path_ignores_lanes_and_takes_the_bundles_sources():
    """On the host path every photon has its lane (no regeneration), so
    `lanes` changes nothing, and the sources are the bundle's."""
    runs = []
    for lanes in ("auto", 64, None):
        np.random.seed(7)
        runs.append(simulate(custom_scene(), 300, seed=2, record_every=0, lanes=lanes,
                             dtype=np.float64, device="cpu"))
    for r in runs[1:]:
        np.testing.assert_array_equal(r.data["fates"], runs[0].data["fates"])
        assert r.data["steps"] == runs[0].data["steps"]
    assert list(runs[0].sources) == ["Light"] * 300


def test_host_path_takes_pathwise_channels():
    """``simulate(score=True, pathwise=...)`` runs on the host path, its
    pathwise channels appended to the score channels."""
    from pvtrace_tpu_torch.diff.transport import fate_gradients

    np.random.seed(3)
    fractions, grads = fate_gradients(lsc_slab_host(), 400, seed=4, wrt="all",
                                      pathwise=[("n", "lsc"), ("size", "lsc", 2)], device="cpu",
                                      dtype=np.float64)
    CH = score.n_channels(tables.scene_tensors(compile_scene(lsc_slab_host())), 2)
    assert sum(fractions.values()) == pytest.approx(1.0)
    assert all(g.shape == (CH,) and np.isfinite(g).all() for g in grads.values())
