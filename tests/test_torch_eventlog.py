"""K11: the event log and histories of the port against the JAX package.

``simulate(..., record_every=k)`` of ``scenes.mesh_small`` (a mesh with
an absorber, a scatterer, a mirror facet and two recorders) from both
packages in float64, at the same seed, in two runs that share nothing:

* (a) record_every=1, max_events=128, 256 lanes for 1024 photons (lane
  regeneration, GENERATE records on refill);
* (b) record_every=3, index_offset=5, max_events=8: the slot map (the
  first recorded photon is 6) and the event-budget kill.

Each is the JAX package's one compile of its logging tracer, shared
through a module fixture by the four tests of its run: fates, recorder
tallies, every log field with ``counts``, and ``histories()``. The
port's own tallies are also held to the tallies ``history_tally``
recomputes from its log (no JAX run), its logs to the lane count, and the
device code's logging ``trace_photon`` (``tracer.cuh``, built for the
host) to the twin. On the card ``test_torch_kernels.py`` (``gpu``) holds
the kernel's log to the twin's and its tallies to its own log.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, eventlog, rng, simulate, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.engine.history_tally import tally_histories  # noqa: E402
from pvtrace_tpu_torch.kernels import host  # noqa: E402
from pvtrace_tpu_torch.light.event import Event  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_recorders, mesh_small  # noqa: E402

torch.set_num_threads(1)
N = 1 << 10
RUNS = {
    "a": dict(record_every=1, max_events=128, lanes=256, index_offset=0),
    "b": dict(record_every=3, max_events=8, lanes=None, index_offset=5),
}
# Photons whose discrete outcome an ulp may flip between the packages.
ULP_PHOTONS = 4
RTOL = 1e-9
INTS = eventlog.LOG_INTS
FLOATS = eventlog.LOG_VECS + eventlog.LOG_SCALARS


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request):
    """(JAX result, port result) of run `request.param` on mesh_small."""
    kwargs = RUNS[request.param]
    ref = jax_engine.simulate(mesh_small(pvtrace_tpu), N, seed=5, dtype=np.float64, **kwargs)
    got = simulate(mesh_small(), N, seed=5, dtype=np.float64, device="cpu", **kwargs)
    return ref, got


def test_fates_match_jax(runs):
    ref, got = (np.asarray(r.data["fates"], dtype=np.int64) for r in runs)
    assert got.sum() == N and got[7] > 0 and got[4] > 0
    assert np.abs(got - ref).max() <= ULP_PHOTONS, (got.tolist(), ref.tolist())
    if runs[1].max_events == 8:
        assert got[9] > 0  # the event budget killed photons


def test_recorder_tallies_match_jax(runs):
    ref, got = (r.data for r in runs)
    for key in ("rec_distinct", "rec_crossings"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    assert got["rec_distinct"].min() > 0
    np.testing.assert_allclose(got["rec_sums"], np.asarray(ref["rec_sums"]), rtol=RTOL, atol=0)


def test_log_matches_jax(runs):
    ref, got = (r.data for r in runs)
    S = -(-N // runs[1].record_every)
    np.testing.assert_array_equal(got["counts"], np.asarray(ref["counts"]))
    assert got["counts"].shape == (S,) and got["counts"].dtype == np.int32
    for key in INTS:
        assert got[key].dtype == np.int32 and got[key].shape == (S, runs[1].max_events), key
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    for key in FLOATS:
        r = np.asarray(ref[key])
        assert got[key].dtype == np.float64 and got[key].shape == r.shape, key
        np.testing.assert_allclose(got[key], r, rtol=RTOL, atol=1e-12 * np.abs(r).max(),
                                   err_msg=key)
    kinds = set(np.unique(got["kind"]).tolist())
    assert {-1, Event.GENERATE.value, Event.TRANSMIT.value, Event.REFLECT.value,
            Event.SCATTER.value, Event.NONRADIATIVE.value, Event.EXIT.value} <= kinds


def _plain(history):
    """A history as plain values: event, metadata, and the ray's numbers."""
    return [
        (event.value, sorted(meta.items()), ray.source,
         (*ray.position, *ray.direction, ray.wavelength, ray.travelled, ray.duration))
        for ray, event, meta in history
    ]


def test_histories_match_jax(runs):
    ref, got = ([_plain(h) for h in r.histories()] for r in runs)
    assert len(got) == len(ref) == runs[1].num_recorded
    for r, g in zip(ref, got):
        assert [e[:3] for e in g] == [e[:3] for e in r]
        np.testing.assert_allclose([e[3] for e in g], [e[3] for e in r], rtol=RTOL, atol=1e-12)


def test_slot_map_follows_jax():
    """Slots of photons 5..14 at record_every 3: photons 6, 9 and 12 in
    slots 0, 1 and 2 of ceil(10 / 3) = 4, the others in no slot (4)."""
    pids = torch.arange(5, 15)
    first = eventlog.first_recorded(5, 3)
    S = eventlog.n_slots(10, 3)
    assert (first, S) == (6, 4) and eventlog.n_slots(10, 0) == 0
    assert eventlog.slots(pids, 3, first, S).tolist() == [4, 0, 4, 4, 1, 4, 4, 2, 4, 4]


@pytest.mark.parametrize("make", [lambda: lsc_slab_recorders(8), mesh_small],
                         ids=["lsc_slab_recorders8", "mesh_small"])
def test_tallies_match_own_log(make):
    """The port's recorder tallies equal the tallies recomputed from its
    own event log (every photon recorded, no budget kill)."""
    scene = make()
    result = simulate(scene, 256, seed=9, record_every=1, max_events=4096, dtype=np.float64,
                      lanes=64, device="cpu")
    assert int(result.data["counts"].max()) < 4096
    oracle = tally_histories(scene, result.histories())
    assert sum(r.rays for r in oracle.values()) > 0
    for name, rec in result.recorders.items():
        want = oracle[name]
        assert (rec.rays, rec.crossings) == (want.rays, want.crossings), name
        np.testing.assert_allclose(rec._moments, want._moments, rtol=RTOL, err_msg=name)
        for h in range(len(rec.spec.histograms)):
            np.testing.assert_array_equal(rec.histogram(h)[-1], want.histogram(h)[-1])


def test_log_does_not_depend_on_lanes():
    """Refilled lanes take their photons' slots: the log of photons 5..804
    at record_every 3 is the same with 64 lanes as with one per photon."""
    st, seed = tables.scene_tensors(compile_scene(mesh_small()), dtype=torch.float64), \
        rng.key_words(2)
    logs = [tracer.trace_eager(st, seed, 800, 5, lanes, record_every=3, max_events=16)[3]
            for lanes in (None, 64)]
    assert logs[0]["ints"].shape == (267, 16, tables.LOG_I)
    for key in ("ints", "floats"):
        assert torch.equal(logs[0][key], logs[1][key]), key


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("make, events", [(mesh_small, 8), (lsc_slab, 128)],
                         ids=["mesh_small-8", "lsc_slab-128"])
def test_device_log_matches_twin_on_host(host_lib, make, events):
    """trace_photon<false, true> (pvt_trace's logging body), host-built,
    against the float32 twin's log: photons equal in every int but for at
    most 2 whose path an ulp of libm moves, floats within 1e-5."""
    st, seed, n = tables.scene_tensors(compile_scene(make())), rng.key_words(4), 512
    log, desc = kernels.empty_log(n, 2, events, 1, "cpu")
    fates = torch.zeros(11, dtype=torch.int64)
    host_lib.h_trace(ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed[0],
                     seed[1], 1, 1 + n, ctypes.byref(desc), fates.data_ptr())
    ref_fates, _, _, ref = tracer.trace_eager(st, seed, n, 1, 256, record_every=2,
                                              max_events=events)
    assert int(fates.sum()) == n and int((fates - ref_fates).abs().max()) <= 2
    same = (log["ints"] == ref["ints"]).flatten(1).all(1)
    assert int((~same).sum()) <= 2 and int((log["ints"][..., 0] >= 0).sum(1).min()) >= 2
    torch.testing.assert_close(log["floats"][same], ref["floats"][same], rtol=1e-5, atol=1e-5)

