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
host) to the twin, counts too. The fetch's pack and unpack
(``eventlog.pack``, ``eventlog.unpack``) give the twin's dense log back bit
for bit, and the device code's per-slot pack (``log_pack_slot``, built for
the host) equals ``eventlog.pack``. On the card ``test_torch_kernels.py``
(``gpu``) holds the kernel's log to the twin's, ``pvt_log_pack`` to
``eventlog.pack`` and its tallies to its own log.
"""
import ctypes

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import api, compile_scene, eventlog, rng, simulate, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.engine.history_tally import tally_histories  # noqa: E402
from pvtrace_tpu_torch.kernels import host  # noqa: E402
from pvtrace_tpu_torch.light.event import Event  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_recorders, mesh_lsc, mesh_small  # noqa: E402

cap_threads()
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
    # The counts each recorded photon wrote at its death: its row's records.
    assert torch.equal(log["counts"], (log["ints"][..., 0] >= 0).sum(1).to(torch.int32))
    assert torch.equal(log["counts"][same], ref["counts"][same])


def _bits(x):
    return x.view(np.int32 if x.dtype == np.float32 else np.int64)


# Twin logs the pack and unpack see: the mesh LSC with the event-budget
# kill, the slab, and every third photon from 5 (a row with no photon of
# its own stays empty).
ROUNDTRIP = {
    "mesh_lsc-8": dict(make=mesh_lsc, n=512, every=1, offset=0, events=8, dtype=torch.float32),
    "lsc_slab-128": dict(make=lsc_slab, n=512, every=1, offset=0, events=128,
                         dtype=torch.float32),
    "mesh_small-every3-offset5": dict(make=mesh_small, n=800, every=3, offset=5, events=16,
                                      dtype=torch.float64),
}


@pytest.mark.parametrize("case", sorted(ROUNDTRIP))
def test_pack_unpack_roundtrip(case):
    """The fetch's path on the twin's log: ``counts`` equals the rows'
    records, ``unpack(pack(log, counts))`` gives the dense log bit for bit
    (``api.fetch_log`` too), and the packed records are the rows' prefixes
    in slot order."""
    spec = ROUNDTRIP[case]
    st = tables.scene_tensors(compile_scene(spec["make"]()), dtype=spec["dtype"])
    fates, _, _, log = tracer.trace_eager(st, rng.key_words(6), spec["n"], spec["offset"], 128,
                                          record_every=spec["every"], max_events=spec["events"])
    S, E = log["ints"].shape[:2]
    counts = log["counts"]
    assert counts.dtype == torch.int32
    assert torch.equal(counts, (log["ints"][..., 0] >= 0).sum(1).to(torch.int32))
    if spec["events"] == 8:
        assert int((counts == 8).sum()) > 0 and int(fates[9]) > 0  # the event budget killed
    ints, floats = eventlog.pack(log, counts)
    first, last = int(counts[0]), int(counts[-1])
    assert ints.shape == (int(counts.sum()), eventlog.LOG_I)
    assert torch.equal(ints[:first], log["ints"][0, :first])
    assert torch.equal(floats[len(floats) - last:], log["floats"][-1, :last])
    np_dtype = np.float32 if spec["dtype"] == torch.float32 else np.float64
    dense = eventlog.unpack(counts.numpy(), ints.numpy(), floats.numpy(), S, E, np_dtype)
    fetched = api.fetch_log(log, np_dtype)
    for got in (dense, fetched):
        assert got[0].dtype == np.int32 and got[1].dtype == np_dtype
        np.testing.assert_array_equal(got[0], log["ints"].numpy())
        np.testing.assert_array_equal(_bits(got[1]), _bits(log["floats"].numpy()))
    np.testing.assert_array_equal(fetched[2], counts.numpy())
    assert api.last_fetch["records"] == int(counts.sum())


@pytest.mark.parametrize("make, events", [(mesh_small, 8), (lsc_slab, 128)],
                         ids=["mesh_small-8", "lsc_slab-128"])
def test_device_log_pack_matches_pack_on_host(host_lib, make, events):
    """``log_pack_slot`` (pvt_log_pack's per-slot copy, each slot as a warp
    of 32 lanes), host-built, against ``eventlog.pack`` on the host build's
    own log, its rows left unfilled as on the card: bit-equal."""
    st, seed, n = tables.scene_tensors(compile_scene(make())), rng.key_words(7), 512
    log, desc = kernels.empty_log(n, 1, events, 0, "cpu", fill=False)
    fates = torch.zeros(11, dtype=torch.int64)
    host_lib.h_trace(ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed[0],
                     seed[1], 0, n, ctypes.byref(desc), fates.data_ptr())
    counts = log["counts"]
    assert int(counts.min()) >= 2 and int(fates.sum()) == n
    ref_ints, ref_floats = eventlog.pack(log, counts)
    offsets = torch.cumsum(counts, 0) - counts
    N = int(counts.sum())
    ints = torch.full((N, eventlog.LOG_I), 7, dtype=torch.int32)
    floats = torch.full((N, eventlog.LOG_F), 7.0)
    host_lib.h_log_pack(ctypes.byref(desc), offsets.data_ptr(), ints.data_ptr(),
                        floats.data_ptr())
    assert torch.equal(ints, ref_ints)
    assert torch.equal(floats.view(torch.int32), ref_floats.view(torch.int32))

