"""K9: the port's recorder tallies against the JAX package.

Both packages trace the same photons from the same seed, at their
defaults (Chebyshev spectra, K5a), each from the scene built from its
own classes: these runs are also the bench slab's fates tests at the
defaults. In float64 the integer tallies (distinct rays, crossings,
bins) agree photon for photon, up to the rare photon whose discrete
outcome an ulp flips (the fates tests allow 4); a recorder whose
distinct rays agree has the same moment sums to rtol 1e-9 (the same
values summed in another order). The device code's ``tally_event``
(``tracer.cuh``, built for the host) is held to the eager twin lane by
lane, and the warp rule that pvt_trace and pvt_tally run on the card
(``tally_warp_host``: the match and the ballots over 32 emulated lanes,
each peer's adds by the device's own ``warp_group_adds``) to
``tally_event`` lane by lane; the facet groups of the recorder index
(``tables.py``) to the per-recorder facet test.
"""
import ctypes
import re

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, rng, simulate, tables, tally, tracer  # noqa: E402
from pvtrace_tpu_torch.engine.result import MOMENT_PROPERTIES  # noqa: E402
from pvtrace_tpu_torch.kernels import build, check, host  # noqa: E402
from pvtrace_tpu_torch.engine.compiler import VOLUME_EVENTS  # noqa: E402
from pvtrace_tpu_torch.engine.recorder import EVENTS, Histogram, Recorder  # noqa: E402
from pvtrace_tpu_torch.scenes import _slab_node, lsc_slab, lsc_slab_heatmap, lsc_slab_recorders  # noqa: E402

cap_threads()
N, N32, LANES = 2 ** 12, 2 ** 13, 2 ** 10
# Photons whose discrete outcome an ulp may flip between the packages.
ULP_PHOTONS = 4
SUMS_RTOL = 1e-9


def _slab(scene):
    return next(n for n in scene.root.iter_preorder() if n.name == "lsc")


def _recorder_scene(ns=None):
    """``lsc_slab_recorders(8)`` plus the recorders of
    ``lsc_slab_heatmap(40)``: facet and facet-less recorders of four
    events with wavelength histograms, a heatmap of local x and y on the
    top face with an angle histogram, and x, y, z histograms and a
    depth-by-wavelength heatmap of lost photons."""
    scene = lsc_slab_recorders(8, ns)
    _slab(scene).recorders += _slab(lsc_slab_heatmap(40, ns)).recorders
    return scene


@pytest.fixture(scope="module")
def float64_runs():
    """(JAX result, port result) of the recorder scene in float64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
        mp.setattr(jax_api, "_TRACER_CACHE", {})
        ref = jax_engine.simulate(_recorder_scene(pvtrace_tpu), N, seed=5, record_every=0,
                                  dtype=np.float64, lanes=LANES)
        got = simulate(_recorder_scene(), N, seed=5, record_every=0, dtype=np.float64,
                       lanes=LANES, device="cpu")
    return ref, got


def test_simulate_at_defaults_float64_matches_jax(float64_runs):
    """The bench slab (with recorders) at both packages' defaults, K5a."""
    ref, got = (np.asarray(r.data["fates"], dtype=np.int64) for r in float64_runs)
    assert float64_runs[1].compiled.cheb_spec is not None
    assert got.sum() == N and set(np.flatnonzero(got)) <= {4, 7, 9}
    assert np.abs(got - ref).max() <= ULP_PHOTONS, (got.tolist(), ref.tolist())


def test_recorder_tallies_float64_match_jax(float64_runs):
    ref, got = (r.data for r in float64_runs)
    R = len(float64_runs[1].compiled.recorder_names)
    for name, n in (("rec_distinct", R), ("rec_crossings", R), ("rec_bins", None)):
        r, g = np.asarray(ref[name]), got[name]
        assert g.dtype == np.int64 and g.shape == r.shape
        assert n is None or g.shape == (n,)
        assert np.abs(g - r).max() <= ULP_PHOTONS, name
    assert got["rec_bins"].sum() > 0 and (got["rec_distinct"] > 0).sum() >= R // 2
    same = got["rec_distinct"] == np.asarray(ref["rec_distinct"])
    assert same.sum() >= R - ULP_PHOTONS
    np.testing.assert_allclose(got["rec_sums"][same], np.asarray(ref["rec_sums"])[same],
                               rtol=SUMS_RTOL, atol=0)


def test_recorder_results_match_jax(float64_runs):
    ref, got = (r.recorders for r in float64_runs)
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        r = ref[name]
        assert abs(g.rays - r.rays) <= ULP_PHOTONS and abs(g.crossings - r.crossings) <= ULP_PHOTONS
        if g.rays != r.rays or not g.rays:
            continue
        for prop in MOMENT_PROPERTIES:
            np.testing.assert_allclose(g.mean(prop), r.mean(prop), rtol=SUMS_RTOL, err_msg=name)
            np.testing.assert_allclose(g.std(prop), r.std(prop), rtol=1e-6, atol=1e-12,
                                       err_msg=name)
        for h in range(len(g.spec.histograms)):
            for ga, ra in zip(g.histogram(h), r.histogram(h)):
                np.testing.assert_allclose(ga, ra, atol=ULP_PHOTONS, err_msg=name)


@pytest.fixture(scope="module")
def float32_runs():
    """(JAX data, port data) of ``lsc_slab_recorders(8)`` in float32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
        mp.setattr(jax_api, "_TRACER_CACHE", {})
        # The JAX package's float32 path runs with 64-bit mode off, as its
        # bench does.
        with jax.enable_x64(False):
            ref = jax_engine.simulate(lsc_slab_recorders(8, pvtrace_tpu), N32, seed=9,
                                      record_every=0, dtype=np.float32, lanes=LANES).data
        got = simulate(lsc_slab_recorders(8), N32, seed=9, record_every=0,
                       dtype=np.float32, lanes=LANES, device="cpu").data
    return ref, got


def _assert_z_below_5(pairs, n):
    """Two-proportion z < 5 for each (JAX count, port count) of n photons."""
    for r, g in pairs:
        pooled = (r + g) / (2.0 * n)
        if pooled == 0.0:
            continue
        z = abs(r - g) / n / np.sqrt(pooled * (1 - pooled) * 2.0 / n)
        assert z < 5, (pairs, z)


def test_simulate_at_defaults_float32_agrees_with_jax(float32_runs):
    ref, got = float32_runs
    assert got["fates"].sum() == N32
    _assert_z_below_5([(np.asarray(ref["fates"])[s], got["fates"][s]) for s in (4, 7)], N32)


def test_recorder_tallies_float32_agree_with_jax(float32_runs):
    ref, got = float32_runs
    assert got["rec_distinct"].sum() > 0
    _assert_z_below_5(list(zip(np.asarray(ref["rec_distinct"]), got["rec_distinct"])), N32)


def test_step_outputs_take_the_kernels_dtypes():
    """What ``physics.step`` returns is what pvt_tally reads (the wrapper
    checks dtype and contiguity of every lane input)."""
    st = tables.scene_tensors(compile_scene(lsc_slab_recorders(8)))
    s = tracer.initial_state(st, rng.key_words(3), torch.arange(256))
    out = tracer.step_state(st, s, 1000, 0)
    want = dict(kernels._empty_state(256, "cpu"), **kernels._empty_flags(256, "cpu"))
    for name, ref in want.items():
        assert out[name].dtype == ref.dtype and out[name].is_contiguous(), name


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


def _many_groups_scene():
    """The LSC slab with 64 "escaping" recorders on the six axis facets,
    each with its own tolerance: 64 facet groups, past one seen word."""
    scene = lsc_slab()
    faces = [(0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)]
    _slab_node(scene).recorders = [
        Recorder(f"g{r:02d}", event="escaping", facet=faces[r % 6], atol=1e-6 * (1 + r),
                 histograms=[Histogram("wavelength", 400.0, 800.0, 8)]) for r in range(64)]
    return scene


@pytest.mark.parametrize("scene", ["mixed", "R256", "groups"])
def test_device_tally_event_matches_twin_on_host(host_lib, scene):
    """tally_event (via tally_lane, the body of pvt_tally) against the
    twin over 8 steps of 4096 lanes, both fed the twin's steps: integer
    tallies and seen bits equal, sums within 1e-4 (the host adds lane by
    lane in float32, moving each recorder's sums to float64 every
    SUMS_FLUSH distinct rays; the twin takes one product over the lanes).
    "mixed" has heatmaps and x/y/z histograms; "R256" is the full width,
    all eight seen words; "groups" has 64 facet groups, so a lane's group
    bits take more than one word."""
    rec_scene = {"mixed": _recorder_scene, "R256": lambda: lsc_slab_recorders(256),
                 "groups": _many_groups_scene}[scene]()
    st = tables.scene_tensors(compile_scene(rec_scene), dtype=torch.float32)
    B, R, total = 4096, st["meta"]["n_rec"], st["meta"]["total_bins"]
    s = tracer.initial_state(st, rng.key_words(2), torch.arange(B))
    twin = tally.empty(st, B)
    seen = torch.zeros((B, tables.SEEN_WORDS), dtype=torch.int32)
    cross = torch.zeros(R, dtype=torch.int64)
    sums = torch.zeros((R, 8), dtype=torch.float32)
    distinct = torch.zeros(R, dtype=torch.int32)
    bins = torch.zeros(total, dtype=torch.int64)
    sums64 = torch.zeros((R, 8), dtype=torch.float64)
    sc = kernels._scene(st, 1000, 0, float("inf"))
    for _ in range(8):
        out = tracer.step_state(st, s, 1000, 0)
        tally.tally(twin, st, out)
        host_lib.h_tally(
            ctypes.byref(sc),
            ctypes.byref(kernels._struct(kernels._State, out, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._Flags, out, kernels._FLAG_PTRS)),
            seen.data_ptr(), B, cross.data_ptr(), sums.data_ptr(), distinct.data_ptr(),
            bins.data_ptr(), sums64.data_ptr(),
        )
        s = out
    assert int(twin["bins"].sum()) > 0 and int(twin["distinct"].sum()) > 0
    if scene == "R256":
        assert bool(twin["distinct"][224:].any())  # the last seen word
        assert int(twin["distinct"].max()) > tables.SUMS_FLUSH  # a move to float64
    if scene == "groups":
        assert st["meta"]["n_grp"] == 64 and bool(twin["distinct"][32:].any())
    assert torch.equal(cross, twin["cross"])
    assert torch.equal(distinct.long(), twin["distinct"])
    assert torch.equal(bins, twin["bins"])
    assert torch.equal(kernels.unpack_seen(seen, R), twin["seen"])
    assert torch.equal(kernels.pack_seen(twin["seen"]), seen)
    scale = twin["sums"].double().abs().clamp(min=1e-30)
    got = sums.double() + sums64
    assert float(((got - twin["sums"].double()).abs() / scale).max()) <= 1e-4


def _host_tally(entry, st, outs):
    """`entry` (h_tally: tally_event lane by lane; h_tally_warp: the warp
    rule) on the twin's steps `outs`: the accumulators and each step's
    seen words."""
    R, total, B = st["meta"]["n_rec"], st["meta"]["total_bins"], outs[0]["px"].shape[0]
    acc = {"seen": torch.zeros((B, tables.SEEN_WORDS), dtype=torch.int32),
           "cross": torch.zeros(R, dtype=torch.int64),
           "sums": torch.zeros((R, 8), dtype=torch.float32),
           "distinct": torch.zeros(R, dtype=torch.int32),
           "bins": torch.zeros(max(total, 1), dtype=torch.int64),
           "sums64": torch.zeros((R, 8), dtype=torch.float64)}
    sc, seen = kernels._scene(st, 1000, 0, float("inf")), []
    for out in outs:
        entry(ctypes.byref(sc),
              ctypes.byref(kernels._struct(kernels._State, out, kernels._STATE_PTRS)),
              ctypes.byref(kernels._struct(kernels._Flags, out, kernels._FLAG_PTRS)),
              acc["seen"].data_ptr(), B, acc["cross"].data_ptr(), acc["sums"].data_ptr(),
              acc["distinct"].data_ptr(), acc["bins"].data_ptr(), acc["sums64"].data_ptr())
        seen.append(acc["seen"].clone())
    return acc, seen


# (scene, lanes): R = 4, 32 and 256 recorders (one, a few and 64 a key),
# the heatmap's bins past a block's shared memory, and 4 recorders over
# enough lanes that the lost photons' recorder passes 2 * SUMS_FLUSH
# distinct rays (its float32 sums move to float64 twice).
WARP_CASES = {
    "R=4": (lambda: lsc_slab_recorders(4), 1000),
    "R=32": (lambda: lsc_slab_recorders(32), 1000),
    "R=256": (lambda: lsc_slab_recorders(256), 1000),
    "heatmap": (lsc_slab_heatmap, 1000),
    "flush": (lambda: lsc_slab_recorders(4), 4 * tables.SUMS_FLUSH + 7),
}


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_tally_warp_rule_matches_lane_rule_on_host(host_lib, case):
    """The warp rule (``tally_warp_host``: the lanes of a key walk its
    facet groups together, one add a recorder for the warp's crossings,
    distinct rays and moment sums, the bins spread over the lanes), on 8
    steps of emulated warps of 32 lanes (the last one partial), against
    ``tally_event`` lane by lane on the same events: crossings, distinct
    rays, bins and every step's seen bits equal, the moment sums within
    two kernel runs' bound (``check.SUMS_RUNS_RTOL``: each within
    ``check.SUMS_BOUND`` of the exact sums)."""
    make, B = WARP_CASES[case]
    st = tables.scene_tensors(compile_scene(make()), dtype=torch.float32)
    outs = [tracer.initial_state(st, rng.key_words(11), torch.arange(B))]
    for _ in range(8):
        outs.append(tracer.step_state(st, outs[-1], 1000, 0))
    lane, lane_seen = _host_tally(host_lib.h_tally, st, outs[1:])
    warp, warp_seen = _host_tally(host_lib.h_tally_warp, st, outs[1:])
    assert int(lane["distinct"].sum()) > 0 and int(lane["bins"].sum()) > 0
    if case == "flush":
        assert int(lane["distinct"].max()) > 2 * tables.SUMS_FLUSH
        assert float(lane["sums64"].abs().max()) > 0.0
    for name in ("cross", "distinct", "bins"):
        assert torch.equal(warp[name], lane[name]), name
    for got, want in zip(warp_seen, lane_seen):
        assert torch.equal(got, want)
    total = {k: a["sums"].double() + a["sums64"] for k, a in (("warp", warp), ("lane", lane))}
    assert torch.allclose(total["warp"], total["lane"], rtol=check.SUMS_RUNS_RTOL, atol=0)


def test_tally_rule_follows_the_kernels_threshold():
    """``kernels.WARP_GROUP`` is tracer.cuh's kWarpGroup, and
    ``kernels.tally_rule`` names the rule the kernels take: the warp rule
    at 256 recorders (groups of up to 64), the lane rule at 4 and 32 and
    for the heatmap."""
    src = (build.CSRC / "tracer.cuh").read_text()
    assert re.search(r"constexpr int kWarpGroup = (\d+);", src).group(1) == str(kernels.WARP_GROUP)
    rules = {case: kernels.tally_rule(tables.scene_tensors(compile_scene(make()))["meta"])
             for case, (make, _) in WARP_CASES.items() if case != "flush"}
    assert rules == {"R=4": "tally_event", "R=32": "tally_event", "R=256": "tally_warp",
                     "heatmap": "tally_event"}


def _facet_scene(seed, n_rec=96):
    """The LSC slab with `n_rec` recorders of random events, of which
    facet recorders take one of a few normals (axis normals, and tilted
    ones, some repeated) and one of two tolerances, or no facet."""
    gen = np.random.default_rng(seed)
    normals = [(0, 0, 1), (0, 0, -1), (1, 0, 0), (0.6, 0.0, 0.8), (0.0, -0.8, 0.6)]
    events = sorted(EVENTS)
    recs = []
    for r in range(n_rec):
        event = events[gen.integers(len(events))]
        facet = None if event in VOLUME_EVENTS or gen.random() < 0.2 else \
            normals[gen.integers(len(normals))]
        recs.append(Recorder(f"f{r:03d}", event=event, facet=facet,
                             atol=(1e-6, 0.3)[gen.integers(2)],
                             histograms=[Histogram("wavelength", 400.0, 800.0, 8)]))
    scene = lsc_slab()
    _slab_node(scene).recorders = recs
    return scene


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_index_walk_matches_recorder_walk(seed):
    """The facet groups of the recorder index: every recorder listed
    once, under its key, in a group whose recorders share its facet test
    (no facet, or the same normal and tolerance), the group's own test
    (``grp_f``) being theirs; and for random world normals, walking a
    key's groups (one test a group, by ``grp_f``) matches the recorders
    that the per-recorder test matches."""
    st = tables.scene_tensors(compile_scene(_facet_scene(seed)))
    rec_i, rec_f = st["rec_i"].numpy(), st["rec_f"].numpy()
    csr, ids = st["rec_csr"].numpy(), st["rec_ids"].numpy()
    grp, pos, grp_f = st["rec_grp"].numpy(), st["grp_pos"].numpy(), st["grp_f"].numpy()
    R, G = st["meta"]["n_rec"], st["meta"]["n_grp"]
    assert sorted(ids.tolist()) == list(range(R)) and pos[-1] == R and G == len(pos) - 1
    assert 8 < G < R

    def test_of(r):
        return (int(rec_i[r, tables.RI_FACET]),
                tuple(rec_f[r].tolist()) if rec_i[r, tables.RI_FACET] else ())

    def group_test(g):
        facet = int(grp_f[g, tables.GF_FACET])
        return facet, tuple(grp_f[g, :tables.GF_FACET].tolist()) if facet else ()

    for key in range(len(csr) - 1):
        assert pos[grp[key]] == csr[key] and pos[grp[key + 1]] == csr[key + 1]
        for g in range(grp[key], grp[key + 1]):
            members = ids[pos[g]:pos[g + 1]]
            assert len(members) > 0
            assert {int(rec_i[r, tables.RI_NODE] * tables.N_SEL + rec_i[r, tables.RI_EVENT])
                    for r in members} == {key}
            assert {test_of(r) for r in members} == {group_test(g)}
        firsts = [test_of(ids[pos[g]]) for g in range(grp[key], grp[key + 1])]
        assert len(set(firsts)) == len(firsts)
    gen = np.random.default_rng(seed)
    axes = np.eye(3)[gen.integers(3, size=2000)] * gen.choice([-1.0, 1.0], size=(2000, 1))
    wn = np.concatenate([axes, axes + gen.normal(scale=0.2, size=axes.shape),
                         gen.normal(size=(400, 3))]).astype(np.float32)

    def passes(r, n):
        return not rec_i[r, tables.RI_FACET] or bool(
            (np.abs(n - rec_f[r, tables.RF_NX:tables.RF_NX + 3]) <= rec_f[r, tables.RF_ATOL]).all())

    def group_passes(g, n):
        return not grp_f[g, tables.GF_FACET] or bool(
            (np.abs(n - grp_f[g, tables.GF_NX:tables.GF_NX + 3]) <= grp_f[g, tables.GF_ATOL]).all())

    matched = 0
    for key in range(len(csr) - 1):
        for n in wn[gen.integers(len(wn), size=40)]:
            by_recorder = {int(r) for r in ids[csr[key]:csr[key + 1]] if passes(r, n)}
            by_group = {int(r) for g in range(grp[key], grp[key + 1]) if group_passes(g, n)
                        for r in ids[pos[g]:pos[g + 1]]}
            assert by_group == by_recorder
            matched += len(by_recorder)
    assert matched > 0
