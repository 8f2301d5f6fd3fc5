"""K12: the port's score channels against the JAX package.

Both packages trace the same photons from the same seed, on the CPU, in
float64, at their defaults (Chebyshev spectra, K5a), with lane
regeneration (``lanes < num_rays``), each from the scene built from its
own classes. ``fate_scores`` and ``rec_scores`` agree to 1e-9 of each
channel's sum of |score| (the port's ``fate_abs`` / ``rec_abs``) when the
fate counts are equal; otherwise within the photons that differ (the
fate counts' total difference) at twice the largest per-photon |score|
the port saw in the channel. The Fresnel partials are held to JAX's
autodiff on a grid, and the device code of ``tracer.cuh`` (``fresnel_dR``,
``score_lane``, ``trace_photon`` with scores, built for the host) to the
eager twin; its float64 build (``score_f64``'s code) traces the slab's
photons to the JAX package's float64 score sums by the same rule.
"""
import ctypes

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu.engine.tracer import _fresnel_dR as jax_fresnel_dR  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, rng, score, simulate, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import check, host  # noqa: E402
from pvtrace_tpu_torch.scenes import (  # noqa: E402
    lsc_slab,
    lsc_slab_recorders,
    lsc_tiles,
    mesh_lsc,
    mesh_small,
    mixed_scene,
)

cap_threads()
N, LANES = 2 ** 12, 2 ** 10
SCORE_RTOL = 1e-9
SCENES = {"recorders": lambda ns=None: lsc_slab_recorders(4, ns), "mixed": mixed_scene}


def _simulate_with_tallies(monkeypatch, make, n, **kwargs):
    """The port's ``simulate(score=True)`` of `make()` on the CPU, and the
    trace's tallies (with the score magnitudes' sums and maxima)."""
    seen = {}
    trace = tracer.trace

    def spy(*args, **kw):
        out = trace(*args, **kw)
        seen["tallies"] = out[2]
        return out

    monkeypatch.setattr(tracer, "trace", spy)
    result = simulate(make(), n, score=True, device="cpu", **kwargs)
    monkeypatch.setattr(tracer, "trace", trace)
    return result, seen["tallies"]


@pytest.fixture(scope="module")
def float64_runs():
    """{scene: (JAX data, port data, port tallies)} in float64, seed 5."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
        mp.setattr(jax_api, "_TRACER_CACHE", {})
        for name, make in SCENES.items():
            ref = jax_engine.simulate(make(pvtrace_tpu), N, seed=5, record_every=0,
                                      dtype=np.float64, lanes=LANES, score=True).data
            got, tallies = _simulate_with_tallies(mp, make, N, seed=5, record_every=0,
                                                  dtype=np.float64, lanes=LANES)
            out[name] = (ref, got.data, tallies)
    return out


def _assert_scores_match(ref, got, tallies):
    """The score sums of `got` (port data) against `ref` (JAX data), with
    the allowance of the module docstring."""
    differing = int(np.abs(np.asarray(ref["fates"]) - got["fates"]).sum())
    smax = tallies["score_max"].numpy()
    for name, abs_name, extra in (("fate_scores", "fate_abs", 0),
                                  ("rec_scores", "rec_abs", "rec_distinct")):
        if name not in ref:
            assert name not in got
            continue
        r, g = np.asarray(ref[name]), got[name]
        assert g.shape == r.shape and g.dtype == np.float64, name
        S = tallies[abs_name][:r.shape[0]].numpy()
        diff = differing
        if extra:
            diff += int(np.abs(np.asarray(ref[extra]) - got[extra]).sum())
        allow = SCORE_RTOL * S.sum(0) if diff == 0 else diff * 2.0 * smax
        assert (np.abs(g - r) <= allow).all(), (name, np.abs(g - r).max(), diff)
        assert np.abs(g).sum() > 0, name


@pytest.mark.parametrize("scene", list(SCENES))
def test_simulate_score_float64_matches_jax(float64_runs, scene):
    ref, got, tallies = float64_runs[scene]
    assert np.abs(np.asarray(ref["fates"]) - got["fates"]).max() <= 4
    _assert_scores_match(ref, got, tallies)


@pytest.fixture(scope="module")
def host_lib64(tmp_path_factory):
    """The device code built for the host with -DPVT_F64, as ``score_f64``
    is (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host64"), f64=True)


def test_host_build_float64_score_sums_match_jax(float64_runs, host_lib64):
    """``trace_photon`` with scores of the float64 build, photon by photon
    (``host.trace_scores``), on the slab with 4 recorders, seed 5: its
    fates within 4 of the JAX package's float64 ``simulate(score=True)``
    of the same photons (regenerated lanes there, one photon at a time
    here: the same streams), and its float64 ``fate_scores`` and
    ``rec_scores`` within the module's allowance of the JAX package's
    (1e-9 of each channel's sum of |score| where the counts agree)."""
    ref = float64_runs["recorders"][0]
    st = tables.scene_tensors(compile_scene(lsc_slab_recorders(4)), dtype=torch.float64)
    R = st["meta"]["n_rec"]
    fates, t = host.trace_scores(host_lib64, st, rng.key_words(5), N)
    assert t["photon_scores"].dtype == torch.float64
    got = {"fates": fates.numpy(), "fate_scores": t["fate_scores"].numpy(),
           "rec_scores": t["rec_scores"][:R].numpy(), "rec_distinct": t["distinct"][:R].numpy()}
    assert np.abs(np.asarray(ref["fates"]) - got["fates"]).max() <= 4
    _assert_scores_match(ref, got, {"score_max": t["photon_scores"].abs().amax(1),
                                    "fate_abs": t["fate_abs"], "rec_abs": t["rec_abs"]})


def test_score_channel_layout(float64_runs):
    """Components, then nodes in preorder; rec_scores only with recorders;
    every channel of the slab scene is touched (both components, the
    world and the slab on either side of a Fresnel coin), none of a fate
    that never happens."""
    compiled = compile_scene(lsc_slab_recorders(4))
    _, got, _ = float64_runs["recorders"]
    CH = compiled.n_components + len(compiled.nodes)
    assert compiled.node_names[:2] == ["world", "lsc"]
    assert got["fate_scores"].shape == (11, CH) and got["rec_scores"].shape == (4, CH)
    assert "rec_scores" not in float64_runs["mixed"][1]
    assert (got["fate_scores"][4] != 0).all() and (got["fate_scores"][7] != 0).all()
    assert not got["fate_scores"][[0, 1, 2, 3, 5, 6, 8, 10]].any()


def test_score_result_is_in_the_run_dtype():
    data = simulate(lsc_slab(), 300, seed=2, record_every=0, score=True, device="cpu",
                    dtype=np.float32).data
    assert data["fate_scores"].dtype == np.float32 and "rec_scores" not in data
    assert np.isfinite(data["fate_scores"]).all()


def _fresnel_grid():
    n1, n2, c = check.fresnel_grid("cpu", torch.float64)
    return n1.numpy(), n2.numpy(), c.numpy()


def test_fresnel_dR_matches_jax_autodiff():
    """The analytic partials equal ``jax.vmap(jax.grad)`` of the reference
    on a grid with normal and grazing incidence, n1 > n2 at and next to
    the critical angle, and n1 < n2: to rtol 1e-12 where JAX is finite,
    with atol 1e-15 where a partial passes through 0 (grazing incidence,
    n1 = n2) and its O(1) terms cancel to the last bits; equal after
    ``nan_to_num`` where JAX is not finite. The port's ``fresnel_R``
    differentiated by torch.autograd agrees off the critical angle."""
    n1, n2, c = _fresnel_grid()
    ref = [np.asarray(v) for v in jax_fresnel_dR(n1, n2, c)]
    got = [v.numpy() for v in score.fresnel_dR(*(torch.as_tensor(v) for v in (n1, n2, c)))]
    for r, g in zip(ref, got):
        fin = np.isfinite(r)
        assert fin.sum() > 2000 and (~fin).sum() > 0
        np.testing.assert_allclose(g[fin], r[fin], rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(np.nan_to_num(g[~fin]), np.nan_to_num(r[~fin]))
    t1, t2 = (torch.as_tensor(v, dtype=torch.float64).requires_grad_() for v in (n1, n2))
    auto = torch.autograd.grad(score.fresnel_R(t1, t2, torch.as_tensor(c)).sum(), (t1, t2))
    x = 1.0 - (n1 / n2) ** 2 * np.clip(1.0 - c * c, 0.0, 1.0)
    regular = x > check.FRESNEL_SINGULAR
    for a, g in zip(auto, got):
        np.testing.assert_allclose(a.numpy()[regular], g[regular], rtol=1e-9, atol=1e-15)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


def test_fresnel_dR_device_code_matches_twin(host_lib):
    n1, n2, c = check.fresnel_grid("cpu")
    d1, d2 = torch.empty_like(n1), torch.empty_like(n1)
    host_lib.h_fresnel(n1.data_ptr(), n2.data_ptr(), c.data_ptr(), n1.numel(), d1.data_ptr(),
                       d2.data_ptr())
    for g, t in zip((d1, d2), score.fresnel_dR(n1, n2, c)):
        fin = torch.isfinite(t)
        assert torch.equal(torch.isfinite(g), fin)
        torch.testing.assert_close(g[fin], t[fin], rtol=1e-6, atol=1e-6)


def _f32(make):
    return tables.scene_tensors(compile_scene(make()), dtype=torch.float32)


@pytest.mark.parametrize("make", [lsc_slab, mixed_scene, lambda: lsc_tiles(tiles=2)],
                         ids=["slab", "mixed", "tiles"])
def test_score_lane_device_code_matches_twin(host_lib, make):
    """``score_lane`` (pvt_score's body) against the twin for 8 steps from
    the same lanes: the steps equal, each path score within 1e-5 of its
    channel's scale, each step's folds within 1e-5 of their magnitudes.
    The tiles have six components a node, more than a step holds
    (``kHeldSlots``): their last slots are evaluated again."""
    st, seed, B = _f32(make), rng.key_words(5), 1 << 12
    CH = score.n_channels(st)
    sc = kernels._scene(st, 1000, 0, float("inf"))
    s = tracer.initial_state(st, seed, torch.arange(B))
    scores = torch.zeros((CH, B))
    for _ in range(8):
        out, new, t = kernels.score_step(st, s, scores)
        fate, fate_abs = t["fate_scores"], t["fate_abs"]
        got, flags = kernels._empty_state(B, "cpu"), kernels._empty_flags(B, "cpu")
        rows = scores.clone()
        folds = torch.zeros((2, 11, CH), dtype=torch.float64)
        comp = torch.empty(B, dtype=torch.int32)
        host_lib.h_score(
            ctypes.byref(sc), ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._State, got, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B,
            rows.data_ptr(), CH, st["meta"]["n_comps"], folds.data_ptr(), comp.data_ptr(),
        )
        got.update(flags, comp_id=comp)
        for name in check.DISCRETE + ("comp_id",):
            assert torch.equal(got[name].long(), out[name].long()), name
        scale = new.abs().amax(1, keepdim=True).clamp(min=1e-30)
        assert float(((rows - new).abs() / scale).max()) <= 1e-5
        assert bool(((folds[0] - fate).abs() <= 1e-5 * fate_abs).all())
        torch.testing.assert_close(folds[1], fate_abs, rtol=1e-5, atol=0)
        s, scores = {k: out[k] for k in s}, new
    assert scores.abs().sum() > 0


@pytest.mark.parametrize("make, record_every", [
    (lambda: lsc_slab_recorders(4), 0), (mixed_scene, 0), (mesh_small, 1),
], ids=["recorders", "mixed", "mesh-log"])
def test_trace_photon_with_scores_matches_twin(host_lib, make, record_every):
    """``trace_photon`` with scores (pvt_trace_score's body) against the
    eager twin, 4096 photons: fates within 2, each photon's record (path
    score, fate, steps) against the twin's, with at most 2 photons parted,
    and the score sums against the records and the twin's
    (``check.compare_score_records``). With the event log (max_events 6)
    the event budget kills photons and folds their scores at KILL."""
    st, seed, n = _f32(make), rng.key_words(5), 4096
    CH, R = score.n_channels(st), max(st["meta"]["n_rec"], 1)
    log, desc = kernels.empty_log(n, record_every, 6, 0, "cpu")
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
    host_lib.h_trace_score(
        ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed[0], seed[1], 0, n,
        ctypes.byref(desc), fates.data_ptr(), cross.data_ptr(), sums.data_ptr(),
        distinct.data_ptr(), bins.data_ptr(), sums64.data_ptr(), row.data_ptr(), CH,
        st["meta"]["n_comps"], fate_scores.data_ptr(), rec_scores.data_ptr(), photon.data_ptr(),
        None, None, 0,
    )
    ref, _, t, _ = tracer.trace_eager(st, seed, n, lanes=512, score=True,
                                      record_every=record_every, max_events=6, per_photon=True)
    assert int(fates.sum()) >= n
    assert int((fates - ref).abs().sum()) <= 2, (fates.tolist(), ref.tolist())
    if st["meta"]["n_rec"]:
        assert torch.equal(distinct.long(), t["distinct"])
    got = {"fate_scores": fate_scores[0], "fate_abs": fate_scores[1],
           "rec_scores": rec_scores[0], "rec_abs": rec_scores[1],
           "photon_scores": photon[:CH], "photon_fate": photon[CH].long(),
           "photon_steps": photon[CH + 1].long()}
    rep = check.compare_score_records(got, t, fates, n, 2)
    assert rep["record_used"] <= 1.0
    # the twin's records are its photons' own: summed by fate they give its
    # float32 sums (KILL aside where a photon folded twice)
    own = torch.zeros((11, CH), dtype=torch.float64).index_add_(
        0, t["photon_fate"], t["photon_scores"].double().T)
    rows = [f for f in range(11) if f != 9 or int(ref.sum()) == n]
    off = (own - t["fate_scores"].double()).abs()[rows]
    assert bool((off <= n * 2.0 ** -24 * t["fate_abs"].double()[rows]).all())
    if record_every:
        budget = (log["ints"][..., 0] == 9) & (log["ints"][..., 1] < 0) \
            & (log["ints"][..., 2] < 0)
        assert int(budget.sum()) > 0
        assert float(fate_scores[0, 9].abs().sum()) > 0
        assert int((photon[CH] == 9).sum()) > 0


@pytest.mark.slow
def test_score_with_event_log_float64_matches_jax(monkeypatch):
    """``score=True`` with ``record_every=1`` on ``mesh_small`` (the JAX
    package's ``body`` with both; max_events 8, so the event budget kills
    photons and their scores fold at KILL): fates, the log's kinds and the
    score sums against the JAX package. Marked slow: with its JAX compile
    (about 25 s on a CPU) the two new test files would pass their share
    of the tier-1 time budget."""
    monkeypatch.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
    monkeypatch.setattr(jax_api, "_TRACER_CACHE", {})
    kwargs = dict(seed=5, record_every=1, max_events=8, dtype=np.float64, lanes=256)
    ref = jax_engine.simulate(mesh_small(pvtrace_tpu), 1024, score=True, **kwargs).data
    got, tallies = _simulate_with_tallies(monkeypatch, mesh_small, 1024, **kwargs)
    assert int(((np.asarray(ref["kind"]) == 9) & (np.asarray(ref["hit"]) < 0)).sum()) > 0
    np.testing.assert_array_equal(got.data["kind"], np.asarray(ref["kind"]))
    _assert_scores_match(ref, got.data, tallies)


@pytest.mark.parametrize("make", [lsc_slab, lambda: lsc_slab_recorders(4), mixed_scene],
                         ids=["slab", "recorders", "mixed"])
def test_score_records_equal_at_any_row_stride(host_lib, make):
    """``trace_photon`` with scores keeps a photon's score row at a stride:
    its column of a launch's rows (stride 1 here) or of a block's shared
    copy (kBlock). Only the addresses differ, so the records and the
    folds' sums are equal bit for bit."""
    st = tables.scene_tensors(compile_scene(make()), dtype=torch.float32)
    seed = rng.key_words(5)
    fates, t = host.trace_scores(host_lib, st, seed, 1024)
    block_fates, block_t = host.trace_scores(host_lib, st, seed, 1024, stride=kernels.BLOCK)
    rec, sums = t["records"], t["folds"]
    block, block_sums = block_t["records"], block_t["folds"]
    assert torch.equal(fates, block_fates) and torch.equal(sums, block_sums)
    assert torch.equal(rec.view(torch.int32), block.view(torch.int32))
    assert float(rec[:-2].abs().sum()) > 0 and float(sums[1].sum()) > 0


LAYOUT_SCENES = {
    "slab": lsc_slab, "recorders-32": lambda: lsc_slab_recorders(32),
    "recorders-256": lambda: lsc_slab_recorders(256), "tiles": lsc_tiles, "mesh": mesh_lsc,
}


@pytest.fixture(scope="module")
def layout_tensors():
    return {name: tables.scene_tensors(compile_scene(make()), dtype=torch.float32)
            for name, make in LAYOUT_SCENES.items()}


SHARED_LIMIT = 96 * 1024
# The float64 build's score and pathwise trace blocks, and its blocks with
# recorders or meshes where the launch has no event log: 128 threads, five
# an SM, each within the SM's 228 KB over five less 1 KB; with the log and
# no scores, four an SM, within the 228 KB over four less 1 KB.
SCORE_LIMIT_F64 = 44 * 1024
LOG_LIMIT_F64 = 56 * 1024


def _shape(meta, score_, f64, log=False, bundle=False):
    """(threads a block, blocks an SM, shared budget) of a trace launch,
    stated apart from the device code."""
    if f64 and (score_ or not log and (meta["n_rec"] or meta["n_tris"])):
        return 128, 5, SCORE_LIMIT_F64
    if f64 and log:
        return 128, 4, LOG_LIMIT_F64
    return 256, 2, SHARED_LIMIT


def _budget_rule(st, score_, n_path, rows_allowed, f64=False, log=False, bundle=False):
    """A block's placement by the budget's rule, stated apart from the
    device code: the recorder tallies (40 bytes a recorder, then the bins
    while they fit), the float64 score sums (8-byte aligned), the threads'
    rows (16-byte aligned, 256 threads of CH + 7 n_path floats), the K5a
    table (16-byte aligned), the mesh triangles (16-byte aligned, 48 bytes
    a triangle), each in shared memory while it fits after the ones before
    it. With `f64`, the float64 build's: 72 bytes a recorder, doubles, 8-byte
    table words and 96-byte triangles, with scores 128 threads a block
    within SCORE_LIMIT_F64, so too with recorders or meshes and no event
    log, and with the log 128 within LOG_LIMIT_F64 (``_shape``).
    ``block``: the threads of a block."""
    meta = st["meta"]
    R, CH = meta["n_rec"], score.n_channels(st, n_path)
    real, rec_bytes = (8, 72) if f64 else (4, 40)
    threads, _, limit = _shape(meta, score_, f64, log, bundle)

    def align(x, a):
        return (x + a - 1) // a * a

    bins = int(R > 0 and rec_bytes * R + 4 * meta["total_bins"] <= limit)
    end = rec_bytes * R + 4 * meta["total_bins"] * bins
    sums = rows = 0
    if score_:
        at, size = align(end, 8), 16 * CH * (11 + R)
        sums = int(at + size <= limit)
        end = at + size * sums
        at, size = align(end, 16), real * threads * (CH + 7 * n_path)
        rows = int(rows_allowed and at + size <= limit)
        end = at + size if rows else end
    size = real * meta["cheb_words"] if meta["cheb_spec"] or meta["cheb_icdf"] or \
        meta["cheb_light"] else 0
    cheb = int(size > 0 and align(end, 16) + size <= limit)
    end = align(end, 16) + size if cheb else end
    size = 12 * real * meta["n_tris"]
    tris = int(size > 0 and align(end, 16) + size <= limit)
    return {"shared_bytes": align(end, 16) + size if tris else end, "shared_bins": bins,
            "shared_scores": sums, "shared_cheb": cheb, "shared_rows": rows,
            "shared_tris": tris, "block": threads}


@pytest.mark.parametrize("scene", list(LAYOUT_SCENES))
def test_trace_layout_follows_the_budget_rule(host_lib, layout_tensors, scene):
    """The device code's ``trace_layout`` (through ``kernels.trace_layout``,
    as ``last_trace`` reports a launch's placement) places each part by the
    budget's rule for every run of the scene: without scores, with score
    channels, and with one and two pathwise channels, the rows allowed in
    shared memory or not."""
    st = layout_tensors[scene]
    for score_, n_path in ((False, 0), (True, 0), (True, 1), (True, 2)):
        for rows in (True, False):
            got = kernels.trace_layout(st, score_, n_path, rows, entry=host_lib.h_layout)
            assert got == _budget_rule(st, score_, n_path, rows), (score_, n_path, rows)


@pytest.mark.parametrize("scene", list(LAYOUT_SCENES))
def test_trace_layout_float64_follows_the_budget_rule(host_lib64, scene):
    """The float64 build's ``trace_layout`` (``score_f64``'s and
    ``pathwise_f64``'s launches, and ``tracer_f64``'s ``pvt_layout``) places
    each part of a float64 scene by the budget's rule in its float64 form:
    with score or pathwise channels in blocks of 128 threads within 44 KB
    (five blocks an SM), with recorders or meshes the same (from a bundle
    too), with the event log in blocks of 128 within 56 KB (four an SM),
    with neither recorders, meshes nor the log within 96 KB as float32's;
    and ``kernels.trace_shape`` gives the same block."""
    st = tables.scene_tensors(compile_scene(LAYOUT_SCENES[scene]()), dtype=torch.float64)
    for score_, n_path in ((False, 0), (True, 0), (True, 1), (True, 2)):
        for rows in (True, False):
            for log, bundle in ((False, False), (True, False), (False, True)):
                got = kernels.trace_layout(st, score_, n_path, rows, entry=host_lib64.h_layout,
                                           log=log, bundle=bundle)
                assert got == _budget_rule(st, score_, n_path, rows, True, log, bundle), \
                    (score_, n_path, rows, log, bundle)
                assert got["block"] == kernels.trace_shape(
                    st["meta"], torch.float64, score_, log, bundle)[0]


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_block_shape_matches_python(host_lib, host_lib64, f64):
    """The host build's block shapes and shared budgets (tracer.cuh's
    kBlock, kScoreBlock, kMinBlocksF64, kSharedTallyLimit,
    kSharedLimitF64, and trace_shape's for launches with nothing, scores,
    recorders, meshes, recorders and the event log) are the Python side's:
    ``kernels.BLOCK``, ``kernels.score_block(dtype)`` (the stride of a
    block's shared rows), ``kernels.trace_shape`` and this file's shapes
    and budgets. The float32 build keeps one shape for every trace
    kernel."""
    out = (ctypes.c_longlong * 20)()
    (host_lib64 if f64 else host_lib).h_block_shape(out)
    dtype = torch.float64 if f64 else torch.float32
    assert list(out[:5]) == [kernels.BLOCK, kernels.score_block(dtype), 5, SHARED_LIMIT,
                             SCORE_LIMIT_F64]
    none, rec, mesh = ({"n_rec": 0, "n_tris": 0}, {"n_rec": 4, "n_tris": 0},
                       {"n_rec": 0, "n_tris": 24})
    launches = [(none, False, False), (none, True, False), (rec, False, False),
                (mesh, False, False), (rec, False, True)]
    for k, (meta, score_, log) in enumerate(launches):
        want = _shape(meta, score_, f64, log)
        assert tuple(out[5 + 3 * k:8 + 3 * k]) == want, (k, list(out))
        assert kernels.trace_shape(meta, dtype, score_, log) == want[:2]
        assert want[1] * (want[2] + 1024) <= 228 * 1024
    assert kernels.score_block(torch.float32) == kernels.BLOCK == 256
    assert kernels.score_block(torch.float64) == kernels.SHAPE_F64[0] == 128


def test_trace_layout_budget(host_lib):
    """The budget's order (tallies, score sums, rows, K5a table) at its
    edges: the slab's rows and table fit; at 256 recorders two pathwise
    channels' rows do not, and at 224 they fit only with the table in
    device memory (the rows take the budget first); ``lsc_tiles``' table
    never fits; rows forced out of shared memory leave the table there."""
    def layout(make, *args):
        st = tables.scene_tensors(compile_scene(make()), dtype=torch.float32)
        return kernels.trace_layout(st, *args, entry=host_lib.h_layout)

    slab = layout(lsc_slab, True, 2)
    assert slab["shared_rows"] == slab["shared_cheb"] == slab["shared_scores"] == 1
    assert slab["shared_bytes"] <= SHARED_LIMIT
    wide, edge = (lambda: lsc_slab_recorders(256)), (lambda: lsc_slab_recorders(224))
    two, one = layout(wide, True, 2), layout(edge, True, 2)
    assert (two["shared_rows"], two["shared_cheb"]) == (0, 1)
    assert (one["shared_rows"], one["shared_cheb"]) == (1, 0)
    forced = layout(edge, True, 2, False)
    assert (forced["shared_rows"], forced["shared_cheb"]) == (0, 1)
    assert layout(lsc_tiles, True, 0)["shared_cheb"] == 0
    assert layout(lsc_slab, False)["shared_bytes"] == 4 * tables.scene_tensors(
        compile_scene(lsc_slab()), dtype=torch.float32)["meta"]["cheb_words"]
