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
lane.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, rng, simulate, tables, tally, tracer  # noqa: E402
from pvtrace_tpu_torch.engine.result import MOMENT_PROPERTIES  # noqa: E402
from pvtrace_tpu_torch.kernels import host  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab_heatmap, lsc_slab_recorders  # noqa: E402

torch.set_num_threads(1)
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


@pytest.mark.parametrize("scene", ["mixed", "R256"])
def test_device_tally_event_matches_twin_on_host(host_lib, scene):
    """tally_event (via tally_lane, the body of pvt_tally) against the
    twin over 8 steps of 4096 lanes, both fed the twin's steps: integer
    tallies and seen bits equal, sums within 1e-4 (the host adds lane by
    lane in float32, moving each recorder's sums to float64 every
    SUMS_FLUSH distinct rays; the twin takes one product over the lanes).
    "mixed" has heatmaps and x/y/z histograms; "R256" is the full width,
    all eight seen words."""
    rec_scene = _recorder_scene() if scene == "mixed" else lsc_slab_recorders(256)
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
    assert torch.equal(cross, twin["cross"])
    assert torch.equal(distinct.long(), twin["distinct"])
    assert torch.equal(bins, twin["bins"])
    assert torch.equal(kernels.unpack_seen(seen, R), twin["seen"])
    assert torch.equal(kernels.pack_seen(twin["seen"]), seen)
    scale = twin["sums"].double().abs().clamp(min=1e-30)
    got = sums.double() + sums64
    assert float(((got - twin["sums"].double()).abs() / scale).max()) <= 1e-4
