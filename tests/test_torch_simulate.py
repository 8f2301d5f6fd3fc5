"""The slice as a whole: the port's ``simulate`` against the JAX package.

Both packages trace the same photons from the same seed (threefry
streams, pid -> stream), so in float64 the fate counts agree photon for
photon, up to the rare photon whose discrete outcome an ulp flips. Each
package traces the scene built from its own classes (``scenes.*(ns)``).
These tests run the exact table-lerp spectral path (K5b) on both sides,
``PVTRACE_TPU_NO_CHEB`` set (read when a JAX tracer is built, so each
test gets an empty tracer cache); ``test_torch_cheb.py`` compares the
packages at their defaults (K5a).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu_torch.engine import simulate  # noqa: E402
from pvtrace_tpu_torch.scenes import (  # noqa: E402
    lsc_slab,
    lsc_slab_recorders,
    mixed_scene,
)

torch.set_num_threads(1)
FATE_NAMES = {4: "NONRADIATIVE", 7: "EXIT", 8: "REACT", 9: "KILL", 10: "NO_HIT"}


@pytest.fixture
def jax_exact_lerp(monkeypatch):
    monkeypatch.setenv("PVTRACE_TPU_NO_CHEB", "1")
    monkeypatch.setattr(jax_api, "_TRACER_CACHE", {})


def _fates(result):
    fates = np.asarray(result.data["fates"], dtype=np.int64)
    assert fates.shape == (11,)
    return fates


def _assert_float64_parity(make, n, **kwargs):
    """Fates of scene `make(ns)` from both packages, float64, seed 5."""
    ref = _fates(jax_engine.simulate(make(pvtrace_tpu), n, seed=5, record_every=0,
                                     dtype=np.float64, **kwargs))
    got = _fates(simulate(make(), n, seed=5, record_every=0, dtype=np.float64,
                          device="cpu", **kwargs))
    assert ref.sum() == n and got.sum() == n
    assert np.abs(got - ref).max() <= 4, (got.tolist(), ref.tolist())
    return got


@pytest.mark.parametrize("n, lanes", [(2 ** 13, 2 ** 10), (2 ** 11, None)])
def test_bench_scene_float64_matches_jax(n, lanes, jax_exact_lerp):
    got = _assert_float64_parity(lsc_slab, n, lanes=lanes)
    assert set(np.flatnonzero(got)) <= {4, 7, 9}


@pytest.mark.parametrize("n, lanes", [(2 ** 13, 2 ** 10), (2 ** 11, None)])
def test_bench_scene_float32_agrees_with_jax(n, lanes, jax_exact_lerp):
    # The JAX package traces float32 with 64-bit mode off, as its bench
    # does: with jax_enable_x64 on, its float32 regeneration loop fails
    # (float64 emission constants promote the loop carry).
    with jax.enable_x64(False):
        ref = _fates(jax_engine.simulate(lsc_slab(pvtrace_tpu), n, seed=9, record_every=0,
                                         dtype=np.float32, lanes=lanes))
    got = _fates(simulate(lsc_slab(), n, seed=9, record_every=0, dtype=np.float32,
                          lanes=lanes, device="cpu"))
    assert ref.sum() == n and got.sum() == n
    for slot in FATE_NAMES:
        pooled = (ref[slot] + got[slot]) / (2.0 * n)
        if pooled == 0.0:
            continue
        z = abs(ref[slot] - got[slot]) / n / np.sqrt(pooled * (1 - pooled) * 2.0 / n)
        assert z < 5, (FATE_NAMES[slot], got.tolist(), ref.tolist())


@pytest.mark.parametrize("options", [
    {"emit_method": "kT"},
    {"emit_method": "redshift", "maxpathlength": 6.0},
    {"emit_method": "full", "maxsteps": 6},
], ids=["kT", "redshift-pathcap", "full-stepcap"])
def test_mixed_scene_float64_matches_jax(options, jax_exact_lerp):
    got = _assert_float64_parity(mixed_scene, 2 ** 11, lanes=2 ** 9, **options)
    assert got[7] > 0 and got[4] > 0 and got[8] > 0
    if "maxpathlength" in options or "maxsteps" in options:
        assert got[9] > 0


def test_lsc_slab_is_the_bench_scene():
    import importlib.util
    from pathlib import Path

    from pvtrace_tpu.engine.compiler import compile_scene as jax_compile_scene
    from pvtrace_tpu_torch.engine import compile_scene

    path = Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("pvtrace_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    digest = jax_compile_scene(bench.build_scene()).content_digest
    assert jax_compile_scene(lsc_slab(pvtrace_tpu)).content_digest == digest
    assert compile_scene(lsc_slab()).content_digest == digest


def test_lanes_do_not_change_fates():
    scene = lsc_slab()
    runs = [
        _fates(simulate(scene, 3000, seed=4, record_every=0, dtype=np.float64,
                        lanes=lanes, device="cpu", index_offset=17))
        for lanes in (None, 1000, 64)
    ]
    for fates in runs[1:]:
        np.testing.assert_array_equal(fates, runs[0])


def test_result_layout():
    result = simulate(lsc_slab(), 500, seed=1, record_every=0, device="cpu")
    assert sum(result.fate_counts().values()) == 500
    assert result.num_rays == 500 and result.sources[3] == "Light"
    assert result.data["fates"].dtype == np.int64
    assert result.data["steps"] > 0
    assert result.data["counts"].shape == (0,)
    assert result.data["position"].shape == (0, 128, 3)
    assert list(result.histories()) == []


def test_result_layout_with_histories():
    """record_every = 4: the JAX package's log layout, and histories that
    start with GENERATE and end with a fate."""
    from pvtrace_tpu_torch import Event

    result = simulate(lsc_slab(), 200, seed=1, record_every=4, max_events=64, device="cpu")
    data = result.data
    assert result.num_recorded == 50 and data["counts"].dtype == np.int32
    assert data["kind"].shape == (50, 64) and data["kind"].dtype == np.int32
    assert data["normal"].shape == (50, 64, 3) and data["duration"].shape == (50, 64)
    assert data["wavelength"].dtype == np.float32
    histories = list(result.histories())
    assert [len(h) for h in histories] == data["counts"].tolist()
    for history in histories:
        assert history[0][1] == Event.GENERATE and history[0][0].source == "Light"
        assert history[-1][1] in (Event.EXIT, Event.NONRADIATIVE, Event.KILL)
    counts = result.event_counts()
    assert counts[Event.GENERATE] == 50 and counts[Event.EXIT] > 0


def _fate_gradients(scene, n, **kwargs):
    from pvtrace_tpu_torch.diff.transport import fate_gradients

    return fate_gradients(scene, n, **kwargs)


# The pathwise specs the JAX package refuses, refused with its messages.
@pytest.mark.parametrize("spec", [
    ("size", "world", 0), ("radius", "lsc"), ("length", "lsc"), ("area", "lsc"),
], ids=["size-on-sphere", "radius-on-box", "length-on-box", "unknown-kind"])
def test_pathwise_spec_refusals_match_jax(spec):
    from pvtrace_tpu.diff.transport import resolve_pathwise_params as jax_resolve
    from pvtrace_tpu.engine.compiler import compile_scene as jax_compile
    from pvtrace_tpu_torch.diff.transport import resolve_pathwise_params
    from pvtrace_tpu_torch.engine import compile_scene

    with pytest.raises(ValueError) as want:
        jax_resolve(jax_compile(lsc_slab(pvtrace_tpu)), [spec])
    with pytest.raises(ValueError) as got:
        resolve_pathwise_params(compile_scene(lsc_slab()), [spec])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=str(want.value)):
        _fate_gradients(lsc_slab(), 10, wrt="pathwise", pathwise=[spec], device="cpu")


@pytest.mark.parametrize("record_every", [0, 1])
def test_pathwise_without_score_is_ignored(record_every):
    """As in the JAX package, `pathwise` acts only with ``score=True``:
    without it the run equals one without `pathwise`."""
    kwargs = dict(seed=4, record_every=record_every, device="cpu")
    plain = simulate(lsc_slab(), 300, **kwargs).data
    got = simulate(lsc_slab(), 300, pathwise=(("n", 1), ("geom", 1, 2)), **kwargs).data
    assert "fate_scores" not in got
    assert set(got) == set(plain)
    for name in plain:
        np.testing.assert_array_equal(got[name], plain[name], err_msg=name)


@pytest.mark.parametrize("n, offset", [(0, 0), (10, -1), (2, 2 ** 32 - 2)])
def test_budget_outside_uint32_photon_ids_is_rejected(n, offset):
    with pytest.raises(ValueError):
        simulate(lsc_slab(), n, record_every=0, device="cpu", index_offset=offset)


def test_recorder_scene_runs():
    """Recorders, which raised before the port had K9, now run: on the
    world sphere (every EXIT) and on the slab's top face."""
    from pvtrace_tpu_torch import Event, Recorder

    scene = lsc_slab_recorders(4)
    scene.root.recorders = [Recorder("out", event="exit")]
    result = simulate(scene, 500, seed=1, record_every=0, device="cpu")
    fates = result.fate_counts()
    assert result.recorders["out"].rays == fates[Event.EXIT]
    assert result.recorders["r000"].rays > 0
    assert result.data["rec_bins"].shape == (4 * 50,)
