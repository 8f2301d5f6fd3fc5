"""The port's LSC device API and scene renderer against the JAX
package's.

``LSC((5, 5, 1))`` at its defaults (Lumogen F Red 305 and a background
absorber under a 555 nm cone lamp, which the compiler lowers to a device
sampler) is simulated by both packages on the CPU in float64 (the JAX
package's default under ``tests/conftest.py``'s x64, the port's
``dtype=float64``, ``device="cpu"``), 400 photons at seed 7 with
``np.random.seed(0)`` before each. The two trace the same photons, so the
counts table, the summary and the dataframe are equal but for photons
whose paths part by one ulp: at most PARTED of the 400, each moving at
most one row of each table cell and one entrance and one exit row of the
dataframe. The floats of the rows that did not part agree to rtol 1e-9.

``LSC.gradient`` with solar cells on the four edges, n = 2**12 at seed 3,
``wrt="concentration"`` (score channels, K12) and ``wrt="n"`` (a
pathwise channel, K13): the recorders' distinct counts are equal and
their score sums agree to SCORE_RTOL of each channel's sum of |score|
(the rule of ``tests/test_torch_score.py`` and
``tests/test_torch_pathwise.py``), and so the returned efficiency is equal
and the gradient within that bound carried through the ratio. Each side's
JAX run is one compile, shared by a module fixture.

Every run of this file takes the table lerp (K5b, ``PVTRACE_TPU_NO_CHEB=1``
on both sides, the JAX compile cache emptied around it): the JAX
package's three compiles of this scene take 23, 10 and 24 s on a CPU that
way and 62, 29 and 51 s at the defaults (Chebyshev spectra, K5a), whose
parity ``tests/test_torch_simulate.py`` and ``tests/test_torch_cheb.py``
hold.

The ``tests/test_lsc.py`` cases run on the port too, and the renderer's.
"""
import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu.device.lsc import LSC as JaxLSC  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
import pvtrace_tpu_torch  # noqa: E402
from pvtrace_tpu_torch.device.lsc import LSC  # noqa: E402
from pvtrace_tpu_torch.engine import api, tracer  # noqa: E402

cap_threads()

N_SIM, SEED_SIM = 400, 7
PARTED = 2
FLOAT_RTOL = 1e-9
N_GRAD, SEED_GRAD = 2 ** 12, 3
SCORE_RTOL = 1e-9
CELLS = {"left", "right", "near", "far"}
F64 = dict(device="cpu", dtype=np.float64)


def _simulated(cls, **kwargs):
    np.random.seed(0)
    lsc = cls((5.0, 5.0, 1.0))
    lsc.simulate(N_SIM, seed=SEED_SIM, **kwargs)
    return lsc


@pytest.fixture(scope="module")
def table_lerp():
    """K5b on both sides for the module's runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PVTRACE_TPU_NO_CHEB", "1")
        mp.setattr(jax_api, "_TRACER_CACHE", {})
        yield


@pytest.fixture(scope="module")
def simulated_lsc(table_lerp):
    return _simulated(LSC, **F64)


@pytest.fixture(scope="module")
def jax_lsc(table_lerp):
    return _simulated(JaxLSC)


def _gradient(monkeypatch, module, wrt, **kwargs):
    """``LSC.gradient`` of `module`'s LSC with solar cells on the edges,
    and the data of its one engine run (``module.engine.api.simulate``)."""
    seen = {}
    simulate = module.engine.api.simulate

    def spy(*args, **kw):
        seen["result"] = simulate(*args, **kw)
        return seen["result"]

    lsc = (LSC if module is pvtrace_tpu_torch else JaxLSC)((5.0, 5.0, 1.0))
    lsc.add_solar_cell(CELLS)
    monkeypatch.setattr(module.engine.api, "simulate", spy)
    out = lsc.gradient(n=N_GRAD, seed=SEED_GRAD, wrt=wrt, **kwargs)
    monkeypatch.setattr(module.engine.api, "simulate", simulate)
    return out, seen["result"].data


@pytest.fixture(scope="module", params=["concentration", "n"])
def gradients(request, table_lerp):
    """(JAX result, JAX data, port result, port data, port tallies) of
    one `wrt`."""
    with pytest.MonkeyPatch.context() as mp:
        ref, ref_data = _gradient(mp, pvtrace_tpu, request.param)
        seen, trace = {}, tracer.trace

        def spy(*args, **kw):
            out = trace(*args, **kw)
            seen["tallies"] = out[2]
            return out

        mp.setattr(tracer, "trace", spy)
        got, got_data = _gradient(mp, pvtrace_tpu_torch, request.param, **F64)
    return ref, ref_data, got, got_data, seen["tallies"]


# -- LSC.simulate against the JAX package ---------------------------------


def test_counts_table_matches_jax(simulated_lsc, jax_lsc):
    got, ref = simulated_lsc.counts(), jax_lsc.counts()
    assert list(got.index) == list(ref.index) and list(got.columns) == list(ref.columns)
    assert int((got - ref).abs().to_numpy().max()) <= PARTED


def test_summary_matches_jax(simulated_lsc, jax_lsc):
    got, ref = simulated_lsc.summary(), jax_lsc.summary()
    assert list(got.index) == list(ref.index)
    for key in got.index:
        g, r = got[key], ref[key]
        if isinstance(r, (set, frozenset)):
            assert g == r, key
        elif key == "Incident":
            assert abs(g - r) <= PARTED
        else:
            assert abs(g - r) <= PARTED / max(float(ref["Incident"]), 1.0), key


def test_dataframe_matches_jax(simulated_lsc, jax_lsc):
    """Columns equal; rows in the same order (entrance rows, then exit
    rows, a photon at a time); the text columns equal and the floats
    within FLOAT_RTOL except on the rows of parted photons."""
    got, ref = simulated_lsc._df, jax_lsc._df
    assert list(got.columns) == list(ref.columns)
    assert abs(len(got) - len(ref)) <= 2 * PARTED
    n = min(len(got), len(ref))
    floats = [c for c in ref.columns if ref[c].dtype.kind == "f"]
    texts = [c for c in ref.columns if c not in floats]
    close = np.isclose(got[floats].to_numpy()[:n], ref[floats].to_numpy()[:n],
                       rtol=FLOAT_RTOL, atol=1e-12, equal_nan=True).all(axis=1)
    same = (got[texts].iloc[:n].fillna("").to_numpy() ==
            ref[texts].iloc[:n].fillna("").to_numpy()).all(axis=1)
    assert int((~(close & same)).sum()) <= 2 * PARTED


# -- tests/test_lsc.py on the port ----------------------------------------


def test_dataframe_columns(simulated_lsc):
    df = simulated_lsc._df
    for col in ("kind", "event", "wavelength", "position_x", "position_y", "position_z",
                "direction_x", "facet", "source"):
        assert col in df.columns


def test_counts_table(simulated_lsc):
    counts = simulated_lsc.counts()
    assert set(counts.index) == {"left", "right", "near", "far", "top", "bottom"}
    # Light shines on the top facet
    assert counts["Solar In"]["top"] > 300


def test_summary(simulated_lsc):
    summary = simulated_lsc.summary()
    assert 0.0 <= summary["Waveguide Efficiency"] <= 1.0 or np.isnan(
        summary["Waveguide Efficiency"])
    expected = 1.5 ** 2 / (25.0 / 20.0 + 1.5 ** 2)
    assert np.isclose(summary["Waveguide Efficiency (Thermodynamic Prediction)"], expected)


def test_spectrum_filters(simulated_lsc):
    lsc = simulated_lsc
    edge = lsc.spectrum(facets={"left", "right", "near", "far"})
    top_bottom = lsc.spectrum(facets={"top", "bottom"})
    assert len(edge) + len(top_bottom) <= len(lsc._df)
    with pytest.raises(ValueError):
        lsc.spectrum(source={"nope"})


def test_luminescent_output_redshifted(simulated_lsc):
    lum = simulated_lsc.spectrum(source={"Lumogen F Red 305"}, kind="last")
    assert len(lum) > 10 and lum.mean() > 570.0


def test_render_and_save(tmp_path):
    from pvtrace_tpu_torch import photon_tracer
    from pvtrace_tpu_torch.scene.renderer import SceneRenderer

    np.random.seed(0)
    lsc = LSC((5.0, 5.0, 1.0))
    lsc._make_scene()
    renderer = SceneRenderer()
    renderer.render(lsc._scene)
    assert len(renderer.segments) > 10
    scene = lsc._scene
    for ray in scene.emit(3):
        renderer.add_history(photon_tracer.follow(scene, ray))
    path = renderer.save(str(tmp_path / "scene.html"))
    text = open(path).read()
    assert "SEGMENTS" in text and "canvas" in text
    assert len(text) > 2000
    assert pvtrace_tpu_torch.MeshcatRenderer is SceneRenderer
    assert pvtrace_tpu_torch.LSC is LSC
    assert isinstance(lsc.show(), SceneRenderer)


# -- LSC.gradient against the JAX package ---------------------------------


def test_gradient_matches_jax(gradients):
    ref, ref_data, got, got_data, tallies = gradients
    R = len(got_data["rec_distinct"])
    np.testing.assert_array_equal(got_data["rec_distinct"], np.asarray(ref_data["rec_distinct"]))
    r, g = np.asarray(ref_data["rec_scores"]), got_data["rec_scores"]
    assert g.shape == r.shape and g.dtype == np.float64
    S = tallies["rec_abs"][:R].numpy().sum(0)
    assert (np.abs(g - r) <= SCORE_RTOL * S).all(), np.abs(g - r).max(0)
    assert got["component"] == ref["component"]
    assert got["optical_efficiency"] == ref["optical_efficiency"]
    # The gradient is (dC * I - C * dI) / I**2 of the four cells' sums and
    # the incident row's, each score sum off by at most SCORE_RTOL * S.
    incident = got_data["rec_distinct"][-1] / N_GRAD
    collected = got["optical_efficiency"] * incident
    err = SCORE_RTOL * S.max() / N_GRAD
    bound = (len(CELLS) * err * incident + collected * err) / incident ** 2
    assert abs(got["gradient"] - ref["gradient"]) <= bound
    assert np.isfinite(got["gradient"]) and got["gradient"] != 0


def test_gradient_channel(gradients):
    """wrt="n" appends one pathwise channel after the two components and
    the two nodes (world, plate); wrt="concentration" has none."""
    _, ref_data, got, got_data, _ = gradients
    assert got_data["rec_scores"].shape == np.asarray(ref_data["rec_scores"]).shape
    want = 2 + 2 + (got["component"] == "n")
    assert got_data["rec_scores"].shape[1] == want


# -- the card, or nothing ---------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
def test_without_device_cpu_it_raises_and_runs_nothing(monkeypatch):
    """Without ``device="cpu"`` the run is on the card: with no card it
    raises, and neither the eager twin nor the oracle runs a photon."""
    from pvtrace_tpu_torch.algorithm import photon_tracer

    def refuse(*args, **kwargs):
        raise AssertionError("the per-ray oracle ran")

    monkeypatch.setattr(photon_tracer, "follow", refuse)
    eager = tracer.eager_runs
    lsc = LSC((5.0, 5.0, 1.0))
    with pytest.raises((RuntimeError, AssertionError)) as info:
        lsc.simulate(100, seed=1)
    assert "oracle" not in str(info.value)
    lsc.add_solar_cell(CELLS)
    with pytest.raises((RuntimeError, AssertionError)):
        lsc.gradient(n=100, seed=1)
    assert tracer.eager_runs == eager
    assert api.is_available() is False
