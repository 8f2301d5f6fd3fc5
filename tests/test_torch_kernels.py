"""The CUDA kernels: layout and arithmetic here, the kernels on the card.

On the CPU:

* the record layout and the structs of ``kernels/csrc/tracer.cuh`` match
  the Python side (``engine/tables.py``, the ctypes Structures);
* the device code of ``tracer.cuh`` (``emit_lane``, ``step_lane``,
  ``trace_photon``, host-callable by design) is compiled with the host
  C++ compiler (``kernels/host.py``) and held against the eager twin, at
  the scene's defaults (Chebyshev spectra, K5a) and with the table lerp
  (K5b, ``PVTRACE_TPU_NO_CHEB``);
* the wrappers take the twin for CPU tensors and count no launch.

On the card (marked ``gpu``, skipped without CUDA): phases 2-4 and 6-9
of ``chip_smoke.py`` at a small size, on both spectral paths, and the
float64 refusal.
"""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.kernels import check  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, physics, rng, tables, tally, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import build, host  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_heatmap, lsc_slab_recorders  # noqa: E402

torch.set_num_threads(1)
HEADER = (build.CSRC / "tracer.cuh").read_text()


def _struct_fields(name):
    body = re.search(r"struct %s \{(.*?)\};" % name, HEADER, re.S).group(1)
    # The last identifier of each declarator: "unsigned char *a, *b;" -> a, b
    return [
        re.findall(r"\w+", part)[-1]
        for decl in body.split(";") if decl.strip()
        for part in decl.split(",")
    ]


def test_header_layout_matches_tables():
    defines = dict(re.findall(r"^#define ([A-Z_0-9]+) (\d+)$", HEADER, re.M))
    assert defines, "no layout defines found"
    for name, value in defines.items():
        assert tables.LAYOUT[name] == int(value), name
    for name in ("NODE_F", "NODE_I", "COMP_F", "COMP_I", "OVR_F", "LIGHT_F", "LIGHT_I"):
        assert name in defines


@pytest.mark.parametrize("struct, cls", [
    ("PvtScene", kernels._Scene), ("PvtState", kernels._State), ("PvtFlags", kernels._Flags),
    ("PvtTallyOut", kernels._TallyOut),
])
def test_header_structs_match_ctypes(struct, cls):
    assert _struct_fields(struct) == [name for name, _ in cls._fields_]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


@pytest.fixture(scope="module")
def bench_f32():
    return tables.scene_tensors(compile_scene(lsc_slab()), dtype=torch.float32, device="cpu")


def _spectra_scene(monkeypatch, spectra, device="cpu"):
    """The bench slab's float32 tensors on spectral path `spectra` (K5a:
    the defaults; K5b: ``PVTRACE_TPU_NO_CHEB`` set)."""
    if spectra == "K5b":
        monkeypatch.setenv("PVTRACE_TPU_NO_CHEB", "1")
    else:
        monkeypatch.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
    st = tables.scene_tensors(compile_scene(lsc_slab()), dtype=torch.float32, device=device)
    cheb = spectra == "K5a"
    assert st["meta"]["cheb_spec"] == cheb and st["meta"]["cheb_icdf"] == cheb
    return st


@pytest.mark.parametrize("spectra", ["K5a", "K5b"])
def test_device_code_matches_twin_on_host(host_lib, monkeypatch, spectra):
    st, seed, B = _spectra_scene(monkeypatch, spectra), rng.key_words(5), 1 << 12
    sc = kernels._scene(st, 1000, 0, float("inf"))
    out = kernels._empty_state(B, "cpu")
    host_lib.h_emit(ctypes.byref(sc), seed[0], seed[1], 7, B,
                    ctypes.byref(kernels._struct(kernels._State, out, kernels._STATE_PTRS)))
    twin = tracer.initial_state(st, seed, 7 + torch.arange(B))
    for name, ref in twin.items():
        if ref.dtype.is_floating_point:
            torch.testing.assert_close(out[name], ref, rtol=0, atol=1e-6)
        else:
            assert torch.equal(out[name].long(), ref.long()), name

    s = twin
    for _ in range(6):
        ref = tracer.step_state(st, s, 1000, 0)
        got, flags = kernels._empty_state(B, "cpu"), kernels._empty_flags(B, "cpu")
        host_lib.h_step(
            ctypes.byref(sc),
            ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._State, got, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B,
        )
        got.update(flags)
        for name in check.DISCRETE:
            assert torch.equal(got[name].long(), ref[name].long()), name
        for name in physics.STATE_FLOATS + physics.SURFACE:
            torch.testing.assert_close(got[name], ref[name], rtol=1e-4, atol=1e-5)
        s = ref

    fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
    host_lib.h_trace(ctypes.byref(sc), seed[0], seed[1], 0, 4096, fates.data_ptr())
    ref, _, _ = tracer.trace_eager(st, seed, 4096, lanes=512)
    assert int(fates.sum()) == 4096
    assert int((fates - ref).abs().max()) <= 2, (fates.tolist(), ref.tolist())


def test_wrappers_run_the_twin_on_cpu(bench_f32):
    st, seed = bench_f32, rng.key_words(3)
    kernels.reset()
    state = kernels.emit(st, seed, 5, 256)
    ref = tracer.initial_state(st, seed, 5 + torch.arange(256))
    for name in ref:
        assert torch.equal(state[name], ref[name]), name
    stepped = kernels.step(st, state)
    assert torch.equal(stepped["alive"], tracer.step_state(st, state, 1000, 0)["alive"])
    fates, _, _ = kernels.trace(st, seed, 300, lanes=64)
    assert torch.equal(fates, tracer.trace_eager(st, seed, 300, lanes=64)[0])
    values = kernels.cheb(st, torch.linspace(-1.0, 1.0, 5))
    assert values.shape == (st["meta"]["cheb_n_fits"], 5)
    rec = tables.scene_tensors(compile_scene(lsc_slab_recorders(8)))
    out = tracer.step_state(rec, tracer.initial_state(rec, seed, torch.arange(256)), 1000, 0)
    got, ref = tally.empty(rec, 256), tally.empty(rec, 256)
    assert kernels.tally_step(got, rec, out) is None
    tally.tally(ref, rec, out)
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    assert set(kernels.launches.values()) == {0}


def test_build_names_library_by_source_hash():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path()
    assert "-use_fast_math" not in build.NVCC_FLAGS and "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    compiled = compile_scene(lsc_slab())
    return tables.scene_tensors(compiled, dtype=torch.float32, device="cuda")


def _cuda_spectra_scene(monkeypatch, spectra):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _spectra_scene(monkeypatch, spectra, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("spectra", ["K5a", "K5b"])
def test_emit_and_step_kernels_match_twin_on_card(monkeypatch, spectra):
    st = _cuda_spectra_scene(monkeypatch, spectra)
    state, rep = check.check_emit(st, rng.key_words(1), 1 << 16, reps=2)
    assert rep["max_abs_err"] <= 1e-5
    rep = check.check_step(st, state, steps=8, reps=2)
    assert rep["discrete_frac"] <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("spectra", ["K5a", "K5b"])
def test_trace_kernel_matches_twin_on_card(monkeypatch, spectra):
    st = _cuda_spectra_scene(monkeypatch, spectra)
    rep = check.check_trace(st, rng.key_words(1), 1 << 16, lanes=1 << 14)
    assert sum(rep["fates"]) == 1 << 16


@pytest.mark.gpu
def test_cheb_and_tally_kernels_match_twin_on_card(cuda_scene):
    rep = check.check_cheb(cuda_scene, n_t=4096, reps=2)
    assert rep["max_rel_err"] <= check.CHEB_RTOL
    st = tables.scene_tensors(compile_scene(lsc_slab_recorders(32)), device="cuda")
    state = tracer.initial_state(st, rng.key_words(1), torch.arange(1 << 14, device="cuda"))
    rep = check.check_tally(st, state, steps=8, reps=2)
    assert rep["max_rel_err"] <= check.SUMS_RTOL


@pytest.mark.gpu
def test_recorder_trace_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for scene, shared_bins in ((lsc_slab_recorders(32), True), (lsc_slab_recorders(256), True),
                               (lsc_slab_heatmap(), False)):
        st = tables.scene_tensors(compile_scene(scene), device="cuda")
        rep = check.check_trace(st, rng.key_words(2), 1 << 16, lanes=1 << 14)
        assert rep["shared_bins"] == shared_bins


@pytest.mark.gpu
def test_simulate_on_card_goes_through_the_kernel(cuda_scene):
    from pvtrace_tpu_torch.engine import simulate

    kernels.reset()
    tracer.eager_runs = 0
    result = simulate(lsc_slab(), 1 << 16, seed=3, record_every=0)
    assert int(np.asarray(result.data["fates"]).sum()) == 1 << 16
    assert kernels.launches["pvt_trace"] == 1 and tracer.eager_runs == 0


@pytest.mark.gpu
def test_float64_on_card_is_refused(cuda_scene):
    st = tables.scene_tensors(compile_scene(lsc_slab()), dtype=torch.float64, device="cuda")
    with pytest.raises(NotImplementedError):
        kernels.trace(st, rng.key_words(1), 10)
