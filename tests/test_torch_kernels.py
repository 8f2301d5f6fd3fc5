"""The CUDA kernels: layout and arithmetic here, the kernels on the card.

On the CPU:

* the record layout and the structs of ``kernels/csrc/tracer.cuh`` match
  the Python side (``engine/tables.py``, the ctypes Structures);
* the device code of ``tracer.cuh`` (``emit_lane``, ``step_lane``,
  ``trace_photon``, host-callable by design) is compiled with the host
  C++ compiler and held against the eager twin;
* the wrappers take the twin for CPU tensors and count no launch.

On the card (marked ``gpu``, skipped without CUDA): phases 2-4 of
``chip_smoke.py`` at a small size, and the float64 refusal.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, physics, rng, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import build  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab  # noqa: E402

torch.set_num_threads(1)
HEADER = (build.CSRC / "tracer.cuh").read_text()

HARNESS = r"""
#include "tracer.cuh"
extern "C" {
void h_emit(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
            long long B, const PvtState* out) {
  for (long long i = 0; i < B; ++i) emit_lane(*sc, s0, s1, off, i, *out);
}
void h_step(const PvtScene* sc, const PvtState* in, const PvtState* out,
            const PvtFlags* fl, long long B) {
  for (long long i = 0; i < B; ++i) step_lane(*sc, *in, *out, *fl, i);
}
void h_trace(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
             unsigned long long total, long long* fates) {
  FateCounts f = {0, 0, 0, 0, 0};
  for (unsigned long long id = off; id < total; ++id)
    trace_photon(*sc, s0, s1, (uint32_t)id, f);
  fates[7] += f.exit; fates[4] += f.nonrad; fates[8] += f.react;
  fates[9] += f.kill; fates[10] += f.no_hit;
}
}
"""


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
])
def test_header_structs_match_ctypes(struct, cls):
    assert _struct_fields(struct) == [name for name, _ in cls._fields_]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path_factory.mktemp("host") / "harness.cpp"
    src.write_text(HARNESS)
    lib = src.with_suffix(".so")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
         "-I", str(build.CSRC), "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=300,
    )
    h = ctypes.CDLL(str(lib))
    vp, u32, u64, i64 = ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_longlong
    h.h_emit.argtypes = [vp, u32, u32, u64, i64, vp]
    h.h_step.argtypes = [vp, vp, vp, vp, i64]
    h.h_trace.argtypes = [vp, u32, u32, u64, u64, vp]
    return h


@pytest.fixture(scope="module")
def bench_f32():
    return tables.scene_tensors(compile_scene(lsc_slab()), dtype=torch.float32, device="cpu")


def _flags(B):
    flags = {name: torch.empty(B, dtype=torch.bool) for name in physics.FLAGS}
    flags["hit"] = torch.empty(B, dtype=torch.int32)
    flags["container"] = torch.empty(B, dtype=torch.int32)
    return flags


def test_device_code_matches_twin_on_host(host_lib, bench_f32):
    st, seed, B = bench_f32, rng.key_words(5), 1 << 12
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
        got, flags = kernels._empty_state(B, "cpu"), _flags(B)
        host_lib.h_step(
            ctypes.byref(sc),
            ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._State, got, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B,
        )
        got.update(flags)
        for name in ("alive", "hit", "container", "source", "count") + physics.FLAGS:
            assert torch.equal(got[name].long(), ref[name].long()), name
        for name in physics.STATE_FLOATS:
            torch.testing.assert_close(got[name], ref[name], rtol=1e-4, atol=1e-5)
        s = ref

    fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
    host_lib.h_trace(ctypes.byref(sc), seed[0], seed[1], 0, 4096, fates.data_ptr())
    ref, _ = tracer.trace_eager(st, seed, 4096, lanes=512)
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
    fates, _ = kernels.trace(st, seed, 300, lanes=64)
    assert torch.equal(fates, tracer.trace_eager(st, seed, 300, lanes=64)[0])
    assert kernels.launches == {"pvt_emit": 0, "pvt_step": 0, "pvt_trace": 0}


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


@pytest.mark.gpu
def test_emit_and_step_kernels_match_twin_on_card(cuda_scene):
    from pvtrace_tpu_torch.kernels import check

    state, rep = check.check_emit(cuda_scene, rng.key_words(1), 1 << 16, reps=2)
    assert rep["max_abs_err"] <= 1e-5
    rep = check.check_step(cuda_scene, state, steps=8, reps=2)
    assert rep["discrete_frac"] <= 1e-4


@pytest.mark.gpu
def test_trace_kernel_matches_twin_on_card(cuda_scene):
    from pvtrace_tpu_torch.kernels import check

    rep = check.check_trace(cuda_scene, rng.key_words(1), 1 << 16, lanes=1 << 14)
    assert sum(rep["fates"]) == 1 << 16


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
