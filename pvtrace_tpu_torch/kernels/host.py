"""The device code of ``csrc/tracer.cuh`` built for the host CPU.

Every device function of the kernels is host-callable (``PVT_FN``), so a
host C++ compiler can build them into a small library with a plain C
interface, one loop per kernel body over the lanes. The CPU tests hold
it to the eager twins: the one check of the kernels' arithmetic that
runs without a card. Built with ``-ffp-contract=off``: the host code
rounds every operation, as the twin does.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

from pvtrace_tpu_torch.kernels import build

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
void h_cheb(const PvtScene* sc, int n_fits, const float* t, long long n_t, float* out) {
  for (int f = 0; f < n_fits; ++f)
    for (long long j = 0; j < n_t; ++j) out[f * n_t + j] = cheb_eval(*sc, f, t[j]);
}
void h_tally(const PvtScene* sc, const PvtState* s, const PvtFlags* fl, unsigned* seen,
             long long B, unsigned long long* cross, float* sums, unsigned* distinct,
             unsigned long long* bins, double* sums64) {
  const PvtTally acc = {cross, sums, distinct, nullptr, bins, sums64};
  for (long long i = 0; i < B; ++i) tally_lane(*sc, *s, *fl, seen, i, acc);
}
void h_trace(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
             unsigned long long total, long long* fates) {
  FateCounts f = {0, 0, 0, 0, 0, 0};
  for (unsigned long long id = off; id < total; ++id)
    trace_photon<false>(*sc, s0, s1, (uint32_t)id, f, nullptr);
  fates[7] += f.exit; fates[4] += f.nonrad; fates[8] += f.react;
  fates[9] += f.kill; fates[10] += f.no_hit;
}
}
"""


def compiler():
    """The host C++ compiler, or None."""
    return shutil.which("g++")


def build_library(directory):
    """Build the harness in `directory` and load it with its argtypes."""
    src = Path(directory) / "harness.cpp"
    src.write_text(HARNESS)
    lib = src.with_suffix(".so")
    subprocess.run(
        [compiler(), "-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         "-I", str(build.CSRC), "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=300,
    )
    h = ctypes.CDLL(str(lib))
    vp, u32, u64, i32, i64 = (
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_longlong
    )
    h.h_emit.argtypes = [vp, u32, u32, u64, i64, vp]
    h.h_step.argtypes = [vp, vp, vp, vp, i64]
    h.h_cheb.argtypes = [vp, i32, vp, i64, vp]
    h.h_tally.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp, vp, vp]
    h.h_trace.argtypes = [vp, u32, u32, u64, u64, vp]
    for fn in (h.h_emit, h.h_step, h.h_cheb, h.h_tally, h.h_trace):
        fn.restype = None
    return h
