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

import torch

from pvtrace_tpu_torch.kernels import build

HARNESS = r"""
#include "tracer.cuh"
#include "diff.cuh"
template <bool kTally, bool kLog, bool kPath>
void h_trace_score_t(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                     unsigned long long total, const PvtLog* lg, FateCounts& f,
                     const PvtTally* acc, const ScoreAcc* sa, const PvtBundle& b) {
  for (unsigned long long id = off; id < total; ++id) {
    if (b.rows)
      trace_photon<kTally, kLog, true, true, kPath, true>(*sc, sc->cheb_pack, s0, s1,
                                                          (uint32_t)id, f, acc, lg, sa, b);
    else
      trace_photon<kTally, kLog, true, true, kPath>(*sc, sc->cheb_pack, s0, s1, (uint32_t)id, f,
                                                    acc, lg, sa, b);
  }
}
template <bool kPath>
void h_trace_score_p(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                     unsigned long long total, const PvtLog* lg, FateCounts& f,
                     const PvtTally* acc, const ScoreAcc* sa, const PvtBundle& b) {
  if (sc->n_rec > 0) {
    if (lg->n_slots > 0) h_trace_score_t<true, true, kPath>(sc, s0, s1, off, total, lg, f, acc, sa, b);
    else h_trace_score_t<true, false, kPath>(sc, s0, s1, off, total, lg, f, acc, sa, b);
  } else {
    if (lg->n_slots > 0) h_trace_score_t<false, true, kPath>(sc, s0, s1, off, total, lg, f, acc, sa, b);
    else h_trace_score_t<false, false, kPath>(sc, s0, s1, off, total, lg, f, acc, sa, b);
  }
}
// The host bundle `b` or none (emission).
PvtBundle h_bundle(const PvtBundle* b) {
  const PvtBundle none = {nullptr, 0, 0};
  return b ? *b : none;
}
extern "C" {
void h_emit(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
            long long B, const PvtState* out) {
  for (long long i = 0; i < B; ++i) emit_lane(*sc, s0, s1, off, i, *out);
}
void h_step(const PvtScene* sc, const PvtState* in, const PvtState* out,
            const PvtFlags* fl, long long B) {
  for (long long i = 0; i < B; ++i) step_lane(*sc, *in, *out, *fl, i);
}
void h_cheb_seg(const PvtScene* sc, int n_fits, const float* t, long long n_t, float* out,
                int* seg) {
  for (int f = 0; f < n_fits; ++f)
    for (long long j = 0; j < n_t; ++j) cheb_lane(sc->cheb_pack, f, t[j], f * n_t + j, out, seg);
}
void h_cheb(const PvtScene* sc, int n_fits, const float* t, long long n_t, float* out) {
  h_cheb_seg(sc, n_fits, t, n_t, out, nullptr);
}
void h_tally(const PvtScene* sc, const PvtState* s, const PvtFlags* fl, unsigned* seen,
             long long B, unsigned long long* cross, float* sums, unsigned* distinct,
             unsigned long long* bins, double* sums64) {
  const PvtTally acc = {cross, sums, distinct, nullptr, bins, sums64};
  for (long long i = 0; i < B; ++i) tally_lane(*sc, *s, *fl, seen, i, acc);
}
void h_trace_bundle(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                    unsigned long long total, const PvtLog* lg, long long* fates,
                    const PvtBundle* bundle) {
  FateCounts f = {0, 0, 0, 0, 0, 0};
  const PvtBundle b = h_bundle(bundle);
  for (unsigned long long id = off; id < total; ++id) {
    const uint32_t pid = (uint32_t)id;
    if (lg->n_slots > 0 && b.rows)
      trace_photon<false, true, true, false, false, true>(*sc, sc->cheb_pack, s0, s1, pid, f,
                                                         nullptr, lg, nullptr, b);
    else if (lg->n_slots > 0)
      trace_photon<false, true, true>(*sc, sc->cheb_pack, s0, s1, pid, f, nullptr, lg, nullptr,
                                      b);
    else if (b.rows)
      trace_photon<false, false, true, false, false, true>(*sc, sc->cheb_pack, s0, s1, pid, f,
                                                           nullptr, nullptr, nullptr, b);
    else
      trace_photon<false, false, true>(*sc, sc->cheb_pack, s0, s1, pid, f, nullptr, nullptr,
                                       nullptr, b);
  }
  fates[7] += f.exit; fates[4] += f.nonrad; fates[8] += f.react;
  fates[9] += f.kill; fates[10] += f.no_hit;
}
void h_trace(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
             unsigned long long total, const PvtLog* lg, long long* fates) {
  h_trace_bundle(sc, s0, s1, off, total, lg, fates, nullptr);
}
void h_mesh(const float* tri, int n_tris, float eps, const float* o, const float* d,
            long long B, float* t1, float* t2, int* cnt, float* nrm) {
  for (long long i = 0; i < B; ++i) mesh_lane(tri, n_tris, eps, o, d, i, t1, t2, cnt, nrm);
}
void h_score(const PvtScene* sc, const PvtState* in, const PvtState* out, const PvtFlags* fl,
             long long B, float* rows, int ch, int n_comps, double* fate_scores, int* comp) {
  for (long long i = 0; i < B; ++i) {
    const ScoreAcc sa = {rows + i, fate_scores, nullptr, B, ch, n_comps, 0};
    score_lane(*sc, *in, *out, *fl, i, sa, comp);
  }
}
// The photons' score rows and tangents at row[c * stride] and
// tang[k * stride], as a thread's column of a launch's rows (stride its
// threads) or of a block's shared copy (stride kBlock).
void h_trace_score_rows(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                        unsigned long long total, const PvtLog* lg, long long* fates,
                        unsigned long long* cross, float* sums, unsigned* distinct,
                        unsigned long long* bins, double* sums64, float* row, int ch,
                        int n_comps, double* fate_scores, double* rec_scores, float* photon,
                        float* tang, const int* path, int n_path, const PvtBundle* bundle,
                        long long stride) {
  FateCounts f = {0, 0, 0, 0, 0, 0};
  const PvtTally acc = {cross, sums, distinct, nullptr, bins, sums64};
  const ScoreAcc sa = {row, fate_scores, rec_scores, stride, ch, n_comps, sc->n_rec, photon,
                       (long long)total, tang, path, n_path};
  const PvtBundle b = h_bundle(bundle);
  if (n_path > 0) h_trace_score_p<true>(sc, s0, s1, off, total, lg, f, &acc, &sa, b);
  else h_trace_score_p<false>(sc, s0, s1, off, total, lg, f, &acc, &sa, b);
  fates[7] += f.exit; fates[4] += f.nonrad; fates[8] += f.react;
  fates[9] += f.kill; fates[10] += f.no_hit;
}
void h_trace_score_bundle(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                   unsigned long long total, const PvtLog* lg, long long* fates,
                   unsigned long long* cross, float* sums, unsigned* distinct,
                   unsigned long long* bins, double* sums64, float* row, int ch, int n_comps,
                   double* fate_scores, double* rec_scores, float* photon, float* tang,
                   const int* path, int n_path, const PvtBundle* bundle) {
  h_trace_score_rows(sc, s0, s1, off, total, lg, fates, cross, sums, distinct, bins, sums64, row,
                     ch, n_comps, fate_scores, rec_scores, photon, tang, path, n_path, bundle, 1);
}
void h_trace_score(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                   unsigned long long total, const PvtLog* lg, long long* fates,
                   unsigned long long* cross, float* sums, unsigned* distinct,
                   unsigned long long* bins, double* sums64, float* row, int ch, int n_comps,
                   double* fate_scores, double* rec_scores, float* photon, float* tang,
                   const int* path, int n_path) {
  h_trace_score_bundle(sc, s0, s1, off, total, lg, fates, cross, sums, distinct, bins, sums64,
                       row, ch, n_comps, fate_scores, rec_scores, photon, tang, path, n_path,
                       nullptr);
}
// pvt_layout's twin (tracer.cu).
void h_layout(const PvtScene* sc, int tally, const PvtScore* score, long long* info) {
  layout_info(trace_layout(*sc, tally != 0, score), info);
}
void h_pathwise(const PvtScene* sc, const PvtState* in, const PvtState* out, const PvtFlags* fl,
                long long B, const PvtPath* pw, int* comp) {
  for (long long i = 0; i < B; ++i) pathwise_lane(*sc, *in, *out, *fl, i, B, *pw, comp);
}
void h_fresnel(const float* n1, const float* n2, const float* c, long long n, float* d1,
               float* d2) {
  for (long long i = 0; i < n; ++i) {
    float d[2];
    fresnel_dR(n1[i], n2[i], c[i], d);
    d1[i] = d[0];
    d2[i] = d[1];
  }
}
void h_absorbed(const PvtAbsorbers* a, const float* pos, const float* dir, const float* wav,
                const float* c, long long P, float* w, float* depth, const float* grad_w,
                float* grad) {
  for (long long i = 0; i < P; ++i) {
    absorbed_lane(*a, pos, dir, wav, c, i, w, depth);
    grad[i] = absorbed_grad_lane(depth, grad_w, *c, i);
  }
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
    h.h_cheb_seg.argtypes = h.h_cheb.argtypes + [vp]
    h.h_tally.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp, vp, vp]
    h.h_trace.argtypes = [vp, u32, u32, u64, u64, vp, vp]
    h.h_trace_bundle.argtypes = h.h_trace.argtypes + [vp]
    h.h_mesh.argtypes = [vp, i32, ctypes.c_float, vp, vp, i64, vp, vp, vp, vp]
    h.h_score.argtypes = [vp, vp, vp, vp, i64, vp, i32, i32, vp, vp]
    h.h_trace_score.argtypes = [vp, u32, u32, u64, u64, vp, vp, vp, vp, vp, vp, vp, vp, i32,
                                i32, vp, vp, vp, vp, vp, i32]
    h.h_trace_score_bundle.argtypes = h.h_trace_score.argtypes + [vp]
    h.h_trace_score_rows.argtypes = h.h_trace_score_bundle.argtypes + [i64]
    h.h_layout.argtypes = [vp, i32, vp, vp]
    h.h_pathwise.argtypes = [vp, vp, vp, vp, i64, vp, vp]
    h.h_fresnel.argtypes = [vp, vp, vp, i64, vp, vp]
    h.h_absorbed.argtypes = [vp, vp, vp, vp, vp, i64, vp, vp, vp, vp]
    for fn in (h.h_emit, h.h_step, h.h_cheb, h.h_cheb_seg, h.h_tally, h.h_trace,
               h.h_trace_bundle, h.h_mesh, h.h_score, h.h_trace_score, h.h_trace_score_bundle,
               h.h_trace_score_rows, h.h_layout, h.h_pathwise, h.h_fresnel, h.h_absorbed):
        fn.restype = None
    return h


def trace_score_records(h, st, seed_words, n, pathwise=(), stride=1):
    """``trace_photon`` with scores (and the resolved `pathwise` specs)
    built for the host (`h`, ``build_library``'s), photons [0, n) of the
    float32 CPU scene tensors `st`, each photon's rows at `stride` (as a
    thread's column of a launch's rows, or of a block's shared copy):
    (fates [11] int64, records [CH + 2, n] float32: each photon's scores,
    fate and steps, the folds' float64 fate_scores [2, 11, CH]: signed sums,
    then magnitudes)."""
    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.engine import score, tables

    C = len(pathwise)
    CH, R = score.n_channels(st, C), max(st["meta"]["n_rec"], 1)
    _, log = kernels.empty_log(n, 0, 6, 0, "cpu")
    fates = torch.zeros(11, dtype=torch.int64)
    cross = torch.zeros(R, dtype=torch.int64)
    bins = torch.zeros(max(st["meta"]["total_bins"], 1), dtype=torch.int64)
    distinct, sums = torch.zeros(R, dtype=torch.int32), torch.zeros(8 * R)
    sums64 = torch.zeros(8 * R, dtype=torch.float64)
    row, tang = torch.zeros(CH * stride), torch.zeros(max(7 * C, 1) * stride)
    fate_scores = torch.zeros((2, 11, CH), dtype=torch.float64)
    rec_scores = torch.zeros((2, R, CH), dtype=torch.float64)
    photon = torch.zeros((CH + 2, n))
    table = tables.pathwise_table(pathwise)
    h.h_trace_score_rows(
        ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed_words[0], seed_words[1], 0,
        n, ctypes.byref(log), fates.data_ptr(), cross.data_ptr(), sums.data_ptr(),
        distinct.data_ptr(), bins.data_ptr(), sums64.data_ptr(), row.data_ptr(), CH,
        st["meta"]["n_comps"], fate_scores.data_ptr(), rec_scores.data_ptr(), photon.data_ptr(),
        tang.data_ptr(), table.data_ptr(), C, None, stride,
    )
    return fates, photon, fate_scores

