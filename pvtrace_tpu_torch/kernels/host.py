"""The device code of ``csrc/tracer.cuh`` built for the host CPU.

Every device function of the kernels is host-callable (``PVT_FN``), so a
host C++ compiler can build them into a small library with a plain C
interface, one loop per kernel body over the lanes. The CPU tests hold
it to the eager twins: the one check of the kernels' arithmetic that
runs without a card. Built with ``-ffp-contract=off``: the host code
rounds every operation, as the twin does. ``build_library(f64=True)``
builds it with ``-DPVT_F64``, as the card's float64 libraries
(``tracer_f64``, ``score_f64``, ``pathwise_f64``, ``diff_f64``) are
built: every real a double (the entries' real arguments and the scene and
absorber descriptors' reals too, ``kernels._Scene64``,
``kernels._Absorbers64``).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from pvtrace_tpu_torch.kernels import build

HARNESS = r"""
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
// pvt_trace's step with the float64 main path's arithmetic (main_step:
// sincos) on lane i, as step_lane takes it, with its uniforms held as U:
// without recorders, the log or meshes (the main path's), or with them as
// kTally, kLog, kMesh (the steps of the kernels with the event log or
// from a host bundle).
template <typename U, bool kTally = false, bool kLog = false, bool kMesh = false>
void step_main_lane(const PvtScene& sc, const PvtState& in, const PvtState& out,
                    const PvtFlags& fl, long long i) {
  Photon p;
  load_lane(in, i, p);
  p.count += p.alive ? 1 : 0;
  const uint32_t k0 = (uint32_t)in.k0[i], k1 = (uint32_t)in.k1[i];
  U u[8];
  pvt_draw(k0, k1, (uint32_t)p.count, 0u, 4, u);
  StepOut o;
  step_one<kTally, kLog, kMesh, false, false, false, U, true>(sc, sc.cheb_pack, p, u, o);
  store_lane(out, i, p, k0, k1);
  store_flags(fl, i, o);
}
// step_main_lane on lanes [0, B) with recorders, the log and meshes as bits 0-2 of `flags`.
template <typename U>
void step_main_lanes(const PvtScene* sc, const PvtState* in, const PvtState* out,
                     const PvtFlags* fl, long long B, int flags) {
  typedef void (*Lane)(const PvtScene&, const PvtState&, const PvtState&, const PvtFlags&,
                       long long);
  const Lane lanes[8] = {step_main_lane<U, false, false, false>,
                         step_main_lane<U, true, false, false>,
                         step_main_lane<U, false, true, false>,
                         step_main_lane<U, true, true, false>,
                         step_main_lane<U, false, false, true>,
                         step_main_lane<U, true, false, true>,
                         step_main_lane<U, false, true, true>,
                         step_main_lane<U, true, true, true>};
  for (long long i = 0; i < B; ++i) lanes[flags & 7](*sc, *in, *out, *fl, i);
}
// pvt_sin and pvt_cos out of line, so that the compiler does not fuse a
// pair of them into a sincos of its own.
__attribute__((noinline)) pvt_real h_sin1(pvt_real x) { return pvt_sin(x); }
__attribute__((noinline)) pvt_real h_cos1(pvt_real x) { return pvt_cos(x); }
// The host bundle `b` or none (emission).
PvtBundle h_bundle(const PvtBundle* b) {
  const PvtBundle none = {nullptr, 0, 0};
  return b ? *b : none;
}
// Photons [off, total): with warps > 0 through trace_warps (pvt_trace's
// loop, `warps` warps of 32 lanes, lane k's rows at sa[k]), else one
// photon at a time through trace_photon (rows at sa[0]); with kMesh where
// the scene has triangles, as the card's launch picks it. out gets the
// steps in all, the lane-steps (warps only) and the longest photon.
template <bool kTally, bool kLog, bool kScore, bool kPath, bool kBundle, bool kMesh>
void h_warp_m(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
              unsigned long long total, int warps, const PvtLog* lg, FateCounts& f,
              const PvtTally* acc, const ScoreAcc* sa, const PvtBundle& b,
              unsigned long long* out, unsigned* started) {
  if (warps > 0) {
    unsigned long long next = off;
    out[2] = (unsigned long long)trace_warps<kTally, kLog, kMesh, kScore, kPath, kBundle>(
        *sc, sc->cheb_pack, s0, s1, &next, total, warps, f, acc, lg, sa, b, out + 1, started,
        off);
  } else {
    for (unsigned long long id = off; id < total; ++id) {
      const int steps = trace_photon<kTally, kLog, kMesh, kScore, kPath, kBundle>(
          *sc, sc->cheb_pack, s0, s1, (uint32_t)id, f, acc, lg, sa, b);
      if ((unsigned long long)steps > out[2]) out[2] = (unsigned long long)steps;
      if (started) started[id - off] += 1;
    }
  }
  out[0] = f.steps;
}
template <bool kTally, bool kLog, bool kScore, bool kPath, bool kBundle>
void h_warp_t(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
              unsigned long long total, int warps, const PvtLog* lg, FateCounts& f,
              const PvtTally* acc, const ScoreAcc* sa, const PvtBundle& b,
              unsigned long long* out, unsigned* started) {
  if (sc->n_tris > 0)
    h_warp_m<kTally, kLog, kScore, kPath, kBundle, true>(sc, s0, s1, off, total, warps, lg, f,
                                                         acc, sa, b, out, started);
  else
    h_warp_m<kTally, kLog, kScore, kPath, kBundle, false>(sc, s0, s1, off, total, warps, lg, f,
                                                          acc, sa, b, out, started);
}
template <bool kTally, bool kLog, bool kScore, bool kPath>
void h_warp_b(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
              unsigned long long total, int warps, const PvtLog* lg, FateCounts& f,
              const PvtTally* acc, const ScoreAcc* sa, const PvtBundle& b,
              unsigned long long* out, unsigned* started) {
  if (b.rows)
    h_warp_t<kTally, kLog, kScore, kPath, true>(sc, s0, s1, off, total, warps, lg, f, acc, sa, b,
                                                out, started);
  else
    h_warp_t<kTally, kLog, kScore, kPath, false>(sc, s0, s1, off, total, warps, lg, f, acc, sa,
                                                 b, out, started);
}
template <bool kTally, bool kLog>
void h_warp_s(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
              unsigned long long total, int warps, const PvtLog* lg, FateCounts& f,
              const PvtTally* acc, const ScoreAcc* sa, const PvtBundle& b,
              unsigned long long* out, unsigned* started) {
  if (!sa)
    h_warp_b<kTally, kLog, false, false>(sc, s0, s1, off, total, warps, lg, f, acc, sa, b, out,
                                         started);
  else if (sa->n_path > 0)
    h_warp_b<kTally, kLog, true, true>(sc, s0, s1, off, total, warps, lg, f, acc, sa, b, out,
                                       started);
  else
    h_warp_b<kTally, kLog, true, false>(sc, s0, s1, off, total, warps, lg, f, acc, sa, b, out,
                                        started);
}
extern "C" {
void h_emit(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
            long long B, const PvtState* out) {
  for (long long i = 0; i < B; ++i) emit_lane(*sc, s0, s1, off, i, *out);
}
// h_emit with the emission pairs of `need` in place of the scene's
// (emit_pairs): 7 draws all three, as the JAX package does.
void h_emit_need(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                 long long B, unsigned need, const PvtState* out) {
  for (long long i = 0; i < B; ++i) {
    const uint32_t pid = (uint32_t)(off + (unsigned long long)i);
    uint32_t k0, k1;
    threefry(s0, s1, pid, 0u, k0, k1);
    Photon p;
    emit_one(*sc, sc->cheb_pack, k0, k1, pid, need, p);
    store_lane(*out, i, p, k0, k1);
  }
}
// The emission pairs lamp li reads (light_pairs) and the scene's
// (emit_pairs), as the kernels find them.
unsigned h_light_pairs(const PvtScene* sc, int li) {
  return light_pairs(sc->light_i + li * LIGHT_I);
}
unsigned h_emit_pairs(const PvtScene* sc) { return emit_pairs(*sc); }
void h_step(const PvtScene* sc, const PvtState* in, const PvtState* out,
            const PvtFlags* fl, long long B) {
  for (long long i = 0; i < B; ++i) step_lane(*sc, *in, *out, *fl, i);
}
void h_cheb_seg(const PvtScene* sc, int n_fits, const pvt_real* t, long long n_t, pvt_real* out,
                int* seg) {
  for (int f = 0; f < n_fits; ++f)
    for (long long j = 0; j < n_t; ++j) cheb_lane(sc->cheb_pack, f, t[j], f * n_t + j, out, seg);
}
void h_cheb(const PvtScene* sc, int n_fits, const pvt_real* t, long long n_t, pvt_real* out) {
  h_cheb_seg(sc, n_fits, t, n_t, out, nullptr);
}
// The angles at which pvt_sincos differs from pvt_sin and pvt_cos in any
// bit, of the n that variants.py's --sincos takes on the card (wide 0:
// 2 pi u, u = i 2^-23 in float32; 1: spread over [-1e6, 1e6]).
long long h_sincos_differ(long long n, int wide) {
  long long bad = 0;
  for (long long i = 0; i < n; ++i) {
    const pvt_real phi = wide ? (i - n / 2) * (2e6 / n) + 1e-3 * (i % 7)
                              : PVT_TWO_PI * (pvt_real)((float)i * 1.1920928955078125e-7f);
    pvt_real sn, cs;
    pvt_sincos(phi, &sn, &cs);
    const pvt_real s1 = h_sin1(phi), c1 = h_cos1(phi);
    bad += memcmp(&sn, &s1, sizeof sn) != 0 || memcmp(&cs, &c1, sizeof cs) != 0;
  }
  return bad;
}
// h_emit through the float64 main path's start (emit_one<true>).
void h_emit_main(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                 long long B, const PvtState* out) {
  const unsigned need = emit_pairs(*sc);
  for (long long i = 0; i < B; ++i) {
    const uint32_t pid = (uint32_t)(off + (unsigned long long)i);
    uint32_t k0, k1;
    threefry(s0, s1, pid, 0u, k0, k1);
    Photon p;
    emit_one<true>(*sc, sc->cheb_pack, k0, k1, pid, need, p);
    store_lane(*out, i, p, k0, k1);
  }
}
// h_step through the float64 main path's step (step_main_lane), its
// uniforms held as floats (`f32`) or as pvt_real, with recorders, the log
// and meshes as bits 0-2 of `flags` (0: the main path's own; else the step
// of a kernel with the event log or from a host bundle).
void h_step_main(const PvtScene* sc, const PvtState* in, const PvtState* out, const PvtFlags* fl,
                 long long B, int f32, int flags) {
  if (f32)
    step_main_lanes<float>(sc, in, out, fl, B, flags);
  else
    step_main_lanes<pvt_real>(sc, in, out, fl, B, flags);
}
void h_tally(const PvtScene* sc, const PvtState* s, const PvtFlags* fl, unsigned* seen,
             long long B, unsigned long long* cross, pvt_real* sums, unsigned* distinct,
             unsigned long long* bins, double* sums64) {
  const PvtTally acc = {cross, sums, distinct, nullptr, bins, sums64};
  for (long long i = 0; i < B; ++i) tally_lane(*sc, *s, *fl, seen, i, acc);
}
// pvt_tally's warp rule: lanes [w kWarp, (w + 1) kWarp) of the B lanes
// as one warp (tally_warp_host), in turn; h_tally's arguments.
void h_tally_warp(const PvtScene* sc, const PvtState* s, const PvtFlags* fl, unsigned* seen,
                  long long B, unsigned long long* cross, pvt_real* sums, unsigned* distinct,
                  unsigned long long* bins, double* sums64) {
  const PvtTally acc = {cross, sums, distinct, nullptr, bins, sums64};
  for (long long w = 0; w * kWarp < B; ++w) {
    StepOut o[kWarp];
    Photon p[kWarp];
    Seen bits[kWarp];
    uint32_t events = 0u;
    for (int l = 0; l < kWarp; ++l) {
      const long long i = w * kWarp + l;
      if (i >= B) continue;
      tally_lane_load(*sc, *s, *fl, seen, i, o[l], p[l], bits[l]);
      events |= 1u << l;
    }
    tally_warp_host(*sc, acc, bits, o, p, events);
    for (int l = 0; l < kWarp && w * kWarp + l < B; ++l)
      seen_to_words(*sc, bits[l], seen + (w * kWarp + l) * SEEN_WORDS);
  }
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
    else if (b.rows && sc->n_tris > 0)
      trace_photon<false, false, true, false, false, true>(*sc, sc->cheb_pack, s0, s1, pid, f,
                                                           nullptr, nullptr, nullptr, b);
    else if (b.rows)  // no mesh: kMesh false, as the card's launch picks it
      trace_photon<false, false, false, false, false, true>(*sc, sc->cheb_pack, s0, s1, pid, f,
                                                            nullptr, nullptr, nullptr, b);
    else if (sc->n_tris > 0)
      trace_photon<false, false, true>(*sc, sc->cheb_pack, s0, s1, pid, f, nullptr, nullptr,
                                       nullptr, b);
    else
      trace_photon<false, false, false>(*sc, sc->cheb_pack, s0, s1, pid, f, nullptr, nullptr,
                                        nullptr, b);
  }
  fates[7] += f.exit; fates[4] += f.nonrad; fates[8] += f.react;
  fates[9] += f.kill; fates[10] += f.no_hit;
}
void h_trace(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
             unsigned long long total, const PvtLog* lg, long long* fates) {
  h_trace_bundle(sc, s0, s1, off, total, lg, fates, nullptr);
}
// pvt_mesh; with `staged` the triangles are read from a copy, as a block
// of the card reads its shared one.
void h_mesh(const pvt_real* tri, int n_tris, int staged, pvt_real eps, const pvt_real* o,
            const pvt_real* d, long long B, pvt_real* t1, pvt_real* t2, int* cnt, pvt_real* nrm) {
  const std::vector<pvt_real> copy(tri, tri + (size_t)n_tris * TRI_F);
  const pvt_real* tris = staged ? copy.data() : tri;
  for (long long i = 0; i < B; ++i) mesh_lane(tris, tri, n_tris, eps, o, d, i, t1, t2, cnt, nrm);
}
void h_score(const PvtScene* sc, const PvtState* in, const PvtState* out, const PvtFlags* fl,
             long long B, pvt_real* rows, int ch, int n_comps, double* fate_scores, int* comp) {
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
                        unsigned long long* cross, pvt_real* sums, unsigned* distinct,
                        unsigned long long* bins, double* sums64, pvt_real* row, int ch,
                        int n_comps, double* fate_scores, double* rec_scores, pvt_real* photon,
                        pvt_real* tang, const int* path, int n_path, const PvtBundle* bundle,
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
                   unsigned long long* cross, pvt_real* sums, unsigned* distinct,
                   unsigned long long* bins, double* sums64, pvt_real* row, int ch, int n_comps,
                   double* fate_scores, double* rec_scores, pvt_real* photon, pvt_real* tang,
                   const int* path, int n_path, const PvtBundle* bundle) {
  h_trace_score_rows(sc, s0, s1, off, total, lg, fates, cross, sums, distinct, bins, sums64, row,
                     ch, n_comps, fate_scores, rec_scores, photon, tang, path, n_path, bundle, 1);
}
void h_trace_score(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                   unsigned long long total, const PvtLog* lg, long long* fates,
                   unsigned long long* cross, pvt_real* sums, unsigned* distinct,
                   unsigned long long* bins, double* sums64, pvt_real* row, int ch, int n_comps,
                   double* fate_scores, double* rec_scores, pvt_real* photon, pvt_real* tang,
                   const int* path, int n_path) {
  h_trace_score_bundle(sc, s0, s1, off, total, lg, fates, cross, sums, distinct, bins, sums64,
                       row, ch, n_comps, fate_scores, rec_scores, photon, tang, path, n_path,
                       nullptr);
}
// The trace of photons [off, total) through pvt_trace's loop on `warps`
// emulated warps (0: one photon at a time, trace_photon), with recorders
// when sc->n_rec > 0, the log when lg->n_slots > 0, score channels when
// `rows` is set (n_path of them pathwise; lane k's score and tangent rows
// at rows + k and tang + k, stride max(32 warps, 1)), from `bundle` when
// it is set: fates, tallies and scores as h_trace_score_rows's; out [3]
// the steps in all, the lane-steps and the longest photon; started [n]
// (may be null) each photon's starts.
void h_trace_warp(const PvtScene* sc, unsigned s0, unsigned s1, unsigned long long off,
                  unsigned long long total, int warps, const PvtLog* lg, long long* fates,
                  unsigned long long* cross, pvt_real* sums, unsigned* distinct,
                  unsigned long long* bins, double* sums64, pvt_real* rows, int ch, int n_comps,
                  double* fate_scores, double* rec_scores, pvt_real* photon, pvt_real* tang,
                  const int* path, int n_path, const PvtBundle* bundle, unsigned long long* out,
                  unsigned* started) {
  FateCounts f = {0, 0, 0, 0, 0, 0};
  const PvtTally acc = {cross, sums, distinct, nullptr, bins, sums64};
  const long long stride = warps > 0 ? 32LL * warps : 1;
  std::vector<ScoreAcc> sa;
  for (long long k = 0; rows && k < stride; ++k)
    sa.push_back({rows + k, fate_scores, rec_scores, stride, ch, n_comps, sc->n_rec, photon,
                  (long long)(total - off), tang ? tang + k : nullptr, path, n_path});
  const ScoreAcc* sap = rows ? sa.data() : nullptr;
  const PvtBundle b = h_bundle(bundle);
  out[0] = out[1] = out[2] = 0;
  if (sc->n_rec > 0) {
    if (lg->n_slots > 0) h_warp_s<true, true>(sc, s0, s1, off, total, warps, lg, f, &acc, sap, b, out, started);
    else h_warp_s<true, false>(sc, s0, s1, off, total, warps, lg, f, &acc, sap, b, out, started);
  } else {
    if (lg->n_slots > 0) h_warp_s<false, true>(sc, s0, s1, off, total, warps, lg, f, &acc, sap, b, out, started);
    else h_warp_s<false, false>(sc, s0, s1, off, total, warps, lg, f, &acc, sap, b, out, started);
  }
  fates[7] += f.exit; fates[4] += f.nonrad; fates[8] += f.react;
  fates[9] += f.kill; fates[10] += f.no_hit;
}
// pvt_draws' twin (tracer.cu): each kWarp lanes an emulated warp.
void h_draws(unsigned s0, unsigned s1, const long long* base, const unsigned char* dead,
             unsigned need, const long long* k0, const long long* k1, const int* count,
             const unsigned char* mask, long long B, long long* keys, pvt_real* emit,
             pvt_real* words, int* calls) {
  for (long long w = 0; w < B / kWarp; ++w)
    draws_warp(s0, s1, base, dead, need, k0, k1, count, mask, w, keys, emit, words, calls);
}
// pvt_log_pack's twin (tracer.cu): slot s as one emulated warp, its
// kWarp lanes in turn (log_pack_slot).
void h_log_pack(const PvtLog* lg, const long long* offsets, int* ints, pvt_real* floats) {
  for (long long s = 0; s < lg->n_slots; ++s)
    for (int lane = 0; lane < kWarp; ++lane)
      log_pack_slot(*lg, s, offsets[s], lane, kWarp, ints, floats);
}
// pvt_layout's twin (tracer.cu).
void h_layout(const PvtScene* sc, int tally, const PvtScore* score, long long* info, int log,
              int bundle) {
  layout_info(trace_layout(*sc, tally != 0, score, log != 0, bundle != 0), info);
  info[7] = trace_shape(tally != 0, log != 0, sc->n_tris > 0, score != nullptr,
                        bundle != 0).threads;
}
// The build's block shapes and shared budgets: kBlock, kScoreBlock,
// kMinBlocksF64, kSharedTallyLimit, kSharedLimitF64, then trace_shape's
// threads, blocks an SM and budget of five launches: with none of
// recorders, meshes or scores; with scores; with recorders; with meshes;
// with recorders and the event log.
void h_block_shape(long long* out) {
  out[0] = kBlock;
  out[1] = kScoreBlock;
  out[2] = kMinBlocksF64;
  out[3] = (long long)kSharedTallyLimit;
  out[4] = (long long)kSharedLimitF64;
  const TraceShape shapes[5] = {
      trace_shape(false, false, false, false, false), trace_shape(false, false, false, true, false),
      trace_shape(true, false, false, false, false), trace_shape(false, false, true, false, false),
      trace_shape(true, true, false, false, false)};
  for (int k = 0; k < 5; ++k) {
    out[5 + 3 * k] = shapes[k].threads;
    out[6 + 3 * k] = shapes[k].blocks;
    out[7 + 3 * k] = (long long)shapes[k].limit;
  }
}
void h_pathwise(const PvtScene* sc, const PvtState* in, const PvtState* out, const PvtFlags* fl,
                long long B, const PvtPath* pw, int* comp) {
  for (long long i = 0; i < B; ++i) pathwise_lane(*sc, *in, *out, *fl, i, B, *pw, comp);
}
void h_fresnel(const pvt_real* n1, const pvt_real* n2, const pvt_real* c, long long n, pvt_real* d1,
               pvt_real* d2) {
  for (long long i = 0; i < n; ++i) {
    pvt_real d[2];
    fresnel_dR(n1[i], n2[i], c[i], d);
    d1[i] = d[0];
    d2[i] = d[1];
  }
}
void h_absorbed(const PvtAbsorbers* a, const pvt_real* pos, const pvt_real* dir,
                const pvt_real* wav, const pvt_real* c, long long P, pvt_real* w,
                pvt_real* depth, const pvt_real* grad_w, pvt_real* grad) {
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


def build_library(directory, f64=False):
    """Build the harness in `directory` and load it with its argtypes;
    with `f64`, the float64 build (``h.f64`` says which)."""
    name = "harness_f64" if f64 else "harness"
    src = Path(directory) / f"{name}.cpp"
    src.write_text(HARNESS)
    lib = src.with_suffix(".so")
    subprocess.run(
        [compiler(), "-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         *(["-DPVT_F64"] if f64 else []), "-I", str(build.CSRC), "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=300,
    )
    h = ctypes.CDLL(str(lib))
    h.f64 = f64
    real = ctypes.c_double if f64 else ctypes.c_float
    vp, u32, u64, i32, i64 = (
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_longlong
    )
    h.h_emit.argtypes = [vp, u32, u32, u64, i64, vp]
    h.h_emit_need.argtypes = [vp, u32, u32, u64, i64, u32, vp]
    h.h_light_pairs.argtypes = [vp, i32]
    h.h_emit_pairs.argtypes = [vp]
    h.h_light_pairs.restype = h.h_emit_pairs.restype = u32
    h.h_step.argtypes = [vp, vp, vp, vp, i64]
    h.h_cheb.argtypes = [vp, i32, vp, i64, vp]
    h.h_cheb_seg.argtypes = h.h_cheb.argtypes + [vp]
    h.h_emit_main.argtypes = h.h_emit.argtypes
    h.h_step_main.argtypes = h.h_step.argtypes + [i32, i32]
    h.h_sincos_differ.argtypes = [i64, i32]
    h.h_sincos_differ.restype = i64
    h.h_tally.argtypes = h.h_tally_warp.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp, vp, vp]
    h.h_trace.argtypes = [vp, u32, u32, u64, u64, vp, vp]
    h.h_trace_bundle.argtypes = h.h_trace.argtypes + [vp]
    h.h_mesh.argtypes = [vp, i32, i32, real, vp, vp, i64, vp, vp, vp, vp]
    h.h_score.argtypes = [vp, vp, vp, vp, i64, vp, i32, i32, vp, vp]
    h.h_trace_score.argtypes = [vp, u32, u32, u64, u64, vp, vp, vp, vp, vp, vp, vp, vp, i32,
                                i32, vp, vp, vp, vp, vp, i32]
    h.h_trace_score_bundle.argtypes = h.h_trace_score.argtypes + [vp]
    h.h_trace_score_rows.argtypes = h.h_trace_score_bundle.argtypes + [i64]
    h.h_trace_warp.argtypes = [vp, u32, u32, u64, u64, i32, vp, vp, vp, vp, vp, vp, vp, vp,
                               i32, i32, vp, vp, vp, vp, vp, i32, vp, vp, vp]
    h.h_layout.argtypes = [vp, i32, vp, vp, i32, i32]
    h.h_block_shape.argtypes = [vp]
    h.h_log_pack.argtypes = [vp, vp, vp, vp]
    h.h_draws.argtypes = [u32, u32, vp, vp, u32, vp, vp, vp, vp, i64, vp, vp, vp, vp]
    h.h_pathwise.argtypes = [vp, vp, vp, vp, i64, vp, vp]
    h.h_fresnel.argtypes = [vp, vp, vp, i64, vp, vp]
    h.h_absorbed.argtypes = [vp, vp, vp, vp, vp, i64, vp, vp, vp, vp]
    entries = [h.h_emit, h.h_emit_need, h.h_step, h.h_cheb, h.h_cheb_seg,
               h.h_emit_main, h.h_step_main, h.h_tally,
               h.h_tally_warp, h.h_trace, h.h_trace_bundle, h.h_mesh, h.h_score, h.h_trace_score,
               h.h_trace_score_bundle, h.h_trace_score_rows, h.h_trace_warp, h.h_layout,
               h.h_block_shape, h.h_log_pack, h.h_draws, h.h_pathwise, h.h_fresnel, h.h_absorbed]
    for fn in entries:
        fn.restype = None
    return h


def trace_scores(h, st, seed_words, n, pathwise=(), stride=1):
    """``trace_photon`` with scores (and the resolved `pathwise` specs)
    built for the host (`h`, ``build_library``'s, of the scene's dtype),
    photons [0, n) of the CPU scene tensors `st`, each photon's rows at
    `stride` (as a thread's column of a launch's rows, or of a block's
    shared copy): (fates [11] int64, a dict as ``kernels.trace(...,
    per_photon=True)`` gives it: ``fate_scores``, ``fate_abs``,
    ``rec_scores``, ``rec_abs`` (float64 sums: signed, then magnitudes),
    ``photon_scores`` [CH, n] in the scene's dtype, ``photon_fate``,
    ``photon_steps``, and the recorders' ``distinct``)."""
    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.engine import score, tables

    real = st["node_f"].dtype
    if (real == torch.float64) != h.f64:
        raise ValueError(f"{real} scene tensors need the harness of that build")
    C = len(pathwise)
    CH, R = score.n_channels(st, C), max(st["meta"]["n_rec"], 1)
    _, log = kernels.empty_log(n, 0, 6, 0, "cpu")
    fates = torch.zeros(11, dtype=torch.int64)
    cross = torch.zeros(R, dtype=torch.int64)
    bins = torch.zeros(max(st["meta"]["total_bins"], 1), dtype=torch.int64)
    distinct, sums = torch.zeros(R, dtype=torch.int32), torch.zeros(8 * R, dtype=real)
    sums64 = torch.zeros(8 * R, dtype=torch.float64)
    row = torch.zeros(CH * stride, dtype=real)
    tang = torch.zeros(max(7 * C, 1) * stride, dtype=real)
    fate_scores = torch.zeros((2, 11, CH), dtype=torch.float64)
    rec_scores = torch.zeros((2, R, CH), dtype=torch.float64)
    photon = torch.zeros((CH + 2, n), dtype=real)
    photon[CH] = -1.0  # a photon that never folds keeps fate -1
    table = tables.pathwise_table(pathwise)
    h.h_trace_score_rows(
        ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed_words[0], seed_words[1], 0,
        n, ctypes.byref(log), fates.data_ptr(), cross.data_ptr(), sums.data_ptr(),
        distinct.data_ptr(), bins.data_ptr(), sums64.data_ptr(), row.data_ptr(), CH,
        st["meta"]["n_comps"], fate_scores.data_ptr(), rec_scores.data_ptr(), photon.data_ptr(),
        tang.data_ptr(), table.data_ptr(), C, None, stride,
    )
    return fates, {"fate_scores": fate_scores[0], "fate_abs": fate_scores[1],
                   "rec_scores": rec_scores[0], "rec_abs": rec_scores[1],
                   "photon_scores": photon[:CH], "photon_fate": photon[CH].long(),
                   "photon_steps": photon[CH + 1].long(), "distinct": distinct.long(),
                   "records": photon, "folds": fate_scores}

