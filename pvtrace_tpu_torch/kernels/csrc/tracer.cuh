// Device functions shared by the kernels of tracer.cu.
//
// One photon per thread, all state in registers. Every function is a
// line-for-line port of the eager twin in pvtrace_tpu_torch/engine
// (rng.py, emit.py, geometry.py, spectral.py, chebyshev.py, physics.py,
// tally.py), which in turn ports pvtrace_tpu/engine/tracer.py. float32
// only; no fast-math: log1p, sqrt, exp, acos and division stay IEEE
// (nvcc's default FMA contraction moves results by ulps).
//
// The functions are also host-callable (PVT_FN), so the arithmetic can
// be compiled by a host C++ compiler and checked without a card.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PVT_FN __host__ __device__ __forceinline__
// A function called from many sites, kept out of line on the card: its
// code inlined at every site makes pvt_trace larger and slower on every
// path, K5b's included (an A/B build on the H100; PERF.md).
#define PVT_CALLED_FN __host__ __device__ __noinline__
#else
#define PVT_FN inline
#define PVT_CALLED_FN inline
#endif

// ---------------------------------------------------------------------
// Record layout: mirrors pvtrace_tpu_torch/engine/tables.py (a CPU test
// compares every #define below with the Python constant of that name).
#define NF_W2L 0
#define NF_L2W 12
#define NF_GP 21
#define NF_EPS 24
#define NF_NIDX 25
#define NODE_F 26

#define NI_GEOM 0
#define NI_SURF 1
#define NI_NCOMP 2
#define NI_COMP0 3
#define NI_OVR0 4
#define NI_NOVR 5
#define NODE_I 6

#define CF_QY 0
#define CF_TAU_RAD 1
#define CF_TAU_NR 2
#define CF_PHASE 3
#define CF_SIN_PHASE 4
#define COMP_F 5

#define CI_TYPE 0
#define CI_PHASE 1
#define CI_LUM 2
#define CI_P1 3
#define COMP_I 4

#define OVR_F 4

#define LF_WAV 0
#define LF_POS 1
#define LF_DIR 4
#define LF_SIN_DIR 5
#define LF_MAT 6
#define LIGHT_F 18

#define LI_WAV 0
#define LI_POS 1
#define LI_DIR 2
#define LI_ROW 3
#define LIGHT_I 4

#define FI_KIND 0
#define FI_NSEG 1
#define FI_SEG0 2
#define CHEB_FIT_I 3
#define FIT_LIN 0
#define FIT_LOG 1
#define FIT_PW 2

#define SF_A 0
#define SF_B 1
#define SF_SCALE 2
#define CHEB_SEG_F 3

#define SI_KIND 0
#define SI_COEF0 1
#define SI_DEG 2
#define CHEB_SEG_I 3

#define RF_NX 0
#define RF_ATOL 3
#define REC_F 4

#define RI_NODE 0
#define RI_EVENT 1
#define RI_FACET 2
#define RI_HIST0 3
#define RI_NHIST 4
#define REC_I 5

#define HF_LO_A 0
#define HF_W_A 1
#define HF_LO_B 2
#define HF_W_B 3
#define HIST_F 4

#define HI_REC 0
#define HI_PROP_A 1
#define HI_PROP_B 2
#define HI_NA 3
#define HI_NB 4
#define HI_OFF 5
#define HIST_I 6

#define N_SEL 7
#define MAX_RECORDERS 256
#define SEEN_WORDS 8
#define SUMS_FLUSH 1024

// Tags of pvtrace_tpu/engine/compiler.py
enum { GEOM_BOX = 0, GEOM_SPHERE = 1, GEOM_CYLINDER = 2 };
enum { SURF_FRESNEL = 0 };
enum { COMP_SCATTERER = 1, COMP_LUMINOPHORE = 2, COMP_REACTOR = 3 };
enum { PHASE_HG = 1, PHASE_CONE = 2 };
enum { EMIT_KT = 0, EMIT_FULL = 2 };
enum { WAV_CONST = 0 };
enum { POS_DEFAULT = 0, POS_RECT = 1, POS_CIRCLE = 2 };
enum { DIR_DEFAULT = 0, DIR_CONE = 1, DIR_ISOTROPIC = 2, DIR_LAMBERTIAN = 3 };
enum { OVR_MIRROR = 0, OVR_ABSORB = 1, OVR_LAMBERTIAN = 2 };
// Recorder selectors (engine/recorder.py EVENTS)
enum { SEL_NONE = -1, REC_ENTERING = 0, REC_ESCAPING = 1, REC_REFLECTED = 2, REC_LOST = 3,
       REC_REACTED = 4, REC_KILLED = 5, REC_EXIT = 6 };

#define PVT_INF INFINITY
#define PVT_TWO_PI 6.283185307179586f
#define PVT_C_CM_PER_S 2.99792458e10f
#define PVT_ALPHA_ZERO 1e-8f

// Reads of the K5a tables go through the read-only data path: lanes read
// different segments, which the constant cache would serialise.
// Accumulators are atomics on the card, plain adds on the host.
#ifdef __CUDA_ARCH__
#define PVT_LDG(p) __ldg(p)
#define PVT_ADD(p, v) atomicAdd((p), (v))
#else
#define PVT_LDG(p) (*(p))
#define PVT_ADD(p, v) (*(p) += (v))
#endif

// Adds 1 to *p and returns the new value.
PVT_FN unsigned int pvt_inc(unsigned int* p) {
#ifdef __CUDA_ARCH__
  return atomicAdd(p, 1u) + 1u;
#else
  return ++*p;
#endif
}

// Returns *p and sets it to 0, in one atomic step on the card: an add
// that races with it lands either in the value returned or in the new 0.
PVT_FN float pvt_take(float* p) {
#ifdef __CUDA_ARCH__
  return atomicExch(p, 0.0f);
#else
  const float v = *p;
  *p = 0.0f;
  return v;
#endif
}

// Scene tensors and run constants (field order mirrored by the ctypes
// Structure in pvtrace_tpu_torch/kernels/__init__.py).
struct PvtScene {
  const float* node_f;
  const int* node_i;
  const float* comp_f;
  const int* comp_i;
  const float* ovr_f;
  const int* ovr_i;
  const float* light_f;
  const int* light_i;
  const float* spec_pack;
  const float* ems_icdf_pairs;
  const float* light_icdf_pairs;
  const int* cheb_fit_i;
  const float* cheb_fit_f;
  const float* cheb_seg_f;
  const int* cheb_seg_i;
  const float* cheb_coef;
  const int* cheb_slot;
  const int* cheb_ref;
  const float* rec_f;
  const int* rec_i;
  const float* hist_f;
  const int* hist_i;
  const int* rec_csr;
  const int* rec_ids;
  int n_nodes;
  int root_id;
  int n_lights;
  int n_lum;
  int grid_n;
  int icdf_n;
  int pack_width;
  int maxsteps;
  int emit_method;
  int cheb_spec;
  int cheb_icdf;
  int cheb_light;
  int cheb_icdf0;
  int cheb_light0;
  int n_rec;
  int total_bins;
  float grid_x0;
  float grid_dx;
  float maxpathlength;
  float cheb_tscale;
};

struct Photon {
  float px, py, pz, dx, dy, dz, wav, trav, dur;
  int source, count;
  bool alive;
};

struct StepOut {
  int hit, container, sel, tnode;
  bool exit_mask, losing, reacting, kills, no_hit_term, have_n, surface_event;
  float wn[3], c_in;  // hit surface's world normal and |cos| on surface events
};

// Structure-of-arrays lane state and flags of pvt_emit / pvt_step (field
// order mirrored by the ctypes Structures of kernels/__init__.py).
struct PvtState {
  float *px, *py, *pz, *dx, *dy, *dz, *wav, *trav, *dur;
  int *source, *count;
  unsigned char* alive;
  long long *k0, *k1;
};

struct PvtFlags {
  int *hit, *container;
  unsigned char *exit_mask, *losing, *reacting, *kills, *no_hit_term;
  int *sel, *tnode;
  unsigned char *have_n, *surface_event;
  float *wnx, *wny, *wnz, *c_in;
};

struct FateCounts {
  unsigned long long exit, nonrad, react, kill, no_hit, steps;
};

// K9 accumulators of one block (shared memory) or of the host harness:
// crossings, moment sums and distinct rays per recorder, and the bins,
// in bins32 when they fit in shared memory, else straight in bins64.
// The float32 sums of a recorder move into the float64 sums64 at every
// SUMS_FLUSH-th distinct ray, so none holds more than about SUMS_FLUSH
// addends however many photons the block traces.
struct PvtTally {
  unsigned long long* cross;
  float* sums;
  unsigned int* distinct;
  unsigned int* bins32;
  unsigned long long* bins64;
  double* sums64;
};

// K9 results in device memory (field order mirrored by ctypes).
struct PvtTallyOut {
  unsigned long long *distinct, *cross, *bins;
  double* sums;
};

// ---------------------------------------------------------------------
// K1: Threefry-2x32, 20 rounds (jax's generator, bit for bit).
PVT_FN uint32_t pvt_rotl(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

PVT_FN void threefry(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                     uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = pvt_rotl(x1, rot[r & 1][i]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + (uint32_t)(r + 1);
  }
  o0 = x0;
  o1 = x1;
}

PVT_FN float pvt_uniform(uint32_t bits) {
  uint32_t f = (bits >> 9) | 0x3F800000u;
#ifdef __CUDA_ARCH__
  return __uint_as_float(f) - 1.0f;
#else
  float v;
  memcpy(&v, &f, sizeof v);
  return v - 1.0f;
#endif
}

// 2n uniforms from counters (c0, first + j), j < n.
PVT_FN void pvt_draw(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t first,
                     int n, float* u) {
  for (int j = 0; j < n; ++j) {
    uint32_t w0, w1;
    threefry(k0, k1, c0, first + (uint32_t)j, w0, w1);
    u[2 * j] = pvt_uniform(w0);
    u[2 * j + 1] = pvt_uniform(w1);
  }
}

// ---------------------------------------------------------------------
// K5b: lerps in the spectral tables.
PVT_FN float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// Inverse-CDF lerp in rows [base, base + M) of a pairs table (fraction
// not clipped; the float is clamped before the integer cast).
PVT_FN float lerp_pairs(const float* pairs, int base, int M, float gamma) {
  float g = gamma * (float)(M - 1);
  int j0 = (int)clampf(g, 0.0f, (float)(M - 2));
  float gfrac = g - (float)j0;
  const float* p = pairs + 2 * (size_t)(base + j0);
  return p[0] + gfrac * (p[1] - p[0]);
}

// Slot w of spec_pack row `row` at fraction `frac`.
PVT_FN float spec_lerp(const PvtScene& sc, int row, int w, float frac) {
  const float* p = sc.spec_pack + (size_t)row * 2 * sc.pack_width + 2 * w;
  return p[0] + frac * (p[1] - p[0]);
}

// ---------------------------------------------------------------------
// K5a: piecewise-Chebyshev fits (engine/chebyshev.py). The lane finds its
// one segment by the reference's masks (the first segment takes t < b,
// the last t >= a, a middle one a <= t < b; a later match wins, and a
// matching log segment wins over linear ones) and runs one Clenshaw
// chain of that segment's degree, instead of every segment's. Called from
// five sites of a step (alpha, roulette, p1, emission and lamp ICDFs).
// Replaces _clenshaw / _eval_fit (pvtrace_tpu/engine/tracer.py). Bound by
// operations and the latency of dependent L1 loads: the segment scan reads
// three values per segment and the chain one coefficient per degree.
PVT_CALLED_FN float cheb_eval(const PvtScene& sc, int fit, float t) {
  const int* fi = sc.cheb_fit_i + fit * CHEB_FIT_I;
  const int kind = PVT_LDG(fi + FI_KIND), nseg = PVT_LDG(fi + FI_NSEG);
  const int seg0 = PVT_LDG(fi + FI_SEG0);
  int lin = -1, lg = -1;
  for (int i = 0; i < nseg; ++i) {
    const int s = seg0 + i;
    const float a = PVT_LDG(sc.cheb_seg_f + s * CHEB_SEG_F + SF_A);
    const float b = PVT_LDG(sc.cheb_seg_f + s * CHEB_SEG_F + SF_B);
    bool m;
    if (nseg == 1)
      m = true;
    else if (i == 0)
      m = t < b;
    else if (i == nseg - 1)
      m = t >= a;
    else
      m = t >= a && t < b;
    if (m) {
      if (PVT_LDG(sc.cheb_seg_i + s * CHEB_SEG_I + SI_KIND) == FIT_LOG)
        lg = s;
      else
        lin = s;
    }
  }
  const int s = lg >= 0 ? lg : lin;
  if (s < 0) return 0.0f;
  const float* sf = sc.cheb_seg_f + s * CHEB_SEG_F;
  const int* si = sc.cheb_seg_i + s * CHEB_SEG_I;
  const float ts = kind == FIT_PW
                       ? clampf((t - PVT_LDG(sf + SF_A)) * PVT_LDG(sf + SF_SCALE) - 1.0f, -1.0f, 1.0f)
                       : t;
  const float* c = sc.cheb_coef + PVT_LDG(si + SI_COEF0);
  float b1 = 0.0f, b2 = 0.0f;
  for (int k = PVT_LDG(si + SI_DEG); k > 0; --k) {
    const float nb = 2.0f * ts * b1 - b2 + PVT_LDG(c + k);
    b2 = b1;
    b1 = nb;
  }
  float v = ts * b1 - b2 + PVT_LDG(c);
  if (PVT_LDG(si + SI_KIND) == FIT_LOG) v = expf(v) - PVT_LDG(sc.cheb_fit_f + fit);
  return v;
}

// Spectral slot w of the lane's container: K5a (the sum of the slot's
// fits at t) when the scene takes it, else K5b (the lerp in row `row`).
PVT_FN float spec_slot(const PvtScene& sc, int container, int row, int w, float frac,
                       float t) {
  if (!sc.cheb_spec) return spec_lerp(sc, row, w, frac);
  const int* slot = sc.cheb_slot + 2 * (container * sc.pack_width + w);
  float v = 0.0f;
  for (int q = 0; q < slot[1]; ++q) v += cheb_eval(sc, sc.cheb_ref[slot[0] + q], t);
  return v;
}

// Henyey-Greenstein cosine for s = 2u - 1 (|g| >= 1e-12).
PVT_FN float hg_mu(float g, float s) {
  float q = (1.0f - g * g) / (1.0f + g * s);
  return clampf((1.0f + g * g - q * q) / (2.0f * g), -1.0f, 1.0f);
}

// ---------------------------------------------------------------------
// K2: emission of photon `pid` with key (k0, k1).
PVT_FN void emit_one(const PvtScene& sc, uint32_t k0, uint32_t k1,
                     uint32_t pid, Photon& p) {
  float u[6];
  pvt_draw(k0, k1, 0u, 16u, 3, u);
  const int li = (int)(pid % (uint32_t)sc.n_lights);
  const float* lf = sc.light_f + li * LIGHT_F;
  const int* lk = sc.light_i + li * LIGHT_I;
  float w = lf[LF_WAV];
  if (lk[LI_WAV] != WAV_CONST)
    w = sc.cheb_light ? cheb_eval(sc, sc.cheb_light0 + lk[LI_ROW], 2.0f * u[0] - 1.0f)
                      : lerp_pairs(sc.light_icdf_pairs, lk[LI_ROW] * sc.icdf_n, sc.icdf_n, u[0]);
  const float a = lf[LF_POS], b = lf[LF_POS + 1], c = lf[LF_POS + 2];
  float lx = 0.0f, ly = 0.0f, lz = 0.0f;
  if (lk[LI_POS] == POS_RECT) {
    lx = (2.0f * u[1] - 1.0f) * a;
    ly = (2.0f * u[2] - 1.0f) * b;
  } else if (lk[LI_POS] == POS_CIRCLE) {
    float r = sqrtf(u[1]) * a;
    float ang = PVT_TWO_PI * u[2];
    lx = r * cosf(ang);
    ly = r * sinf(ang);
  } else if (lk[LI_POS] != POS_DEFAULT) {
    lx = (2.0f * u[1] - 1.0f) * a;
    ly = (2.0f * u[2] - 1.0f) * b;
    lz = (2.0f * u[3] - 1.0f) * c;
  }
  float ldx = 0.0f, ldy = 0.0f, ldz = 1.0f;
  const int dk = lk[LI_DIR];
  if (dk != DIR_DEFAULT) {
    float mu, st;
    if (dk == DIR_CONE) {
      st = sqrtf(u[4]) * lf[LF_SIN_DIR];
      mu = sqrtf(fmaxf(1.0f - st * st, 0.0f));
    } else if (dk == DIR_ISOTROPIC) {
      mu = 2.0f * u[4] - 1.0f;
      st = sqrtf(fmaxf(1.0f - mu * mu, 0.0f));
    } else if (dk == DIR_LAMBERTIAN) {
      st = sqrtf(u[4]);
      mu = sqrtf(fmaxf(1.0f - u[4], 0.0f));
    } else {
      mu = hg_mu(lf[LF_DIR], 2.0f * u[4] - 1.0f);
      st = sqrtf(fmaxf(1.0f - mu * mu, 0.0f));
    }
    float phi = PVT_TWO_PI * u[5];
    ldx = st * cosf(phi);
    ldy = st * sinf(phi);
    ldz = mu;
  }
  const float* m = lf + LF_MAT;
  p.px = m[0] * lx + m[1] * ly + m[2] * lz + m[3];
  p.py = m[4] * lx + m[5] * ly + m[6] * lz + m[7];
  p.pz = m[8] * lx + m[9] * ly + m[10] * lz + m[11];
  p.dx = m[0] * ldx + m[1] * ldy + m[2] * ldz;
  p.dy = m[4] * ldx + m[5] * ldy + m[6] * ldz;
  p.dz = m[8] * ldx + m[9] * ldy + m[10] * ldz;
  p.wav = w;
  p.trav = 0.0f;
  p.dur = 0.0f;
  p.source = -1;
  p.count = 0;
  p.alive = true;
}

// ---------------------------------------------------------------------
// K3: forward-hit candidates of one node in its local frame. Writes up
// to four (t, valid) pairs in candidate order and returns their number.
PVT_FN int intersect_node(int gtype, const float* gp, const float* o,
                          const float* d, float eps, float* t, bool* v) {
  if (gtype == GEOM_BOX) {
    float tmin = -PVT_INF, tmax = PVT_INF;
    bool miss = false;
    for (int k = 0; k < 3; ++k) {
      const float h = 0.5f * gp[k], oo = o[k], dd = d[k];
      const bool par = fabsf(dd) < 1e-30f;
      const float inv = 1.0f / (par ? 1.0f : dd);
      const float t1 = (-h - oo) * inv, t2 = (h - oo) * inv;
      const float lo = par ? -PVT_INF : fminf(t1, t2);
      const float hi = par ? PVT_INF : fmaxf(t1, t2);
      miss = miss || (par && (oo < -h || oo > h));
      tmin = fmaxf(tmin, lo);
      tmax = fminf(tmax, hi);
    }
    const bool ok = tmax >= tmin && !miss;
    t[0] = tmin;
    v[0] = ok && tmin > eps;
    t[1] = tmax;
    v[1] = ok && tmax > eps;
    return 2;
  }
  if (gtype == GEOM_SPHERE) {
    const float r = gp[0];
    const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float b = 2.0f * (d[0] * o[0] + d[1] * o[1] + d[2] * o[2]);
    const float c = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - r * r;
    const float disc = b * b - 4.0f * a * c;
    const bool ok = disc >= 0.0f;
    const float sq = sqrtf(ok ? disc : 0.0f);
    t[0] = (-b - sq) / (2.0f * a);
    t[1] = (-b + sq) / (2.0f * a);
    v[0] = ok && t[0] > eps;
    v[1] = ok && t[1] > eps;
    return 2;
  }
  const float half = 0.5f * gp[0], r = gp[1];
  const float a = d[0] * d[0] + d[1] * d[1];
  const bool hasb = a > 1e-30f;
  const float sa = hasb ? a : 1.0f;
  const float b = 2.0f * (o[0] * d[0] + o[1] * d[1]);
  const float c = o[0] * o[0] + o[1] * o[1] - r * r;
  const float disc = b * b - 4.0f * a * c;
  const bool ok = hasb && disc >= 0.0f;
  const float sq = sqrtf(disc >= 0.0f ? disc : 0.0f);
  t[0] = (-b - sq) / (2.0f * sa);
  t[1] = (-b + sq) / (2.0f * sa);
  for (int k = 0; k < 2; ++k) {
    const float z = o[2] + t[k] * d[2];
    v[k] = ok && z > -half && z < half && t[k] > eps;
  }
  const bool hasc = fabsf(d[2]) > 1e-30f;
  const float sdz = hasc ? d[2] : 1.0f;
  for (int k = 0; k < 2; ++k) {
    const float zcap = k == 0 ? -half : half;
    const float tc = (zcap - o[2]) / sdz;
    const float x = o[0] + tc * d[0], y = o[1] + tc * d[1];
    t[2 + k] = tc;
    v[2 + k] = hasc && x * x + y * y <= r * r && tc > eps;
  }
  return 4;
}

struct Hits {
  float t0;        // nearest forward hit distance
  int hit;         // its node
  int container;   // node the photon is in
  int adjacent;    // node across the hit surface (-1 when there is none)
  int nhits;       // forward hits over all nodes
  float lo[3];     // ray in the hit node's local frame
  float ld[3];
};

// K3: nearest two forward hits over all nodes (strict < in node order,
// then candidate order), container and adjacent node.
PVT_FN void intersect_nodes(const PvtScene& sc, const Photon& p, Hits& h) {
  float t1 = PVT_INF, t2 = PVT_INF, cont_t = PVT_INF;
  int n1 = 0, n2 = 0, cont_n = 0, nhits = 0;
  for (int n = 0; n < sc.n_nodes; ++n) {
    const float* nf = sc.node_f + n * NODE_F;
    const float* R = nf + NF_W2L;
    float o[3], d[3], t[4];
    bool v[4];
    for (int k = 0; k < 3; ++k) {
      o[k] = R[4 * k] * p.px + R[4 * k + 1] * p.py + R[4 * k + 2] * p.pz + R[4 * k + 3];
      d[k] = R[4 * k] * p.dx + R[4 * k + 1] * p.dy + R[4 * k + 2] * p.dz;
    }
    const int nc = intersect_node(sc.node_i[n * NODE_I + NI_GEOM], nf + NF_GP,
                                  o, d, nf[NF_EPS], t, v);
    int cnt_n = 0;
    float tmin_n = PVT_INF;
    for (int c = 0; c < nc; ++c) {
      const float tv = v[c] ? t[c] : PVT_INF;
      cnt_n += v[c];
      tmin_n = fminf(tmin_n, tv);
      if (tv < t1) {
        t2 = t1;
        n2 = n1;
        t1 = tv;
        n1 = n;
        for (int k = 0; k < 3; ++k) {
          h.lo[k] = o[k];
          h.ld[k] = d[k];
        }
      } else if (tv < t2) {
        t2 = tv;
        n2 = n;
      }
    }
    nhits += cnt_n;
    if (cnt_n == 1 && tmin_n < cont_t) {
      cont_t = tmin_n;
      cont_n = n;
    }
  }
  h.t0 = t1;
  h.hit = n1;
  h.nhits = nhits;
  int container = isfinite(cont_t) ? cont_n : n1;
  int adjacent = container == n1 ? n2 : n1;
  if (nhits == 1) {
    container = n1;
    adjacent = -1;
  }
  h.container = container;
  h.adjacent = adjacent;
}

// K4: outward local normal at local point q (box: first face of least
// distance in the order -x, +x, -y, +y, -z, +z).
PVT_FN void local_normal(int gtype, const float* gp, const float* q, float* nrm) {
  if (gtype == GEOM_BOX) {
    float best = PVT_INF;
    int face = 0;
    for (int k = 0; k < 6; ++k) {
      const float h = 0.5f * gp[k / 2];
      const float dist = fabsf(k % 2 == 0 ? q[k / 2] + h : q[k / 2] - h);
      if (k == 0 || dist < best) {
        face = k;
        best = dist;
      }
    }
    nrm[0] = nrm[1] = nrm[2] = 0.0f;
    nrm[face / 2] = face % 2 == 0 ? -1.0f : 1.0f;
    return;
  }
  if (gtype == GEOM_SPHERE) {
    float mag = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
    mag = mag == 0.0f ? 1.0f : mag;
    for (int k = 0; k < 3; ++k) nrm[k] = q[k] / mag;
    return;
  }
  const float half = 0.5f * gp[0];
  const float atol = 1e-8f + 1e-5f * fabsf(half);
  const bool bottom = fabsf(q[2] + half) <= atol;
  const bool top = fabsf(q[2] - half) <= atol;
  const float r = sqrtf(q[0] * q[0] + q[1] * q[1]);
  const float sr = r == 0.0f ? 1.0f : r;
  nrm[0] = (bottom || top) ? 0.0f : q[0] / sr;
  nrm[1] = (bottom || top) ? 0.0f : q[1] / sr;
  nrm[2] = bottom ? -1.0f : (top ? 1.0f : 0.0f);
}

// ---------------------------------------------------------------------
// K3 + K4 + K5 + K6: one physics step of photon p with uniforms u[0..7]
// (p.count already incremented). Mirrors physics.step of the eager twin.
// With kTally it also gives the recorder selectors and takes the world
// normal on EXIT; without, out.sel is SEL_NONE and the normal is taken
// only where the surface needs it.
template <bool kTally>
PVT_FN void step_one(const PvtScene& sc, Photon& p, const float* u, StepOut& out) {
  Hits h;
  intersect_nodes(sc, p, h);
  out.hit = h.hit;
  out.container = h.container;
  out.exit_mask = out.losing = out.reacting = out.kills = out.no_hit_term = false;
  out.wn[0] = out.wn[1] = out.wn[2] = out.c_in = 0.0f;

  bool alive = p.alive;
  out.no_hit_term = alive && h.nhits == 0;
  alive = alive && h.nhits != 0;
  const bool kill_max = alive && (p.count > sc.maxsteps || p.trav > sc.maxpathlength);
  alive = alive && !kill_max;

  const float* cf_node = sc.node_f + h.container * NODE_F;
  const int* ci_node = sc.node_i + h.container * NODE_I;
  const float n_cont = cf_node[NF_NIDX];
  const bool exit_mask = alive && h.hit == sc.root_id;

  // Free path against the boundary distance.
  const float posf = (p.wav - sc.grid_x0) / sc.grid_dx;
  const int i0 = (int)clampf(posf, 0.0f, (float)(sc.grid_n - 2));
  const float frac = clampf(posf - (float)i0, 0.0f, 1.0f);
  const int row = h.container * sc.grid_n + i0;
  const float t = ((float)i0 + frac) * sc.cheb_tscale - 1.0f;
  const int K = ci_node[NI_NCOMP];
  const float alpha = K > 0 ? spec_slot(sc, h.container, row, K - 1, frac, t) : 0.0f;
  const float depth =
      alpha > PVT_ALPHA_ZERO ? -log1pf(-u[0]) / fmaxf(alpha, 1e-30f) : PVT_INF;
  const bool absorbed = alive && !exit_mask && depth < h.t0;
  const float advance = absorbed ? depth : h.t0;
  if (alive) {
    p.px = p.px + p.dx * advance;
    p.py = p.py + p.dy * advance;
    p.pz = p.pz + p.dz * advance;
    p.trav = p.trav + advance;
    p.dur = p.dur + advance * n_cont / PVT_C_CM_PER_S;
  }

  // Volume event: component roulette, quantum-yield coin, re-emission.
  bool nonrad = false;
  if (absorbed) {
    const float target = u[1] * alpha;
    int ordinal = 0;
    for (int k = 0; k < K - 1; ++k)
      ordinal += spec_slot(sc, h.container, row, k, frac, t) < target;
    const int cid = ci_node[NI_COMP0] + ordinal;
    const float* cf = sc.comp_f + cid * COMP_F;
    const int* ci = sc.comp_i + cid * COMP_I;
    const int ctype = ci[CI_TYPE];
    const bool is_lum = ctype == COMP_LUMINOPHORE;
    const bool radiative = (is_lum || ctype == COMP_SCATTERER) && u[2] < cf[CF_QY];
    if (radiative) {
      float mu;
      if (ci[CI_PHASE] == PHASE_HG) {
        mu = hg_mu(cf[CF_PHASE], 2.0f * u[3] - 1.0f);
      } else if (ci[CI_PHASE] == PHASE_CONE) {
        const float s = sqrtf(u[3]) * cf[CF_SIN_PHASE];
        mu = sqrtf(fmaxf(1.0f - s * s, 0.0f));
      } else {
        mu = 2.0f * u[3] - 1.0f;
      }
      const float st = sqrtf(fmaxf(1.0f - mu * mu, 0.0f));
      const float phi = PVT_TWO_PI * u[4];
      if (is_lum) {
        float p1 = 0.0f;
        if (sc.emit_method != EMIT_FULL)
          p1 = spec_slot(sc, h.container, row,
                         ci[CI_P1] + (sc.emit_method == EMIT_KT ? 0 : 1), frac, t);
        const float gamma = p1 + (1.0f - p1) * u[5];
        p.wav = sc.cheb_icdf
                    ? cheb_eval(sc, sc.cheb_icdf0 + ci[CI_LUM], 2.0f * gamma - 1.0f)
                    : lerp_pairs(sc.ems_icdf_pairs, ci[CI_LUM] * sc.icdf_n, sc.icdf_n, gamma);
        const float tau = cf[CF_TAU_RAD];
        p.dur = p.dur + (tau > 0.0f ? -log1pf(-u[6]) * tau : 0.0f);
      }
      p.dx = st * cosf(phi);
      p.dy = st * sinf(phi);
      p.dz = mu;
      p.source = cid;
    } else {
      nonrad = true;
      const float tau = cf[CF_TAU_NR];
      p.dur = p.dur + (tau > 0.0f ? -log1pf(-u[6]) * tau : 0.0f);
      out.reacting = ctype == COMP_REACTOR;
      out.losing = !out.reacting;
    }
  }

  // Surface event at the hit node; with kTally the normal is also taken
  // on EXIT, for the recorders.
  bool surf = alive && !exit_mask && !absorbed;
  const bool adj_bad = surf && h.adjacent < 0;
  surf = surf && !adj_bad;
  bool reflecting = false;
  if (surf || (kTally && exit_mask)) {
    const float* hf = sc.node_f + h.hit * NODE_F;
    const int* hi = sc.node_i + h.hit * NODE_I;
    float q[3], ln[3];
    for (int k = 0; k < 3; ++k) q[k] = h.lo[k] + h.t0 * h.ld[k];
    local_normal(hi[NI_GEOM], hf + NF_GP, q, ln);
    const float* Rw = hf + NF_L2W;
    const float wnx = Rw[0] * ln[0] + Rw[1] * ln[1] + Rw[2] * ln[2];
    const float wny = Rw[3] * ln[0] + Rw[4] * ln[1] + Rw[5] * ln[2];
    const float wnz = Rw[6] * ln[0] + Rw[7] * ln[1] + Rw[8] * ln[2];
    const float ddot = wnx * p.dx + wny * p.dy + wnz * p.dz;
    const float c_in = clampf(fabsf(ddot), 0.0f, 1.0f);
    out.wn[0] = wnx;
    out.wn[1] = wny;
    out.wn[2] = wnz;
    out.c_in = c_in;
    if (surf) {
      int mode = -1;
      for (int o = hi[NI_OVR0]; o < hi[NI_OVR0] + hi[NI_NOVR] && mode < 0; ++o) {
        const float* of = sc.ovr_f + o * OVR_F;
        if (fabsf(ln[0] - of[0]) <= of[3] && fabsf(ln[1] - of[1]) <= of[3] &&
            fabsf(ln[2] - of[2]) <= of[3])
          mode = sc.ovr_i[o];
      }
      const float flip = ddot < 0.0f ? -1.0f : 1.0f;
      const float nax = wnx * flip, nay = wny * flip, naz = wnz * flip;
      const float n1r = n_cont;
      const float n2r = sc.node_f[h.adjacent * NODE_F + NF_NIDX];
      const bool is_fresnel = hi[NI_SURF] == SURF_FRESNEL;
      const float s2 = clampf(1.0f - c_in * c_in, 0.0f, 1.0f);
      const float ratio = n1r / n2r;
      float r = 0.0f;
      if (is_fresnel) {
        const bool tir = n2r < n1r && s2 * ratio * ratio > 1.0f;
        const float kterm = sqrtf(fmaxf(1.0f - ratio * ratio * s2, 0.0f));
        const float rs = (n1r * c_in - n2r * kterm) / (n1r * c_in + n2r * kterm);
        const float rp = (n1r * kterm - n2r * c_in) / (n1r * kterm + n2r * c_in);
        r = tir ? 1.0f : clampf(0.5f * (rs * rs + rp * rp), 0.0f, 1.0f);
      }
      if (mode == OVR_MIRROR || mode == OVR_LAMBERTIAN) r = 1.0f;
      if (mode == OVR_ABSORB) r = 0.0f;
      reflecting = u[7] < r;
      if (reflecting) {
        const float two_d = 2.0f * c_in;
        if (mode == OVR_LAMBERTIAN) {
          const float st_l = sqrtf(u[3]);
          const float ct_l = sqrtf(fmaxf(1.0f - u[3], 0.0f));
          const float phi_l = PVT_TWO_PI * u[4];
          const float lx = st_l * cosf(phi_l), ly = st_l * sinf(phi_l);
          const float axx = -nax, axy = -nay, axz = -naz;
          const float sign = axz >= 0.0f ? 1.0f : -1.0f;
          const float a_ = -1.0f / (sign + axz);
          const float b_ = axx * axy * a_;
          const float t1x = 1.0f + sign * axx * axx * a_, t1y = sign * b_, t1z = -sign * axx;
          const float t2x = b_, t2y = sign + axy * axy * a_, t2z = -axy;
          p.dx = lx * t1x + ly * t2x + ct_l * axx;
          p.dy = lx * t1y + ly * t2y + ct_l * axy;
          p.dz = lx * t1z + ly * t2z + ct_l * axz;
        } else {
          p.dx = p.dx - two_d * nax;
          p.dy = p.dy - two_d * nay;
          p.dz = p.dz - two_d * naz;
        }
      } else if (is_fresnel && mode != OVR_ABSORB) {
        const float cterm = sqrtf(fmaxf(1.0f - ratio * ratio * (1.0f - c_in * c_in), 0.0f));
        const float scale = cterm - ratio * c_in;
        p.dx = ratio * p.dx + scale * nax;
        p.dy = ratio * p.dy + scale * nay;
        p.dz = ratio * p.dz + scale * naz;
      }
    }
  }
  const bool transmitting = surf && !reflecting;

  // Recorder selectors, in the reference's order (physics.py).
  out.sel = SEL_NONE;
  out.tnode = -1;
  out.have_n = out.surface_event = false;
  if (kTally) {
    if (kill_max) {
      out.sel = REC_KILLED;
      out.tnode = h.container;
    }
    if (exit_mask) {
      out.sel = REC_EXIT;
      out.tnode = h.hit;
    }
    if (out.reacting || out.losing) {
      out.sel = out.losing ? REC_LOST : REC_REACTED;
      out.tnode = h.container;
    }
    const bool refl_tally = reflecting && h.container != h.hit;
    if (refl_tally) {
      out.sel = REC_REFLECTED;
      out.tnode = h.hit;
    }
    if (transmitting) {
      out.sel = h.container == h.hit ? REC_ESCAPING : REC_ENTERING;
      out.tnode = h.hit;
    }
    out.have_n = exit_mask || refl_tally || transmitting;
    out.surface_event = exit_mask || reflecting || transmitting;
  }

  out.exit_mask = exit_mask;
  out.kills = kill_max || adj_bad;
  p.alive = alive && !exit_mask && !nonrad;
}

// ---------------------------------------------------------------------
// K9: add one event of a photon (step output o, post-step state p) to the
// recorders that match it. The (tnode, sel) CSR index lists the
// candidates; a facet recorder also needs the world normal within atol
// on all three axes. Every match adds a crossing; the photon's first
// match of a recorder (its bit in `seen`) adds a distinct ray, the eight
// moments and the recorder's histogram bins. Replaces _tally and the tally
// frame of body_fast (pvtrace_tpu/engine/tracer.py): the [B, R] match
// matrix becomes a walk over the few recorders of this (node, event).
// Bound by atomics: threads of a block add to the same few addresses.
PVT_FN void tally_event(const PvtScene& sc, const PvtTally& acc, uint32_t* seen,
                        const StepOut& o, const Photon& p) {
  if (o.sel < 0) return;
  const int key = o.tnode * N_SEL + o.sel;
  const int q1 = sc.rec_csr[key + 1];
  int q = sc.rec_csr[key];
  if (q == q1) return;
  const float angle = o.surface_event ? acosf(o.c_in) : 0.0f;
  const float moments[8] = {p.wav, p.wav * p.wav, angle, angle * angle,
                            p.dur, p.dur * p.dur, p.trav, p.trav * p.trav};
  // Histogram properties (engine/recorder.py PROPERTIES); x, y, z in the
  // tnode's local frame.
  const float* W = sc.node_f + o.tnode * NODE_F + NF_W2L;
  float props[7] = {p.wav, angle, p.dur, p.trav};
  for (int k = 0; k < 3; ++k)
    props[4 + k] = W[4 * k] * p.px + W[4 * k + 1] * p.py + W[4 * k + 2] * p.pz + W[4 * k + 3];
  for (; q < q1; ++q) {
    const int r = sc.rec_ids[q];
    const int* ri = sc.rec_i + r * REC_I;
    if (ri[RI_FACET]) {
      const float* rf = sc.rec_f + r * REC_F;
      const float atol = rf[RF_ATOL];
      if (!(o.have_n && fabsf(o.wn[0] - rf[RF_NX]) <= atol &&
            fabsf(o.wn[1] - rf[RF_NX + 1]) <= atol && fabsf(o.wn[2] - rf[RF_NX + 2]) <= atol))
        continue;
    }
    PVT_ADD(acc.cross + r, 1ull);
    const uint32_t bit = 1u << (r & 31);
    if (seen[r >> 5] & bit) continue;
    seen[r >> 5] |= bit;
    const unsigned int rays = pvt_inc(acc.distinct + r);
    for (int k = 0; k < 8; ++k) PVT_ADD(acc.sums + 8 * r + k, moments[k]);
    if (rays % SUMS_FLUSH == 0)
      for (int k = 0; k < 8; ++k)
        PVT_ADD(acc.sums64 + 8 * r + k, (double)pvt_take(acc.sums + 8 * r + k));
    for (int hh = ri[RI_HIST0]; hh < ri[RI_HIST0] + ri[RI_NHIST]; ++hh) {
      const int* hi = sc.hist_i + hh * HIST_I;
      const float* hf = sc.hist_f + hh * HIST_F;
      const int na = hi[HI_NA], nb = hi[HI_NB];
      const float fa = floorf((props[hi[HI_PROP_A]] - hf[HF_LO_A]) / hf[HF_W_A] * (float)na);
      if (!(fa >= 0.0f && fa < (float)na)) continue;
      int ib = 0;
      if (hi[HI_PROP_B] >= 0) {
        const float fb = floorf((props[hi[HI_PROP_B]] - hf[HF_LO_B]) / hf[HF_W_B] * (float)nb);
        if (!(fb >= 0.0f && fb < (float)nb)) continue;
        ib = (int)fb;
      }
      const int bin = hi[HI_OFF] + (int)fa * nb + ib;
      if (acc.bins32)
        PVT_ADD(acc.bins32 + bin, 1u);
      else
        PVT_ADD(acc.bins64 + bin, 1ull);
    }
  }
}

// ---------------------------------------------------------------------
// Per-lane bodies of the kernels.

PVT_FN void load_lane(const PvtState& s, long long i, Photon& p) {
  p.px = s.px[i];
  p.py = s.py[i];
  p.pz = s.pz[i];
  p.dx = s.dx[i];
  p.dy = s.dy[i];
  p.dz = s.dz[i];
  p.wav = s.wav[i];
  p.trav = s.trav[i];
  p.dur = s.dur[i];
  p.source = s.source[i];
  p.alive = s.alive[i] != 0;
  p.count = s.count[i];
}

PVT_FN void store_lane(const PvtState& s, long long i, const Photon& p,
                       uint32_t k0, uint32_t k1) {
  s.px[i] = p.px;
  s.py[i] = p.py;
  s.pz[i] = p.pz;
  s.dx[i] = p.dx;
  s.dy[i] = p.dy;
  s.dz[i] = p.dz;
  s.wav[i] = p.wav;
  s.trav[i] = p.trav;
  s.dur[i] = p.dur;
  s.source[i] = p.source;
  s.count[i] = p.count;
  s.alive[i] = p.alive;
  s.k0[i] = k0;
  s.k1[i] = k1;
}

// pvt_emit: keys and initial state of photon offset + i into lane i.
PVT_FN void emit_lane(const PvtScene& sc, uint32_t s0, uint32_t s1,
                      unsigned long long offset, long long i, const PvtState& out) {
  const uint32_t pid = (uint32_t)(offset + (unsigned long long)i);
  uint32_t k0, k1;
  threefry(s0, s1, pid, 0u, k0, k1);
  Photon p;
  emit_one(sc, k0, k1, pid, p);
  store_lane(out, i, p, k0, k1);
}

// pvt_step: count the step, draw, take one physics step of lane i.
PVT_FN void step_lane(const PvtScene& sc, const PvtState& in, const PvtState& out,
                      const PvtFlags& fl, long long i) {
  Photon p;
  load_lane(in, i, p);
  p.count += p.alive ? 1 : 0;
  const uint32_t k0 = (uint32_t)in.k0[i], k1 = (uint32_t)in.k1[i];
  float u[8];
  pvt_draw(k0, k1, (uint32_t)p.count, 0u, 4, u);
  StepOut o;
  step_one<true>(sc, p, u, o);
  store_lane(out, i, p, k0, k1);
  fl.hit[i] = o.hit;
  fl.container[i] = o.container;
  fl.exit_mask[i] = o.exit_mask;
  fl.losing[i] = o.losing;
  fl.reacting[i] = o.reacting;
  fl.kills[i] = o.kills;
  fl.no_hit_term[i] = o.no_hit_term;
  fl.sel[i] = o.sel;
  fl.tnode[i] = o.tnode;
  fl.have_n[i] = o.have_n;
  fl.surface_event[i] = o.surface_event;
  fl.wnx[i] = o.wn[0];
  fl.wny[i] = o.wn[1];
  fl.wnz[i] = o.wn[2];
  fl.c_in[i] = o.c_in;
}

// pvt_tally: add the event of lane i (post-step state s, selectors fl)
// to acc; `seen` holds SEEN_WORDS words per lane, read and written back.
PVT_FN void tally_lane(const PvtScene& sc, const PvtState& s, const PvtFlags& fl,
                       uint32_t* seen, long long i, const PvtTally& acc) {
  Photon p;
  load_lane(s, i, p);
  StepOut o;
  o.sel = fl.sel[i];
  o.tnode = fl.tnode[i];
  o.have_n = fl.have_n[i] != 0;
  o.surface_event = fl.surface_event[i] != 0;
  o.wn[0] = fl.wnx[i];
  o.wn[1] = fl.wny[i];
  o.wn[2] = fl.wnz[i];
  o.c_in = fl.c_in[i];
  uint32_t words[SEEN_WORDS];
  for (int k = 0; k < SEEN_WORDS; ++k) words[k] = seen[i * SEEN_WORDS + k];
  tally_event(sc, acc, words, o, p);
  for (int k = 0; k < SEEN_WORDS; ++k) seen[i * SEEN_WORDS + k] = words[k];
}

// pvt_trace: key, emit and step photon `pid` until it dies, adding its
// fates and steps to f and, with kTally, its recorder events to *acc.
// Returns its step count.
template <bool kTally>
PVT_FN int trace_photon(const PvtScene& sc, uint32_t s0, uint32_t s1, uint32_t pid,
                        FateCounts& f, const PvtTally* acc) {
  uint32_t k0, k1;
  threefry(s0, s1, pid, 0u, k0, k1);
  Photon p;
  emit_one(sc, k0, k1, pid, p);
  uint32_t seen[SEEN_WORDS];
  if (kTally)
    for (int k = 0; k < SEEN_WORDS; ++k) seen[k] = 0u;
  while (p.alive) {
    p.count += 1;
    float u[8];
    pvt_draw(k0, k1, (uint32_t)p.count, 0u, 4, u);
    StepOut o;
    step_one<kTally>(sc, p, u, o);
    f.exit += o.exit_mask;
    f.nonrad += o.losing;
    f.react += o.reacting;
    f.kill += o.kills;
    f.no_hit += o.no_hit_term;
    if (kTally) tally_event(sc, *acc, seen, o, p);
  }
  f.steps += (unsigned long long)p.count;
  return p.count;
}
