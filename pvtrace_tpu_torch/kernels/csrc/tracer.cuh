// Device functions shared by the kernels of tracer.cu.
//
// One photon per thread, all state in registers. Every function is a
// line-for-line port of the eager twin in pvtrace_tpu_torch/engine
// (rng.py, emit.py, geometry.py, spectral.py, chebyshev.py, physics.py,
// tally.py, eventlog.py, score.py), which in turn ports pvtrace_tpu/engine/tracer.py. In
// the real type pvt_real below (float, or double in the float64 build); no
// fast-math: log1p, sqrt, exp, acos and division stay IEEE (nvcc's default
// FMA contraction moves results by ulps).
//
// The functions are also host-callable (PVT_FN), so the arithmetic can
// be compiled by a host C++ compiler and checked without a card.
#pragma once
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>
#ifndef __CUDACC__
#include <vector>
#endif

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

// The real type of a build, chosen when it is compiled: float, or double
// under -DPVT_F64 (the tracer_f64 library and the float64 host harness,
// kernels/build.py and kernels/host.py), so the float32 library's code is
// the same whichever build exists. The JAX package traces in the run's
// dtype throughout; so does a build, but for the random words: threefry
// and pvt_uniform are the same in both, a uniform made in float32 and then
// widened, as the JAX package's _uniform32 makes it. pvt_word is a word
// of the K5a table (engine/tables.py packs it in the run's dtype: int32
// words holding float32 bits, or int64 words holding float64 bits).
// PVT_R(x) is the literal x in the build's type; pvt_sqrt and the rest are
// the math library's functions of that type.
#ifdef PVT_F64
typedef double pvt_real;
typedef long long pvt_word;
#define PVT_R(x) x
#define PVT_REAL_MAX DBL_MAX
// Functions of doubles, so that a float argument (a literal such as
// 0.0f) is converted: a call of the math library's fmax(double, float)
// would take the host's template in device code.
PVT_FN double pvt_sqrt(double x) { return sqrt(x); }
PVT_FN double pvt_fabs(double x) { return fabs(x); }
PVT_FN double pvt_fmin(double a, double b) { return fmin(a, b); }
PVT_FN double pvt_fmax(double a, double b) { return fmax(a, b); }
PVT_FN double pvt_log1p(double x) { return log1p(x); }
PVT_FN double pvt_expm1(double x) { return expm1(x); }
PVT_FN double pvt_exp(double x) { return exp(x); }
PVT_FN double pvt_cos(double x) { return cos(x); }
PVT_FN double pvt_sin(double x) { return sin(x); }
PVT_FN double pvt_acos(double x) { return acos(x); }
PVT_FN double pvt_floor(double x) { return floor(x); }
PVT_FN void pvt_sincos(double x, double* s, double* c) { sincos(x, s, c); }
#else
typedef float pvt_real;
typedef int pvt_word;
#define PVT_R(x) x##f
#define PVT_REAL_MAX FLT_MAX
#define pvt_sqrt sqrtf
#define pvt_fabs fabsf
#define pvt_fmin fminf
#define pvt_fmax fmaxf
#define pvt_log1p log1pf
#define pvt_expm1 expm1f
#define pvt_exp expf
#define pvt_cos cosf
#define pvt_sin sinf
#define pvt_acos acosf
#define pvt_floor floorf
PVT_FN void pvt_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
#endif
// Reals, and K5a table words, in 16 bytes: one vector load or store.
constexpr int kReals16 = (int)(16 / sizeof(pvt_real));
constexpr int kWords16 = (int)(16 / sizeof(pvt_word));

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
#define NI_TRI0 6
#define NI_NTRI 7
#define NODE_I 8

#define TF_V0 0
#define TF_E1 3
#define TF_E2 6
#define TF_N 9
#define TRI_F 12

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

#define CHEB_REC 4
#define FR_NSEG 0
#define FR_SEG 1
#define FR_BRK 2
#define FR_OFF 3
#define SR_A 0
#define SR_SCALE 1
#define SR_COEF 2
#define SR_DEG 3
#define SEG_DEG_MASK 255
#define SEG_LOG 256
#define SEG_MAP 512

#define RF_NX 0
#define RF_ATOL 3
#define REC_F 4

#define GF_NX 0
#define GF_ATOL 3
#define GF_FACET 4
#define GRP_F 5

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

#define LOG_I 6
#define LOG_F 12

#define PATH_KIND 0
#define PATH_NODE 1
#define PATH_PARAM 2
#define PATH_I 3
#define PATH_N 0
#define PATH_GEOM 1
#define PATH_J 10

#define N_SEL 7
#define MAX_RECORDERS 256
#define SEEN_WORDS 8
#define SUMS_FLUSH 1024

// Tags of pvtrace_tpu/engine/compiler.py
enum { GEOM_BOX = 0, GEOM_SPHERE = 1, GEOM_CYLINDER = 2, GEOM_MESH = 3 };
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
// Fate counter slots (the Event values, and one for photons that left
// without a hit)
enum { N_FATES = 11, FATE_NO_HIT = 10 };
// Event kinds of the log (light/event.py Event values)
enum { EV_GENERATE = 0, EV_REFLECT = 1, EV_TRANSMIT = 2, EV_ABSORB = 3, EV_NONRADIATIVE = 4,
       EV_SCATTER = 5, EV_EMIT = 6, EV_EXIT = 7, EV_REACT = 8, EV_KILL = 9 };

#define PVT_INF INFINITY
#define PVT_TWO_PI PVT_R(6.283185307179586)
#define PVT_C_CM_PER_S PVT_R(2.99792458e10)
#define PVT_ALPHA_ZERO PVT_R(1e-8)

// Reads of the triangles go through the read-only data path: lanes read
// different rows, which the constant cache would serialise.
// Accumulators are atomics on the card, plain adds on the host.
#ifdef __CUDA_ARCH__
#define PVT_LDG(p) __ldg(p)
#define PVT_ADD(p, v) atomicAdd((p), (v))
#else
#define PVT_LDG(p) (*(p))
#define PVT_ADD(p, v) (*(p) += (v))
#endif

// Adds v to *p and returns the value before.
PVT_FN unsigned int pvt_add(unsigned int* p, unsigned int v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(p, v);
#else
  const unsigned int before = *p;
  *p += v;
  return before;
#endif
}

// Returns *p and sets it to 0, in one atomic step on the card: an add
// that races with it lands either in the value returned or in the new 0.
#ifndef PVT_F64
PVT_FN float pvt_take(float* p) {
#ifdef __CUDA_ARCH__
  return atomicExch(p, 0.0f);
#else
  const float v = *p;
  *p = 0.0f;
  return v;
#endif
}
#endif

PVT_FN unsigned int pvt_take(unsigned int* p) {
#ifdef __CUDA_ARCH__
  return atomicExch(p, 0u);
#else
  const unsigned int v = *p;
  *p = 0u;
  return v;
#endif
}

// A block counts a recorder's crossings in a 32-bit word, a native
// shared atomic where a 64-bit add is a compare-and-swap loop (2-6 %
// faster with one recorder a facet group; PERF.md, section 6), and moves
// them into the 64-bit totals whenever they pass a multiple of
// kCrossFlush, so the word never wraps.
constexpr unsigned int kCrossFlush = 1u << 30;

// Adds v[k] to p[k], k < 8, where v[k] is not 0 (the moment sums: all
// non-negative, so a 0 changes nothing). On the card a float32 atomicAdd
// to shared memory is a compare-and-swap loop (ATOMS.CAST.SPIN); eight of
// them in a row wait for eight round trips. Here the eight compare-and-
// swaps (ATOMS.CAS) run side by side: a lane waits for one round trip,
// and retries only where another lane's add came between. Where lanes of
// one warp add to one address, as tally_event's do, it measured far
// slower than atomicAdd (PERF.md, section 6): only tally_warp, whose
// lanes add to different recorders, takes it. The float64 build's
// compare-and-swaps are of 64-bit words.
#ifdef PVT_F64
typedef unsigned long long PvtRealBits;
#define PVT_REAL_BITS(x) __double_as_longlong(x)
#define PVT_BITS_REAL(x) __longlong_as_double(x)
#else
typedef unsigned int PvtRealBits;
#define PVT_REAL_BITS(x) __float_as_uint(x)
#define PVT_BITS_REAL(x) __uint_as_float(x)
#endif
PVT_FN void pvt_add8(pvt_real* p, const pvt_real* v) {
#ifdef __CUDA_ARCH__
  PvtRealBits* w = reinterpret_cast<PvtRealBits*>(p);
  PvtRealBits held[8];
  unsigned int todo = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    held[k] = reinterpret_cast<volatile PvtRealBits*>(w)[k];
    if (v[k] != 0.0f) todo |= 1u << k;
  }
  while (todo) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!(todo >> k & 1u)) continue;
      const PvtRealBits got =
          atomicCAS(w + k, held[k], (PvtRealBits)PVT_REAL_BITS(PVT_BITS_REAL(held[k]) + v[k]));
      if (got == held[k]) todo &= ~(1u << k);
      held[k] = got;
    }
  }
#else
  for (int k = 0; k < 8; ++k)
    if (v[k] != 0.0f) p[k] += v[k];
#endif
}

// Scene tensors and run constants (field order mirrored by the ctypes
// Structure in pvtrace_tpu_torch/kernels/__init__.py). K9's facet groups
// (engine/tables.py) come last: key k's groups are [rec_grp[k],
// rec_grp[k + 1]), group g's recorders rec_ids[grp_pos[g] .. grp_pos[g +
// 1]) and its facet test grp_f[g] (GF_*), and every event that matches
// one of a group's recorders matches them all.
struct PvtScene {
  const pvt_real* node_f;
  const int* node_i;
  const pvt_real* comp_f;
  const int* comp_i;
  const pvt_real* ovr_f;
  const int* ovr_i;
  const pvt_real* tri_f;
  const pvt_real* light_f;
  const int* light_i;
  const pvt_real* spec_pack;
  const pvt_real* ems_icdf_pairs;
  const pvt_real* light_icdf_pairs;
  const int* cheb_slot;
  const int* cheb_ref;
  const pvt_word* cheb_pack;
  const pvt_real* rec_f;
  const int* rec_i;
  const pvt_real* hist_f;
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
  int n_tris;
  int maxsteps;
  int emit_method;
  int cheb_spec;
  int cheb_icdf;
  int cheb_light;
  int cheb_icdf0;
  int cheb_light0;
  int cheb_words;
  int n_rec;
  int total_bins;
  pvt_real grid_x0;
  pvt_real grid_dx;
  pvt_real maxpathlength;
  pvt_real cheb_tscale;
  const int* rec_grp;
  const int* grp_pos;
  const pvt_real* grp_f;
  int n_grp;
  int grp_max;
};

struct Photon {
  pvt_real px, py, pz, dx, dy, dz, wav, trav, dur;
  int source, count;
  bool alive;
};

// The cumulative K5a slots a step keeps in registers (alpha_slot).
constexpr int kHeldSlots = 2;

struct StepOut {
  int hit, container, sel, tnode;
  bool exit_mask, losing, reacting, kills, no_hit_term, have_n, surface_event;
  pvt_real wn[3], c_in;  // hit surface's world normal and |cos| on surface events
  // What the event log records besides (step_one with kLog), and what the
  // score channels read (with kScore; the shared fields with either)
  int adjacent, comp, source_pre;
  bool kill_max, adj_bad, absorbed, emitting, scattering, reflecting, transmitting;
  pvt_real dur_adv;
  // The score channels' inputs (kScore): alive after the no-hit and kill
  // masks, the distance moved, the container's total attenuation, and on
  // a surface event the two indices, the reflectivity after the overrides
  // and whether the reflect/transmit was a Fresnel coin.
  bool moving, fres_coin;
  pvt_real advance, alpha, n1r, n2r, refl_r;
  // What the pathwise channels' tangent map reads besides (kPath): the
  // nearest hit's distance, its candidate and a mesh hit's triangle, the
  // facet override (-1 for none), TIR, and whether the volume event was
  // radiative (and with `emitting`, an emission).
  pvt_real t0;
  int cand, tri, mode;
  bool tir, radiative;
  // The container's cumulative K5a slots 0 .. kHeldSlots - 1 at the
  // incoming wavelength (alpha_slot; read by the roulette and kScore).
  pvt_real held[kHeldSlots];
};

// Structure-of-arrays lane state and flags of pvt_emit / pvt_step (field
// order mirrored by the ctypes Structures of kernels/__init__.py).
struct PvtState {
  pvt_real *px, *py, *pz, *dx, *dy, *dz, *wav, *trav, *dur;
  int *source, *count;
  unsigned char* alive;
  long long *k0, *k1;
};

struct PvtFlags {
  int *hit, *container;
  unsigned char *exit_mask, *losing, *reacting, *kills, *no_hit_term;
  int *sel, *tnode;
  unsigned char *have_n, *surface_event;
  pvt_real *wnx, *wny, *wnz, *c_in;
};

struct FateCounts {
  unsigned long long exit, nonrad, react, kill, no_hit, steps;
};

// K9 accumulators of one block (shared memory) or of the host harness:
// crossings, moment sums and distinct rays per recorder, and the bins,
// in bins32 when they fit in shared memory, else straight in bins64. A
// block counts crossings in cross32 and moves them into `cross`, the
// totals (the host adds to `cross`, cross32 null). The float32 sums of a
// recorder move into the float64 sums64 whenever its distinct rays pass
// a multiple of SUMS_FLUSH (recorder_add), so none holds more than
// SUMS_FLUSH addends however many photons the block traces. The float64
// build adds straight into its double sums, as the JAX package adds in
// the run's dtype, and moves nothing (sums64 unused).
struct PvtTally {
  unsigned long long* cross;
  pvt_real* sums;
  unsigned int* distinct;
  unsigned int* bins32;
  unsigned long long* bins64;
  double* sums64;
  unsigned int* cross32;
};

// K9 results in device memory (field order mirrored by ctypes).
struct PvtTallyOut {
  unsigned long long *distinct, *cross, *bins;
  double* sums;
};

// K11: the event log of every `every`-th photon, n_slots rows of
// max_events records, LOG_I ints and LOG_F floats each (engine/
// eventlog.py); photon pid's slot is (pid - first) / every, `first` being
// the first multiple of `every` at or after the run's first pid. A
// recorded photon writes its records from the start of its row and, when
// it dies, their number to counts[slot]; nothing past a row's count is
// written or read, so the launch neither fills the rows nor zeroes more
// than the counts. Field order mirrored by ctypes.
struct PvtLog {
  int* ints;
  pvt_real* floats;
  long long n_slots;
  int max_events;
  unsigned int every;
  unsigned long long first;
  int* counts;
};

// K12: a score run's accumulators (field order mirrored by ctypes):
// per-thread path scores `rows` [ch, stride] (channel-major: thread t's
// channel c at c * stride + t), and the float64 totals, each [.., ch]
// twice over: the signed sums, then the sums of the addends' magnitudes
// (fate_scores [2, 11, ch], rec_scores [2, n_rec, ch]). `shared`, set by
// the launch: a block adds into shared memory and then the totals (1), or
// straight into the totals (0, when ch is too large). `photon`, when not
// null, gets each photon's record at its fold ([ch + 2, photon_n], photon
// id p in column p: its path score, its fate, its step count; the last
// fold wins), which lets a check compare the kernel with its twin photon
// by photon.
//
// K13: with pathwise channels (n_path > 0, the last n_path of the ch), each
// thread also keeps its photon's tangents in `tang` [n_path, 7, stride]
// (channel ci's coordinate k at (ci * 7 + k) * stride + t), and `path`
// [n_path, PATH_I] says what each channel differentiates: the kind
// (PATH_N, a node's refractive index; PATH_GEOM, a geometry parameter),
// the node and the parameter's index in NF_GP.
//
// `shared_rows`: given, whether a trace block may keep its threads' rows
// (score and tangents) in its shared memory; set by the launch, whether
// they are there (trace_layout), `rows` and `tang` then left unused.
struct PvtScore {
  pvt_real* rows;
  double* fate_scores;
  double* rec_scores;
  long long stride;
  int ch;
  int n_comps;
  int shared;
  pvt_real* photon;
  long long photon_n;
  pvt_real* tang;
  const int* path;
  int n_path;
  int shared_rows;
};

// K8's host-bundle start (trace_bundle): photons whose lights the host
// emitted (engine/emit.py). Photon pid starts from column pid - first of
// `rows` [7, n] (px, py, pz, dx, dy, dz, wav: structure of arrays, so the
// loads of a warp's consecutive pids coalesce). rows null: each photon is
// emitted on the device (emit_one). Field order mirrored by ctypes.
struct PvtBundle {
  const pvt_real* rows;
  long long n;
  unsigned long long first;
};

// One thread's view of them: its row, the accumulators it adds to (a
// block's shared copies or the totals), and the per-photon records. Its
// rows are a column of `rows` and `tang` (stride s.stride), or of the
// block's shared copy (stride kBlock): channel c at row[c * stride].
struct ScoreAcc {
  pvt_real* row;
  double* fate;
  double* rec;
  long long stride;
  int ch;
  int n_comps;
  int n_rec;
  pvt_real* photon;
  long long photon_n;
  pvt_real* tang;
  const int* path;
  int n_path;
};

// ---------------------------------------------------------------------
// What a block of the trace kernel shares, and where. Its dynamic shared
// memory holds, in this order and each while it fits its budget
// (trace_shape's: kSharedTallyLimit, kSharedLimitF64 or
// kSharedLimitLogF64) after the ones
// before it: the recorder tallies (K9), the float64 score sums (K12), its
// threads' score and tangent rows (K12, K13), the K5a table, the mesh
// triangles (K10).
// What does not fit stays in device memory, read and written by the same
// code through the same generic pointers. Host-callable: the launch,
// pvt_layout (tracer.cu) and the host build's tests share it.

// Threads of a block, in every kernel of the port but the float64 build's
// score, pathwise, recorder and mesh trace kernels (trace_shape).
constexpr int kBlock = 256;
// A block's shared budget: two blocks of 256 threads are resident per SM
// (kMinBlocks, below), and 2 x 96 KB fits the SM's 228 KB.
// Larger recorder bin sets (big heatmaps) go straight to 64-bit atomics in
// device memory.
constexpr size_t kSharedTallyLimit = 96 * 1024;

// Blocks of the trace kernel resident per SM, which caps a thread at 128
// registers: left free, nvcc gives the main path's instantiation and the
// heavier ones more and one block per SM, which ran slower than two
// blocks that spill a little (an A/B build on the H100; again with the
// step-a-turn loop: as fast on pvt_trace, slower with score or pathwise
// channels; PERF.md, section 6).
constexpr int kMinBlocks = 2;

// The float64 build's trace kernels with score channels (K12, K13), and
// those with recorders (K9) or meshes (K10) and without the event log:
// blocks of kBlockF64 threads, kMinBlocksF64 of them resident an
// SM: five warps on each of the SM's four schedulers, whose 16,384
// registers leave a thread 96 (in steps of 8). Their doubles take two
// registers each, and 20 warps an SM that spill more hide the float64
// pipe's and the shared atomics' latency better than 16 at 128 registers
// (an A/B on the H100; PERF.md, section 6): the score kernels spilled up
// to 1,248 bytes a thread at two blocks of 256, and one block of 256 (255
// registers, no spill) ran 1.29-1.56 times slower than that; the recorder
// and mesh kernels ran faster at five of 128 (slab with 32 recorders
// -11.9 %, with 256 -7.4 %, the mesh LSC -3.3 %, R = 4 as fast), and
// slower at 12 warps of 162-168 registers without a spill, at 24 of 80,
// and in blocks of 192. A block's budget is then the SM's 228 KB over five
// blocks, less the 1 KB the card keeps for each: 44 KB, which leaves 256
// recorders' bins in device memory, and that too ran faster. A host
// bundle's kernels with recorders or meshes take that shape too: the
// host-lit slab with 4 recorders ran 2 % faster there at 2**24 photons
// than at two blocks of 256, 8 % with float uniforms (main_step). The float64 main path, and
// the bundle's launch that runs its step, keep two blocks of 256, the
// event log's kernels take kMinBlocksLogF64 (below), and the float32
// build keeps kBlock, kMinBlocks and kSharedTallyLimit for every one. On
// the main path those blocks spill
// (128 registers) and still ran the slab faster than every other shape
// timed: five blocks of 128 (96 registers) by 3 %, 128 x 3 and 192 x 2
// without a spill (168 registers) by 17-18 %, 256 x 1 (184) by 62 % (A/Bs
// on the H100; PERF.md, section 6): its 16 warps an SM hide the float64
// pipe's latency, and its turn is bound by the double math.
constexpr int kBlockF64 = 128;
constexpr int kMinBlocksF64 = 5;
constexpr size_t kSharedLimitF64 = (228 / kMinBlocksF64 - 1) * 1024;
// The float64 build's trace kernels with the event log (K11) and without
// score channels: blocks of kBlockF64 threads, kMinBlocksLogF64 of them an
// SM, so 16 warps at 128 registers, and a block's budget the SM's 228 KB
// over four less 1 KB: 56 KB. A recorded photon's lane stores a record
// most steps, and its kernel holds the record's operands and its slot
// beside the step's: at five blocks of 128 (96 registers) it spilled
// twice as much and ran 23-30 % slower where every photon is recorded, at
// three of 192 (96 registers) 4-21 % slower; four of 128 ran the mesh
// LSC's history at 2**27 with the log at 1000 1.9 % faster than two of
// 256 (359.7 against 366.8 ms, both with float uniforms, main_step), with
// the log at 1 1.4 %, and no slower elsewhere (A/Bs on the H100; PERF.md,
// section 6).
constexpr int kMinBlocksLogF64 = 4;
constexpr size_t kSharedLimitLogF64 = (228 / kMinBlocksLogF64 - 1) * 1024;

// A trace instantiation's block: its threads, the blocks of it resident an
// SM (its __launch_bounds__) and a block's shared budget (trace_layout).
struct TraceShape {
  int threads, blocks;
  size_t limit;
};

// The shape of the trace instantiation with recorders (`tally`), the event
// log, meshes, score channels and a host bundle as given: in the float32
// build kBlock and kMinBlocks for every one. (A bundle moves no shape: a
// host-given photon's kernel takes its device-emitted twin's.)
PVT_FN constexpr TraceShape trace_shape(bool tally, bool log, bool mesh, bool score,
                                        bool bundle) {
#ifdef PVT_F64
  return (void)bundle,
         score || (!log && (tally || mesh))
             ? TraceShape{kBlockF64, kMinBlocksF64, kSharedLimitF64}
         : log ? TraceShape{kBlockF64, kMinBlocksLogF64, kSharedLimitLogF64}
               : TraceShape{kBlock, kMinBlocks, kSharedTallyLimit};
#else
  return (void)tally, (void)log, (void)mesh, (void)score, (void)bundle,
         TraceShape{kBlock, kMinBlocks, kSharedTallyLimit};
#endif
}

// A score or pathwise kernel's block (trace_shape's with score channels,
// whatever else the launch has): the stride of its shared rows.
constexpr int kScoreBlock = trace_shape(false, false, false, true, false).threads;

// Whether a trace instantiation's K10 takes the wide loop
// (mesh_nearest_two's kWide): the float64 build's with meshes and neither
// the event log, scores nor a bundle; and pvt_mesh in the float64 build.
// The log's and the bundle's mesh kernels ran 0.2-1.5 % slower with it at
// their shapes (an A/B on the H100; PERF.md, section 6).
PVT_FN constexpr bool wide_mesh(bool log, bool mesh, bool score, bool bundle) {
#ifdef PVT_F64
  return mesh && !log && !score && !bundle;
#else
  return (void)log, (void)mesh, (void)score, (void)bundle, false;
#endif
}

// Whether a trace instantiation's step and start are the float64 main
// path's: the float64 build's without score channels, and either without
// recorders and meshes (the main path's launch, and the bundle's, which
// runs the same step) or with the event log or from a host bundle. Its
// step and start hold their uniforms as floats, widened where read, and
// take an angle's sine and cosine from one sincos (bit-equal to sin and
// cos at every angle a trace takes, on the card and the host): the same
// results, 3.3 % faster on the slab at 2^27, 6.7 % with K5b, its spill
// stores 136 bytes where they were 176; with the log (two blocks of 256)
// 0-6 % faster, from a bundle with recorders (five of 128) 6 % (A/Bs on
// the H100; PERF.md, section 6). The recorder and mesh kernels with
// neither keep their uniforms as doubles (not timed with floats).
// Two Clenshaw chains side by side in alpha_slot, inline or in one call,
// and fates added only at a photon's death ran slower there.
PVT_FN constexpr bool main_step(bool tally, bool log, bool mesh, bool score, bool bundle) {
#ifdef PVT_F64
  return !score && (log || bundle || (!tally && !mesh));
#else
  return (void)tally, (void)log, (void)mesh, (void)score, (void)bundle, false;
#endif
}

// The type a step's or an emission's uniforms are held in: pvt_real, or
// with kFloat float (pvt_uniform's own type, widened where it is read).
template <bool kFloat>
struct PvtUnif {
  typedef pvt_real type;
};
template <>
struct PvtUnif<true> {
  typedef float type;
};

// Bytes of a block's K9 accumulators: crossings u32 [R], sums [8R] of
// pvt_real, distinct u32 [R], then the bins u32 [total_bins] when they are
// shared; the float64 build keeps its 8-byte sums first, aligned. Their
// offsets, in bytes per recorder:
#ifdef PVT_F64
constexpr size_t kTallySums = 0, kTallyCross = 64, kTallyDistinct = 68, kTallyBins = 72;
#else
constexpr size_t kTallyCross = 0, kTallySums = 4, kTallyDistinct = 36, kTallyBins = 40;
#endif
PVT_FN size_t tally_bytes(const PvtScene& sc, bool shared_bins) {
  return kTallyBins * (size_t)sc.n_rec + (shared_bins ? 4 * (size_t)sc.total_bins : 0);
}

// Bytes of a block's K12 accumulators when they are shared: float64
// fate_scores [2, 11, ch] and rec_scores [2, R, ch].
PVT_FN size_t score_bytes(const PvtScene& sc, const PvtScore& s) {
  return s.shared ? 16 * (size_t)s.ch * (N_FATES + (size_t)sc.n_rec) : 0;
}

// `s` with its `shared` decided: the block's score sums go to shared
// memory when they fit its budget `limit` after `offset` bytes of tallies.
PVT_FN PvtScore score_placed(const PvtScene& sc, const PvtScore& s, size_t offset,
                             size_t limit = kSharedTallyLimit) {
  PvtScore placed = s;
  placed.shared = 1;
  placed.shared = offset + score_bytes(sc, placed) <= limit ? 1 : 0;
  return placed;
}

// Offset of the score accumulators: after the tallies, 8-byte aligned.
PVT_FN size_t score_offset(const PvtScene& sc, bool tally, int shared_bins) {
  return ((tally ? tally_bytes(sc, shared_bins) : 0) + 7) / 8 * 8;
}

// Bytes of a block's rows: score [ch] and tangents [n_path, 7] for each
// of its kScoreBlock threads, thread-minor (thread t's channel c at c *
// kScoreBlock + t, so a warp's accesses fall in 32 banks).
PVT_FN size_t rows_bytes(const PvtScore& s) {
  return sizeof(pvt_real) * (size_t)kScoreBlock * ((size_t)s.ch + 7 * (size_t)s.n_path);
}

// Offset of the rows: after the score sums (s.shared placed), 16-byte
// aligned.
PVT_FN size_t rows_offset(const PvtScene& sc, bool tally, int shared_bins, const PvtScore& s) {
  return (score_offset(sc, tally, shared_bins) + score_bytes(sc, s) + 15) / 16 * 16;
}

// Bytes of the scene's K5a table (cheb_pack) when a run reads it: some
// lookup takes K5a.
PVT_FN size_t cheb_bytes(const PvtScene& sc) {
  return sc.cheb_spec || sc.cheb_icdf || sc.cheb_light ? sizeof(pvt_word) * (size_t)sc.cheb_words
                                                       : 0;
}

// Bytes of the scene's mesh triangles (tri_f).
PVT_FN size_t tris_bytes(const PvtScene& sc) {
  return sizeof(pvt_real) * TRI_F * (size_t)sc.n_tris;
}

// A trace block's placement: whether the recorder bins, the score sums and
// the rows are in shared memory, where the K5a table and the triangles
// start there (-1: in device memory), and the block's dynamic shared bytes.
struct TraceLayout {
  int shared_bins, shared_scores, shared_rows, cheb_at, tris_at;
  size_t bytes;
};

// The placement of a launch with recorders (`tally`), score channels
// (`score`, null for none; its `shared_rows` says whether the rows may be
// placed), the event log and a bundle, within the budget of its kernel's
// block (trace_shape; meshes where the scene has triangles). The rows take
// the budget before the K5a table: where only one of the two fits, the
// rows in shared memory ran faster (an A/B on the H100; PERF.md).
PVT_FN TraceLayout trace_layout(const PvtScene& sc, bool tally, const PvtScore* score,
                                bool log = false, bool bundle = false) {
  const size_t limit = trace_shape(tally, log, sc.n_tris > 0, score != nullptr, bundle).limit;
  TraceLayout L;
  L.shared_bins = tally && tally_bytes(sc, true) <= limit ? 1 : 0;
  L.shared_scores = L.shared_rows = 0;
  size_t end = tally ? tally_bytes(sc, L.shared_bins) : 0;
  if (score) {
    const size_t at = score_offset(sc, tally, L.shared_bins);
    const PvtScore s = score_placed(sc, *score, at, limit);
    L.shared_scores = s.shared;
    end = at + score_bytes(sc, s);
    const size_t rows_at = rows_offset(sc, tally, L.shared_bins, s);
    L.shared_rows = score->shared_rows && rows_at + rows_bytes(s) <= limit ? 1 : 0;
    if (L.shared_rows) end = rows_at + rows_bytes(s);
  }
  const size_t cheb_start = (end + 15) / 16 * 16;
  const bool cheb = cheb_bytes(sc) > 0 && cheb_start + cheb_bytes(sc) <= limit;
  L.cheb_at = cheb ? (int)cheb_start : -1;
  if (cheb) end = cheb_start + cheb_bytes(sc);
  const size_t tris_start = (end + 15) / 16 * 16;
  const bool tris = sc.n_tris > 0 && tris_start + tris_bytes(sc) <= limit;
  L.tris_at = tris ? (int)tris_start : -1;
  L.bytes = tris ? tris_start + tris_bytes(sc) : end;
  return L;
}

// A placement as a launch's info reports it: info[1] the block's dynamic
// shared bytes, info[2..6] 1 where the recorder bins, the score sums, the
// K5a table, the rows and the mesh triangles are in shared memory, else 0.
PVT_FN void layout_info(const TraceLayout& L, long long* info) {
  info[1] = (long long)L.bytes;
  info[2] = L.shared_bins;
  info[3] = L.shared_scores;
  info[4] = L.cheb_at >= 0 ? 1 : 0;
  info[5] = L.shared_rows;
  info[6] = L.tris_at >= 0 ? 1 : 0;
}

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

// A uniform in [0, 1) from a word's top 23 bits, in float32 in every
// build (the JAX package's _uniform32).
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

// 2n uniforms from counters (c0, first + j), j < n. Returns the threefry
// calls it made (pvt_draws counts them; unused elsewhere).
template <typename U>
PVT_FN int pvt_draw(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t first, int n, U* u) {
  int calls = 0;
  for (int j = 0; j < n; ++j) {
    uint32_t w0, w1;
    threefry(k0, k1, c0, first + (uint32_t)j, w0, w1);
    ++calls;
    u[2 * j] = pvt_uniform(w0);
    u[2 * j + 1] = pvt_uniform(w1);
  }
  return calls;
}

// K2's draws: emission pair j of a photon is threefry(key, (0, 16 + j)),
// emit_one's u[2j], u[2j + 1]; the JAX package draws all three
// (_device_emit_flat). light_pairs gives the pairs a lamp reads (bit j:
// pair j): pair 0 for a spectrum's wavelength (u[0]) or a position (u[1]),
// pair 1 for a position (u[2], u[3]), pair 2 for a direction (u[4], u[5]);
// kernels/check.py's light_pairs mirrors it for the bound, and the CPU
// tests hold the two equal. emit_pairs gives those of every lamp of the
// scene, one mask for every photon, so that the lanes of a warp, whatever
// their lamps, draw the same pairs; the others are never read, and every
// word read is pvt_draw's bit for bit. The bench slab's lamp (one
// wavelength, from a point, in a cone) reads pair 2 alone: a refill makes
// two threefry calls, the key and one pair, where it made four (PERF.md,
// section 6).
PVT_FN unsigned light_pairs(const int* lk) {
  const bool pos = lk[LI_POS] != POS_DEFAULT;
  return (lk[LI_WAV] != WAV_CONST || pos ? 1u : 0u) | (pos ? 2u : 0u) |
         (lk[LI_DIR] != DIR_DEFAULT ? 4u : 0u);
}

PVT_FN unsigned emit_pairs(const PvtScene& sc) {
  unsigned need = 0u;
  for (int li = 0; li < sc.n_lights; ++li) need |= light_pairs(sc.light_i + li * LIGHT_I);
  return need;
}

// The emission uniforms of the pairs of `need` (key k0, k1) into u[6]: all
// three as pvt_draw draws them (three chains the compiler interleaves; a
// pair at a time ran 1.9 % slower on the mixed scene, whose lamps read all
// three), else the pairs one by one. Returns the threefry calls it made.
template <typename U>
PVT_FN int emit_draws(uint32_t k0, uint32_t k1, unsigned need, U* u) {
  if (need == 7u) return pvt_draw(k0, k1, 0u, 16u, 3, u);
  int calls = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (!(need >> j & 1u)) continue;
    uint32_t w0, w1;
    threefry(k0, k1, 0u, 16u + (uint32_t)j, w0, w1);
    ++calls;
    u[2 * j] = pvt_uniform(w0);
    u[2 * j + 1] = pvt_uniform(w1);
  }
  return calls;
}

// ---------------------------------------------------------------------
// K5b: lerps in the spectral tables.
PVT_FN pvt_real clampf(pvt_real x, pvt_real lo, pvt_real hi) {
  return pvt_fmin(pvt_fmax(x, lo), hi);
}

// Inverse-CDF lerp in rows [base, base + M) of a pairs table (fraction
// not clipped; the float is clamped before the integer cast).
PVT_FN pvt_real lerp_pairs(const pvt_real* pairs, int base, int M, pvt_real gamma) {
  pvt_real g = gamma * (pvt_real)(M - 1);
  int j0 = (int)clampf(g, 0.0f, (pvt_real)(M - 2));
  pvt_real gfrac = g - (pvt_real)j0;
  const pvt_real* p = pairs + 2 * (size_t)(base + j0);
  return p[0] + gfrac * (p[1] - p[0]);
}

// Slot w of spec_pack row `row` at fraction `frac`.
PVT_FN pvt_real spec_lerp(const PvtScene& sc, int row, int w, pvt_real frac) {
  const pvt_real* p = sc.spec_pack + (size_t)row * 2 * sc.pack_width + 2 * w;
  return p[0] + frac * (p[1] - p[0]);
}

// ---------------------------------------------------------------------
// K5a: piecewise-Chebyshev fits (engine/chebyshev.py), read from the
// packed table cheb_pack (engine/tables.py): fit and segment records of
// four words (16 bytes; 32 in the float64 build, whose words are 8),
// each piecewise fit's interior breakpoints, and each segment's
// coefficients from the highest degree down from a record's boundary.
// Replaces _clenshaw / _eval_fit (pvtrace_tpu/engine/tracer.py). The
// trace kernels copy the table into a block's shared memory when it fits
// there, else read it in device memory (trace_kernel.cuh); `tab` points at
// either, and plain (generic) loads serve both. The compiler's piecewise
// fits partition [-1, 1] (the host checks it), so the one segment the
// reference's masks select (the first takes t < b, the last t >= a, a
// middle one a <= t < b) is the count of breakpoints <= t: a binary search
// of ceil(log2 nseg) steps in place of a scan of every segment. NaN t
// selects none (0.0) in a fit of more than one segment, as the masks do.
// Then one Clenshaw chain of the segment's degree, four coefficients to a
// 16-byte load (two in the float64 build) ahead of their dependent FMAs. Bound by operations (the
// search's steps and the chain's FMAs; about a third fewer instructions a
// fit than the scan took); the table stays in shared memory or L1.

// A word of the K5a table as the real whose bits it holds.
PVT_FN pvt_real pvt_word_real(pvt_word w) {
#if defined(__CUDA_ARCH__) && defined(PVT_F64)
  return __longlong_as_double(w);
#elif defined(__CUDA_ARCH__)
  return __int_as_float(w);
#else
  pvt_real v;
  memcpy(&v, &w, sizeof v);
  return v;
#endif
}

// Four words of the K5a table from a 16-byte boundary, as reals: one
// 16-byte load, two in the float64 build.
PVT_FN void pvt_load4(const pvt_word* p, pvt_real* c) {
#if defined(__CUDA_ARCH__) && defined(PVT_F64)
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  c[0] = q0.x;
  c[1] = q0.y;
  c[2] = q1.x;
  c[3] = q1.y;
#elif defined(__CUDA_ARCH__)
  const float4 q = *reinterpret_cast<const float4*>(p);
  c[0] = q.x;
  c[1] = q.y;
  c[2] = q.z;
  c[3] = q.w;
#else
  memcpy(c, p, 4 * sizeof(pvt_real));
#endif
}

// The largest power of two <= n (n >= 1).
PVT_FN int pvt_top_pow2(int n) {
#ifdef __CUDA_ARCH__
  return 1 << (31 - __clz(n));
#else
  return 1 << (31 - __builtin_clz((unsigned)n));
#endif
}

// Word offset in `tab` of fit `fit`'s segment record for t (-1: none):
// the count of its interior breakpoints <= t, by halving steps.
PVT_FN int cheb_segment(const pvt_word* tab, int fit, pvt_real t) {
  const pvt_word* fr = tab + CHEB_REC * fit;
  const int nb = (int)fr[FR_NSEG] - 1;
  int s = 0;
  if (nb > 0) {
    if (t != t) return -1;
    const pvt_word* brk = tab + fr[FR_BRK];
    for (int step = pvt_top_pow2(nb); step > 0; step >>= 1) {
      const int j = s + step;
      if (j <= nb && pvt_word_real(brk[j - 1]) <= t) s = j;
    }
  }
  return (int)fr[FR_SEG] + CHEB_REC * s;
}

// One Clenshaw step with coefficient c.
PVT_FN void cheb_step(pvt_real ts, pvt_real c, pvt_real& b1, pvt_real& b2) {
  const pvt_real nb = 2.0f * ts * b1 - b2 + c;
  b2 = b1;
  b1 = nb;
}

// Fit `fit` of the table `tab` at t: its segment's Clenshaw chain in whole
// chunks of four steps (a record's width), then the last deg mod 4 steps
// and c_0.
PVT_CALLED_FN pvt_real cheb_eval(const pvt_word* tab, int fit, pvt_real t) {
  const int s = cheb_segment(tab, fit, t);
  if (s < 0) return 0.0f;
  const pvt_word* sr = tab + s;
  const int info = (int)sr[SR_DEG], deg = info & SEG_DEG_MASK;
  const pvt_real ts =
      info & SEG_MAP
          ? clampf((t - pvt_word_real(sr[SR_A])) * pvt_word_real(sr[SR_SCALE]) - 1.0f, -1.0f,
                   1.0f)
          : t;
  const pvt_word* c = tab + sr[SR_COEF];
  pvt_real b1 = 0.0f, b2 = 0.0f, q[4];
  int j = 0;
  for (; j + 4 <= deg; j += 4) {
    pvt_load4(c + j, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) cheb_step(ts, q[e], b1, b2);
  }
  pvt_load4(c + j, q);  // the last deg - j < 4 steps, then c_0
  pvt_real c0 = q[0];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    if (j + e < deg) cheb_step(ts, q[e], b1, b2);
    if (j + e + 1 == deg) c0 = q[e + 1];
  }
  pvt_real v = ts * b1 - b2 + c0;
  if (info & SEG_LOG) v = pvt_exp(v) - pvt_word_real(tab[CHEB_REC * fit + FR_OFF]);
  return v;
}

// The sum of the fits of K5a slot w of `container` at t, in the slot's
// order (a cumulative slot lists its components' fits).
PVT_FN pvt_real slot_fits(const PvtScene& sc, const pvt_word* cheb, int container, int w,
                          pvt_real t) {
  const int* slot = sc.cheb_slot + 2 * (container * sc.pack_width + w);
  pvt_real v = 0.0f;
  for (int q = 0; q < slot[1]; ++q) v += cheb_eval(cheb, sc.cheb_ref[slot[0] + q], t);
  return v;
}

// Spectral slot w of the lane's container: K5a (the sum of the slot's
// fits at t) when the scene takes it, else K5b (the lerp in row `row`).
PVT_FN pvt_real spec_slot(const PvtScene& sc, const pvt_word* cheb, int container, int row, int w,
                          pvt_real frac, pvt_real t) {
  return sc.cheb_spec ? slot_fits(sc, cheb, container, w, t) : spec_lerp(sc, row, w, frac);
}

// Slot K - 1 of a container of K components, its attenuation, as
// spec_slot gives it, each of its K component fits evaluated once. On K5a
// the partial sum after fit k is cumulative slot k (the compiler lists in
// slot k the first k + 1 of slot K - 1's fits, in the same order; the host
// checks it), and held[k] keeps it for k < kHeldSlots: the roulette and
// the score channels read those (cum_slot) and evaluate nothing again.
PVT_FN pvt_real alpha_slot(const PvtScene& sc, const pvt_word* cheb, int container, int row, int K,
                           pvt_real frac, pvt_real t, pvt_real* held) {
  if (!sc.cheb_spec) return spec_lerp(sc, row, K - 1, frac);
  const int* slot = sc.cheb_slot + 2 * (container * sc.pack_width + K - 1);
  pvt_real v = 0.0f;
  for (int q = 0; q < slot[1]; ++q) {
    v += cheb_eval(cheb, sc.cheb_ref[slot[0] + q], t);
#pragma unroll
    for (int k = 0; k < kHeldSlots; ++k)
      if (q == k) held[k] = v;
  }
  return v;
}

// Cumulative slot k < K - 1 of the container at the step's wavelength:
// the value alpha_slot held (K5a, k < kHeldSlots), K5b's lerp, or in a
// node of more than kHeldSlots + 1 components slot k's fits evaluated
// again (registers hold kHeldSlots values; an array indexed by k would
// live in local memory on every step).
PVT_FN pvt_real cum_slot(const PvtScene& sc, const pvt_word* cheb, const pvt_real* held,
                         int container, int row, int k, pvt_real frac, pvt_real t) {
  if (!sc.cheb_spec) return spec_lerp(sc, row, k, frac);
  if (k >= kHeldSlots) return slot_fits(sc, cheb, container, k, t);
  pvt_real v = held[0];
#pragma unroll
  for (int j = 1; j < kHeldSlots; ++j)
    if (k == j) v = held[j];
  return v;
}

// Henyey-Greenstein cosine for s = 2u - 1 (|g| >= 1e-12).
PVT_FN pvt_real hg_mu(pvt_real g, pvt_real s) {
  pvt_real q = (1.0f - g * g) / (1.0f + g * s);
  return clampf((1.0f + g * g - q * q) / (2.0f * g), -1.0f, 1.0f);
}

// ---------------------------------------------------------------------
// K2: emission of photon `pid` with key (k0, k1), from the emission pairs
// of `need` (emit_draws), which hold every pair its lamp reads. kMain (the
// float64 main path's start, main_step): the uniforms held as floats, and
// each angle's sine and cosine from one sincos.
template <bool kMain = false>
PVT_FN void emit_one(const PvtScene& sc, const pvt_word* cheb, uint32_t k0, uint32_t k1,
                     uint32_t pid, unsigned need, Photon& p) {
  typename PvtUnif<kMain>::type u[6];
  emit_draws(k0, k1, need, u);
  const int li = (int)(pid % (uint32_t)sc.n_lights);
  const pvt_real* lf = sc.light_f + li * LIGHT_F;
  const int* lk = sc.light_i + li * LIGHT_I;
  pvt_real w = lf[LF_WAV];
  if (lk[LI_WAV] != WAV_CONST)
    w = sc.cheb_light
            ? cheb_eval(cheb, sc.cheb_light0 + lk[LI_ROW], 2.0f * (pvt_real)u[0] - 1.0f)
            : lerp_pairs(sc.light_icdf_pairs, lk[LI_ROW] * sc.icdf_n, sc.icdf_n, (pvt_real)u[0]);
  const pvt_real a = lf[LF_POS], b = lf[LF_POS + 1], c = lf[LF_POS + 2];
  pvt_real lx = 0.0f, ly = 0.0f, lz = 0.0f;
  if (lk[LI_POS] == POS_RECT) {
    lx = (2.0f * (pvt_real)u[1] - 1.0f) * a;
    ly = (2.0f * (pvt_real)u[2] - 1.0f) * b;
  } else if (lk[LI_POS] == POS_CIRCLE) {
    pvt_real r = pvt_sqrt((pvt_real)u[1]) * a;
    pvt_real ang = PVT_TWO_PI * (pvt_real)u[2];
    if constexpr (kMain) {
      pvt_real sn, cs;
      pvt_sincos(ang, &sn, &cs);
      lx = r * cs;
      ly = r * sn;
    } else {
      lx = r * pvt_cos(ang);
      ly = r * pvt_sin(ang);
    }
  } else if (lk[LI_POS] != POS_DEFAULT) {
    lx = (2.0f * (pvt_real)u[1] - 1.0f) * a;
    ly = (2.0f * (pvt_real)u[2] - 1.0f) * b;
    lz = (2.0f * (pvt_real)u[3] - 1.0f) * c;
  }
  pvt_real ldx = 0.0f, ldy = 0.0f, ldz = 1.0f;
  const int dk = lk[LI_DIR];
  if (dk != DIR_DEFAULT) {
    pvt_real mu, st;
    const pvt_real u4 = u[4];
    if (dk == DIR_CONE) {
      st = pvt_sqrt(u4) * lf[LF_SIN_DIR];
      mu = pvt_sqrt(pvt_fmax(1.0f - st * st, 0.0f));
    } else if (dk == DIR_ISOTROPIC) {
      mu = 2.0f * u4 - 1.0f;
      st = pvt_sqrt(pvt_fmax(1.0f - mu * mu, 0.0f));
    } else if (dk == DIR_LAMBERTIAN) {
      st = pvt_sqrt(u4);
      mu = pvt_sqrt(pvt_fmax(1.0f - u4, 0.0f));
    } else {
      mu = hg_mu(lf[LF_DIR], 2.0f * u4 - 1.0f);
      st = pvt_sqrt(pvt_fmax(1.0f - mu * mu, 0.0f));
    }
    pvt_real phi = PVT_TWO_PI * (pvt_real)u[5];
    if constexpr (kMain) {
      pvt_real sn, cs;
      pvt_sincos(phi, &sn, &cs);
      ldx = st * cs;
      ldy = st * sn;
    } else {
      ldx = st * pvt_cos(phi);
      ldy = st * pvt_sin(phi);
    }
    ldz = mu;
  }
  const pvt_real* m = lf + LF_MAT;
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

// K8's host-bundle start: photon pid's row of the bundle, in the state
// emit_one leaves (source -1, count 0, alive; _run's init).
PVT_FN void load_one(const PvtBundle& b, uint32_t pid, Photon& p) {
  const pvt_real* r = b.rows + ((unsigned long long)pid - b.first);
  p.px = r[0];
  p.py = r[b.n];
  p.pz = r[2 * b.n];
  p.dx = r[3 * b.n];
  p.dy = r[4 * b.n];
  p.dz = r[5 * b.n];
  p.wav = r[6 * b.n];
  p.trav = 0.0f;
  p.dur = 0.0f;
  p.source = -1;
  p.count = 0;
  p.alive = true;
}

// ---------------------------------------------------------------------
// K3: forward-hit candidates of one node in its local frame. Writes up
// to four (t, valid) pairs in candidate order and returns their number.
PVT_FN int intersect_node(int gtype, const pvt_real* gp, const pvt_real* o,
                          const pvt_real* d, pvt_real eps, pvt_real* t, bool* v) {
  if (gtype == GEOM_BOX) {
    pvt_real tmin = -PVT_INF, tmax = PVT_INF;
    bool miss = false;
    for (int k = 0; k < 3; ++k) {
      const pvt_real h = 0.5f * gp[k], oo = o[k], dd = d[k];
      const bool par = pvt_fabs(dd) < PVT_R(1e-30);
      const pvt_real inv = 1.0f / (par ? 1.0f : dd);
      const pvt_real t1 = (-h - oo) * inv, t2 = (h - oo) * inv;
      const pvt_real lo = par ? -PVT_INF : pvt_fmin(t1, t2);
      const pvt_real hi = par ? PVT_INF : pvt_fmax(t1, t2);
      miss = miss || (par && (oo < -h || oo > h));
      tmin = pvt_fmax(tmin, lo);
      tmax = pvt_fmin(tmax, hi);
    }
    const bool ok = tmax >= tmin && !miss;
    t[0] = tmin;
    v[0] = ok && tmin > eps;
    t[1] = tmax;
    v[1] = ok && tmax > eps;
    return 2;
  }
  if (gtype == GEOM_SPHERE) {
    const pvt_real r = gp[0];
    const pvt_real a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const pvt_real b = 2.0f * (d[0] * o[0] + d[1] * o[1] + d[2] * o[2]);
    const pvt_real c = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - r * r;
    const pvt_real disc = b * b - 4.0f * a * c;
    const bool ok = disc >= 0.0f;
    const pvt_real sq = pvt_sqrt(ok ? disc : 0.0f);
    t[0] = (-b - sq) / (2.0f * a);
    t[1] = (-b + sq) / (2.0f * a);
    v[0] = ok && t[0] > eps;
    v[1] = ok && t[1] > eps;
    return 2;
  }
  const pvt_real half = 0.5f * gp[0], r = gp[1];
  const pvt_real a = d[0] * d[0] + d[1] * d[1];
  const bool hasb = a > PVT_R(1e-30);
  const pvt_real sa = hasb ? a : 1.0f;
  const pvt_real b = 2.0f * (o[0] * d[0] + o[1] * d[1]);
  const pvt_real c = o[0] * o[0] + o[1] * o[1] - r * r;
  const pvt_real disc = b * b - 4.0f * a * c;
  const bool ok = hasb && disc >= 0.0f;
  const pvt_real sq = pvt_sqrt(disc >= 0.0f ? disc : 0.0f);
  t[0] = (-b - sq) / (2.0f * sa);
  t[1] = (-b + sq) / (2.0f * sa);
  for (int k = 0; k < 2; ++k) {
    const pvt_real z = o[2] + t[k] * d[2];
    v[k] = ok && z > -half && z < half && t[k] > eps;
  }
  const bool hasc = pvt_fabs(d[2]) > PVT_R(1e-30);
  const pvt_real sdz = hasc ? d[2] : 1.0f;
  for (int k = 0; k < 2; ++k) {
    const pvt_real zcap = k == 0 ? -half : half;
    const pvt_real tc = (zcap - o[2]) / sdz;
    const pvt_real x = o[0] + tc * d[0], y = o[1] + tc * d[1];
    t[2 + k] = tc;
    v[2 + k] = hasc && x * x + y * y <= r * r && tc > eps;
  }
  return 4;
}

// Triangle k's test in mesh_nearest_two's loops (its v0 in a0..a2, e1 in
// e10..e12, e2 in e20..e22): one text for both loops.
#define PVT_MESH_TRIANGLE                                                   \
  const pvt_real pvx = d[1] * e22 - d[2] * e21;                             \
  const pvt_real pvy = d[2] * e20 - d[0] * e22;                             \
  const pvt_real pvz = d[0] * e21 - d[1] * e20;                             \
  const pvt_real det = e10 * pvx + e11 * pvy + e12 * pvz;                   \
  const bool ok = pvt_fabs(det) > PVT_R(1e-14);                             \
  const pvt_real inv = 1.0f / (ok ? det : 1.0f);                            \
  const pvt_real tvx = o[0] - a0, tvy = o[1] - a1, tvz = o[2] - a2;         \
  const pvt_real u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;             \
  const pvt_real qvx = tvy * e12 - tvz * e11;                               \
  const pvt_real qvy = tvz * e10 - tvx * e12;                               \
  const pvt_real qvz = tvx * e11 - tvy * e10;                               \
  const pvt_real v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) * inv;          \
  const pvt_real th = (e20 * qvx + e21 * qvy + e22 * qvz) * inv;            \
  const bool hit = ok && u >= -PVT_R(1e-12) && v >= -PVT_R(1e-12) &&        \
                   u + v <= (pvt_real)(1.0 + 1e-12) && th > eps;            \
  cnt += hit;                                                               \
  const pvt_real tv = hit ? th : PVT_INF;                                   \
  if (tv < t1) {                                                            \
    t2 = t1;                                                                \
    t1 = tv;                                                                \
    first = k;                                                              \
  } else if (tv < t2) {                                                     \
    t2 = tv;                                                                \
  }

// K10: Möller–Trumbore over the n_tris triangles `tri` (rows of TRI_F:
// v0, e1, e2, face normal) of one mesh node, in its local frame. Writes
// the nearest two forward hits (strict < in triangle order; PVT_INF where
// there are fewer) and the index of the nearest's triangle (-1 without
// one; `mesh_normal` reads its face normal), and returns the number of
// forward hits. Tolerances as the JAX
// function's: |det| > 1e-14, u, v >= -1e-12, u + v <= 1 + 1e-12 (1 in
// float32), t > eps; no dedup of a hit on a shared edge. Replaces
// _mesh_nearest_two (pvtrace_tpu/engine/tracer.py). Bound by operations:
// about 60 per triangle. A warp's lanes take the same triangle together,
// so its 12 floats are one broadcast a load: `tri` points into the block's
// shared copy (stage_tris, trace_kernel.cuh) where it fit, else into
// device memory, read through the same generic loads. Inlined: only the
// kMesh instantiations and pvt_mesh call it. kWide (the float64 build's
// K10 launches, wide_mesh): the loop unrolled by two and each row's v0,
// e1 and e2 read as five double pairs, 16-byte loads, where the others
// read nine doubles; the same arithmetic in the same order (1-8 % faster
// on the mesh LSC and the tessellated slab, and slower in the launches
// with the event log or scores, which keep the plain loop: an A/B on the
// H100; PERF.md, section 6).
template <bool kWide = false>
PVT_FN int mesh_nearest_two(const pvt_real* tri, int n_tris, const pvt_real* o, const pvt_real* d,
                            pvt_real eps, pvt_real* t1_out, pvt_real* t2_out, int* first_out) {
  pvt_real t1 = PVT_INF, t2 = PVT_INF;
  int cnt = 0, first = -1;
#if defined(__CUDA_ARCH__) && defined(PVT_F64)
  if constexpr (kWide) {
#pragma unroll 2
    for (int k = 0; k < n_tris; ++k) {
      const double2* r = reinterpret_cast<const double2*>(tri + (size_t)k * TRI_F);
      const double2 q0 = r[0], q1 = r[1], q2 = r[2], q3 = r[3], q4 = r[4];
      const pvt_real a0 = q0.x, a1 = q0.y, a2 = q1.x;
      const pvt_real e10 = q1.y, e11 = q2.x, e12 = q2.y;
      const pvt_real e20 = q3.x, e21 = q3.y, e22 = q4.x;
      PVT_MESH_TRIANGLE
    }
    *t1_out = t1;
    *t2_out = t2;
    *first_out = first;
    return cnt;
  }
#endif
  for (int k = 0; k < n_tris; ++k) {
    const pvt_real* r = tri + (size_t)k * TRI_F;
    const pvt_real a0 = r[TF_V0], a1 = r[TF_V0 + 1], a2 = r[TF_V0 + 2];
    const pvt_real e10 = r[TF_E1], e11 = r[TF_E1 + 1], e12 = r[TF_E1 + 2];
    const pvt_real e20 = r[TF_E2], e21 = r[TF_E2 + 1], e22 = r[TF_E2 + 2];
    PVT_MESH_TRIANGLE
  }
  *t1_out = t1;
  *t2_out = t2;
  *first_out = first;
  return cnt;
}
#undef PVT_MESH_TRIANGLE

// The face normal of triangle `first` of `tri`, (0, 0, 1) for -1.
PVT_FN void mesh_normal(const pvt_real* tri, int first, pvt_real* nrm) {
  for (int k = 0; k < 3; ++k)
    nrm[k] = first >= 0 ? PVT_LDG(tri + (size_t)first * TRI_F + TF_N + k) : (k == 2 ? 1.0f : 0.0f);
}

struct Hits {
  pvt_real t0;        // nearest forward hit distance
  int hit;         // its node
  int container;   // node the photon is in
  int adjacent;    // node across the hit surface (-1 when there is none)
  int nhits;       // forward hits over all nodes
  pvt_real lo[3];     // ray in the hit node's local frame
  pvt_real ld[3];
  int tri;         // a mesh hit node's nearest triangle (its row in tri_f)
  int cand;        // the candidate of the hit node that gave t0 (kPath)
};

// K3: nearest two forward hits over all nodes (strict < in node order,
// then candidate order), container and adjacent node. With kMesh a mesh
// node's candidates are its nearest two triangle hits, and all its hits
// count; without, the scene has no mesh and the code has no mesh branch
// (it would cost the other scenes registers: an A/B build on the H100).
// With kPath it also keeps the hit's candidate. `tris`: the scene's
// triangles where a block staged them, null for sc.tri_f. kWide: K10's
// wide loop (mesh_nearest_two).
template <bool kMesh, bool kPath = false, bool kWide = false>
PVT_FN void intersect_nodes(const PvtScene& sc, const Photon& p, Hits& h,
                            const pvt_real* tris = nullptr) {
  pvt_real t1 = PVT_INF, t2 = PVT_INF, cont_t = PVT_INF;
  int n1 = 0, n2 = 0, cont_n = 0, nhits = 0;
  for (int n = 0; n < sc.n_nodes; ++n) {
    const pvt_real* nf = sc.node_f + n * NODE_F;
    const int* ni = sc.node_i + n * NODE_I;
    const pvt_real* R = nf + NF_W2L;
    pvt_real o[3], d[3], t[4];
    bool v[4];
    int tri = -1;
    for (int k = 0; k < 3; ++k) {
      o[k] = R[4 * k] * p.px + R[4 * k + 1] * p.py + R[4 * k + 2] * p.pz + R[4 * k + 3];
      d[k] = R[4 * k] * p.dx + R[4 * k + 1] * p.dy + R[4 * k + 2] * p.dz;
    }
    int nc, cnt_n = 0;
    if (kMesh && ni[NI_GEOM] == GEOM_MESH) {
      const pvt_real* rows = (tris ? tris : sc.tri_f) + (size_t)ni[NI_TRI0] * TRI_F;
      cnt_n = mesh_nearest_two<kWide>(rows, ni[NI_NTRI], o, d, nf[NF_EPS], &t[0], &t[1], &tri);
      if (tri >= 0) tri += ni[NI_TRI0];
      v[0] = cnt_n >= 1;
      v[1] = cnt_n >= 2;
      nc = 2;
    } else {
      nc = intersect_node(ni[NI_GEOM], nf + NF_GP, o, d, nf[NF_EPS], t, v);
      for (int c = 0; c < nc; ++c) cnt_n += v[c];
    }
    pvt_real tmin_n = PVT_INF;
    for (int c = 0; c < nc; ++c) {
      const pvt_real tv = v[c] ? t[c] : PVT_INF;
      tmin_n = pvt_fmin(tmin_n, tv);
      if (tv < t1) {
        t2 = t1;
        n2 = n1;
        t1 = tv;
        n1 = n;
        for (int k = 0; k < 3; ++k) {
          h.lo[k] = o[k];
          h.ld[k] = d[k];
        }
        if (kMesh) h.tri = tri;
        if (kPath) h.cand = c;
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
PVT_FN void local_normal(int gtype, const pvt_real* gp, const pvt_real* q, pvt_real* nrm) {
  if (gtype == GEOM_BOX) {
    pvt_real best = PVT_INF;
    int face = 0;
    for (int k = 0; k < 6; ++k) {
      const pvt_real h = 0.5f * gp[k / 2];
      const pvt_real dist = pvt_fabs(k % 2 == 0 ? q[k / 2] + h : q[k / 2] - h);
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
    pvt_real mag = pvt_sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
    mag = mag == 0.0f ? 1.0f : mag;
    for (int k = 0; k < 3; ++k) nrm[k] = q[k] / mag;
    return;
  }
  const pvt_real half = 0.5f * gp[0];
  const pvt_real atol = PVT_R(1e-8) + PVT_R(1e-5) * pvt_fabs(half);
  const bool bottom = pvt_fabs(q[2] + half) <= atol;
  const bool top = pvt_fabs(q[2] - half) <= atol;
  const pvt_real r = pvt_sqrt(q[0] * q[0] + q[1] * q[1]);
  const pvt_real sr = r == 0.0f ? 1.0f : r;
  nrm[0] = (bottom || top) ? 0.0f : q[0] / sr;
  nrm[1] = (bottom || top) ? 0.0f : q[1] / sr;
  nrm[2] = bottom ? -1.0f : (top ? 1.0f : 0.0f);
}

// ---------------------------------------------------------------------
// K3 + K4 + K5 + K6: one physics step of photon p with uniforms u[0..7]
// (p.count already incremented). Mirrors physics.step of the eager twin.
// With kTally it also gives the recorder selectors and takes the world
// normal on EXIT; without, out.sel is SEL_NONE and the normal is taken
// only where the surface needs it. With kLog it also gives what the event
// log records (StepOut's middle fields); without, those are not set. kMesh
// false: the scene has no mesh. With kScore it also gives the score
// channels' inputs (StepOut's last fields and the shared ones), and with
// kPath (only with kScore) what the pathwise channels' tangent map reads.
// kWide: K10's wide loop (mesh_nearest_two). U: the uniforms' type (float
// in the float64 main path's step, main_step), widened where each is
// read.
template <bool kTally, bool kLog = false, bool kMesh = true, bool kScore = false,
          bool kPath = false, bool kWide = false, typename U = pvt_real,
          bool kMain = main_step(kTally, kLog, kMesh, kScore, false)>
PVT_FN void step_one(const PvtScene& sc, const pvt_word* cheb, Photon& p, const U* u,
                     StepOut& out, const pvt_real* tris = nullptr) {
  constexpr bool kExtras = kLog || kScore;
  Hits h;
  intersect_nodes<kMesh, kPath, kWide>(sc, p, h, tris);
  if (kPath) {
    out.t0 = h.t0;
    out.cand = h.cand;
    out.tri = kMesh ? h.tri : -1;
    out.mode = -1;
    out.tir = out.radiative = out.emitting = false;
  }
  out.hit = h.hit;
  out.container = h.container;
  out.exit_mask = out.losing = out.reacting = out.kills = out.no_hit_term = false;
  out.wn[0] = out.wn[1] = out.wn[2] = out.c_in = 0.0f;

  bool alive = p.alive;
  out.no_hit_term = alive && h.nhits == 0;
  alive = alive && h.nhits != 0;
  const bool kill_max = alive && (p.count > sc.maxsteps || p.trav > sc.maxpathlength);
  alive = alive && !kill_max;

  const pvt_real* cf_node = sc.node_f + h.container * NODE_F;
  const int* ci_node = sc.node_i + h.container * NODE_I;
  const pvt_real n_cont = cf_node[NF_NIDX];
  const bool exit_mask = alive && h.hit == sc.root_id;

  // Free path against the boundary distance.
  const pvt_real posf = (p.wav - sc.grid_x0) / sc.grid_dx;
  const int i0 = (int)clampf(posf, 0.0f, (pvt_real)(sc.grid_n - 2));
  const pvt_real frac = clampf(posf - (pvt_real)i0, 0.0f, 1.0f);
  const int row = h.container * sc.grid_n + i0;
  const pvt_real t = ((pvt_real)i0 + frac) * sc.cheb_tscale - 1.0f;
  const int K = ci_node[NI_NCOMP];
  const pvt_real alpha =
      K > 0 ? alpha_slot(sc, cheb, h.container, row, K, frac, t, out.held) : 0.0f;
  const pvt_real depth =
      alpha > PVT_ALPHA_ZERO ? -pvt_log1p(-(pvt_real)u[0]) / pvt_fmax(alpha, PVT_R(1e-30))
                             : PVT_INF;
  const bool absorbed = alive && !exit_mask && depth < h.t0;
  const pvt_real advance = absorbed ? depth : h.t0;
  if (kScore) {
    out.moving = alive;
    out.advance = advance;
    out.alpha = alpha;
    out.fres_coin = false;
    out.n1r = n_cont;
    out.n2r = 1.0f;
    out.refl_r = 0.0f;
  }
  if (alive) {
    p.px = p.px + p.dx * advance;
    p.py = p.py + p.dy * advance;
    p.pz = p.pz + p.dz * advance;
    p.trav = p.trav + advance;
    p.dur = p.dur + advance * n_cont / PVT_C_CM_PER_S;
  }
  if (kLog) {
    out.dur_adv = p.dur;
    out.source_pre = p.source;
    out.emitting = out.scattering = false;
  }
  if (kExtras) out.comp = -1;

  // Volume event: component roulette, quantum-yield coin, re-emission.
  bool nonrad = false;
  if (absorbed) {
    const pvt_real target = (pvt_real)u[1] * alpha;
    int ordinal = 0;
    for (int k = 0; k < K - 1; ++k)
      ordinal += cum_slot(sc, cheb, out.held, h.container, row, k, frac, t) < target;
    const int cid = ci_node[NI_COMP0] + ordinal;
    const pvt_real* cf = sc.comp_f + cid * COMP_F;
    const int* ci = sc.comp_i + cid * COMP_I;
    const int ctype = ci[CI_TYPE];
    const bool is_lum = ctype == COMP_LUMINOPHORE;
    const bool radiative = (is_lum || ctype == COMP_SCATTERER) && (pvt_real)u[2] < cf[CF_QY];
    if (kExtras) out.comp = cid;
    if (kLog) {
      out.emitting = radiative && is_lum;
      out.scattering = radiative && !is_lum;
    }
    if (kPath) {
      out.radiative = radiative;
      out.emitting = radiative && is_lum;
    }
    if (radiative) {
      pvt_real mu;
      if (ci[CI_PHASE] == PHASE_HG) {
        mu = hg_mu(cf[CF_PHASE], 2.0f * (pvt_real)u[3] - 1.0f);
      } else if (ci[CI_PHASE] == PHASE_CONE) {
        const pvt_real s = pvt_sqrt((pvt_real)u[3]) * cf[CF_SIN_PHASE];
        mu = pvt_sqrt(pvt_fmax(1.0f - s * s, 0.0f));
      } else {
        mu = 2.0f * (pvt_real)u[3] - 1.0f;
      }
      const pvt_real st = pvt_sqrt(pvt_fmax(1.0f - mu * mu, 0.0f));
      const pvt_real phi = PVT_TWO_PI * (pvt_real)u[4];
      if (is_lum) {
        pvt_real p1 = 0.0f;
        if (sc.emit_method != EMIT_FULL)
          p1 = spec_slot(sc, cheb, h.container, row,
                         ci[CI_P1] + (sc.emit_method == EMIT_KT ? 0 : 1), frac, t);
        const pvt_real gamma = p1 + (1.0f - p1) * (pvt_real)u[5];
        p.wav = sc.cheb_icdf
                    ? cheb_eval(cheb, sc.cheb_icdf0 + ci[CI_LUM], 2.0f * gamma - 1.0f)
                    : lerp_pairs(sc.ems_icdf_pairs, ci[CI_LUM] * sc.icdf_n, sc.icdf_n, gamma);
        const pvt_real tau = cf[CF_TAU_RAD];
        p.dur = p.dur + (tau > 0.0f ? -pvt_log1p(-(pvt_real)u[6]) * tau : 0.0f);
      }
      if constexpr (kMain) {
        pvt_real sn, cs;
        pvt_sincos(phi, &sn, &cs);
        p.dx = st * cs;
        p.dy = st * sn;
      } else {
        p.dx = st * pvt_cos(phi);
        p.dy = st * pvt_sin(phi);
      }
      p.dz = mu;
      p.source = cid;
    } else {
      nonrad = true;
      const pvt_real tau = cf[CF_TAU_NR];
      p.dur = p.dur + (tau > 0.0f ? -pvt_log1p(-(pvt_real)u[6]) * tau : 0.0f);
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
    const pvt_real* hf = sc.node_f + h.hit * NODE_F;
    const int* hi = sc.node_i + h.hit * NODE_I;
    pvt_real ln[3];
    if (kMesh && hi[NI_GEOM] == GEOM_MESH) {
      mesh_normal(sc.tri_f, h.tri, ln);
    } else {
      pvt_real q[3];
      for (int k = 0; k < 3; ++k) q[k] = h.lo[k] + h.t0 * h.ld[k];
      local_normal(hi[NI_GEOM], hf + NF_GP, q, ln);
    }
    const pvt_real* Rw = hf + NF_L2W;
    const pvt_real wnx = Rw[0] * ln[0] + Rw[1] * ln[1] + Rw[2] * ln[2];
    const pvt_real wny = Rw[3] * ln[0] + Rw[4] * ln[1] + Rw[5] * ln[2];
    const pvt_real wnz = Rw[6] * ln[0] + Rw[7] * ln[1] + Rw[8] * ln[2];
    const pvt_real ddot = wnx * p.dx + wny * p.dy + wnz * p.dz;
    const pvt_real c_in = clampf(pvt_fabs(ddot), 0.0f, 1.0f);
    out.wn[0] = wnx;
    out.wn[1] = wny;
    out.wn[2] = wnz;
    out.c_in = c_in;
    if (surf) {
      int mode = -1;
      for (int o = hi[NI_OVR0]; o < hi[NI_OVR0] + hi[NI_NOVR] && mode < 0; ++o) {
        const pvt_real* of = sc.ovr_f + o * OVR_F;
        if (pvt_fabs(ln[0] - of[0]) <= of[3] && pvt_fabs(ln[1] - of[1]) <= of[3] &&
            pvt_fabs(ln[2] - of[2]) <= of[3])
          mode = sc.ovr_i[o];
      }
      const pvt_real flip = ddot < 0.0f ? -1.0f : 1.0f;
      const pvt_real nax = wnx * flip, nay = wny * flip, naz = wnz * flip;
      const pvt_real n1r = n_cont;
      const pvt_real n2r = sc.node_f[h.adjacent * NODE_F + NF_NIDX];
      const bool is_fresnel = hi[NI_SURF] == SURF_FRESNEL;
      const pvt_real s2 = clampf(1.0f - c_in * c_in, 0.0f, 1.0f);
      const pvt_real ratio = n1r / n2r;
      pvt_real r = 0.0f;
      bool tir = false;
      if (is_fresnel) {
        tir = n2r < n1r && s2 * ratio * ratio > 1.0f;
        const pvt_real kterm = pvt_sqrt(pvt_fmax(1.0f - ratio * ratio * s2, 0.0f));
        const pvt_real rs = (n1r * c_in - n2r * kterm) / (n1r * c_in + n2r * kterm);
        const pvt_real rp = (n1r * kterm - n2r * c_in) / (n1r * kterm + n2r * c_in);
        r = tir ? 1.0f : clampf(0.5f * (rs * rs + rp * rp), 0.0f, 1.0f);
      }
      if (mode == OVR_MIRROR || mode == OVR_LAMBERTIAN) r = 1.0f;
      if (mode == OVR_ABSORB) r = 0.0f;
      if (kScore) {
        out.n2r = n2r;
        out.refl_r = r;
        out.fres_coin = is_fresnel && !tir && mode < 0;
      }
      if (kPath) {
        out.mode = mode;
        out.tir = tir;
      }
      reflecting = (pvt_real)u[7] < r;
      if (reflecting) {
        const pvt_real two_d = 2.0f * c_in;
        if (mode == OVR_LAMBERTIAN) {
          const pvt_real st_l = pvt_sqrt((pvt_real)u[3]);
          const pvt_real ct_l = pvt_sqrt(pvt_fmax(1.0f - (pvt_real)u[3], 0.0f));
          const pvt_real phi_l = PVT_TWO_PI * (pvt_real)u[4];
          pvt_real lx, ly;
          if constexpr (kMain) {
            pvt_real sn, cs;
            pvt_sincos(phi_l, &sn, &cs);
            lx = st_l * cs;
            ly = st_l * sn;
          } else {
            lx = st_l * pvt_cos(phi_l);
            ly = st_l * pvt_sin(phi_l);
          }
          const pvt_real axx = -nax, axy = -nay, axz = -naz;
          const pvt_real sign = axz >= 0.0f ? 1.0f : -1.0f;
          const pvt_real a_ = -1.0f / (sign + axz);
          const pvt_real b_ = axx * axy * a_;
          const pvt_real t1x = 1.0f + sign * axx * axx * a_, t1y = sign * b_, t1z = -sign * axx;
          const pvt_real t2x = b_, t2y = sign + axy * axy * a_, t2z = -axy;
          p.dx = lx * t1x + ly * t2x + ct_l * axx;
          p.dy = lx * t1y + ly * t2y + ct_l * axy;
          p.dz = lx * t1z + ly * t2z + ct_l * axz;
        } else {
          p.dx = p.dx - two_d * nax;
          p.dy = p.dy - two_d * nay;
          p.dz = p.dz - two_d * naz;
        }
      } else if (is_fresnel && mode != OVR_ABSORB) {
        const pvt_real cterm =
            pvt_sqrt(pvt_fmax(1.0f - ratio * ratio * (1.0f - c_in * c_in), 0.0f));
        const pvt_real scale = cterm - ratio * c_in;
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

  if (kExtras) {
    out.adjacent = h.adjacent;
    out.kill_max = kill_max;
    out.adj_bad = adj_bad;
    out.absorbed = absorbed;
    out.reflecting = reflecting;
    out.transmitting = transmitting;
  }
  out.exit_mask = exit_mask;
  out.kills = kill_max || adj_bad;
  p.alive = alive && !exit_mask && !nonrad;
}

// ---------------------------------------------------------------------
// K12: score-function channels (engine/score.py). Replaces the score
// block of body, _fresnel_R_scalar and _fresnel_dR (pvtrace_tpu/engine/
// tracer.py); the reference takes dR/dn with jax.vmap(jax.grad), the port
// writes the partials out in the twin's order.

// NaN to 0 and +-inf to the largest finite real (jnp.nan_to_num).
PVT_FN pvt_real pvt_nan_to_num(pvt_real x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? PVT_REAL_MAX : -PVT_REAL_MAX;
  return x;
}

// dR/dn1 and dR/dn2 of the unpolarised Fresnel reflectivity from n1 into
// n2 at incidence cosine c, with the reference's rule for the clip of
// 1 - ratio^2 s2 at 0 (slope 1 above, 1/2 at the tie, 0 below): inf or
// NaN where that term is 0, as the reference's are.
PVT_FN void fresnel_dR(pvt_real n1, pvt_real n2, pvt_real c, pvt_real* d) {
  const pvt_real s2 = clampf(1.0f - c * c, 0.0f, 1.0f);
  const pvt_real ratio = n1 / n2;
  const pvt_real x = 1.0f - ratio * ratio * s2;
  const pvt_real slope = x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
  const pvt_real k = pvt_sqrt(pvt_fmax(x, 0.0f));
  const pvt_real half_over_k = 0.5f / k;
  const pvt_real A = n1 * c - n2 * k, B = n1 * c + n2 * k;
  const pvt_real C = n1 * k - n2 * c, D = n1 * k + n2 * c;
  const pvt_real qs = A / B, qp = C / D;
  for (int j = 0; j < 2; ++j) {
    const pvt_real dratio = j == 0 ? 1.0f / n2 : -n1 / (n2 * n2);
    const pvt_real dn1 = j == 0 ? 1.0f : 0.0f, dn2 = j == 0 ? 0.0f : 1.0f;
    const pvt_real dk = slope * (-(2.0f * ratio * dratio) * s2) * half_over_k;
    const pvt_real dA = dn1 * c - (dn2 * k + n2 * dk);
    const pvt_real dB = dn1 * c + (dn2 * k + n2 * dk);
    const pvt_real dC = (dn1 * k + n1 * dk) - dn2 * c;
    const pvt_real dD = (dn1 * k + n1 * dk) + dn2 * c;
    const pvt_real dqs = dA / B - dB * A / (B * B);
    const pvt_real dqp = dC / D - dD * C / (D * D);
    d[j] = 0.5f * (2.0f * qs * dqs + 2.0f * qp * dqp);
  }
}

// Adds one step's contributions (step output o with kScore; the incoming
// wavelength wav_in) to a photon's score row. Component channel c of the
// container: -a_c * advance on a lane that moved, a_c being c's slot minus
// the previous one at wav_in (the last slot is o.alpha, the others the
// step's held values, cum_slot), plus 1 where c absorbed the photon. Node
// channels of the container and the adjacent node on a Fresnel coin:
// nan_to_num(dR/dn * branch), branch 1/max(R, 1e-12) on a reflection and
// -1/max(1 - R, 1e-12) on a transmission. Touches at most K + 2 channels.
PVT_FN void score_step(const PvtScene& sc, const pvt_word* cheb, const StepOut& o, pvt_real wav_in,
                       const ScoreAcc& sa) {
  if (o.moving) {
    const int* ci = sc.node_i + o.container * NODE_I;
    const int K = ci[NI_NCOMP], comp0 = ci[NI_COMP0];
    if (K > 0) {
      const pvt_real posf = (wav_in - sc.grid_x0) / sc.grid_dx;
      const int i0 = (int)clampf(posf, 0.0f, (pvt_real)(sc.grid_n - 2));
      const pvt_real frac = clampf(posf - (pvt_real)i0, 0.0f, 1.0f);
      const int row = o.container * sc.grid_n + i0;
      const pvt_real t = ((pvt_real)i0 + frac) * sc.cheb_tscale - 1.0f;
      pvt_real prev = 0.0f;
      for (int k = 0; k < K; ++k) {
        const pvt_real cum =
            k == K - 1 ? o.alpha : cum_slot(sc, cheb, o.held, o.container, row, k, frac, t);
        const pvt_real a = k > 0 ? cum - prev : cum;
        prev = cum;
        pvt_real ds = -a * o.advance;
        if (o.absorbed && o.comp == comp0 + k) ds += 1.0f;
        sa.row[(comp0 + k) * sa.stride] += ds;
      }
    }
  }
  if (o.fres_coin && (o.reflecting || o.transmitting)) {
    pvt_real d[2];
    fresnel_dR(o.n1r, o.n2r, o.c_in, d);
    const pvt_real branch = o.reflecting ? 1.0f / pvt_fmax(o.refl_r, PVT_R(1e-12))
                                      : -1.0f / pvt_fmax(1.0f - o.refl_r, PVT_R(1e-12));
    sa.row[(sa.n_comps + o.container) * sa.stride] += pvt_nan_to_num(d[0] * branch);
    if (o.adjacent >= 0)
      sa.row[(sa.n_comps + o.adjacent) * sa.stride] += pvt_nan_to_num(d[1] * branch);
  }
}

// The fate a step's output terminates the photon with, the reference's
// last mask winning (EXIT, NONRADIATIVE, REACT, the two KILLs, NO_HIT),
// or -1. A KILL for want of an adjacent node leaves the photon alive.
PVT_FN int score_fate(const StepOut& o) {
  int f = -1;
  if (o.exit_mask) f = EV_EXIT;
  if (o.losing) f = EV_NONRADIATIVE;
  if (o.reacting) f = EV_REACT;
  if (o.kills) f = EV_KILL;
  if (o.no_hit_term) f = FATE_NO_HIT;
  return f;
}

// Adds the photon's score row into slot `slot` of `acc` ([2, n, ch]: the
// signed sums, then the magnitudes' sums), in float64; zero channels are
// skipped.
PVT_FN void score_add(const ScoreAcc& sa, double* acc, int n, int slot) {
  for (int c = 0; c < sa.ch; ++c) {
    const pvt_real v = sa.row[c * sa.stride];
    if (v == 0.0f) continue;
    PVT_ADD(acc + slot * sa.ch + c, (double)v);
    PVT_ADD(acc + (n + slot) * sa.ch + c, (double)pvt_fabs(v));
  }
}

// Writes photon `pid`'s record (its path score, `fate` and `steps`) when
// the run keeps per-photon records.
PVT_FN void score_record(const ScoreAcc& sa, uint32_t pid, int fate, int steps) {
  if (!sa.photon || (long long)pid >= sa.photon_n) return;
  const long long n = sa.photon_n;
  for (int c = 0; c < sa.ch; ++c) sa.photon[c * n + pid] = sa.row[c * sa.stride];
  sa.photon[sa.ch * n + pid] = (pvt_real)fate;
  sa.photon[(sa.ch + 1) * n + pid] = (pvt_real)steps;
}

// ---------------------------------------------------------------------
// K9: recorder tallies. Replaces _tally and the tally frame of body_fast
// (pvtrace_tpu/engine/tracer.py): the [B, R] match matrix becomes a walk
// over the few recorders of an event's (node, event) key, in the facet
// groups of engine/tables.py (one facet test a group: the recorders of a
// group match the same events). Every match of a recorder adds a
// crossing; a photon's first match of it (its group's bit in `seen`) adds
// a distinct ray, the eight moments and the recorder's histogram bins.
// Each recorder keeps its own tallies. With score channels (sa), a first
// match also adds the photon's path score to the recorder's rec_scores.
//
// A lane's seen bits, one a facet group: bit g % 32 of word g / 32. A
// scene of at most 32 groups (256 recorders of the benchmark slab make
// 10) kept in one word that no run-time index reaches measured no faster
// (PERF.md, section 6).
struct Seen {
  uint32_t w[SEEN_WORDS];
};

PVT_FN void seen_clear(Seen& seen) {
  for (int k = 0; k < SEEN_WORDS; ++k) seen.w[k] = 0u;
}

// Sets group g's bit and returns whether it was set before.
PVT_FN bool seen_test_set(Seen& seen, int g) {
  const uint32_t bit = 1u << (g & 31);
  const bool had = (seen.w[g >> 5] & bit) != 0u;
  seen.w[g >> 5] |= bit;
  return had;
}

// A lane's group bits from the recorder bits of pvt_tally's seen words
// (bit r % 32 of word r / 32: recorder r), and back (or-ed in).
PVT_FN void seen_from_words(const PvtScene& sc, const uint32_t* words, Seen& seen) {
  seen_clear(seen);
  for (int g = 0; g < sc.n_grp; ++g) {
    const int r = sc.rec_ids[sc.grp_pos[g]];
    if (words[r >> 5] >> (r & 31) & 1u) seen_test_set(seen, g);
  }
}

PVT_FN void seen_to_words(const PvtScene& sc, Seen seen, uint32_t* words) {
  for (int g = 0; g < sc.n_grp; ++g) {
    if (!seen_test_set(seen, g)) continue;
    for (int q = sc.grp_pos[g]; q < sc.grp_pos[g + 1]; ++q)
      words[sc.rec_ids[q] >> 5] |= 1u << (sc.rec_ids[q] & 31);
  }
}

// Which rule adds a trace's recorder events: 0 none (no recorders), 1
// each lane its own (tally_event), 2 the warp's together (tally_warp),
// where some facet group has more than kWarpGroup recorders. The warp rule
// measured 16 % slower than the lane rule at 8 recorders a group (R = 32),
// 3 % faster at 16 (R = 64) and 2.0-2.4 times faster at 32 and 64 (R =
// 128, 256), and 1.6-1.8 times slower with one a group (R = 4, the
// heatmap, the mesh LSC); the threshold lies between the first two
// (PERF.md, section 6). Each rule is its own template instantiation
// (kWarpTally): compiled into one, the unused rule slowed the other by up
// to 19 %. pvt_tally takes this rule.
constexpr int kWarpGroup = 12;

PVT_FN int tally_rule(const PvtScene& sc) {
  return sc.n_rec == 0 ? 0 : sc.grp_max > kWarpGroup ? 2 : 1;
}

// The rule of a trace launch on sc: tally_rule's in the launch it was
// timed in, pvt_trace's with recorders and without the event log, meshes,
// score channels or a bundle; the lane rule in every other, which carries
// no copy of the warp rule (trace_kernel.cuh, launch_for).
PVT_FN int trace_rule(const PvtScene& sc, bool log, bool score, bool bundle) {
  const int rule = tally_rule(sc);
  return rule == 2 && (log || score || bundle || sc.n_tris > 0) ? 1 : rule;
}

// The groups [*g0, *g1) of a step's event (step output o), none without
// one.
PVT_FN void tally_groups(const PvtScene& sc, const StepOut& o, int* g0, int* g1) {
  *g0 = *g1 = 0;
  if (o.sel < 0) return;
  const int key = o.tnode * N_SEL + o.sel;
  *g0 = sc.rec_grp[key];
  *g1 = sc.rec_grp[key + 1];
}

// Whether the event passes group g's facet test: its recorders have no
// facet, or the world normal is within atol of theirs on all three axes.
PVT_FN bool group_passes(const PvtScene& sc, int g, const StepOut& o) {
  const pvt_real* gf = sc.grp_f + g * GRP_F;
  if (gf[GF_FACET] == 0.0f) return true;
  const pvt_real atol = gf[GF_ATOL];
  return o.have_n && pvt_fabs(o.wn[0] - gf[GF_NX]) <= atol &&
         pvt_fabs(o.wn[1] - gf[GF_NX + 1]) <= atol && pvt_fabs(o.wn[2] - gf[GF_NX + 2]) <= atol;
}

// An event's eight moments and its histogram properties
// (engine/recorder.py PROPERTIES; x, y, z in the tnode's local frame).
PVT_FN void tally_values(const PvtScene& sc, const StepOut& o, const Photon& p, pvt_real* moments,
                         pvt_real* props) {
  const pvt_real angle = o.surface_event ? pvt_acos(o.c_in) : 0.0f;
  const pvt_real m[8] = {p.wav, p.wav * p.wav, angle, angle * angle,
                      p.dur, p.dur * p.dur, p.trav, p.trav * p.trav};
  for (int k = 0; k < 8; ++k) moments[k] = m[k];
  const pvt_real* W = sc.node_f + o.tnode * NODE_F + NF_W2L;
  props[0] = p.wav;
  props[1] = angle;
  props[2] = p.dur;
  props[3] = p.trav;
  for (int k = 0; k < 3; ++k)
    props[4 + k] = W[4 * k] * p.px + W[4 * k + 1] * p.py + W[4 * k + 2] * p.pz + W[4 * k + 3];
}

// Adds to recorder r `cross` crossings and, when `fresh` > 0, `fresh`
// distinct rays whose moments sum to `sums`. Its float32 sums move into
// the float64 sums64 when its distinct rays pass a multiple of SUMS_FLUSH
// (with one ray an add, at every SUMS_FLUSH-th ray). Between two moves a
// partial takes at most SUMS_FLUSH adds, and at most one more in flight
// from each of the block's other threads (tally_event) or warps
// (tally_warp, whose add of a warp's rays is their sum in lane order, at
// most 31 roundings of itself): within check.SUMS_BOUND's (SUMS_FLUSH +
// 255) roundings of its value either way. The float64 build's sums take
// every add (PvtTally). `side_by_side`: pvt_add8.
PVT_FN void recorder_add(const PvtTally& acc, int r, unsigned cross, unsigned fresh,
                         const pvt_real* sums, bool side_by_side = false) {
  if (acc.cross32) {
    const unsigned before = pvt_add(acc.cross32 + r, cross);
    if (before / kCrossFlush != (before + cross) / kCrossFlush)
      PVT_ADD(acc.cross + r, (unsigned long long)pvt_take(acc.cross32 + r));
  } else {
    PVT_ADD(acc.cross + r, (unsigned long long)cross);
  }
  if (!fresh) return;
  const unsigned before = pvt_add(acc.distinct + r, fresh);
  if (side_by_side)
    pvt_add8(acc.sums + 8 * r, sums);
  else
    for (int k = 0; k < 8; ++k) PVT_ADD(acc.sums + 8 * r + k, sums[k]);
#ifdef PVT_F64
  (void)before;
#else
  if (before / SUMS_FLUSH != (before + fresh) / SUMS_FLUSH)
    for (int k = 0; k < 8; ++k)
      PVT_ADD(acc.sums64 + 8 * r + k, (double)pvt_take(acc.sums + 8 * r + k));
#endif
}

// Adds one photon (properties props) to recorder r's histogram bins.
PVT_FN void recorder_bins(const PvtScene& sc, const PvtTally& acc, int r, const pvt_real* props) {
  const int* ri = sc.rec_i + r * REC_I;
  for (int hh = ri[RI_HIST0]; hh < ri[RI_HIST0] + ri[RI_NHIST]; ++hh) {
    const int* hi = sc.hist_i + hh * HIST_I;
    const pvt_real* hf = sc.hist_f + hh * HIST_F;
    const int na = hi[HI_NA], nb = hi[HI_NB];
    const pvt_real fa = pvt_floor((props[hi[HI_PROP_A]] - hf[HF_LO_A]) / hf[HF_W_A] * (pvt_real)na);
    if (!(fa >= 0.0f && fa < (pvt_real)na)) continue;
    int ib = 0;
    if (hi[HI_PROP_B] >= 0) {
      const pvt_real fb =
          pvt_floor((props[hi[HI_PROP_B]] - hf[HF_LO_B]) / hf[HF_W_B] * (pvt_real)nb);
      if (!(fb >= 0.0f && fb < (pvt_real)nb)) continue;
      ib = (int)fb;
    }
    const int bin = hi[HI_OFF] + (int)fa * nb + ib;
    if (acc.bins32)
      PVT_ADD(acc.bins32 + bin, 1u);
    else
      PVT_ADD(acc.bins64 + bin, 1ull);
  }
}

// One lane's event (step output o, post-step state p) added to the
// recorders that match it: the rule for one photon, which trace_photon
// takes and the warp rule below is held to.
PVT_FN void tally_event(const PvtScene& sc, const PvtTally& acc, Seen& seen, const StepOut& o,
                        const Photon& p, const ScoreAcc* sa = nullptr) {
  int g0, g1;
  tally_groups(sc, o, &g0, &g1);
  if (g0 == g1) return;
  pvt_real moments[8], props[7];
  tally_values(sc, o, p, moments, props);
  for (int g = g0; g < g1; ++g) {
    if (!group_passes(sc, g, o)) continue;
    const bool fresh = !seen_test_set(seen, g);
    for (int q = sc.grp_pos[g]; q < sc.grp_pos[g + 1]; ++q) {
      const int r = sc.rec_ids[q];
      recorder_add(acc, r, 1u, fresh ? 1u : 0u, moments);
      if (!fresh) continue;
      if (sa) score_add(*sa, sa->rec, sa->n_rec, r);
      recorder_bins(sc, acc, r, props);
    }
  }
}

// The warp's events of one turn, as pvt_trace and pvt_tally add them in
// a scene with a facet group of more than kWarpGroup recorders
// (tally_rule, trace_rule). The lanes whose events share a key (`peers`,
// __match_any_sync) walk its groups together, while lanes of other keys
// walk theirs beside them; for each group a ballot among the peers gives
// those that pass its test (`passed`) and those that pass it for the
// first time (`fresh`). Then each peer takes its part of the group's adds
// (warp_group_adds), so a group of many recorders is added by many lanes
// at once, and no two lanes of the warp meet on an address. The sums are
// the same values in another order, the integers the same.
//
// On the card every lane of the warp calls tally_warp together (event: it
// holds a step's output). The host build's tally_warp_host takes the same
// steps over kWarp lanes in turn, the ballots and the match computed from
// the lanes' own tests, and each peer's part by the same warp_group_adds:
// only the intrinsics differ.
constexpr int kWarp = 32;

PVT_FN int pvt_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The lane of the i-th set bit of m (i from 0).
PVT_FN int nth_lane(uint32_t m, int i) {
  for (int k = 0; k < i; ++k) m &= m - 1u;
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// Lane l's rank among the lanes of `dead`: how many of them are below it.
PVT_FN int lane_rank(uint32_t dead, int l) { return pvt_popc(dead & ((1u << l) - 1u)); }

// The key of a lane's event in the warp rule: a key's groups [g0, g1) are
// its own, so the same first group is the same key; -1 without groups.
PVT_FN int warp_key(int g0, int g1) { return g0 < g1 ? g0 : -1; }

// What a lane reads of its peers' events: their moments and properties,
// on the card by shuffles among the peers (moments, props: the lane's
// own), on the host from the warp's rows ([kWarp][8], [kWarp][7]).
struct PeerReads {
  uint32_t peers;
  const pvt_real* moments;
  const pvt_real* props;

  PVT_FN pvt_real moment(int l, int k) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(peers, moments[k], l);
#else
    return moments[8 * l + k];
#endif
  }
  PVT_FN pvt_real prop(int l, int k) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(peers, props[k], l);
#else
    return props[7 * l + k];
#endif
  }
};

// Lane `lane`'s part of group g's adds in the warp rule, rank `rank` of
// its n_peers peers: `passed` are the peers whose event passes g's test,
// `fresh_m` those that pass it first, `fresh` whether this lane is one
// (its moments, props). The fresh lanes' moments are summed in lane order.
// Recorder j of the group's n is added by the peer of rank j % n_peers:
// popc(passed) crossings and popc(fresh_m) distinct rays with the sums,
// one add each (recorder_add, the eight moment adds side by side:
// pvt_add8). The (fresh lane, recorder) pairs of the histograms, pair
// i * n + j (the i-th fresh lane, recorder j), go to the peer of rank
// (i * n + j) % n_peers, which reads that lane's properties. Every peer
// runs the same loops, so the shuffles in them are taken by all the peers
// together. No launch with score channels takes this rule (trace_rule),
// so it adds no scores.
PVT_FN void warp_group_adds(const PvtScene& sc, const PvtTally& acc, int g, int lane, int rank,
                            int n_peers, uint32_t passed, uint32_t fresh_m, bool fresh,
                            const PeerReads& peer, const pvt_real* moments, const pvt_real* props) {
  pvt_real sums[8];
  for (int k = 0; k < 8; ++k) sums[k] = n_peers == 1 && fresh ? moments[k] : 0.0f;
  if (n_peers > 1)
    for (uint32_t m = fresh_m; m; m &= m - 1u) {
      const int l = nth_lane(m, 0);
      for (int k = 0; k < 8; ++k) sums[k] += peer.moment(l, k);
    }
  const int q0 = sc.grp_pos[g], n = sc.grp_pos[g + 1] - q0;
  for (int j = rank; j < n; j += n_peers)
    recorder_add(acc, sc.rec_ids[q0 + j], pvt_popc(passed), pvt_popc(fresh_m), sums, true);
  if (!fresh_m || !sc.total_bins) return;
  if (n_peers == 1) {
    for (int j = 0; j < n; ++j) recorder_bins(sc, acc, sc.rec_ids[q0 + j], props);
    return;
  }
  const int pairs = pvt_popc(fresh_m) * n;
  for (int c0 = 0; c0 < pairs; c0 += n_peers) {
    const int c = c0 + rank;
    const int src = c < pairs ? nth_lane(fresh_m, c / n) : lane;
    pvt_real pr[7];
    for (int k = 0; k < 7; ++k) pr[k] = peer.prop(src, k);
    if (c < pairs) recorder_bins(sc, acc, sc.rec_ids[q0 + c % n], pr);
  }
}

#ifdef __CUDACC__
__device__ __forceinline__ void tally_warp(const PvtScene& sc, const PvtTally& acc, Seen& seen,
                                           const StepOut& o, const Photon& p, bool event) {
  const int lane = threadIdx.x % kWarp;
  int g0 = 0, g1 = 0;
  if (event) tally_groups(sc, o, &g0, &g1);
  const uint32_t peers = __match_any_sync(0xffffffffu, warp_key(g0, g1));
  if (g0 == g1) return;
  const int rank = lane_rank(peers, lane), n_peers = pvt_popc(peers);
  pvt_real moments[8], props[7];
  tally_values(sc, o, p, moments, props);
  const PeerReads peer = {peers, moments, props};
  for (int g = g0; g < g1; ++g) {
    const bool pass = group_passes(sc, g, o);
    const uint32_t passed = __ballot_sync(peers, pass);
    if (!passed) continue;
    const bool fresh = pass && !seen_test_set(seen, g);
    warp_group_adds(sc, acc, g, lane, rank, n_peers, passed, __ballot_sync(peers, fresh), fresh,
                    peer, moments, props);
  }
}
#else
// The warp rule on the host: lanes l of `events` (a bit a lane) hold
// step outputs o[l] and post-step photons p[l], their seen bits seen[l].
// The keys' peers take their turns from the lowest lane up.
inline void tally_warp_host(const PvtScene& sc, const PvtTally& acc, Seen* seen,
                            const StepOut* o, const Photon* p, uint32_t events) {
  int g0[kWarp], g1[kWarp];
  pvt_real moments[kWarp][8], props[kWarp][7];
  uint32_t pending = 0u;
  for (int l = 0; l < kWarp; ++l) {
    g0[l] = g1[l] = 0;
    if (events >> l & 1u) tally_groups(sc, o[l], &g0[l], &g1[l]);
    if (g0[l] == g1[l]) continue;
    pending |= 1u << l;
    tally_values(sc, o[l], p[l], moments[l], props[l]);
  }
  while (pending) {
    const int first = nth_lane(pending, 0);
    uint32_t peers = 0u;  // __match_any_sync
    for (uint32_t m = pending; m; m &= m - 1u)
      if (warp_key(g0[nth_lane(m, 0)], g1[nth_lane(m, 0)]) == warp_key(g0[first], g1[first]))
        peers |= 1u << nth_lane(m, 0);
    pending &= ~peers;
    const PeerReads peer = {peers, &moments[0][0], &props[0][0]};
    for (int g = g0[first]; g < g1[first]; ++g) {
      uint32_t passed = 0u, fresh_m = 0u;  // __ballot_sync
      for (uint32_t m = peers; m; m &= m - 1u) {
        const int l = nth_lane(m, 0);
        if (!group_passes(sc, g, o[l])) continue;
        passed |= 1u << l;
        if (!seen_test_set(seen[l], g)) fresh_m |= 1u << l;
      }
      if (!passed) continue;
      for (uint32_t m = peers; m; m &= m - 1u) {
        const int l = nth_lane(m, 0);
        warp_group_adds(sc, acc, g, l, lane_rank(peers, l), pvt_popc(peers), passed, fresh_m,
                        (fresh_m >> l & 1u) != 0u, peer, moments[l], props[l]);
      }
    }
  }
}
#endif

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
  emit_one(sc, sc.cheb_pack, k0, k1, pid, emit_pairs(sc), p);
  store_lane(out, i, p, k0, k1);
}

PVT_FN void store_flags(const PvtFlags& fl, long long i, const StepOut& o) {
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

// pvt_cheb: fit `fit` of the table `tab` at t into out[i], and with `seg`
// its segment's index (the row of cheb_seg_f; -1 for none) into seg[i].
PVT_FN void cheb_lane(const pvt_word* tab, int fit, pvt_real t, long long i, pvt_real* out,
                      int* seg) {
  out[i] = cheb_eval(tab, fit, t);
  if (seg) {
    const int s = cheb_segment(tab, fit, t);
    seg[i] = s < 0 ? -1 : (s - (int)tab[FR_SEG]) / CHEB_REC;
  }
}

// pvt_step: count the step, draw, take one physics step of lane i.
PVT_FN void step_lane(const PvtScene& sc, const PvtState& in, const PvtState& out,
                      const PvtFlags& fl, long long i) {
  Photon p;
  load_lane(in, i, p);
  p.count += p.alive ? 1 : 0;
  const uint32_t k0 = (uint32_t)in.k0[i], k1 = (uint32_t)in.k1[i];
  pvt_real u[8];
  pvt_draw(k0, k1, (uint32_t)p.count, 0u, 4, u);
  StepOut o;
  step_one<true>(sc, sc.cheb_pack, p, u, o);
  store_lane(out, i, p, k0, k1);
  store_flags(fl, i, o);
}

// pvt_score: pvt_step with the score channels: lane i's step, its
// contributions added to its score (row i of sa, updated in place), and
// the score folded into sa.fate where the step terminated the photon;
// comp[i] gets the component that absorbed it (-1 for none).
PVT_FN void score_lane(const PvtScene& sc, const PvtState& in, const PvtState& out,
                       const PvtFlags& fl, long long i, const ScoreAcc& sa, int* comp) {
  Photon p;
  load_lane(in, i, p);
  p.count += p.alive ? 1 : 0;
  const uint32_t k0 = (uint32_t)in.k0[i], k1 = (uint32_t)in.k1[i];
  const pvt_real wav_in = p.wav;
  pvt_real u[8];
  pvt_draw(k0, k1, (uint32_t)p.count, 0u, 4, u);
  StepOut o;
  step_one<true, false, true, true>(sc, sc.cheb_pack, p, u, o);
  store_lane(out, i, p, k0, k1);
  store_flags(fl, i, o);
  comp[i] = o.absorbed ? o.comp : -1;
  score_step(sc, sc.cheb_pack, o, wav_in, sa);
  const int fate = score_fate(o);
  if (fate >= 0) score_add(sa, sa.fate, N_FATES, fate);
}

// ---------------------------------------------------------------------
// K13: pathwise channels (engine/pathwise.py). Replaces the jax.linearize
// of physics_core in the pathwise block of body and the hybrid channels
// built on it (pvtrace_tpu/engine/tracer.py). The primal step is step_one
// with kPath, which keeps the branch it took; step_tangent is then a
// straight-line, hand-written JVP of that branch, applied once per channel
// to the channel's tangent row. Branch decisions come from the primal step
// and are never taken again, so a tangent follows its photon's path
// exactly. Ties follow JAX's rules: a clip has slope 1/2 at a bound, an
// absolute value slope +1 at 0, a minimum or maximum 1/2 of each slope at a
// tie; a square root at 0 has an infinite slope, and the hybrid terms take
// nan_to_num of every tangent, as the reference does.

// Slope of jnp.clip(x, lo, hi) in x.
PVT_FN pvt_real clip_slope(pvt_real x, pvt_real lo, pvt_real hi) {
  if (x > lo && x < hi) return 1.0f;
  return (x == lo || x == hi) ? 0.5f : 0.0f;
}

// Slope of jnp.maximum(x, 0) (jnp.clip(x, 0, None)) in x.
PVT_FN pvt_real max0_slope(pvt_real x) { return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f); }

// min(a, b) and max(a, b) with their tangents (1/2 of each at a tie).
PVT_FN void min_t(pvt_real a, pvt_real da, pvt_real b, pvt_real db, pvt_real& m, pvt_real& dm) {
  m = pvt_fmin(a, b);
  dm = a < b ? da : (b < a ? db : 0.5f * (da + db));
}

PVT_FN void max_t(pvt_real a, pvt_real da, pvt_real b, pvt_real db, pvt_real& m, pvt_real& dm) {
  m = pvt_fmax(a, b);
  dm = a > b ? da : (b > a ? db : 0.5f * (da + db));
}

// One Clenshaw step with coefficient c, and of its derivative recurrence.
PVT_FN void cheb_step_d(pvt_real ts, pvt_real c, pvt_real& b1, pvt_real& b2, pvt_real& d1,
                        pvt_real& d2) {
  const pvt_real nb = 2.0f * ts * b1 - b2 + c;
  const pvt_real nd = 2.0f * b1 + 2.0f * ts * d1 - d2;
  b2 = b1;
  b1 = nb;
  d2 = d1;
  d1 = nd;
}

// cheb_eval of fit `fit` at t and its derivative in t (the same segment
// search; the segment's affine map and clip, the Clenshaw derivative
// recurrence, exp on a log segment).
PVT_CALLED_FN pvt_real cheb_eval_d(const pvt_word* tab, int fit, pvt_real t, pvt_real* dv_dt) {
  const int s = cheb_segment(tab, fit, t);
  *dv_dt = 0.0f;
  if (s < 0) return 0.0f;
  const pvt_word* sr = tab + s;
  const int info = (int)sr[SR_DEG], deg = info & SEG_DEG_MASK;
  pvt_real ts = t, dts = 1.0f;
  if (info & SEG_MAP) {
    const pvt_real scale = pvt_word_real(sr[SR_SCALE]);
    const pvt_real x = (t - pvt_word_real(sr[SR_A])) * scale - 1.0f;
    ts = clampf(x, -1.0f, 1.0f);
    dts = clip_slope(x, -1.0f, 1.0f) * scale;
  }
  const pvt_word* c = tab + sr[SR_COEF];
  pvt_real b1 = 0.0f, b2 = 0.0f, d1 = 0.0f, d2 = 0.0f, q[4];
  int j = 0;
  for (; j + 4 <= deg; j += 4) {
    pvt_load4(c + j, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) cheb_step_d(ts, q[e], b1, b2, d1, d2);
  }
  pvt_load4(c + j, q);  // the last deg - j < 4 steps, then c_0
  pvt_real c0 = q[0];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    if (j + e < deg) cheb_step_d(ts, q[e], b1, b2, d1, d2);
    if (j + e + 1 == deg) c0 = q[e + 1];
  }
  pvt_real v = ts * b1 - b2 + c0;
  pvt_real dv = b1 + ts * d1 - d2;
  if (info & SEG_LOG) {
    const pvt_real e = pvt_exp(v);
    v = e - pvt_word_real(tab[CHEB_REC * fit + FR_OFF]);
    dv = e * dv;
  }
  *dv_dt = dv * dts;
  return v;
}

// Slot w of the container (*value, as spec_slot gives it) and its slope
// in the wavelength at the step's incoming wavelength: K5a's fits and
// their derivatives in t, each fit evaluated once, or K5b's lerp and its
// slope, through t = (i0 + frac) * tscale - 1 and frac = clip(posf - i0,
// 0, 1) (its slope fr_s), posf = (wav - x0) / dx.
PVT_FN pvt_real spec_slot_slope(const PvtScene& sc, const pvt_word* cheb, int container,
                                int row, int w, pvt_real frac, pvt_real t, pvt_real fr_s,
                                pvt_real* value) {
  pvt_real d_frac;
  if (!sc.cheb_spec) {
    const pvt_real* p = sc.spec_pack + (size_t)row * 2 * sc.pack_width + 2 * w;
    *value = p[0] + frac * (p[1] - p[0]);
    d_frac = p[1] - p[0];
  } else {
    const int* slot = sc.cheb_slot + 2 * (container * sc.pack_width + w);
    pvt_real v = 0.0f, d_t = 0.0f;
    for (int q = 0; q < slot[1]; ++q) {
      pvt_real d;
      v += cheb_eval_d(cheb, sc.cheb_ref[slot[0] + q], t, &d);
      d_t += d;
    }
    *value = v;
    d_frac = d_t * sc.cheb_tscale;
  }
  return d_frac * fr_s / sc.grid_dx;
}

// Slope of lerp_pairs in gamma: (M - 1) times the row's difference.
PVT_FN pvt_real lerp_pairs_slope(const pvt_real* pairs, int base, int M, pvt_real gamma) {
  const pvt_real g = gamma * (pvt_real)(M - 1);
  const int j0 = (int)clampf(g, 0.0f, (pvt_real)(M - 2));
  const pvt_real* p = pairs + 2 * (size_t)(base + j0);
  return (pvt_real)(M - 1) * (p[1] - p[0]);
}

// What a step's tangent map shares between its channels: the slopes of the
// container's attenuation and of p1 in the incoming wavelength, and of the
// emitted wavelength in gamma (K5a or K5b, evaluated once per step).
struct PathSlopes {
  pvt_real dalpha, dp1, dnew;
};

PVT_FN PathSlopes path_slopes(const PvtScene& sc, const pvt_word* cheb, const StepOut& o,
                              pvt_real wav_in, const pvt_real* u) {
  PathSlopes ps = {0.0f, 0.0f, 0.0f};
  const int K = sc.node_i[o.container * NODE_I + NI_NCOMP];
  if (K == 0) return ps;
  const pvt_real posf = (wav_in - sc.grid_x0) / sc.grid_dx;
  const int i0 = (int)clampf(posf, 0.0f, (pvt_real)(sc.grid_n - 2));
  const pvt_real fr = posf - (pvt_real)i0;
  const pvt_real frac = clampf(fr, 0.0f, 1.0f);
  const pvt_real fr_s = clip_slope(fr, 0.0f, 1.0f);
  const int row = o.container * sc.grid_n + i0;
  const pvt_real t = ((pvt_real)i0 + frac) * sc.cheb_tscale - 1.0f;
  pvt_real alpha;
  ps.dalpha = spec_slot_slope(sc, cheb, o.container, row, K - 1, frac, t, fr_s, &alpha);
  if (o.emitting) {
    const int* ci = sc.comp_i + o.comp * COMP_I;
    pvt_real p1 = 0.0f;
    if (sc.emit_method != EMIT_FULL) {
      const int w = ci[CI_P1] + (sc.emit_method == EMIT_KT ? 0 : 1);
      ps.dp1 = spec_slot_slope(sc, cheb, o.container, row, w, frac, t, fr_s, &p1);
    }
    const pvt_real gamma = p1 + (1.0f - p1) * u[5];
    if (sc.cheb_icdf) {
      cheb_eval_d(cheb, sc.cheb_icdf0 + ci[CI_LUM], 2.0f * gamma - 1.0f, &ps.dnew);
      ps.dnew *= 2.0f;
    } else {
      ps.dnew = lerp_pairs_slope(sc.ems_icdf_pairs, ci[CI_LUM] * sc.icdf_n, sc.icdf_n, gamma);
    }
  }
  return ps;
}

// Tangent of candidate `cand` of one node's forward hits (intersect_node's
// formulas, or Möller–Trumbore on triangle row `tri` of a mesh), for the
// ray (o, d) with tangents (dO, dD) and the geometry's parameter tangents
// dgp.
PVT_FN pvt_real hit_tangent(const PvtScene& sc, int gtype, const pvt_real* gp,
                            const pvt_real* dgp, const pvt_real* o, const pvt_real* d,
                            const pvt_real* dO, const pvt_real* dD, int cand, int tri) {
  if (gtype == GEOM_BOX) {
    pvt_real tmin = -PVT_INF, tmax = PVT_INF, dmin = 0.0f, dmax = 0.0f;
    for (int k = 0; k < 3; ++k) {
      const pvt_real h = 0.5f * gp[k], dh = 0.5f * dgp[k];
      pvt_real lo = -PVT_INF, hi = PVT_INF, dlo = 0.0f, dhi = 0.0f;
      if (!(pvt_fabs(d[k]) < PVT_R(1e-30))) {
        const pvt_real inv = 1.0f / d[k], dinv = -dD[k] * inv * inv;
        const pvt_real t1 = (-h - o[k]) * inv, t2 = (h - o[k]) * inv;
        const pvt_real dt1 = (-dh - dO[k]) * inv + (-h - o[k]) * dinv;
        const pvt_real dt2 = (dh - dO[k]) * inv + (h - o[k]) * dinv;
        min_t(t1, dt1, t2, dt2, lo, dlo);
        max_t(t1, dt1, t2, dt2, hi, dhi);
      }
      max_t(tmin, dmin, lo, dlo, tmin, dmin);
      min_t(tmax, dmax, hi, dhi, tmax, dmax);
    }
    return cand == 0 ? dmin : dmax;
  }
  if (gtype == GEOM_SPHERE || (gtype == GEOM_CYLINDER && cand < 2)) {
    const bool sphere = gtype == GEOM_SPHERE;
    const pvt_real r = sphere ? gp[0] : gp[1], dr = sphere ? dgp[0] : dgp[1];
    const int m = sphere ? 3 : 2;
    pvt_real a = 0.0f, da = 0.0f, b = 0.0f, db = 0.0f, c = 0.0f, dc = 0.0f;
    for (int k = 0; k < m; ++k) {
      a += d[k] * d[k];
      da += 2.0f * d[k] * dD[k];
      b += d[k] * o[k];
      db += dD[k] * o[k] + d[k] * dO[k];
      c += o[k] * o[k];
      dc += 2.0f * o[k] * dO[k];
    }
    b *= 2.0f;
    db *= 2.0f;
    c -= r * r;
    dc -= 2.0f * r * dr;
    const pvt_real disc = b * b - 4.0f * a * c;
    const pvt_real ddisc = 2.0f * b * db - 4.0f * (da * c + a * dc);
    const pvt_real sq = pvt_sqrt(disc >= 0.0f ? disc : 0.0f);
    const pvt_real dsq = ddisc * (0.5f / sq);
    const bool has = sphere || a > PVT_R(1e-30);
    const pvt_real y = 2.0f * (has ? a : 1.0f), dy = has ? 2.0f * da : 0.0f;
    const pvt_real x = cand == 0 ? -b - sq : -b + sq, dx = cand == 0 ? -db - dsq : -db + dsq;
    return dx / y - x * dy / (y * y);
  }
  if (gtype == GEOM_CYLINDER) {
    const pvt_real zcap = cand == 2 ? -0.5f * gp[0] : 0.5f * gp[0];
    const pvt_real dz = cand == 2 ? -0.5f * dgp[0] : 0.5f * dgp[0];
    const bool hasc = pvt_fabs(d[2]) > PVT_R(1e-30);
    const pvt_real y = hasc ? d[2] : 1.0f, dy = hasc ? dD[2] : 0.0f;
    return (dz - dO[2]) / y - (zcap - o[2]) * dy / (y * y);
  }
  const pvt_real* rw = sc.tri_f + (size_t)tri * TRI_F;
  const pvt_real* e1 = rw + TF_E1;
  const pvt_real* e2 = rw + TF_E2;
  const pvt_real pv[3] = {d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                       d[0] * e2[1] - d[1] * e2[0]};
  const pvt_real dpv[3] = {dD[1] * e2[2] - dD[2] * e2[1], dD[2] * e2[0] - dD[0] * e2[2],
                        dD[0] * e2[1] - dD[1] * e2[0]};
  const pvt_real det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2];
  const pvt_real ddet = e1[0] * dpv[0] + e1[1] * dpv[1] + e1[2] * dpv[2];
  const pvt_real inv = 1.0f / det, dinv = -ddet * inv * inv;
  const pvt_real tv[3] = {o[0] - rw[TF_V0], o[1] - rw[TF_V0 + 1], o[2] - rw[TF_V0 + 2]};
  const pvt_real qv[3] = {tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
                       tv[0] * e1[1] - tv[1] * e1[0]};
  const pvt_real dqv[3] = {dO[1] * e1[2] - dO[2] * e1[1], dO[2] * e1[0] - dO[0] * e1[2],
                        dO[0] * e1[1] - dO[1] * e1[0]};
  const pvt_real num = e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2];
  const pvt_real dnum = e2[0] * dqv[0] + e2[1] * dqv[1] + e2[2] * dqv[2];
  return dnum * inv + num * dinv;
}

// Tangent dn of the outward local normal at local point q (tangent dq):
// zero on a box face, a cylinder's cap and a mesh face; the sphere's and
// the barrel's q / |q| otherwise.
PVT_FN void normal_tangent(int gtype, const pvt_real* gp, const pvt_real* q, const pvt_real* dq,
                           pvt_real* dn) {
  dn[0] = dn[1] = dn[2] = 0.0f;
  if (gtype == GEOM_SPHERE) {
    const pvt_real mag = pvt_sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
    if (mag == 0.0f) {
      for (int k = 0; k < 3; ++k) dn[k] = dq[k];
      return;
    }
    const pvt_real dmag =
        2.0f * (q[0] * dq[0] + q[1] * dq[1] + q[2] * dq[2]) * (0.5f / mag);
    for (int k = 0; k < 3; ++k) dn[k] = dq[k] / mag - q[k] * dmag / (mag * mag);
    return;
  }
  if (gtype != GEOM_CYLINDER) return;
  const pvt_real half = 0.5f * gp[0];
  const pvt_real atol = PVT_R(1e-8) + PVT_R(1e-5) * pvt_fabs(half);
  if (pvt_fabs(q[2] + half) <= atol || pvt_fabs(q[2] - half) <= atol) return;
  const pvt_real r = pvt_sqrt(q[0] * q[0] + q[1] * q[1]);
  const pvt_real sr = r == 0.0f ? 1.0f : r;
  const pvt_real dsr = r == 0.0f ? 0.0f : 2.0f * (q[0] * dq[0] + q[1] * dq[1]) * (0.5f / r);
  for (int k = 0; k < 2; ++k) dn[k] = dq[k] / sr - q[k] * dsr / (sr * sr);
}

// K13's linear map: one channel's tangents through the step that produced
// `o` (step_one with kPath) from the photon's position pp and direction pd
// before it, uniforms u, shared slopes ps. `spec` is the channel's row of the
// path table, `tin` the tangents of (px, py, pz, dx, dy, dz, wav) before
// the step. Writes j[PATH_J]: the new coordinates' tangents, then those of
// t0, alpha and the reflectivity (0 off a surface event), raw: infinite or
// NaN where the reference's are.
PVT_FN void step_tangent(const PvtScene& sc, const pvt_real* pp, const pvt_real* pd,
                         const StepOut& o, const PathSlopes& ps, const pvt_real* u, const int* spec,
                         const pvt_real* tin, pvt_real* j) {
  const int kind = spec[PATH_KIND], pnode = spec[PATH_NODE];
  const pvt_real dn1 = kind == PATH_N && pnode == o.container ? 1.0f : 0.0f;
  const pvt_real dn2 = kind == PATH_N && o.adjacent >= 0 && pnode == o.adjacent ? 1.0f : 0.0f;
  const pvt_real din[3] = {tin[3], tin[4], tin[5]};
  // The hit node's local ray and its tangent, t0's tangent.
  const int h = o.hit;
  const pvt_real* nf = sc.node_f + h * NODE_F;
  const int gtype = sc.node_i[h * NODE_I + NI_GEOM];
  const pvt_real* R = nf + NF_W2L;
  pvt_real lo[3], ld[3], dlo[3], dld[3];
  for (int k = 0; k < 3; ++k) {
    lo[k] = R[4 * k] * pp[0] + R[4 * k + 1] * pp[1] + R[4 * k + 2] * pp[2] + R[4 * k + 3];
    ld[k] = R[4 * k] * pd[0] + R[4 * k + 1] * pd[1] + R[4 * k + 2] * pd[2];
    dlo[k] = R[4 * k] * tin[0] + R[4 * k + 1] * tin[1] + R[4 * k + 2] * tin[2];
    dld[k] = R[4 * k] * tin[3] + R[4 * k + 1] * tin[4] + R[4 * k + 2] * tin[5];
  }
  pvt_real dgp[3] = {0.0f, 0.0f, 0.0f};
  if (kind == PATH_GEOM && pnode == h) dgp[spec[PATH_PARAM]] = 1.0f;
  const pvt_real dt0 = isfinite(o.t0)
                        ? hit_tangent(sc, gtype, nf + NF_GP, dgp, lo, ld, dlo, dld, o.cand, o.tri)
                        : 0.0f;
  // Attenuation, free path and the advance.
  const pvt_real dalpha = ps.dalpha * tin[6];
  pvt_real dp[3] = {tin[0], tin[1], tin[2]};
  pvt_real dd[3] = {din[0], din[1], din[2]};
  pvt_real dw = tin[6];
  if (o.moving) {
    const pvt_real dadv = o.absorbed ? pvt_log1p(-u[0]) * dalpha / (o.alpha * o.alpha) : dt0;
    for (int k = 0; k < 3; ++k) dp[k] = tin[k] + din[k] * o.advance + pd[k] * dadv;
  }
  // Volume event: a new direction drawn from u alone; re-emission at gamma.
  if (o.absorbed && o.radiative) {
    dd[0] = dd[1] = dd[2] = 0.0f;
    if (o.emitting) dw = ps.dnew * (ps.dp1 * tin[6] * (1.0f - u[5]));
  }
  // Surface event at the hit node.
  pvt_real dr = 0.0f;
  if (o.reflecting || o.transmitting) {
    pvt_real q[3], dq[3], dln[3];
    for (int k = 0; k < 3; ++k) {
      q[k] = lo[k] + o.t0 * ld[k];
      dq[k] = dlo[k] + dt0 * ld[k] + o.t0 * dld[k];
    }
    normal_tangent(gtype, nf + NF_GP, q, dq, dln);
    const pvt_real* Rw = nf + NF_L2W;
    pvt_real dwn[3];
    for (int k = 0; k < 3; ++k)
      dwn[k] = Rw[3 * k] * dln[0] + Rw[3 * k + 1] * dln[1] + Rw[3 * k + 2] * dln[2];
    const pvt_real* wn = o.wn;
    const pvt_real ddot = wn[0] * pd[0] + wn[1] * pd[1] + wn[2] * pd[2];
    const pvt_real dddot = dwn[0] * pd[0] + dwn[1] * pd[1] + dwn[2] * pd[2] + wn[0] * din[0] +
                        wn[1] * din[1] + wn[2] * din[2];
    const pvt_real c = o.c_in;
    const pvt_real dc = clip_slope(pvt_fabs(ddot), 0.0f, 1.0f) * (ddot >= 0.0f ? dddot : -dddot);
    const pvt_real flip = ddot < 0.0f ? -1.0f : 1.0f;
    const pvt_real na[3] = {wn[0] * flip, wn[1] * flip, wn[2] * flip};
    const pvt_real dna[3] = {dwn[0] * flip, dwn[1] * flip, dwn[2] * flip};
    const pvt_real n1 = o.n1r, n2 = o.n2r;
    const pvt_real ratio = n1 / n2, dratio = dn1 / n2 - n1 * dn2 / (n2 * n2);
    if (o.fres_coin) {
      const pvt_real s2r = 1.0f - c * c;
      const pvt_real s2 = clampf(s2r, 0.0f, 1.0f);
      const pvt_real ds2 = clip_slope(s2r, 0.0f, 1.0f) * (-2.0f * c * dc);
      const pvt_real ur = 1.0f - ratio * ratio * s2;
      const pvt_real dur = max0_slope(ur) * -(2.0f * ratio * dratio * s2 + ratio * ratio * ds2);
      const pvt_real k = pvt_sqrt(pvt_fmax(ur, 0.0f));
      const pvt_real dk = dur * (0.5f / k);
      const pvt_real A = n1 * c - n2 * k, B = n1 * c + n2 * k;
      const pvt_real dA = dn1 * c + n1 * dc - (dn2 * k + n2 * dk);
      const pvt_real dB = dn1 * c + n1 * dc + (dn2 * k + n2 * dk);
      const pvt_real C = n1 * k - n2 * c, D = n1 * k + n2 * c;
      const pvt_real dC = dn1 * k + n1 * dk - (dn2 * c + n2 * dc);
      const pvt_real dD2 = dn1 * k + n1 * dk + (dn2 * c + n2 * dc);
      const pvt_real qs = A / B, qp = C / D;
      const pvt_real dqs = dA / B - A * dB / (B * B), dqp = dC / D - C * dD2 / (D * D);
      dr = clip_slope(0.5f * (qs * qs + qp * qp), 0.0f, 1.0f) * (qs * dqs + qp * dqp);
    }
    if (o.reflecting) {
      if (o.mode == OVR_LAMBERTIAN) {
        const pvt_real st_l = pvt_sqrt(u[3]);
        const pvt_real ct_l = pvt_sqrt(pvt_fmax(1.0f - u[3], 0.0f));
        const pvt_real phi_l = PVT_TWO_PI * u[4];
        const pvt_real lx = st_l * pvt_cos(phi_l), ly = st_l * pvt_sin(phi_l);
        const pvt_real ax = -na[0], ay = -na[1], az = -na[2];
        const pvt_real dax = -dna[0], day = -dna[1], daz = -dna[2];
        const pvt_real sign = az >= 0.0f ? 1.0f : -1.0f;
        const pvt_real den = sign + az;
        const pvt_real a_ = -1.0f / den, da_ = daz / (den * den);
        const pvt_real db_ = dax * ay * a_ + ax * day * a_ + ax * ay * da_;
        const pvt_real dt1[3] = {sign * (2.0f * ax * dax * a_ + ax * ax * da_), sign * db_,
                              -sign * dax};
        const pvt_real dt2[3] = {db_, 2.0f * ay * day * a_ + ay * ay * da_, -day};
        const pvt_real dax3[3] = {dax, day, daz};
        for (int k = 0; k < 3; ++k) dd[k] = lx * dt1[k] + ly * dt2[k] + ct_l * dax3[k];
      } else {
        for (int k = 0; k < 3; ++k) dd[k] = din[k] - 2.0f * (dc * na[k] + c * dna[k]);
      }
    } else if (sc.node_i[h * NODE_I + NI_SURF] == SURF_FRESNEL && o.mode != OVR_ABSORB) {
      const pvt_real cr = 1.0f - ratio * ratio * (1.0f - c * c);
      const pvt_real dcr =
          -(2.0f * ratio * dratio * (1.0f - c * c)) + ratio * ratio * 2.0f * c * dc;
      const pvt_real cterm = pvt_sqrt(pvt_fmax(cr, 0.0f));
      const pvt_real dct = max0_slope(cr) * dcr * (0.5f / cterm);
      const pvt_real scale = cterm - ratio * c, dscale = dct - (dratio * c + ratio * dc);
      for (int k = 0; k < 3; ++k)
        dd[k] = dratio * pd[k] + ratio * din[k] + dscale * na[k] + scale * dna[k];
    }
  }
  for (int k = 0; k < 3; ++k) {
    j[k] = dp[k];
    j[3 + k] = dd[k];
  }
  j[6] = dw;
  j[7] = dt0;
  j[8] = dalpha;
  j[9] = dr;
}

// What the hybrid terms of a step share between channels.
struct PathTerms {
  bool surv, coll, coin;
  pvt_real t0_fin, a_t0, coll_denom, rep_fac, branch;
};

PVT_FN PathTerms path_terms(const StepOut& o) {
  PathTerms pt;
  pt.surv = o.moving && !o.absorbed;
  const bool finite_t0 = isfinite(o.t0);
  pt.t0_fin = finite_t0 ? o.t0 : 0.0f;
  pt.a_t0 = o.alpha * pt.t0_fin;
  pt.coll_denom = pvt_fmax(-pvt_expm1(-pt.a_t0), PVT_R(1e-12));
  pt.coll = o.absorbed && finite_t0;
  pt.rep_fac = pvt_exp(pvt_fmin(o.alpha * (o.advance - pt.t0_fin), 0.0f)) *
               (-pvt_expm1(-o.alpha * o.advance)) / pt.coll_denom;
  pt.coin = o.fres_coin && (o.reflecting || o.transmitting);
  pt.branch = o.reflecting ? 1.0f / pvt_fmax(o.refl_r, PVT_R(1e-12))
                           : -1.0f / pvt_fmax(1.0f - o.refl_r, PVT_R(1e-12));
  return pt;
}

// One channel's hybrid contribution from its map j (step_tangent), and its
// new tangents tout[7] (pd: the pre-step direction): survival -d(alpha t0)
// on lanes that reached a boundary, collision e^{-a t0} d(alpha t0) /
// max(-expm1(-a t0), 1e-12) on absorbed lanes, the coin nan_to_num(dR *
// branch); the absorption point moved by dt0 * rep_fac along pd.
PVT_FN pvt_real path_contribution(const PathTerms& pt, const StepOut& o, const pvt_real* j,
                                  const pvt_real* pd, pvt_real* tout) {
  const pvt_real dt0 = pvt_nan_to_num(j[7]);
  const pvt_real d_at0 = pvt_nan_to_num(j[8]) * pt.t0_fin + o.alpha * dt0;
  const pvt_real ds = (pt.surv ? -d_at0 : 0.0f) +
                   (pt.coll ? pvt_exp(-pt.a_t0) * d_at0 / pt.coll_denom : 0.0f) +
                   (pt.coin ? pvt_nan_to_num(j[9] * pt.branch) : 0.0f);
  const pvt_real shift = pt.coll ? dt0 * pt.rep_fac : 0.0f;
  for (int k = 0; k < 7; ++k) tout[k] = pvt_nan_to_num(j[k]);
  for (int k = 0; k < 3; ++k) tout[k] += shift * pd[k];
  return ds;
}

// K13 in the trace: after step_one<.., kPath> gave o (pp, pd and wav_in,
// the photon's position, direction and wavelength before the step), each
// pathwise channel's contribution is added to the photon's score row and
// its tangent row replaced by the new tangents. `dwav`, the photon's flag
// that some channel's wavelength tangent is not 0 (false at emission), is
// read and set again: the spectral slopes multiply that tangent, so they
// are skipped while it is 0 everywhere (no parameter moves a wavelength,
// so it stays 0 from emission on; the K5a fits' slopes are finite).
PVT_FN void pathwise_step(const PvtScene& sc, const pvt_word* cheb, const StepOut& o,
                          const pvt_real* pp, const pvt_real* pd, pvt_real wav_in,
                          const pvt_real* u, const ScoreAcc& sa, bool& dwav) {
  const PathSlopes ps = dwav ? path_slopes(sc, cheb, o, wav_in, u) : PathSlopes{0.0f, 0.0f, 0.0f};
  const PathTerms pt = path_terms(o);
  const int first = sa.ch - sa.n_path;
  dwav = false;
  for (int ci = 0; ci < sa.n_path; ++ci) {
    pvt_real* row = sa.tang + (size_t)ci * 7 * sa.stride;
    pvt_real tin[7], j[PATH_J], tout[7];
    for (int k = 0; k < 7; ++k) tin[k] = row[k * sa.stride];
    step_tangent(sc, pp, pd, o, ps, u, sa.path + ci * PATH_I, tin, j);
    sa.row[(first + ci) * sa.stride] += path_contribution(pt, o, j, pd, tout);
    for (int k = 0; k < 7; ++k) row[k * sa.stride] = tout[k];
    dwav = dwav || tout[6] != 0.0f;
  }
}

// The pathwise lanes of pvt_pathwise (field order mirrored by ctypes):
// the path table, n channels, the tangents before the step tin [n, 7, B]
// and after it tout [n, 7, B], each channel's map jv [n, PATH_J, B]
// (step_tangent's, taken through nan_to_num) and contribution ds [n, B].
struct PvtPath {
  const int* path;
  int n;
  const pvt_real* tin;
  pvt_real* tout;
  pvt_real* jv;
  pvt_real* ds;
};

// pvt_pathwise: lane i's step (as pvt_step's), then every channel's map,
// contribution and new tangents; comp[i] as pvt_score's.
PVT_FN void pathwise_lane(const PvtScene& sc, const PvtState& in, const PvtState& out,
                          const PvtFlags& fl, long long i, long long B, const PvtPath& pw,
                          int* comp) {
  Photon p;
  load_lane(in, i, p);
  p.count += p.alive ? 1 : 0;
  const uint32_t k0 = (uint32_t)in.k0[i], k1 = (uint32_t)in.k1[i];
  const pvt_real pp[3] = {p.px, p.py, p.pz}, pd[3] = {p.dx, p.dy, p.dz}, wav_in = p.wav;
  pvt_real u[8];
  pvt_draw(k0, k1, (uint32_t)p.count, 0u, 4, u);
  StepOut o;
  step_one<true, false, true, true, true>(sc, sc.cheb_pack, p, u, o);
  store_lane(out, i, p, k0, k1);
  store_flags(fl, i, o);
  comp[i] = o.absorbed ? o.comp : -1;
  const PathSlopes ps = path_slopes(sc, sc.cheb_pack, o, wav_in, u);
  const PathTerms pt = path_terms(o);
  for (int ci = 0; ci < pw.n; ++ci) {
    pvt_real tin[7], j[PATH_J], tout[7];
    for (int k = 0; k < 7; ++k) tin[k] = pw.tin[(ci * 7 + k) * B + i];
    step_tangent(sc, pp, pd, o, ps, u, pw.path + ci * PATH_I, tin, j);
    pw.ds[ci * B + i] = path_contribution(pt, o, j, pd, tout);
    for (int k = 0; k < 7; ++k) pw.tout[(ci * 7 + k) * B + i] = tout[k];
    for (int k = 0; k < PATH_J; ++k) pw.jv[(ci * PATH_J + k) * B + i] = pvt_nan_to_num(j[k]);
  }
}

// pvt_tally's lane i: its event (post-step state s into p, selectors and
// normal fl into o) and its seen bits (SEEN_WORDS words a lane of
// recorder bits, as groups).
PVT_FN void tally_lane_load(const PvtScene& sc, const PvtState& s, const PvtFlags& fl,
                            const uint32_t* seen, long long i, StepOut& o, Photon& p,
                            Seen& bits) {
  load_lane(s, i, p);
  o.sel = fl.sel[i];
  o.tnode = fl.tnode[i];
  o.have_n = fl.have_n[i] != 0;
  o.surface_event = fl.surface_event[i] != 0;
  o.wn[0] = fl.wnx[i];
  o.wn[1] = fl.wny[i];
  o.wn[2] = fl.wnz[i];
  o.c_in = fl.c_in[i];
  seen_from_words(sc, seen + i * SEEN_WORDS, bits);
}

// pvt_tally on the host, one lane at a time: lane i's event added to acc
// by tally_event, its seen words written back.
PVT_FN void tally_lane(const PvtScene& sc, const PvtState& s, const PvtFlags& fl,
                       uint32_t* seen, long long i, const PvtTally& acc) {
  StepOut o;
  Photon p;
  Seen bits;
  tally_lane_load(sc, s, fl, seen, i, o, p, bits);
  tally_event(sc, acc, bits, o, p);
  seen_to_words(sc, bits, seen + i * SEEN_WORDS);
}

// Eight bytes of ints and sixteen of reals, moved as one access each on
// the card (a log record is three of ints and three of reals, six in the
// float64 build).
#if defined(__CUDACC__) && defined(PVT_F64)
typedef int2 PvtInt2;
typedef double2 PvtReal16;
#elif defined(__CUDACC__)
typedef int2 PvtInt2;
typedef float4 PvtReal16;
#else
struct alignas(8) PvtInt2 {
  int x, y;
};
struct alignas(16) PvtReal16 {
  pvt_real v[kReals16];
};
#endif
// 16-byte pieces of a record's LOG_F reals.
constexpr int kLogPieces = LOG_F / kReals16;

// K11: one record of photon slot `slot`, its nev-th, unless the row is
// full (engine/eventlog.py record). `nrm` may be null (zeros). The
// photon owns its row, so these are plain stores: three 8-byte and three
// 16-byte ones on the card (six in the float64 build; a record's ints
// start 8-byte and its reals 16-byte aligned), which ran 15 % faster than
// 18 scalar stores where every photon is recorded (PERF.md, section 6).
PVT_FN void log_record(const PvtLog& lg, long long slot, int& nev, int kind, int hit,
                       int container, int adjacent, int component, int source,
                       const pvt_real* pos, const pvt_real* dir, const pvt_real* nrm, pvt_real wav,
                       pvt_real trav, pvt_real dur) {
  if (nev >= lg.max_events) return;
  const long long at = slot * lg.max_events + nev;
  const pvt_real n0 = nrm ? nrm[0] : 0.0f, n1 = nrm ? nrm[1] : 0.0f, n2 = nrm ? nrm[2] : 0.0f;
  PvtInt2* ri = reinterpret_cast<PvtInt2*>(lg.ints + at * LOG_I);
  ri[0] = PvtInt2{kind, hit};
  ri[1] = PvtInt2{container, adjacent};
  ri[2] = PvtInt2{component, source};
  PvtReal16* rf = reinterpret_cast<PvtReal16*>(lg.floats + at * LOG_F);
#ifdef PVT_F64
  rf[0] = PvtReal16{pos[0], pos[1]};
  rf[1] = PvtReal16{pos[2], dir[0]};
  rf[2] = PvtReal16{dir[1], dir[2]};
  rf[3] = PvtReal16{n0, n1};
  rf[4] = PvtReal16{n2, wav};
  rf[5] = PvtReal16{trav, dur};
#else
  rf[0] = PvtReal16{pos[0], pos[1], pos[2], dir[0]};
  rf[1] = PvtReal16{dir[1], dir[2], n0, n1};
  rf[2] = PvtReal16{n2, wav, trav, dur};
#endif
  ++nev;
}

// K11: the records of one step (o, post-step state p; the direction,
// wavelength and source before it), in the JAX package's order
// (engine/eventlog.py record_step).
PVT_FN void log_step(const PvtLog& lg, long long slot, int& nev, const StepOut& o,
                     const Photon& p, const pvt_real* d_in, pvt_real wav_in, int src_in) {
  const pvt_real pos[3] = {p.px, p.py, p.pz};
  const pvt_real d_out[3] = {p.dx, p.dy, p.dz};
  if (o.kill_max)
    log_record(lg, slot, nev, EV_KILL, -1, o.container, -1, -1, src_in, pos, d_in, nullptr,
               p.wav, p.trav, p.dur);
  if (o.exit_mask)
    log_record(lg, slot, nev, EV_EXIT, o.hit, o.container, o.adjacent, -1, p.source, pos, d_in,
               nullptr, p.wav, p.trav, o.dur_adv);
  if (o.absorbed)
    log_record(lg, slot, nev, EV_ABSORB, -1, o.container, -1, o.comp, o.source_pre, pos, d_in,
               nullptr, wav_in, p.trav, o.dur_adv);
  const int volume[4] = {EV_EMIT, EV_SCATTER, EV_REACT, EV_NONRADIATIVE};
  const bool happened[4] = {o.emitting, o.scattering, o.reacting, o.losing};
  for (int k = 0; k < 4; ++k)
    if (happened[k])
      log_record(lg, slot, nev, volume[k], -1, o.container, -1, o.comp, p.source, pos, d_out,
                 nullptr, p.wav, p.trav, p.dur);
  if (o.adj_bad)
    log_record(lg, slot, nev, EV_KILL, o.hit, o.container, -1, -1, p.source, pos, d_out, nullptr,
               p.wav, p.trav, p.dur);
  if (o.reflecting || o.transmitting)
    log_record(lg, slot, nev, o.reflecting ? EV_REFLECT : EV_TRANSMIT, o.hit, o.container,
               o.adjacent, -1, p.source, pos, d_out, o.wn, p.wav, p.trav, p.dur);
}

// K11's pack (pvt_log_pack, tracer.cu), slot s: its first counts[s]
// records, a prefix of its row, to records offset.. of the packed ints
// [N, LOG_I] and floats [N, LOG_F]. Worker `lane` of `width` moves every
// width-th of the slot's 8-byte int pairs and 16-byte pieces of reals
// (float quads, or double pairs in the float64 build), so a warp's lanes
// read and write neighbouring words. A row and a packed
// record start 8-byte aligned in the ints and 16-byte aligned in the
// floats (LOG_I 6, LOG_F 12, the arrays' bases 16-byte aligned).
PVT_FN void log_pack_slot(const PvtLog& lg, long long s, long long offset, int lane, int width,
                          int* ints, pvt_real* floats) {
  const int words = 3 * lg.counts[s];
  const long long row = s * lg.max_events;
  const PvtInt2* si = reinterpret_cast<const PvtInt2*>(lg.ints + row * LOG_I);
  const PvtReal16* sf = reinterpret_cast<const PvtReal16*>(lg.floats + row * LOG_F);
  PvtInt2* di = reinterpret_cast<PvtInt2*>(ints + offset * LOG_I);
  PvtReal16* df = reinterpret_cast<PvtReal16*>(floats + offset * LOG_F);
  for (int k = lane; k < words; k += width) {
    di[k] = si[k];
    df[k] = sf[k];
  }
#ifdef PVT_F64
  // The other half of the records' 16-byte pieces of reals.
  for (int k = words + lane; k < kLogPieces * lg.counts[s]; k += width) df[k] = sf[k];
#endif
}

// ---------------------------------------------------------------------
// K7/K8: a photon's trace in three pieces, start, step and finish, which
// pvt_trace's loop (trace_kernel.cuh) runs one step a turn on every lane
// of a warp and trace_photon runs back to back. What a lane carries from
// one step to the next: the photon, its keys and id, with kTally the
// facet groups it has matched (`seen`), with kLog its log slot (-1: not
// recorded) and record count, with kPath its wavelength-tangent flag.
struct TraceLane {
  Photon p;
  uint32_t k0, k1, pid;
  Seen seen;
  long long slot;
  int nev;
  bool dwav;
};

// start: key and emit photon `pid` into lane L (kBundle: its row of the
// host bundle, load_one, in place of emit_one; its keys are the same),
// clear its `seen` bits, with kScore zero its score row (kPath: and its
// tangent rows) in *sa, and with kLog, when it is recorded, write its
// GENERATE record. Every photon starts alive. It draws the emission pairs
// of `need` (start_pairs). kMain: the float64 main path's start
// (main_step; emit_one's kMain).
template <bool kTally, bool kLog, bool kScore, bool kPath, bool kBundle, bool kMain = false>
PVT_FN void photon_start(const PvtScene& sc, const pvt_word* cheb, uint32_t s0, uint32_t s1,
                         uint32_t pid, unsigned need, TraceLane& L, const PvtLog* lg,
                         const ScoreAcc* sa, const PvtBundle& bundle) {
  L.pid = pid;
  threefry(s0, s1, pid, 0u, L.k0, L.k1);
  if (kBundle)
    load_one(bundle, pid, L.p);
  else
    emit_one<kMain>(sc, cheb, L.k0, L.k1, pid, need, L.p);
  if (kTally) seen_clear(L.seen);
  if (kScore)
    for (int c = 0; c < sa->ch; ++c) sa->row[c * sa->stride] = 0.0f;
  if (kPath)
    for (int k = 0; k < 7 * sa->n_path; ++k) sa->tang[k * sa->stride] = 0.0f;
  L.dwav = false;
  L.slot = -1;
  L.nev = 0;
  if (kLog && pid % lg->every == 0) {
    L.slot = (long long)(((unsigned long long)pid - lg->first) / lg->every);
    if (L.slot >= lg->n_slots) L.slot = -1;
  }
  if (kLog && L.slot >= 0) {
    const Photon& p = L.p;
    const pvt_real pos[3] = {p.px, p.py, p.pz}, dir[3] = {p.dx, p.dy, p.dz};
    log_record(*lg, L.slot, L.nev, EV_GENERATE, -1, -1, -1, -1, -1, pos, dir, nullptr, p.wav,
               0.0f, 0.0f);
  }
}

// step: one step of lane L's live photon, adding its fates to f, with
// kLog, when it is recorded, the step's records to *lg, or the
// event-budget KILL (a recorded photon with max_events - 1 records or more
// dies before its next step, counted in f.kill). kMesh false: the scene
// has no mesh; `tris` its triangles where a block staged them, else
// null (sc.tri_f). With kScore the step's contributions go to the photon's
// score row, which is folded at its fate where the step ended it (or at
// KILL by the event budget) with its record written where the run keeps
// them; with kPath (and kScore) the pathwise channels' contributions
// (pathwise_step, with the photon's wavelength-tangent flag) before the
// fold. When the photon dies, L.p.alive is false. Returns whether it took
// a step, whose output is then in o: the caller adds its recorder event
// (kTally; tally_event, or the warp's with tally_warp). kWide: K10's wide
// loop (mesh_nearest_two). The float64 main path's step (main_step) holds
// its uniforms as floats (step_one's kMain).
template <bool kTally, bool kLog, bool kMesh, bool kScore, bool kPath, bool kWide = false,
          bool kMain = main_step(kTally, kLog, kMesh, kScore, false)>
PVT_FN bool photon_step(const PvtScene& sc, const pvt_word* cheb, TraceLane& L, FateCounts& f,
                        const PvtLog* lg, const ScoreAcc* sa, StepOut& o,
                        const pvt_real* tris = nullptr) {
  Photon& p = L.p;
  p.count += 1;
  if (kLog && L.slot >= 0 && L.nev >= lg->max_events - 1) {
    const pvt_real pos[3] = {p.px, p.py, p.pz}, dir[3] = {p.dx, p.dy, p.dz};
    log_record(*lg, L.slot, L.nev, EV_KILL, -1, -1, -1, -1, p.source, pos, dir, nullptr, p.wav,
               p.trav, p.dur);
    f.kill += 1;
    if (kScore) {
      score_add(*sa, sa->fate, N_FATES, EV_KILL);
      score_record(*sa, L.pid, EV_KILL, p.count);
    }
    p.alive = false;
    return false;
  }
  const pvt_real d_in[3] = {p.dx, p.dy, p.dz};
  const pvt_real wav_in = p.wav;
  const int src_in = p.source;
  const pvt_real p_in[3] = {p.px, p.py, p.pz};
  typedef typename PvtUnif<kMain>::type U;
  U u[8];
  pvt_draw(L.k0, L.k1, (uint32_t)p.count, 0u, 4, u);
  step_one<kTally, kLog, kMesh, kScore, kPath, kWide, U, kMain>(sc, cheb, p, u, o, tris);
  f.exit += o.exit_mask;
  f.nonrad += o.losing;
  f.react += o.reacting;
  f.kill += o.kills;
  f.no_hit += o.no_hit_term;
  if (kScore) {
    score_step(sc, cheb, o, wav_in, *sa);
    if constexpr (kPath) pathwise_step(sc, cheb, o, p_in, d_in, wav_in, u, *sa, L.dwav);
    const int fate = score_fate(o);
    if (fate >= 0) {
      score_add(*sa, sa->fate, N_FATES, fate);
      score_record(*sa, L.pid, fate, p.count);
    }
  }
  if (kLog && L.slot >= 0) log_step(*lg, L.slot, L.nev, o, p, d_in, wav_in, src_in);
  return true;
}

// finish: adds lane L's dead photon's steps to f and returns them; with
// kLog, when it is recorded, writes its record count to the log's counts
// (one site for every death, the event budget's KILL included).
template <bool kLog>
PVT_FN int photon_finish(const TraceLane& L, FateCounts& f, const PvtLog* lg) {
  f.steps += (unsigned long long)L.p.count;
  if (kLog && L.slot >= 0) lg->counts[L.slot] = L.nev;
  return L.p.count;
}

// The emission pairs a trace's photon_start draws, found once a run: those
// the scene's lamps read (emit_pairs), but with kPath all three (drawing
// fewer ran 3.5 % slower on the mesh LSC's pathwise trace, whose
// instantiation spills; PERF.md, section 6).
template <bool kPath>
PVT_FN unsigned start_pairs(const PvtScene& sc) {
  return kPath ? 7u : emit_pairs(sc);
}

// Photon `pid` from emission to death, the three pieces back to back:
// start, step while it lives, finish. Returns its step count.
template <bool kTally, bool kLog, bool kMesh, bool kScore = false, bool kPath = false,
          bool kBundle = false>
PVT_FN int trace_photon(const PvtScene& sc, const pvt_word* cheb, uint32_t s0, uint32_t s1,
                        uint32_t pid, FateCounts& f, const PvtTally* acc, const PvtLog* lg,
                        const ScoreAcc* sa, const PvtBundle& bundle) {
  TraceLane L;
  constexpr bool kMain = main_step(kTally, kLog, kMesh, kScore, kBundle);
  photon_start<kTally, kLog, kScore, kPath, kBundle, kMain>(
      sc, cheb, s0, s1, pid, start_pairs<kPath>(sc), L, lg, sa, bundle);
  while (L.p.alive) {
    StepOut o;
    if (photon_step<kTally, kLog, kMesh, kScore, kPath, false, kMain>(sc, cheb, L, f, lg, sa,
                                                                      o) &&
        kTally)
      tally_event(sc, *acc, L.seen, o, L.p, kScore ? sa : nullptr);
  }
  return photon_finish<kLog>(L, f, lg);
}

// The warp's refill, as pvt_trace's loop takes it (the JAX package's
// regeneration at warp scope): at the top of every turn in which some lane
// holds no live photon, the lanes that hold none (`dead`, a bit a lane)
// take the next ids of the run's counter, one atomic for the warp, lane l
// the id at its rank among them (lane_rank). Waiting for 4, 8 or 16 dead lanes before
// a refill gained 3 % at most (at 2^20 photons) and lost 4-10 % on the
// main path and the mesh LSC at full size (PERF.md, section 6).

// pvt_draws (tracer.cu), lane i: the words of mask[i] (bit k: u[k]) of its
// step (pvt_draw's four pairs, as photon_step draws them; -1 for the words
// not in the mask) into words[8 i ..], and where the lane refills, rank
// `rank` among its warp's dead lanes, the key and the emission pairs of
// `need` of photon base + rank (emit_draws; -1 for the pairs not drawn)
// into keys[2 i ..] and emit[6 i ..]; 0 and -1 where it does not. Returns
// the threefry calls its refill made, counted where they are made.
PVT_FN int draws_lane(uint32_t s0, uint32_t s1, unsigned long long base, bool dead, int rank,
                      unsigned need, const long long* k0, const long long* k1,
                      const int* count, const unsigned char* mask, long long i,
                      long long* keys, pvt_real* emit, pvt_real* words) {
  pvt_real u[8];
  pvt_draw((uint32_t)k0[i], (uint32_t)k1[i], (uint32_t)count[i], 0u, 4, u);
  for (int k = 0; k < 8; ++k) words[8 * i + k] = mask[i] >> k & 1u ? u[k] : -1.0f;
  uint32_t pk0 = 0u, pk1 = 0u;
  pvt_real eu[6];
  for (int k = 0; k < 6; ++k) eu[k] = -1.0f;
  int calls = 0;
  if (dead) {
    threefry(s0, s1, (uint32_t)(base + (unsigned long long)rank), 0u, pk0, pk1);
    calls = 1 + emit_draws(pk0, pk1, need, eu);
  }
  keys[2 * i] = pk0;
  keys[2 * i + 1] = pk1;
  for (int k = 0; k < 6; ++k) emit[6 * i + k] = eu[k];
  return calls;
}

#ifndef __CUDACC__
// pvt_draws on the host: lanes [w kWarp, (w + 1) kWarp) of the arrays as
// one emulated warp; calls[w] gets the threefry calls its refill issued,
// the most any of its lanes made (a warp's lanes make them together).
void draws_warp(uint32_t s0, uint32_t s1, const long long* base, const unsigned char* dead,
                unsigned need, const long long* k0, const long long* k1, const int* count,
                const unsigned char* mask, long long w, long long* keys, pvt_real* emit,
                pvt_real* words, int* calls) {
  uint32_t deadm = 0u;
  for (int l = 0; l < kWarp; ++l)
    if (dead[w * kWarp + l]) deadm |= 1u << l;
  int most = 0;
  for (int l = 0; l < kWarp; ++l) {
    const int made = draws_lane(s0, s1, (unsigned long long)base[w], deadm >> l & 1u,
                                lane_rank(deadm, l), need, k0, k1, count, mask, w * kWarp + l,
                                keys, emit, words);
    if (made > most) most = made;
  }
  calls[w] = most;
}

// The host build's model of pvt_trace's loop, for the CPU tests: `warps`
// warps of kWarp lanes (lane k's score rows at sa[k]) take turns in
// order, each turn as a warp of the kernel takes it (the refill by
// lane_rank, the ids from *next up to `total`), until none holds a
// photon. Adds the photons' fates and steps to f, kWarp a turn of each
// warp to *lane_steps, and one to started[pid - first] at each photon's
// start (started may be null); returns the longest photon's steps.
template <bool kTally, bool kLog, bool kMesh, bool kScore, bool kPath, bool kBundle>
int trace_warps(const PvtScene& sc, const pvt_word* cheb, uint32_t s0, uint32_t s1,
                unsigned long long* next, unsigned long long total, int warps, FateCounts& f,
                const PvtTally* acc, const PvtLog* lg, const ScoreAcc* sa,
                const PvtBundle& bundle, unsigned long long* lane_steps, unsigned* started,
                unsigned long long first) {
  std::vector<TraceLane> lanes(warps * kWarp);
  std::vector<char> exhausted(warps, 0), done(warps, 0);
  for (TraceLane& L : lanes) L.p.alive = false;
  const unsigned need = start_pairs<kPath>(sc);
  int longest = 0, running = warps;
  while (running > 0) {
    for (int w = 0; w < warps; ++w) {
      if (done[w]) continue;
      TraceLane* L = lanes.data() + w * kWarp;
      const ScoreAcc* wsa = kScore ? sa + w * kWarp : nullptr;
      uint32_t dead = 0u;
      for (int l = 0; l < kWarp; ++l)
        if (!L[l].p.alive) dead |= 1u << l;
      if (!exhausted[w] && dead) {
        const unsigned long long base = *next;
        *next += (unsigned long long)pvt_popc(dead);
        exhausted[w] = base + pvt_popc(dead) >= total;
        for (int l = 0; l < kWarp; ++l) {
          const unsigned long long id = base + lane_rank(dead, l);
          if (!(dead >> l & 1u) || id >= total) continue;
          photon_start<kTally, kLog, kScore, kPath, kBundle,
                       main_step(kTally, kLog, kMesh, kScore, kBundle)>(
              sc, cheb, s0, s1, (uint32_t)id, need, L[l], lg, kScore ? wsa + l : nullptr, bundle);
          if (started) started[id - first] += 1;
        }
      }
      bool any = false;
      for (int l = 0; l < kWarp; ++l) any = any || L[l].p.alive;
      if (!any) {
        done[w] = 1;
        --running;
        continue;
      }
      *lane_steps += kWarp;
      StepOut o[kWarp];
      Photon p[kWarp];
      Seen seen[kWarp];
      uint32_t events = 0u;
      for (int l = 0; l < kWarp; ++l) {
        if (!L[l].p.alive) continue;
        if (photon_step<kTally, kLog, kMesh, kScore, kPath, false,
                        main_step(kTally, kLog, kMesh, kScore, kBundle)>(
                sc, cheb, L[l], f, lg, kScore ? wsa + l : nullptr, o[l]))
          events |= 1u << l;
        if (!L[l].p.alive) {
          const int steps = photon_finish<kLog>(L[l], f, lg);
          if (steps > longest) longest = steps;
        }
      }
      if (kTally && trace_rule(sc, kLog, kScore, kBundle) == 2) {
        for (int l = 0; l < kWarp; ++l) {
          p[l] = L[l].p;
          seen[l] = L[l].seen;
        }
        tally_warp_host(sc, *acc, seen, o, p, events);
        for (int l = 0; l < kWarp; ++l) L[l].seen = seen[l];
      } else if (kTally) {
        for (int l = 0; l < kWarp; ++l)
          if (events >> l & 1u)
            tally_event(sc, *acc, L[l].seen, o[l], L[l].p, kScore ? wsa + l : nullptr);
      }
    }
  }
  return longest;
}
#endif

// pvt_mesh: nearest two hits of ray i (o, d: [B, 3] in the node's local
// frame) against the node's triangles, read at `tris` (a block's shared
// copy, or `tri`), the nearest's normal from `tri` in device memory.
PVT_FN void mesh_lane(const pvt_real* tris, const pvt_real* tri, int n_tris, pvt_real eps,
                      const pvt_real* o, const pvt_real* d, long long i, pvt_real* t1, pvt_real* t2,
                      int* cnt, pvt_real* nrm) {
  int first;
  cnt[i] = mesh_nearest_two<wide_mesh(false, true, false, false)>(tris, n_tris, o + 3 * i,
                                                                   d + 3 * i, eps, t1 + i, t2 + i,
                                                                   &first);
  mesh_normal(tri, first, nrm + 3 * i);
}
