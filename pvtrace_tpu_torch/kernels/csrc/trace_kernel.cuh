// The persistent trace kernel of pvtrace_tpu_torch (pvt_trace) and what a
// block of it shares in shared memory: its recorder tallies (K9), score
// sums (K12), its threads' score and tangent rows (K12, K13) and the K5a
// table (trace_layout, tracer.cuh). Included by tracer.cu, which instantiates the score-free
// kernels, by score.cu, which instantiates the score kernels, and by
// pathwise.cu, which instantiates the score kernels with pathwise channels:
// three translation units that nvcc builds side by side.
#pragma once
#include <cuda_runtime.h>

#include "tracer.cuh"

namespace {

// Blocks of the trace kernel resident per SM, which caps a thread at 128
// registers: left free, nvcc gives the main path's instantiation and the
// heavier ones more and one block per SM, which ran slower than two
// blocks that spill a little (an A/B build on the H100; again with the
// step-a-turn loop: as fast on pvt_trace, slower with score or pathwise
// channels; PERF.md, section 6). A block's shared
// memory, kSharedTallyLimit, and its layout (trace_layout) are in
// tracer.cuh.
constexpr int kMinBlocks = 2;

bool bins_fit_shared(const PvtScene& sc) {
  return tally_bytes(sc, true) <= kSharedTallyLimit;
}

// Points a block's accumulators into dynamic shared memory and zeroes
// them (the caller synchronises). Per-block distinct and bins are 32-bit:
// they are bounded by the photons the block traces; so are crossings (up
// to maxsteps per photon), moved into the 64-bit totals before they could
// wrap (recorder_add).
__device__ PvtTally tally_block_init(const PvtScene& sc, unsigned char* smem, int shared_bins,
                                     const PvtTallyOut& out) {
  PvtTally acc;
  acc.cross = out.cross;
  acc.cross32 = reinterpret_cast<unsigned int*>(smem + kTallyCross * (size_t)sc.n_rec);
  acc.sums = reinterpret_cast<pvt_real*>(smem + kTallySums * (size_t)sc.n_rec);
  acc.distinct = reinterpret_cast<unsigned int*>(smem + kTallyDistinct * (size_t)sc.n_rec);
  acc.bins32 = shared_bins ? reinterpret_cast<unsigned int*>(smem + kTallyBins * (size_t)sc.n_rec)
                           : nullptr;
  acc.bins64 = shared_bins ? nullptr : out.bins;
  acc.sums64 = out.sums;
  for (int r = threadIdx.x; r < sc.n_rec; r += blockDim.x) {
    acc.cross32[r] = 0u;
    acc.distinct[r] = 0u;
  }
  for (int k = threadIdx.x; k < 8 * sc.n_rec; k += blockDim.x) acc.sums[k] = 0.0f;
  if (shared_bins)
    for (int b = threadIdx.x; b < sc.total_bins; b += blockDim.x) acc.bins32[b] = 0u;
  return acc;
}

// Adds a block's accumulators to device memory, one atomic per non-zero
// entry; the float32 sums left since their last move (tally_event) are
// added in float64, the float64 build's whole sums likewise (the caller
// synchronises first).
__device__ void tally_block_flush(const PvtScene& sc, const PvtTally& acc,
                                  const PvtTallyOut& out) {
  for (int r = threadIdx.x; r < sc.n_rec; r += blockDim.x) {
    if (acc.cross32[r]) atomicAdd(out.cross + r, (unsigned long long)acc.cross32[r]);
    if (acc.distinct[r]) atomicAdd(out.distinct + r, (unsigned long long)acc.distinct[r]);
  }
  for (int k = threadIdx.x; k < 8 * sc.n_rec; k += blockDim.x)
    if (acc.sums[k] != 0.0f) atomicAdd(out.sums + k, (double)acc.sums[k]);
  if (acc.bins32)
    for (int b = threadIdx.x; b < sc.total_bins; b += blockDim.x)
      if (acc.bins32[b]) atomicAdd(out.bins + b, (unsigned long long)acc.bins32[b]);
}

// A thread's K12 view: its own rows and the block's float64 accumulators,
// zeroed in shared memory at `smem` (s.shared) or the totals themselves
// (the caller synchronises). Its rows are the block's shared copy at
// `rows` (s.shared_rows; stride kBlock), or column `lane` of s.rows and
// s.tang, the global thread `lane` of the launch (stride s.stride).
__device__ ScoreAcc score_block_init(const PvtScene& sc, const PvtScore& s, unsigned char* smem,
                                     unsigned char* rows, long long lane) {
  ScoreAcc a;
  if (s.shared_rows) {
    a.row = reinterpret_cast<pvt_real*>(rows) + threadIdx.x;
    a.stride = kBlock;
    a.tang = a.row + (size_t)s.ch * kBlock;
  } else {
    a.row = s.rows + lane;
    a.stride = s.stride;
    a.tang = s.tang ? s.tang + lane : nullptr;
  }
  a.ch = s.ch;
  a.n_comps = s.n_comps;
  a.n_rec = sc.n_rec;
  a.photon = s.photon;
  a.photon_n = s.photon_n;
  a.path = s.path;
  a.n_path = s.n_path;
  if (s.shared) {
    a.fate = reinterpret_cast<double*>(smem);
    a.rec = a.fate + 2 * N_FATES * s.ch;
    for (int k = threadIdx.x; k < 2 * (N_FATES + sc.n_rec) * s.ch; k += blockDim.x)
      a.fate[k] = 0.0;
  } else {
    a.fate = s.fate_scores;
    a.rec = s.rec_scores;
  }
  return a;
}

// Adds a block's shared score sums to the totals (the caller
// synchronises first); nothing when they were added there directly.
__device__ void score_block_flush(const PvtScene& sc, const PvtScore& s, const ScoreAcc& a) {
  if (!s.shared) return;
  for (int k = threadIdx.x; k < 2 * N_FATES * s.ch; k += blockDim.x)
    if (a.fate[k] != 0.0) atomicAdd(s.fate_scores + k, a.fate[k]);
  for (int k = threadIdx.x; k < 2 * sc.n_rec * s.ch; k += blockDim.x)
    if (a.rec[k] != 0.0) atomicAdd(s.rec_scores + k, a.rec[k]);
}

// Copies the scene's K5a table into a block's shared memory at `dst`
// (16-byte aligned), 16 bytes a thread at a time, and returns it there
// (the caller synchronises). A block of a persistent kernel copies it once.
__device__ const pvt_word* stage_cheb(const PvtScene& sc, unsigned char* dst) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* src = reinterpret_cast<const int4*>(sc.cheb_pack);
  for (int k = threadIdx.x; k < sc.cheb_words / kWords16; k += blockDim.x) d[k] = src[k];
  return reinterpret_cast<const pvt_word*>(dst);
}

// Copies the scene's mesh triangles (tri_f, n_tris rows of TRI_F reals)
// into a block's shared memory at `dst` (16-byte aligned), 16 bytes a
// thread at a time, and returns them there (the caller synchronises).
__device__ const pvt_real* stage_tris(const pvt_real* tri_f, int n_tris, unsigned char* dst) {
  PvtReal16* d = reinterpret_cast<PvtReal16*>(dst);
  const PvtReal16* src = reinterpret_cast<const PvtReal16*>(tri_f);
  for (int k = threadIdx.x; k < n_tris * TRI_F / kReals16; k += blockDim.x) d[k] = src[k];
  return reinterpret_cast<const pvt_real*>(dst);
}

unsigned int grid_for(long long n) { return (unsigned int)((n + kBlock - 1) / kBlock); }

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it
// must be asked for).
template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Fate counter slots (light.event.Event values; 10 = left without a hit).
enum { F_NONRAD = 4, F_EXIT = 7, F_REACT = 8, F_KILL = 9, F_NO_HIT = 10 };

// Replaces _run, the while_loop of body_fast (and of body) steps and its
// lane regeneration (pvtrace_tpu/engine/tracer.py): K1-K13 in one kernel,
// persistent, with no host loop and no per-step sync. Each turn of a
// warp's loop is one step of every lane that holds a live photon
// (photon_step, tracer.cuh). At the top of a turn the lanes whose photon
// has died, or that hold none, take the next photon ids, the JAX
// package's regeneration at warp scope: a ballot finds them, one lane adds
// their number to the 64-bit counter (one atomic a warp), and each takes
// the id at its rank among them (lane_rank), keys and emits
// its photon (photon_start) and steps with the others in the same turn.
// The warp leaves when no lane holds a photon. Every photon's streams are
// a pure function of (seed, pid, its own step count), so which lane
// traces which pid, and when, changes no result.
//
// What bounds it: a warp's 32 lanes run one instruction stream, so a lane
// without a photon idles through its warp's turns. A loop per photon (a
// lane took a new photon only when all 32 of its warp's had died, the
// design before) spent 0.42 of a warp's lane-steps on photons on the
// slab: a photon takes 4.76 steps on average, the longest of 32 about 11.
// Now a lane idles only in the run's last turns (lane_steps: kWarp a turn
// of each warp; 0.999 of them trace a photon at 2^27 photons, 0.92 at
// 2^20), and the refilled lanes' emission branch, which the others wait
// through, costs less than waiting for more lanes to refill together
// would. Past that the step itself bounds it: its arithmetic, divergence
// inside step_one (lanes hold photons at different stages) and registers
// (128 a thread at two blocks an SM); with score channels and no
// recorders, the fold's float64 shared-memory atomics (PERF.md, section 6).
//
// Fates, steps and turns stay in registers, are reduced per block in
// shared memory and added to the int64 counters, one atomic each. With
// recorders (kTally), each turn's events go to the block's shared
// accumulators, each lane its own (tally_event) or, with kWarpTally, the
// warp's together (tally_warp; only pvt_trace's launch with recorders
// alone takes it, by the scene's facet groups: trace_rule, launch_for);
// a lane's `seen` bits mark the groups its photon has
// matched. They are flushed once at the end, the moment sums also every
// SUMS_FLUSH distinct rays of a recorder. With
// meshes (kMesh) a block first copies the triangles into its shared
// memory where they fit (trace_layout), and every step's K10 reads them
// there. The instantiation without
// recorders computes no selectors and takes no normal on EXIT. With the
// event log (kLog, K11; replaces _record and the log calls of body), a
// recorded photon's lane writes its records to the photon's own row with
// plain vector stores, its record count in a register and, at the
// photon's death, in the log's counts: one lane traces the photon from
// emission to death, so no two threads share a row and nothing needs an
// atomic; the rows are not filled beforehand (pvt_log_pack copies only
// what the counts cover). With score channels (kScore, K12; replaces the
// score block of body), the photon's score lives in the thread's own row
// of `score.rows` (any number of channels; a step touches the container's
// components and two node channels), zeroed at each start, and is folded
// in float64 into the block's shared [fate, channel] sums, which go to the
// totals at the end; the rows are the block's, in shared memory where
// they fit (trace_layout), so a step's reads and writes of them stay on
// the SM. The instantiations without the log carry none of its code,
// those without meshes (kMesh) none of K10's, those without scores none of
// K12's. With pathwise channels (kPath, K13, only with kScore; replaces
// the pathwise block of body), the photon's tangents live in the thread's
// own rows of `score.tang` beside its score row, and each step's tangent
// map and hybrid terms run after the primal step (pathwise_step); only
// the instantiations of pathwise.cu carry that code. With kBundle (K8's
// trace_bundle entry) each photon starts from its row of a host bundle in
// place of emit_one: a template axis, not a runtime branch, because a
// branch on the bundle in every instantiation moved the registers and
// spills of nearly all of them (PERF.md, section 6).
template <bool kTally, bool kLog, bool kMesh, bool kScore, bool kPath = false,
          bool kBundle = false, bool kWarpTally = false>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
trace_kernel(PvtScene sc, uint32_t s0, uint32_t s1, unsigned long long total,
             unsigned long long* next, unsigned long long* fates, int* max_count,
             unsigned long long* steps, PvtTallyOut tout, int shared_bins, PvtLog lg,
             PvtScore score, PvtBundle bundle, int cheb_at, int tris_at) {
  static_assert(!kWarpTally || !kScore, "the warp rule adds no scores");
  __shared__ unsigned long long block_fates[7];
  __shared__ int block_max;
  extern __shared__ __align__(16) unsigned char smem[];
  if (threadIdx.x < 7) block_fates[threadIdx.x] = 0ull;
  if (threadIdx.x == 0) block_max = 0;
  PvtTally acc;
  if (kTally) acc = tally_block_init(sc, smem, shared_bins, tout);
  ScoreAcc sa;
  if (kScore)
    sa = score_block_init(sc, score, smem + score_offset(sc, kTally, shared_bins),
                          smem + rows_offset(sc, kTally, shared_bins, score),
                          (long long)blockIdx.x * blockDim.x + threadIdx.x);
  const pvt_word* cheb = cheb_at >= 0 ? stage_cheb(sc, smem + cheb_at) : sc.cheb_pack;
  const pvt_real* tris = nullptr;
  if (kMesh && tris_at >= 0) tris = stage_tris(sc.tri_f, sc.n_tris, smem + tris_at);
  __syncthreads();

  FateCounts f = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
  int longest = 0;
  unsigned long long turns = 0ull;
  const int lane = threadIdx.x % kWarp;
  bool exhausted = false;
  TraceLane L;
  L.p.alive = false;
  const unsigned need = kBundle ? 0u : start_pairs<kPath>(sc);
  for (;;) {
    const uint32_t dead = __ballot_sync(0xffffffffu, !L.p.alive);
    if (!exhausted && dead) {
      const int leader = __ffs(dead) - 1;
      unsigned long long base = 0ull;
      if (lane == leader) base = atomicAdd(next, (unsigned long long)__popc(dead));
      base = __shfl_sync(0xffffffffu, base, leader);
      exhausted = base + __popc(dead) >= total;
      const unsigned long long id = base + lane_rank(dead, lane);
      if (!L.p.alive && id < total)
        photon_start<kTally, kLog, kScore, kPath, kBundle>(sc, cheb, s0, s1, (uint32_t)id, need,
                                                           L, &lg, kScore ? &sa : nullptr, bundle);
    }
    if (!__any_sync(0xffffffffu, L.p.alive)) break;
    ++turns;
    StepOut o;
    bool stepped = false;
    if (L.p.alive) {
      stepped = photon_step<kTally, kLog, kMesh, kScore, kPath>(sc, cheb, L, f, &lg,
                                                                kScore ? &sa : nullptr, o, tris);
      if (!L.p.alive) longest = max(longest, photon_finish<kLog>(L, f, &lg));
    }
    // Every lane of the warp is here: the loop leaves only by the warp's
    // vote above.
    if (kTally && kWarpTally) tally_warp(sc, acc, L.seen, o, L.p, stepped);
    if (kTally && !kWarpTally && stepped)
      tally_event(sc, acc, L.seen, o, L.p, kScore ? &sa : nullptr);
  }

  atomicAdd(&block_fates[0], f.exit);
  atomicAdd(&block_fates[1], f.nonrad);
  atomicAdd(&block_fates[2], f.react);
  atomicAdd(&block_fates[3], f.kill);
  atomicAdd(&block_fates[4], f.no_hit);
  atomicAdd(&block_fates[5], f.steps);
  atomicAdd(&block_fates[6], turns);
  atomicMax(&block_max, longest);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int slot[5] = {F_EXIT, F_NONRAD, F_REACT, F_KILL, F_NO_HIT};
    for (int k = 0; k < 5; ++k)
      if (block_fates[k]) atomicAdd(&fates[slot[k]], block_fates[k]);
    atomicAdd(steps, block_fates[5]);
    atomicAdd(steps + 1, block_fates[6]);
    atomicMax(max_count, block_max);
  }
  if (kTally) tally_block_flush(sc, acc, tout);
  if (kScore) score_block_flush(sc, score, sa);
}

// One pvt_trace launch of the instantiation <kTally, kLog, kMesh, kScore,
// kPath, kBundle, kWarpTally>, sized to the card's resident capacity (see pvt_trace),
// and with scores to at most score.stride threads (the rows there are).
// Without a bundle every photon is emitted on the device, which a scene
// without device lights cannot do: refused. info gets the thread count, a
// block's dynamic shared memory, and whether the recorder bins, the score
// sums, the K5a table and the threads' rows were placed there
// (trace_layout).
template <bool kTally, bool kLog, bool kMesh, bool kScore, bool kPath, bool kBundle,
          bool kWarpTally = false>
cudaError_t launch_trace(const PvtScene& sc, unsigned int s0, unsigned int s1,
                         unsigned long long total, long long max_threads,
                         unsigned long long* next, unsigned long long* fates, int* max_count,
                         unsigned long long* steps, const PvtTallyOut& tally,
                         const PvtLog& lg, const PvtScore& given, const PvtBundle& bundle,
                         long long* info, cudaStream_t stream) {
  // A photon without a bundle row is emitted from light pid % n_lights.
  if (kBundle ? !bundle.rows : sc.n_lights <= 0) return cudaErrorInvalidValue;
  const TraceLayout L = trace_layout(sc, kTally, kScore ? &given : nullptr);
  const int shared_bins = L.shared_bins, cheb_at = L.cheb_at;
  const size_t bytes = L.bytes;
  PvtScore score = given;
  if (kScore) {
    score.shared = L.shared_scores;
    score.shared_rows = L.shared_rows;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const auto kernel = trace_kernel<kTally, kLog, kMesh, kScore, kPath, kBundle, kWarpTally>;
  if (err == cudaSuccess && bytes > 0) err = allow_shared(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, bytes);
  if (err != cudaSuccess) return err;
  long long blocks = (long long)sms * per_sm;
  long long wanted = grid_for(max_threads);
  if (kScore && score.stride / kBlock < wanted) wanted = score.stride / kBlock;
  if (wanted < blocks) blocks = wanted;
  if (blocks < 1) return cudaErrorInvalidValue;
  info[0] = blocks * kBlock;
  layout_info(L, info);
  kernel<<<(unsigned int)blocks, kBlock, bytes, stream>>>(sc, s0, s1, total, next, fates,
                                                           max_count, steps, tally, shared_bins,
                                                           lg, score, bundle, cheb_at, L.tris_at);
  return cudaGetLastError();
}

// The signature every launch_trace instantiation shares.
using LaunchTrace = cudaError_t (*)(const PvtScene&, unsigned int, unsigned int,
                                    unsigned long long, long long, unsigned long long*,
                                    unsigned long long*, int*, unsigned long long*,
                                    const PvtTallyOut&, const PvtLog&, const PvtScore&,
                                    const PvtBundle&, long long*, cudaStream_t);

// The launch_trace instantiation of a run with scores (kScore) and
// pathwise channels (kPath): by whether it starts from a bundle, has
// recorders, writes the log, and has meshes; and by the rule that adds
// the recorder events (trace_rule): the warp rule only in pvt_trace's
// launch with recorders alone, the lane rule in every other.
template <bool kScore, bool kPath>
LaunchTrace launch_for(const PvtScene& sc, const PvtLog& lg, const PvtBundle& bundle) {
  if constexpr (!kScore)
    if (trace_rule(sc, lg.n_slots > 0, kScore, bundle.rows != nullptr) == 2)
      return launch_trace<true, false, false, false, false, false, true>;
#define PVT_LAUNCH(b, t, l) \
  {launch_trace<t, l, false, kScore, kPath, b>, launch_trace<t, l, true, kScore, kPath, b>}
  const LaunchTrace launch[2][2][2][2] = {
      {{PVT_LAUNCH(false, false, false), PVT_LAUNCH(false, false, true)},
       {PVT_LAUNCH(false, true, false), PVT_LAUNCH(false, true, true)}},
      {{PVT_LAUNCH(true, false, false), PVT_LAUNCH(true, false, true)},
       {PVT_LAUNCH(true, true, false), PVT_LAUNCH(true, true, true)}},
  };
#undef PVT_LAUNCH
  return launch[bundle.rows != nullptr][sc.n_rec > 0][lg.n_slots > 0][sc.n_tris > 0];
}

}  // namespace
