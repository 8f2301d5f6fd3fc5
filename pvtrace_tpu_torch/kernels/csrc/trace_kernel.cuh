// The persistent trace kernel of pvtrace_tpu_torch (pvt_trace) and what a
// block of it shares: its recorder tallies (K9) and score sums (K12) in
// shared memory. Included by tracer.cu, which instantiates the score-free
// kernels, by score.cu, which instantiates the score kernels, and by
// pathwise.cu, which instantiates the score kernels with pathwise channels:
// three translation units that nvcc builds side by side.
#pragma once
#include <cuda_runtime.h>

#include "tracer.cuh"

namespace {

constexpr int kBlock = 256;
// Recorder tallies keep their bins in shared memory while a block's
// accumulators fit in this many bytes: two blocks of 256 threads are
// resident per SM (registers allow no more), and 2 x 96 KB fits the
// SM's 228 KB. Larger bin sets (big heatmaps) go straight to 64-bit
// atomics in device memory.
constexpr size_t kSharedTallyLimit = 96 * 1024;

// Bytes of a block's K9 accumulators: crossings u64 [R], sums f32 [8R],
// distinct u32 [R], then the bins u32 [total_bins] when they are shared.
__host__ __device__ inline size_t tally_bytes(const PvtScene& sc, bool shared_bins) {
  return 44 * (size_t)sc.n_rec + (shared_bins ? 4 * (size_t)sc.total_bins : 0);
}

bool bins_fit_shared(const PvtScene& sc) {
  return tally_bytes(sc, true) <= kSharedTallyLimit;
}

// Bytes of a block's K12 accumulators when they are shared: float64
// fate_scores [2, 11, ch] and rec_scores [2, R, ch].
__host__ __device__ inline size_t score_bytes(const PvtScene& sc, const PvtScore& s) {
  return s.shared ? 16 * (size_t)s.ch * (N_FATES + (size_t)sc.n_rec) : 0;
}

// `s` with its `shared` decided: the block's score sums go to shared
// memory when they fit there after `offset` bytes of tallies.
PvtScore score_placed(const PvtScene& sc, const PvtScore& s, size_t offset) {
  PvtScore placed = s;
  placed.shared = 1;
  placed.shared = offset + score_bytes(sc, placed) <= kSharedTallyLimit ? 1 : 0;
  return placed;
}

// Offset of the score accumulators in a block's dynamic shared memory:
// after the tallies, 8-byte aligned.
__host__ __device__ inline size_t score_offset(const PvtScene& sc, bool tally, int shared_bins) {
  return ((tally ? tally_bytes(sc, shared_bins) : 0) + 7) / 8 * 8;
}

// Points a block's accumulators into dynamic shared memory and zeroes
// them (the caller synchronises). Per-block distinct and bins are 32-bit:
// they are bounded by the photons the block traces; crossings (up to
// maxsteps per photon) are 64-bit.
__device__ PvtTally tally_block_init(const PvtScene& sc, unsigned char* smem, int shared_bins,
                                     const PvtTallyOut& out) {
  PvtTally acc;
  acc.cross = reinterpret_cast<unsigned long long*>(smem);
  acc.sums = reinterpret_cast<float*>(smem + 8 * (size_t)sc.n_rec);
  acc.distinct = reinterpret_cast<unsigned int*>(smem + 40 * (size_t)sc.n_rec);
  acc.bins32 = shared_bins ? reinterpret_cast<unsigned int*>(smem + 44 * (size_t)sc.n_rec)
                           : nullptr;
  acc.bins64 = shared_bins ? nullptr : out.bins;
  acc.sums64 = out.sums;
  for (int r = threadIdx.x; r < sc.n_rec; r += blockDim.x) {
    acc.cross[r] = 0ull;
    acc.distinct[r] = 0u;
  }
  for (int k = threadIdx.x; k < 8 * sc.n_rec; k += blockDim.x) acc.sums[k] = 0.0f;
  if (shared_bins)
    for (int b = threadIdx.x; b < sc.total_bins; b += blockDim.x) acc.bins32[b] = 0u;
  return acc;
}

// Adds a block's accumulators to device memory, one atomic per non-zero
// entry; the float32 sums left since their last move (tally_event) are
// added in float64 (the caller synchronises first).
__device__ void tally_block_flush(const PvtScene& sc, const PvtTally& acc,
                                  const PvtTallyOut& out) {
  for (int r = threadIdx.x; r < sc.n_rec; r += blockDim.x) {
    if (acc.cross[r]) atomicAdd(out.cross + r, acc.cross[r]);
    if (acc.distinct[r]) atomicAdd(out.distinct + r, (unsigned long long)acc.distinct[r]);
  }
  for (int k = threadIdx.x; k < 8 * sc.n_rec; k += blockDim.x)
    if (acc.sums[k] != 0.0f) atomicAdd(out.sums + k, (double)acc.sums[k]);
  if (acc.bins32)
    for (int b = threadIdx.x; b < sc.total_bins; b += blockDim.x)
      if (acc.bins32[b]) atomicAdd(out.bins + b, (unsigned long long)acc.bins32[b]);
}

// A thread's K12 view: its own score row (global thread `lane` of the
// launch) and the block's float64 accumulators, zeroed in shared memory
// at `smem` (s.shared) or the totals themselves (the caller synchronises).
__device__ ScoreAcc score_block_init(const PvtScene& sc, const PvtScore& s, unsigned char* smem,
                                     long long lane) {
  ScoreAcc a;
  a.row = s.rows + lane;
  a.stride = s.stride;
  a.ch = s.ch;
  a.n_comps = s.n_comps;
  a.n_rec = sc.n_rec;
  a.photon = s.photon;
  a.photon_n = s.photon_n;
  a.tang = s.tang ? s.tang + lane : nullptr;
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
// lane regeneration (pvtrace_tpu/engine/tracer.py): K1-K12 in one kernel.
// Persistent: each thread takes the next photon id from a 64-bit atomic
// counter, keys and emits the photon, steps it in registers until it
// dies, and takes another, until `total`. Every photon's streams are a
// pure function of (seed, pid, its own step count), so which thread
// traces which pid cannot change the result, and there is no host loop,
// no per-step sync and no refill prefix sum. Bound by divergence and
// registers (the physics step per thread); the atomic is one per photon.
// Fates and steps stay in registers, are reduced per block in shared
// memory and added to the int64 counters, one atomic each. With
// recorders (kTally), each photon's events go to the block's shared
// accumulators (a per-thread `seen` bitset marks the recorders the
// photon has matched), flushed once at the end, the moment sums also
// every SUMS_FLUSH distinct rays of a recorder. The instantiation
// without recorders computes no selectors and takes no normal on EXIT.
// With the event log (kLog, K11; replaces _record and the log calls of
// body), a recorded photon's thread writes its records to the photon's
// own row with plain stores, its record count in a register: the thread
// traces the photon from emission to death, so no two threads share a
// row and nothing needs an atomic. With score channels (kScore, K12;
// replaces the score block of body), the photon's score lives in the
// thread's own row of `score.rows` (any number of channels; a step
// touches the container's components and two node channels), and is
// folded in float64 into the block's shared [fate, channel] sums, which
// go to the totals at the end. The instantiations without the log carry
// none of its code, those without meshes (kMesh) none of K10's, those
// without scores none of K12's. With pathwise channels (kPath, K13, only
// with kScore; replaces the pathwise block of body), the photon's tangents
// live in the thread's own rows of `score.tang` beside its score row, and
// each step's tangent map and hybrid terms run after the primal step
// (pathwise_step); only the instantiations of pathwise.cu carry that code.
template <bool kTally, bool kLog, bool kMesh, bool kScore, bool kPath = false>
__global__ void __launch_bounds__(kBlock)
trace_kernel(PvtScene sc, uint32_t s0, uint32_t s1, unsigned long long total,
             unsigned long long* next, unsigned long long* fates, int* max_count,
             unsigned long long* steps, PvtTallyOut tout, int shared_bins, PvtLog lg,
             PvtScore score) {
  __shared__ unsigned long long block_fates[6];
  __shared__ int block_max;
  extern __shared__ __align__(8) unsigned char smem[];
  if (threadIdx.x < 6) block_fates[threadIdx.x] = 0ull;
  if (threadIdx.x == 0) block_max = 0;
  PvtTally acc;
  if (kTally) acc = tally_block_init(sc, smem, shared_bins, tout);
  ScoreAcc sa;
  if (kScore)
    sa = score_block_init(sc, score, smem + score_offset(sc, kTally, shared_bins),
                          (long long)blockIdx.x * blockDim.x + threadIdx.x);
  __syncthreads();

  FateCounts f = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
  int longest = 0;
  for (;;) {
    const unsigned long long id = atomicAdd(next, 1ull);
    if (id >= total) break;
    longest = max(longest, trace_photon<kTally, kLog, kMesh, kScore, kPath>(
                               sc, s0, s1, (uint32_t)id, f, &acc, &lg, kScore ? &sa : nullptr));
  }

  atomicAdd(&block_fates[0], f.exit);
  atomicAdd(&block_fates[1], f.nonrad);
  atomicAdd(&block_fates[2], f.react);
  atomicAdd(&block_fates[3], f.kill);
  atomicAdd(&block_fates[4], f.no_hit);
  atomicAdd(&block_fates[5], f.steps);
  atomicMax(&block_max, longest);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int slot[5] = {F_EXIT, F_NONRAD, F_REACT, F_KILL, F_NO_HIT};
    for (int k = 0; k < 5; ++k)
      if (block_fates[k]) atomicAdd(&fates[slot[k]], block_fates[k]);
    atomicAdd(steps, block_fates[5]);
    atomicMax(max_count, block_max);
  }
  if (kTally) tally_block_flush(sc, acc, tout);
  if (kScore) score_block_flush(sc, score, sa);
}

// One pvt_trace launch of the instantiation <kTally, kLog, kMesh, kScore,
// kPath>, sized to the card's resident capacity (see pvt_trace), and with
// scores to at most score.stride threads (the rows there are). info gets the
// thread count, a block's dynamic shared memory, and whether the recorder
// bins and the score sums were placed there.
template <bool kTally, bool kLog, bool kMesh, bool kScore, bool kPath = false>
cudaError_t launch_trace(const PvtScene& sc, unsigned int s0, unsigned int s1,
                         unsigned long long total, long long max_threads,
                         unsigned long long* next, unsigned long long* fates, int* max_count,
                         unsigned long long* steps, const PvtTallyOut& tally,
                         const PvtLog& lg, const PvtScore& given, long long* info,
                         cudaStream_t stream) {
  const int shared_bins = kTally && bins_fit_shared(sc) ? 1 : 0;
  const size_t offset = score_offset(sc, kTally, shared_bins);
  const PvtScore score = kScore ? score_placed(sc, given, offset) : given;
  const size_t bytes = kScore ? offset + score_bytes(sc, score)
                              : (kTally ? tally_bytes(sc, shared_bins) : 0);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const auto kernel = trace_kernel<kTally, kLog, kMesh, kScore, kPath>;
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
  info[1] = (long long)bytes;
  info[2] = shared_bins;
  info[3] = kScore ? score.shared : 0;
  kernel<<<(unsigned int)blocks, kBlock, bytes, stream>>>(
      sc, s0, s1, total, next, fates, max_count, steps, tally, shared_bins, lg, score);
  return cudaGetLastError();
}

// The signature every launch_trace instantiation shares.
using LaunchTrace = cudaError_t (*)(const PvtScene&, unsigned int, unsigned int,
                                    unsigned long long, long long, unsigned long long*,
                                    unsigned long long*, int*, unsigned long long*,
                                    const PvtTallyOut&, const PvtLog&, const PvtScore&,
                                    long long*, cudaStream_t);

}  // namespace
