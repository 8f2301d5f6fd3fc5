// The Hopper kernels of pvtrace_tpu_torch: emission, one physics step,
// the persistent trace kernel of the main path (with recorders, an event
// log, or both), and the standalone K5a, K9 and K10 entries that let the
// card hold those device functions to their twins.
//
// Built by pvtrace_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (no fast-math) and bound with ctypes. Every entry point launches on the
// stream it is given, allocates nothing, and returns a CUDA error code.
// The per-lane bodies live in tracer.cuh.
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
size_t tally_bytes(const PvtScene& sc, bool shared_bins) {
  return 44 * (size_t)sc.n_rec + (shared_bins ? 4 * (size_t)sc.total_bins : 0);
}

bool bins_fit_shared(const PvtScene& sc) {
  return tally_bytes(sc, true) <= kSharedTallyLimit;
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

// Replaces _photon_keys and _device_emit_flat (pvtrace_tpu/engine/
// tracer.py). Bound by integer ALU: four threefry evaluations (80 rounds
// of add/rotate/xor) per photon against a few dozen float operations and
// 60 bytes written. One thread per photon; nothing to share.
__global__ void __launch_bounds__(kBlock)
emit_kernel(PvtScene sc, uint32_t s0, uint32_t s1, unsigned long long offset,
            long long B, PvtState out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) emit_lane(sc, s0, s1, offset, i, out);
}

// Replaces one step of body_fast: the step_fn draws and physics_core
// (pvtrace_tpu/engine/tracer.py), with the per-lane fate flags and
// recorder selectors. Bound by divergence and registers: the node loop,
// the volume branch and the surface branch are taken by different lanes
// of a warp. Not on the main path; it lets the card hold the physics to
// the eager twin lane by lane.
__global__ void __launch_bounds__(kBlock)
step_kernel(PvtScene sc, PvtState in, PvtState out, PvtFlags fl, long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) step_lane(sc, in, out, fl, i);
}

// Replaces _clenshaw / _eval_fit (pvtrace_tpu/engine/tracer.py) on a grid:
// out[f * n_t + j] = fit f at t[j], one thread each. Not on the main path
// (cheb_eval runs inside pvt_trace); it lets the card hold K5a to its
// twin fit by fit. Bound by the segment search and the Clenshaw chain
// (operations; each fit's few hundred coefficient bytes stay in L1).
__global__ void __launch_bounds__(kBlock)
cheb_kernel(PvtScene sc, const float* t, long long n_t, long long n, float* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = cheb_eval(sc, (int)(i / n_t), t[i % n_t]);
}

// Replaces _tally and the tally frame of body_fast (pvtrace_tpu/engine/
// tracer.py) for one step of B lanes: one thread per lane walks the CSR
// list of its (tnode, sel), accumulating per block in shared memory as
// pvt_trace does. Not on the main path; it lets the card hold K9 to its
// twin lane by lane. Bound by shared-memory atomics on hot recorders.
__global__ void __launch_bounds__(kBlock)
tally_kernel(PvtScene sc, PvtState s, PvtFlags fl, uint32_t* seen, long long B,
             PvtTallyOut out, int shared_bins) {
  extern __shared__ __align__(8) unsigned char smem[];
  const PvtTally acc = tally_block_init(sc, smem, shared_bins, out);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) tally_lane(sc, s, fl, seen, i, acc);
  __syncthreads();
  tally_block_flush(sc, acc, out);
}

// Replaces _mesh_nearest_two (pvtrace_tpu/engine/tracer.py) for B rays
// against one mesh node, one thread each. Not on the main path
// (mesh_nearest_two runs inside pvt_trace); it lets the card hold K10 to
// its twin ray by ray. Bound by operations, about 60 a triangle.
__global__ void __launch_bounds__(kBlock)
mesh_kernel(const float* tri, int n_tris, float eps, const float* o, const float* d,
            long long B, float* t1, float* t2, int* cnt, float* nrm) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) mesh_lane(tri, n_tris, eps, o, d, i, t1, t2, cnt, nrm);
}

// Fate counter slots (light.event.Event values; 10 = left without a hit).
enum { F_NONRAD = 4, F_EXIT = 7, F_REACT = 8, F_KILL = 9, F_NO_HIT = 10 };

// Replaces _run, the while_loop of body_fast steps and its lane
// regeneration (pvtrace_tpu/engine/tracer.py): K1-K9 in one kernel.
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
// row and nothing needs an atomic. The instantiations without the log
// carry none of its code, those without meshes (kMesh) none of K10's.
template <bool kTally, bool kLog, bool kMesh>
__global__ void __launch_bounds__(kBlock)
trace_kernel(PvtScene sc, uint32_t s0, uint32_t s1, unsigned long long total,
             unsigned long long* next, unsigned long long* fates, int* max_count,
             unsigned long long* steps, PvtTallyOut tout, int shared_bins, PvtLog lg) {
  __shared__ unsigned long long block_fates[6];
  __shared__ int block_max;
  extern __shared__ __align__(8) unsigned char smem[];
  if (threadIdx.x < 6) block_fates[threadIdx.x] = 0ull;
  if (threadIdx.x == 0) block_max = 0;
  PvtTally acc;
  if (kTally) acc = tally_block_init(sc, smem, shared_bins, tout);
  __syncthreads();

  FateCounts f = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
  int longest = 0;
  for (;;) {
    const unsigned long long id = atomicAdd(next, 1ull);
    if (id >= total) break;
    longest = max(longest,
                  trace_photon<kTally, kLog, kMesh>(sc, s0, s1, (uint32_t)id, f, &acc, &lg));
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
}

unsigned int grid_for(long long n) { return (unsigned int)((n + kBlock - 1) / kBlock); }

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it
// must be asked for).
template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// One pvt_trace launch of the instantiation <kTally, kLog, kMesh>, sized
// to the card's resident capacity (see pvt_trace).
template <bool kTally, bool kLog, bool kMesh>
cudaError_t launch_trace(const PvtScene& sc, unsigned int s0, unsigned int s1,
                         unsigned long long total, long long max_threads,
                         unsigned long long* next, unsigned long long* fates, int* max_count,
                         unsigned long long* steps, const PvtTallyOut& tally,
                         const PvtLog& lg, long long* info, cudaStream_t stream) {
  const int shared_bins = kTally && bins_fit_shared(sc) ? 1 : 0;
  const size_t bytes = kTally ? tally_bytes(sc, shared_bins) : 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const auto kernel = trace_kernel<kTally, kLog, kMesh>;
  if (err == cudaSuccess && kTally) err = allow_shared(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, bytes);
  if (err != cudaSuccess) return err;
  long long blocks = (long long)sms * per_sm;
  const long long wanted = grid_for(max_threads);
  if (wanted < blocks) blocks = wanted;
  if (blocks < 1) blocks = 1;
  info[0] = blocks * kBlock;
  info[1] = (long long)bytes;
  info[2] = shared_bins;
  kernel<<<(unsigned int)blocks, kBlock, bytes, stream>>>(
      sc, s0, s1, total, next, fates, max_count, steps, tally, shared_bins, lg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pvt_emit(const PvtScene* sc, unsigned int s0, unsigned int s1,
             unsigned long long offset, long long B, const PvtState* out, void* stream) {
  emit_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(*sc, s0, s1, offset, B, *out);
  return (int)cudaGetLastError();
}

int pvt_step(const PvtScene* sc, const PvtState* in, const PvtState* out,
             const PvtFlags* flags, long long B, void* stream) {
  step_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(*sc, *in, *out, *flags, B);
  return (int)cudaGetLastError();
}

// Every fit of the scene (sc->cheb_* tables, n_fits of them) at the n_t
// values t: out is [n_fits, n_t].
int pvt_cheb(const PvtScene* sc, int n_fits, const float* t, long long n_t, float* out,
             void* stream) {
  const long long n = (long long)n_fits * n_t;
  cheb_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(*sc, t, n_t, n, out);
  return (int)cudaGetLastError();
}

// One step's events of B lanes added to *out (zeroed by the caller);
// seen is [B, SEEN_WORDS], updated. Writes 1 to *shared_bins when the
// bins were accumulated in shared memory.
int pvt_tally(const PvtScene* sc, const PvtState* state, const PvtFlags* flags,
              unsigned int* seen, long long B, const PvtTallyOut* out, int* shared_bins,
              void* stream) {
  *shared_bins = bins_fit_shared(*sc) ? 1 : 0;
  const size_t bytes = tally_bytes(*sc, *shared_bins);
  cudaError_t err = allow_shared(tally_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  tally_kernel<<<grid_for(B), kBlock, bytes, (cudaStream_t)stream>>>(
      *sc, *state, *flags, seen, B, *out, *shared_bins);
  return (int)cudaGetLastError();
}

// B rays (o, d: [B, 3], the node's local frame) against n_tris triangles
// (rows of TRI_F): t1, t2, cnt [B] and the nearest hit's normal nrm [B, 3].
int pvt_mesh(const float* tri, int n_tris, float eps, const float* o, const float* d,
             long long B, float* t1, float* t2, int* cnt, float* nrm, void* stream) {
  mesh_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(tri, n_tris, eps, o, d, B, t1,
                                                                 t2, cnt, nrm);
  return (int)cudaGetLastError();
}

// Launches min(max_threads, resident capacity) threads, rounded up to
// whole blocks. info[0] gets their number, info[1] the dynamic shared
// memory of a block, info[2] 1 when the recorder bins were in shared
// memory. With sc->n_rec == 0 the tally outputs are not touched, with
// log->n_slots == 0 the log. The instantiation follows the scene and the
// run: recorders, log, meshes.
int pvt_trace(const PvtScene* sc, unsigned int s0, unsigned int s1,
              unsigned long long total, long long max_threads,
              unsigned long long* next, unsigned long long* fates, int* max_count,
              unsigned long long* steps, const PvtTallyOut* tally, const PvtLog* log,
              long long* info, void* stream) {
  using Launch = cudaError_t (*)(const PvtScene&, unsigned int, unsigned int, unsigned long long,
                                 long long, unsigned long long*, unsigned long long*, int*,
                                 unsigned long long*, const PvtTallyOut&, const PvtLog&,
                                 long long*, cudaStream_t);
  const Launch launch[2][2][2] = {
      {{launch_trace<false, false, false>, launch_trace<false, false, true>},
       {launch_trace<false, true, false>, launch_trace<false, true, true>}},
      {{launch_trace<true, false, false>, launch_trace<true, false, true>},
       {launch_trace<true, true, false>, launch_trace<true, true, true>}},
  };
  return (int)launch[sc->n_rec > 0][log->n_slots > 0][sc->n_tris > 0](
      *sc, s0, s1, total, max_threads, next, fates, max_count, steps, *tally, *log, info,
      (cudaStream_t)stream);
}

}  // extern "C"
