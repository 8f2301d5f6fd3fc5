// The Hopper kernels of pvtrace_tpu_torch: emission, one physics step,
// and the persistent trace kernel of the main path.
//
// Built by pvtrace_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (no fast-math) and bound with ctypes. Every entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
// The per-lane bodies live in tracer.cuh.
#include <cuda_runtime.h>

#include "tracer.cuh"

namespace {

constexpr int kBlock = 256;

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
// (pvtrace_tpu/engine/tracer.py), with the per-lane fate flags. Bound by
// divergence and registers: the node loop, the volume branch and the
// surface branch are taken by different lanes of a warp. Not on the main
// path; it lets the card hold the physics to the eager twin lane by lane.
__global__ void __launch_bounds__(kBlock)
step_kernel(PvtScene sc, PvtState in, PvtState out, PvtFlags fl, long long B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) step_lane(sc, in, out, fl, i);
}

// Fate counter slots (light.event.Event values; 10 = left without a hit).
enum { F_NONRAD = 4, F_EXIT = 7, F_REACT = 8, F_KILL = 9, F_NO_HIT = 10 };

// Replaces _run, the while_loop of body_fast steps and its lane
// regeneration (pvtrace_tpu/engine/tracer.py): K1-K8 in one kernel.
// Persistent: each thread takes the next photon id from a 64-bit atomic
// counter, keys and emits the photon, steps it in registers until it
// dies, and takes another, until `total`. Every photon's streams are a
// pure function of (seed, pid, its own step count), so which thread
// traces which pid cannot change the result, and there is no host loop,
// no per-step sync and no refill prefix sum. Bound by divergence and
// registers (the physics step per thread); the atomic is one per photon.
// Fates stay in registers, are reduced per block in shared memory and
// added to the five int64 counters that can be non-zero, one atomic each.
__global__ void __launch_bounds__(kBlock)
trace_kernel(PvtScene sc, uint32_t s0, uint32_t s1, unsigned long long total,
             unsigned long long* next, unsigned long long* fates, int* max_count) {
  __shared__ unsigned long long block_fates[5];
  __shared__ int block_max;
  if (threadIdx.x < 5) block_fates[threadIdx.x] = 0ull;
  if (threadIdx.x == 0) block_max = 0;
  __syncthreads();

  FateCounts f = {0ull, 0ull, 0ull, 0ull, 0ull};
  int longest = 0;
  for (;;) {
    const unsigned long long id = atomicAdd(next, 1ull);
    if (id >= total) break;
    longest = max(longest, trace_photon(sc, s0, s1, (uint32_t)id, f));
  }

  atomicAdd(&block_fates[0], f.exit);
  atomicAdd(&block_fates[1], f.nonrad);
  atomicAdd(&block_fates[2], f.react);
  atomicAdd(&block_fates[3], f.kill);
  atomicAdd(&block_fates[4], f.no_hit);
  atomicMax(&block_max, longest);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int slot[5] = {F_EXIT, F_NONRAD, F_REACT, F_KILL, F_NO_HIT};
    for (int k = 0; k < 5; ++k)
      if (block_fates[k]) atomicAdd(&fates[slot[k]], block_fates[k]);
    atomicMax(max_count, block_max);
  }
}

unsigned int grid_for(long long n) { return (unsigned int)((n + kBlock - 1) / kBlock); }

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

// Launches min(max_threads, resident capacity) threads, rounded up to
// whole blocks, and writes their number to *threads.
int pvt_trace(const PvtScene* sc, unsigned int s0, unsigned int s1,
              unsigned long long total, long long max_threads,
              unsigned long long* next, unsigned long long* fates, int* max_count,
              long long* threads, void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trace_kernel, kBlock, 0);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * per_sm;
  const long long wanted = grid_for(max_threads);
  if (wanted < blocks) blocks = wanted;
  if (blocks < 1) blocks = 1;
  *threads = blocks * kBlock;
  trace_kernel<<<(unsigned int)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      *sc, s0, s1, total, next, fates, max_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
