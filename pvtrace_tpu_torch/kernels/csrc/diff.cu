// K15 on the card: the first-pass Beer–Lambert surrogate of
// absorbed_fraction_fn (pvtrace_tpu/diff/transport.py _chord_fn and
// absorbed_fraction_fn), forward (pvt_absorbed) and backward in
// log_concentration (pvt_absorbed_grad). A translation unit of its own,
// built by pvtrace_tpu_torch/kernels/build.py beside tracer.cu and
// score.cu, and again with -DPVT_F64 (diff_f64: every real a double),
// bound with ctypes; every entry launches on the stream it is given,
// allocates nothing and returns a CUDA error code.
//
// Bound by bytes: a photon reads 28 bytes and writes 8 (twice that in
// float64) against some 60 operations per absorbing node, so one thread
// per photon with coalesced loads is the design; the node records and the attenuation rows are read
// by every thread through L1. The backward pass reads 8 bytes a photon
// and reduces: each thread adds its photons in float64, a warp and then a
// block reduce by shuffles and shared memory, and one float64 atomic per
// block gives the sum.
#include <cuda_runtime.h>

#include "diff.cuh"

namespace {

__global__ void __launch_bounds__(kBlock)
absorbed_kernel(PvtAbsorbers a, const pvt_real* pos, const pvt_real* dir, const pvt_real* wav,
                const pvt_real* c, long long P, pvt_real* w, pvt_real* depth) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P) absorbed_lane(a, pos, dir, wav, c, i, w, depth);
}

__global__ void __launch_bounds__(kBlock)
absorbed_grad_kernel(const pvt_real* depth, const pvt_real* grad_w, const pvt_real* c,
                     long long P, double* out) {
  __shared__ double warp_sums[kBlock / 32];
  const pvt_real cc = *c;
  double acc = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < P;
       i += (long long)gridDim.x * blockDim.x)
    acc += (double)absorbed_grad_lane(depth, grad_w, cc, i);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kBlock / 32 ? warp_sums[threadIdx.x] : 0.0;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (threadIdx.x == 0) atomicAdd(out, acc);
  }
}

}  // namespace

extern "C" {

// Weights w [P] and optical depths depth [P] of P photons (pos, dir
// [P, 3], wav [P], world frame) at the concentration scale *c (on the
// card).
int pvt_absorbed(const PvtAbsorbers* a, const pvt_real* pos, const pvt_real* dir,
                 const pvt_real* wav, const pvt_real* c, long long P, pvt_real* w,
                 pvt_real* depth, void* stream) {
  const unsigned int blocks = (unsigned int)((P + kBlock - 1) / kBlock);
  absorbed_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(*a, pos, dir, wav, c, P, w,
                                                                depth);
  return (int)cudaGetLastError();
}

// *out (float64, zeroed by the caller) += sum_i grad_w[i] * c * depth[i]
// * exp(-c * depth[i]), with `blocks` blocks striding over the P photons.
int pvt_absorbed_grad(const pvt_real* depth, const pvt_real* grad_w, const pvt_real* c,
                      long long P, int blocks, double* out, void* stream) {
  absorbed_grad_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(depth, grad_w, c, P, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
