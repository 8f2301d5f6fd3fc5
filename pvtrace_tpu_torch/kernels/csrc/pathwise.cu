// K13 on the card: the pathwise instantiations of the trace kernel
// (pvt_trace_pathwise) and one physics step with its pathwise tangent map
// and hybrid terms (pvt_pathwise). A translation unit of its own, so that
// nvcc builds it beside tracer.cu and score.cu; their kernels carry none
// of this code.
//
// Built by pvtrace_tpu_torch/kernels/build.py (flags as tracer.cu's), and
// again with -DPVT_F64 (pathwise_f64: every real a double), and bound
// with ctypes. Every entry point launches on the stream it is
// given, allocates nothing, and returns a CUDA error code.
#include "trace_kernel.cuh"

namespace {

// Replaces one step of body with pathwise channels (pvtrace_tpu/engine/
// tracer.py): pvt_step's step, then per channel the linearized step
// (step_tangent), its hybrid contribution and the new tangents. Not on the
// gradient path (pathwise_step runs inside pvt_trace_pathwise); it lets
// the card hold K13 to its twin lane by lane. Bound as pvt_step, plus per
// channel the tangent map and three K5a derivatives per step.
__global__ void __launch_bounds__(kBlock)
pathwise_kernel(PvtScene sc, PvtState in, PvtState out, PvtFlags fl, long long B, PvtPath pw,
                int* comp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) pathwise_lane(sc, in, out, fl, i, B, pw, comp);
}

}  // namespace

extern "C" {

// One step of B lanes with pathwise channels: the new state and flags as
// pvt_step's, comp [B] the absorbing component (-1 for none), and per
// channel (path->n of them) the new tangents, the map and the
// contribution (PvtPath).
int pvt_pathwise(const PvtScene* sc, const PvtState* in, const PvtState* out,
                 const PvtFlags* flags, long long B, const PvtPath* path, int* comp,
                 void* stream) {
  pathwise_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(*sc, *in, *out, *flags, B,
                                                                    *path, comp);
  return (int)cudaGetLastError();
}

// pvt_trace_score with pathwise channels: the last score->n_path of the
// score->ch channels are pathwise, their tangents in score->tang
// ([n_path, 7, score->stride]) and their specs in score->path.
int pvt_trace_pathwise(const PvtScene* sc, unsigned int s0, unsigned int s1,
                       unsigned long long total, long long max_threads,
                       unsigned long long* next, unsigned long long* fates, int* max_count,
                       unsigned long long* steps, const PvtTallyOut* tally, const PvtLog* log,
                       const PvtScore* score, const PvtBundle* bundle, long long* info,
                       void* stream) {
  return (int)launch_for<true, true>(*sc, *log, *bundle)(
      *sc, s0, s1, total, max_threads, next, fates, max_count, steps, *tally, *log, *score,
      *bundle, info, (cudaStream_t)stream);
}

}  // extern "C"
