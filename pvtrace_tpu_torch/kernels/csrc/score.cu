// K12 on the card: the score instantiations of the trace kernel
// (pvt_trace_score), one physics step with its score contributions and
// fold (pvt_score), and the Fresnel partials alone (pvt_fresnel). A
// translation unit of its own, so that nvcc builds it beside tracer.cu;
// the score-free kernels there carry none of this code.
//
// Built by pvtrace_tpu_torch/kernels/build.py (flags as tracer.cu's) and
// bound with ctypes. Every entry point launches on the stream it is
// given, allocates nothing, and returns a CUDA error code.
#include "trace_kernel.cuh"

namespace {

// Replaces one step of body with score=True (pvtrace_tpu/engine/
// tracer.py): pvt_step's step, the score block's contributions to each
// lane's score (rows [ch, B], updated in place) and their fold into
// fate_scores, per block in shared memory as pvt_trace does. Not on the
// gradient path (score_step runs inside pvt_trace_score); it lets the
// card hold K12 to its twin lane by lane. Bound as pvt_step, plus the
// K5a slots the component channels evaluate again.
__global__ void __launch_bounds__(kBlock)
score_kernel(PvtScene sc, PvtState in, PvtState out, PvtFlags fl, long long B, PvtScore score,
             int* comp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const ScoreAcc sa = score_block_init(sc, score, smem, nullptr, i);
  __syncthreads();
  if (i < B) score_lane(sc, in, out, fl, i, sa, comp);
  __syncthreads();
  score_block_flush(sc, score, sa);
}

// Replaces _fresnel_dR (jax.vmap(jax.grad(_fresnel_R_scalar))) on n
// (n1, n2, c) triples, one thread each; lets the card hold fresnel_dR to
// its twin. Bound by operations (about 60, three divisions and a root).
__global__ void __launch_bounds__(kBlock)
fresnel_kernel(const float* n1, const float* n2, const float* c, long long n, float* d1,
               float* d2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float d[2];
  fresnel_dR(n1[i], n2[i], c[i], d);
  d1[i] = d[0];
  d2[i] = d[1];
}

}  // namespace

extern "C" {

// One step of B lanes with score channels: the new state and flags as
// pvt_step's, and comp [B] the absorbing component (-1 for none);
// score->rows [ch, B] (stride B) updated; the folds added to
// score->fate_scores [2, 11, ch] (zeroed by the caller), per block in
// shared memory when they fit there.
int pvt_score(const PvtScene* sc, const PvtState* in, const PvtState* out,
              const PvtFlags* flags, long long B, const PvtScore* given, int* comp,
              void* stream) {
  const PvtScore score = score_placed(*sc, *given, 0);
  const size_t bytes = score_bytes(*sc, score);
  cudaError_t err = cudaSuccess;
  if (bytes > 0) err = allow_shared(score_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  score_kernel<<<grid_for(B), kBlock, bytes, (cudaStream_t)stream>>>(*sc, *in, *out, *flags, B,
                                                                     score, comp);
  return (int)cudaGetLastError();
}

// dR/dn1, dR/dn2 of n (n1, n2, c) triples.
int pvt_fresnel(const float* n1, const float* n2, const float* c, long long n, float* d1,
                float* d2, void* stream) {
  fresnel_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(n1, n2, c, n, d1, d2);
  return (int)cudaGetLastError();
}

// pvt_trace with score channels: as pvt_trace, and every photon's path
// score in the thread's row of score->rows ([ch, score->stride]; at most
// score->stride threads are launched), folded into score->fate_scores
// [2, 11, ch] and, with recorders, score->rec_scores [2, R, ch] (float64,
// zeroed by the caller; signed sums, then magnitudes), per block in shared
// memory when they fit beside the tallies (info[3] says whether they did),
// and with score->photon each photon's record. With score->shared_rows
// each block keeps its threads' rows in shared memory where they fit
// (info[5]), score->rows then unused.
int pvt_trace_score(const PvtScene* sc, unsigned int s0, unsigned int s1,
                    unsigned long long total, long long max_threads,
                    unsigned long long* next, unsigned long long* fates, int* max_count,
                    unsigned long long* steps, const PvtTallyOut* tally, const PvtLog* log,
                    const PvtScore* score, const PvtBundle* bundle, long long* info,
                    void* stream) {
  return (int)launch_for<true, false>(*sc, *log, *bundle)(
      *sc, s0, s1, total, max_threads, next, fates, max_count, steps, *tally, *log, *score,
      *bundle, info, (cudaStream_t)stream);
}

}  // extern "C"
