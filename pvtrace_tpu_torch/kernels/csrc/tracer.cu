// The Hopper kernels of pvtrace_tpu_torch: emission, one physics step,
// the persistent trace kernel of the main path (with recorders, an event
// log, or both), the event log's pack, and the standalone K5a, K9 and K10
// entries that let the card hold those device functions to their twins. The score
// instantiations of the trace kernel are in score.cu, the Beer–Lambert
// surrogate in diff.cu.
//
// Built by pvtrace_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (no fast-math) and bound with ctypes, twice: the float32 library, and
// with -DPVT_F64 the float64 one (tracer_f64: every real a double,
// tracer.cuh's pvt_real), whose entry points have the same names and
// arguments, the reals' pointers to doubles. Every entry point launches on the
// stream it is given, allocates nothing, and returns a CUDA error code.
// The per-lane bodies live in tracer.cuh, the trace kernel in
// trace_kernel.cuh.
#include "trace_kernel.cuh"

namespace {

// Replaces _photon_keys and _device_emit_flat (pvtrace_tpu/engine/
// tracer.py). Bound by integer ALU: the key and the emission pairs the
// scene's lamps read (emit_draws: up to four threefry evaluations of 20
// rounds of add, rotate and xor) per photon against a few dozen float
// operations and 61 bytes written. One thread per photon; nothing to
// share.
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
// out[f * n_t + j] = fit f at t[j], one thread each, and with `seg` the
// segment each took. Not on the main path (cheb_eval runs inside
// pvt_trace); it lets the card hold K5a to its twin fit by fit, with the
// table placed as pvt_trace places it: with `staged` each block first
// copies it into shared memory, else it is read in device memory. Bound by
// the segment search and the Clenshaw chain (operations).
__global__ void __launch_bounds__(kBlock)
cheb_kernel(PvtScene sc, int staged, const pvt_real* t, long long n_t, long long n, pvt_real* out,
            int* seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const pvt_word* tab = sc.cheb_pack;
  if (staged) {
    tab = stage_cheb(sc, smem);
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) cheb_lane(tab, (int)(i / n_t), t[i % n_t], i, out, seg);
}

// Replaces _tally and the tally frame of body_fast (pvtrace_tpu/engine/
// tracer.py) for one step of B lanes, one thread a lane, by the rule
// pvt_trace's launch with recorders alone takes for the scene (tally_rule:
// each lane its own event, or the warp's together, tally_warp),
// accumulating per block in shared memory as pvt_trace does. Not on the
// main path; it lets the card hold K9 to its twin lane by lane. Bound by
// shared-memory atomics on hot recorders.
template <bool kWarpTally>
__global__ void __launch_bounds__(kBlock)
tally_kernel(PvtScene sc, PvtState s, PvtFlags fl, uint32_t* seen, long long B,
             PvtTallyOut out, int shared_bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PvtTally acc = tally_block_init(sc, smem, shared_bins, out);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  StepOut o;
  Photon p;
  Seen bits;
  if (i < B) tally_lane_load(sc, s, fl, seen, i, o, p, bits);
  if (kWarpTally)
    tally_warp(sc, acc, bits, o, p, i < B);  // every lane, those past B without an event
  else if (i < B)
    tally_event(sc, acc, bits, o, p);
  if (i < B) seen_to_words(sc, bits, seen + i * SEEN_WORDS);
  __syncthreads();
  tally_block_flush(sc, acc, out);
}

// Replaces _mesh_nearest_two (pvtrace_tpu/engine/tracer.py) for B rays
// against one mesh node, one thread each. Not on the main path
// (mesh_nearest_two runs inside pvt_trace); it lets the card hold K10 to
// its twin ray by ray. With `staged` each block first copies the
// triangles into its shared memory, as pvt_trace's blocks do. Bound by
// operations, about 60 a triangle.
__global__ void __launch_bounds__(kBlock)
mesh_kernel(const pvt_real* tri, int n_tris, int staged, pvt_real eps, const pvt_real* o,
            const pvt_real* d, long long B, pvt_real* t1, pvt_real* t2, int* cnt, pvt_real* nrm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const pvt_real* tris = tri;
  if (staged) {
    tris = stage_tris(tri, n_tris, smem);
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) mesh_lane(tris, tri, n_tris, eps, o, d, i, t1, t2, cnt, nrm);
}

// The trace's draws on B lanes (B a multiple of kWarp), each kWarp of
// them a warp, against the words pvt_draw gives: a step's four pairs and a
// refill's keys and the emission pairs the scene's lamps read
// (draws_lane). Not on the main path (the same functions run inside
// pvt_trace); it lets the card hold them to the twin (engine/rng.py,
// warp_draws) word by word. Bound by the threefry calls (integer
// operations).
__global__ void __launch_bounds__(kBlock)
draws_kernel(uint32_t s0, uint32_t s1, const long long* base, const unsigned char* dead,
             unsigned need, const long long* k0, const long long* k1, const int* count,
             const unsigned char* mask, long long B, long long* keys, pvt_real* emit,
             pvt_real* words, int* calls) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;  // whole warps: B is a multiple of kWarp
  const int lane = threadIdx.x % kWarp;
  const uint32_t deadm = __ballot_sync(0xffffffffu, dead[i] != 0);
  const int made = draws_lane(s0, s1, (unsigned long long)base[i / kWarp], dead[i] != 0,
                              lane_rank(deadm, lane), need, k0, k1, count, mask, i, keys, emit,
                              words);
  // The warp's refill issued the most calls any of its lanes made.
  const unsigned most = __reduce_max_sync(0xffffffffu, (unsigned)made);
  if (lane == 0) calls[i / kWarp] = (int)most;
}

// K11's pack of the event log: slot s's first counts[s] records to
// record offsets[s] of the packed arrays (log_pack_slot), one warp a
// slot, the slots strided over the grid's warps. Replaces no JAX function
// (the JAX package fetches its whole log): it lets the fetch copy only the
// records written, about 5 % of the dense rows on the mesh LSC. Bound by
// bytes: every record read once and written once; the rows' unwritten
// tails are never touched.
__global__ void __launch_bounds__(kBlock)
log_pack_kernel(PvtLog lg, const long long* offsets, int* ints, pvt_real* floats) {
  const int lane = threadIdx.x % kWarp;
  const long long warps = (long long)gridDim.x * (kBlock / kWarp);
  for (long long s = ((long long)blockIdx.x * kBlock + threadIdx.x) / kWarp; s < lg.n_slots;
       s += warps)
    log_pack_slot(lg, s, offsets[s], lane, kWarp, ints, floats);
}

}  // namespace

extern "C" {

// The records of log->counts[s] of each of the log's n_slots rows, in
// slot order, into ints [N, LOG_I] and floats [N, LOG_F] (N the counts'
// sum), slot s's from record offsets[s] (the counts' exclusive sum).
int pvt_log_pack(const PvtLog* log, const long long* offsets, int* ints, pvt_real* floats,
                 void* stream) {
  if (log->n_slots <= 0) return 0;
  log_pack_kernel<<<grid_for(log->n_slots * kWarp), kBlock, 0, (cudaStream_t)stream>>>(
      *log, offsets, ints, floats);
  return (int)cudaGetLastError();
}

// pvt_draws: per warp w of the B lanes, a refill of the lanes `dead` marks
// from photon base[w] (their keys into keys [B, 2] and the emission pairs
// of `need` into emit [B, 6], -1 where not drawn; 0 and -1 on live lanes),
// and per lane the words of mask[i] (bit k: u[k]) of the step with key
// (k0[i], k1[i]) at count[i] (into words [B, 8], -1 where not in the
// mask); calls [B / kWarp] gets the threefry calls each warp's refill
// issued, counted where draws_lane makes them.
int pvt_draws(unsigned int s0, unsigned int s1, const long long* base, const unsigned char* dead,
              unsigned int need, const long long* k0, const long long* k1, const int* count,
              const unsigned char* mask, long long B, long long* keys, pvt_real* emit,
              pvt_real* words, int* calls, void* stream) {
  if (B % kWarp) return (int)cudaErrorInvalidValue;
  draws_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
      s0, s1, base, dead, need, k0, k1, count, mask, B, keys, emit, words, calls);
  return (int)cudaGetLastError();
}

int pvt_emit(const PvtScene* sc, unsigned int s0, unsigned int s1,
             unsigned long long offset, long long B, const PvtState* out, void* stream) {
  if (sc->n_lights <= 0) return (int)cudaErrorInvalidValue;  // no device lights: host emission
  emit_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(*sc, s0, s1, offset, B, *out);
  return (int)cudaGetLastError();
}

int pvt_step(const PvtScene* sc, const PvtState* in, const PvtState* out,
             const PvtFlags* flags, long long B, void* stream) {
  step_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(*sc, *in, *out, *flags, B);
  return (int)cudaGetLastError();
}

// Every fit of the scene (sc->cheb_pack, n_fits of them) at the n_t values
// t: out is [n_fits, n_t], and seg, when not null, each one's segment (-1
// for none). With `shared` the blocks stage the table in shared memory
// when it fits the trace kernel's budget; *placed gets 1 when they did.
int pvt_cheb(const PvtScene* sc, int n_fits, const pvt_real* t, long long n_t, pvt_real* out,
             int* seg, int shared, int* placed, void* stream) {
  const long long n = (long long)n_fits * n_t;
  const size_t bytes = sizeof(pvt_word) * (size_t)sc->cheb_words;
  *placed = shared && bytes <= kSharedTallyLimit ? 1 : 0;
  if (*placed) {
    const cudaError_t err = allow_shared(cheb_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cheb_kernel<<<grid_for(n), kBlock, *placed ? bytes : 0, (cudaStream_t)stream>>>(
      *sc, *placed, t, n_t, n, out, seg);
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
  const auto kernel = tally_rule(*sc) == 2 ? tally_kernel<true> : tally_kernel<false>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(B), kBlock, bytes, (cudaStream_t)stream>>>(*sc, *state, *flags, seen, B,
                                                                *out, *shared_bins);
  return (int)cudaGetLastError();
}

// B rays (o, d: [B, 3], the node's local frame) against n_tris triangles
// (rows of TRI_F, 16-byte aligned): t1, t2, cnt [B] and the nearest hit's
// normal nrm [B, 3]. The blocks stage the triangles in shared memory
// where they fit a trace block's budget, as pvt_trace does.
int pvt_mesh(const pvt_real* tri, int n_tris, pvt_real eps, const pvt_real* o, const pvt_real* d,
             long long B, pvt_real* t1, pvt_real* t2, int* cnt, pvt_real* nrm, void* stream) {
  const size_t bytes = sizeof(pvt_real) * TRI_F * (size_t)n_tris;
  const int staged = bytes <= kSharedTallyLimit ? 1 : 0;
  if (staged) {
    const cudaError_t err = allow_shared(mesh_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  mesh_kernel<<<grid_for(B), kBlock, staged ? bytes : 0, (cudaStream_t)stream>>>(
      tri, n_tris, staged, eps, o, d, B, t1, t2, cnt, nrm);
  return (int)cudaGetLastError();
}

// Launches min(max_threads, resident capacity) threads, rounded up to
// whole blocks. info[0] gets their number, info[1] the dynamic shared
// memory of a block, info[2] 1 when the recorder bins were in shared
// memory, info[3] 1 when the score sums were (0 here), info[4] 1 when the
// K5a table was, info[5] 1 when the threads' score rows were (0 here),
// info[6] 1 when the mesh triangles were.
// fates [11], max_count and steps [2] (zeroed by the caller) get the fate
// counts, the longest photon's steps, the photons' steps in all and the
// lane-steps of the warps' turns (kWarp a turn of each warp). With
// sc->n_rec == 0 the tally outputs are not touched, with log->n_slots == 0
// the log. With
// bundle->rows set, photon pid starts from column pid - bundle->first of
// the host bundle (K8's trace_bundle entry; the caller sets next to
// bundle->first and total to first + n), else it is emitted on the device.
// The instantiation follows the scene and the run: recorders, log,
// meshes; none computes scores (pvt_trace_score, score.cu).
int pvt_trace(const PvtScene* sc, unsigned int s0, unsigned int s1,
              unsigned long long total, long long max_threads,
              unsigned long long* next, unsigned long long* fates, int* max_count,
              unsigned long long* steps, const PvtTallyOut* tally, const PvtLog* log,
              const PvtBundle* bundle, long long* info, void* stream) {
  const PvtScore no_score = {nullptr, nullptr, nullptr, 0, 0, 0, 0};
  return (int)launch_for<false, false>(*sc, *log, *bundle)(
      *sc, s0, s1, total, max_threads, next, fates, max_count, steps, *tally, *log, no_score,
      *bundle, info, (cudaStream_t)stream);
}

// Where a trace launch on sc would place what its blocks share, without
// launching: info[1..5] as pvt_trace's, for a launch with recorders
// (tally) and, unless score is null, score->ch channels of which
// score->n_path pathwise, the rows allowed in shared memory where
// score->shared_rows.
int pvt_layout(const PvtScene* sc, int tally, const PvtScore* score, long long* info) {
  layout_info(trace_layout(*sc, tally != 0, score), info);
  return 0;
}

}  // extern "C"
