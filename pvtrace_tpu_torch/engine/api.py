"""``simulate``: the port's entry point, with the JAX package's signature.

Port of ``pvtrace_tpu.engine.api.simulate``: fates, recorders,
event-log histories, score-function gradient sums (``score=True``) and
pathwise channels (``pathwise=``), with the lights emitted on the device
where the compiler lowered them to samplers, else on the host
(``engine/emit.py::emit_bundle``) and traced as a bundle. The result is
the port's copy of the JAX package's ``EngineResult`` with the same
``data`` layout. ``simulate_stream`` traces a budget in bundles whose
union equals one ``simulate``; ``is_available`` says whether the card can
run the kernels.
"""
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pvtrace_tpu_torch.engine import eventlog, rng, tracer
from pvtrace_tpu_torch.engine.compiler import EMIT_METHODS, compile_scene
from pvtrace_tpu_torch.engine.emit import emit_bundle
from pvtrace_tpu_torch.engine.result import EngineResult, _RoundRobinSources
from pvtrace_tpu_torch.engine.tables import scene_tensors

_U32 = 2 ** 32 - 1
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}
# The last fetch_log: host seconds of the pack (its wrapper; the kernel
# runs on while the copies wait for it), of the copies to host memory with
# their synchronize, and of the numpy unpack; the pack kernel's time on
# the card (ms, 0 on the CPU); the records and the bytes copied, and the
# dense log's bytes.
last_fetch = {"pack_s": 0.0, "copy_s": 0.0, "unpack_s": 0.0, "pack_ms": 0.0, "records": 0,
              "bytes": 0, "dense_bytes": 0}


def is_available():
    """True when the port can run on the card: CUDA is available and
    device 0 has compute capability 9.x (the kernels are built for
    sm_90a). The JAX package's ``is_available`` is True whenever jax
    imports."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability(0)[0] == 9


def require_device(device):
    """`device` as a ``torch.device``, which for CUDA must exist. The
    port's entry points run on the card unless the caller asks for the
    CPU, and none falls back to the CPU without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA card and torch sees none; "
            "pass device='cpu' for the eager PyTorch twin"
        )
    return device


def _check_budget(num_rays, index_offset):
    """Photon ids ``index_offset + [0, num_rays)`` must fit in uint32;
    counters and budget arithmetic are 64-bit."""
    if num_rays <= 0:
        raise ValueError(f"num_rays must be positive, got {num_rays}")
    if index_offset < 0 or index_offset + num_rays > _U32:
        raise ValueError(
            f"photon ids [{index_offset}, {index_offset + num_rays}) must "
            f"lie in [0, {_U32}): they label the per-photon random streams."
        )


def fetch_log(log, np_dtype):
    """A trace's event `log` as the dense numpy arrays of the JAX layout:
    (ints [S, E, LOG_I] int32, floats [S, E, LOG_F] in `np_dtype`, counts
    [S] int32). The written records are packed where the log lies
    (``kernels.log_pack``: ``pvt_log_pack`` on the card), copied to host
    memory (on the card: pinned, non-blocking, one synchronize) with the
    counts, and unpacked (``eventlog.unpack``)."""
    from pvtrace_tpu_torch import kernels

    S, E = log["ints"].shape[:2]
    tic = time.perf_counter()
    packed = (log["counts"], *kernels.log_pack(log))
    packed_at = time.perf_counter()
    if log["counts"].is_cuda:
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in packed]
        for h, t in zip(host, packed):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        packed = host
    counts, ints, floats = (t.numpy() for t in packed)
    counts = counts.copy()
    copied_at = time.perf_counter()
    dense = eventlog.unpack(counts, ints, floats, S, E, np_dtype)
    last_fetch.update(
        pack_s=packed_at - tic, copy_s=copied_at - packed_at,
        unpack_s=time.perf_counter() - copied_at,
        pack_ms=kernels.pack_ms() if log["counts"].is_cuda else 0.0, records=len(ints),
        bytes=counts.nbytes + ints.nbytes + floats.nbytes,
        dense_bytes=dense[0].nbytes + dense[1].nbytes,
    )
    return (*dense, counts)


def tally_data(compiled, fates, steps, tallies, np_dtype, score):
    """The tally keys of ``simulate``'s data, as numpy: ``rec_distinct``,
    ``rec_crossings``, ``rec_sums`` (in `np_dtype`), ``rec_bins``,
    ``fates``, ``steps`` and, with `score`, ``fate_scores`` and (with
    recorders) ``rec_scores``, from a trace's `fates`, `steps` and
    `tallies`."""
    data = {
        "rec_distinct": tallies["distinct"].cpu().numpy(),
        "rec_crossings": tallies["cross"].cpu().numpy(),
        "rec_sums": tallies["sums"].cpu().numpy().astype(np_dtype),
        "rec_bins": tallies["bins"].cpu().numpy(),
        "fates": fates.cpu().numpy(),
        "steps": int(steps),
    }
    if score:
        data["fate_scores"] = tallies["fate_scores"].cpu().numpy().astype(np_dtype)
        if compiled.n_recorders > 0:
            data["rec_scores"] = tallies["rec_scores"][:compiled.n_recorders].cpu().numpy().astype(
                np_dtype)
    return data


def simulate(
    scene,
    num_rays,
    seed=None,
    workers=None,
    maxsteps=1000,
    maxpathlength=None,
    max_events=128,
    emit_method="kT",
    record_every=1,
    dtype=None,
    compiled=None,
    lanes="auto",
    score=False,
    pathwise=(),
    index_offset=0,
    device="cuda",
):
    """Trace `num_rays` photons through `scene` on `device`.

    Arguments are those of ``pvtrace_tpu.engine.simulate``; what differs:

    * `device` (default "cuda") holds the run. On a CUDA device the trace
      is the kernel ``pvt_trace`` (``pvt_trace_score`` with score
      channels, ``pvt_trace_pathwise`` with pathwise ones too), of the
      float32 libraries or, for ``dtype=np.float64``, of their float64
      builds (``tracer_f64``, ``score_f64``, ``pathwise_f64``: every real
      a double); on "cpu" it is the eager PyTorch twin, in float32 or
      float64. There is no fallback from one to the other, nor from
      float64 to float32.
    * `dtype` None means float32.
    * Lights the compiler cannot lower to device samplers (a histogram
      spectrum, a custom delegate) are emitted on the host, as in the JAX
      package: ``emit_bundle(scene, num_rays)`` draws from the global
      ``np.random`` stream, the bundle goes to `device` in the run's dtype
      (28 bytes a photon in float32, 56 in float64) and is traced without
      regeneration (`lanes` ignored; on the card ``pvt_trace`` in bundle
      mode). `elapsed` counts the upload, the
      trace and the fetch, not the sampling, and the result's sources are
      the bundle's. `workers` is accepted and unused.
    * With `score`, ``data["fate_scores"]`` [11, CH] and, with recorders,
      ``data["rec_scores"]`` [R, CH] in the run's dtype, channels in the
      JAX package's layout: the components, then the nodes in preorder
      (``engine/score.py``), then one channel per entry of `pathwise`
      (``engine/pathwise.py``; resolved specs, as
      ``diff.transport.resolve_pathwise_params`` makes them). On the card
      a photon's score is in the run's dtype and the accumulators
      float64. Without
      `score`, `pathwise` is ignored, as in the JAX package.
    * `lanes`: on the CPU the wavefront width of the eager twin ("auto":
      ``min(num_rays, 2**18)``, None: one lane per photon, no
      regeneration); on the card a cap on the persistent kernel's thread
      count ("auto" and None: the card's resident capacity).
    * ``data["steps"]`` is the eager twin's number of wavefront steps on
      the CPU, and the largest per-photon step count on the card: the
      persistent kernel has no common step. The JAX package reports its
      loop's step count.
    * Fate counts and the recorders' ``rec_distinct``, ``rec_crossings``
      and ``rec_bins`` are int64, and ``index_offset + num_rays`` may
      reach ``2**32 - 1``. ``rec_sums`` is in the run's dtype (the
      float32 kernel adds per-block float32 sums in float64, the float64
      kernel adds doubles throughout).
    * With a log, `elapsed` ends once the dense numpy log exists: the
      written records are packed on the device and copied with their
      counts, then unpacked on the host (``fetch_log``).
    * The spectra take the Chebyshev fits (K5a) or the table lerp (K5b)
      by the JAX package's rule, ``PVTRACE_TPU_NO_CHEB`` included, read
      on every call.
    """
    if emit_method not in EMIT_METHODS:
        raise ValueError(f"emit_method must be one of {sorted(EMIT_METHODS)}")
    _check_budget(num_rays, index_offset)
    if compiled is None:
        compiled = compile_scene(scene)
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    dtype = _TORCH_DTYPES[np.dtype(np.float32 if dtype is None else dtype)]
    device = torch.device(device)
    st = scene_tensors(compiled, dtype=dtype, device=device)
    if lanes == "auto":
        lanes = min(num_rays, 1 << 18) if device.type == "cpu" else None

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    bundle = None
    if compiled.lights_supported:
        sources = _RoundRobinSources(compiled.light_names, num_rays, offset=index_offset)
    else:
        positions, directions, wavelengths, sources = emit_bundle(scene, num_rays)
        host = tracer.bundle_rows(positions, directions, wavelengths, np_dtype)
    tic = time.perf_counter()
    if not compiled.lights_supported:
        bundle = torch.from_numpy(host).to(device)
    fates, steps, tallies, log = tracer.trace(
        st, rng.key_words(seed), num_rays, index_offset=index_offset,
        lanes=lanes, maxsteps=maxsteps, emit_method=EMIT_METHODS[emit_method],
        maxpathlength=float("inf") if maxpathlength is None else float(maxpathlength),
        record_every=max(int(record_every), 0), max_events=int(max_events), score=bool(score),
        pathwise=tuple(tuple(p) for p in pathwise) if score else (), bundle=bundle,
    )
    fates = fates.cpu()
    if log is None:
        log_ints = np.full((0, max_events, eventlog.LOG_I), -1, np.int32)
        log_floats = np.zeros((0, max_events, eventlog.LOG_F), np_dtype)
        counts = np.zeros(0, np.int32)
    else:
        log_ints, log_floats, counts = fetch_log(log, np_dtype)
    elapsed = time.perf_counter() - tic

    data = tally_data(compiled, fates, steps, tallies, np_dtype, score)
    data["counts"] = counts
    for i, name in enumerate(eventlog.LOG_INTS):
        data[name] = log_ints[..., i]
    for i, name in enumerate(eventlog.LOG_VECS):
        data[name] = log_floats[..., 3 * i:3 * i + 3]
    for i, name in enumerate(eventlog.LOG_SCALARS):
        data[name] = log_floats[..., 9 + i]
    return EngineResult(compiled, data, sources, max_events, record_every, elapsed)


def simulate_stream(scene, num_rays, bundle=50000, seed=None, device="cuda", **kwargs):
    """Trace in bundles, yielding (EngineResult, rays_traced_so_far).

    Port of ``pvtrace_tpu.engine.simulate_stream``. Every bundle shares
    ONE base seed and passes its global start as ``index_offset``, and
    each photon's random stream is a pure function of (seed, global
    photon id), so the union of the streamed results equals
    one ``simulate(num_rays)`` of the same seed: integer tallies (counts,
    crossings, histogram bins, fates) bit for bit, float moment sums up to
    summation order, and recorded histories cover the same global
    every-k-th photons. Sum the ``rec_*`` arrays to accumulate recorder
    tallies. `kwargs` are ``simulate``'s; the run is on `device` (the card
    unless "cpu").

    Unlike the JAX package's, the arguments are checked when the function
    is called, before the generator is returned: `num_rays` must be
    positive, `bundle` a positive integer, and every photon id
    ``[0, num_rays)`` below 2**32 - 1 (``_check_budget``; the JAX package
    lets the ids reach 2**32).

    The next bundle runs in one worker thread while the caller consumes
    the current one. Every result depends only on its arguments, whatever
    the prefetch does; but the module-level reports (``kernels.last_trace``,
    ``kernels.launches``, ``last_fetch``) are written by whichever bundle
    finished last, so read them only once the stream is exhausted.
    """
    _check_budget(num_rays, 0)
    if int(bundle) != bundle or bundle <= 0:
        raise ValueError(f"bundle must be a positive integer, got {bundle}")
    bundle = int(bundle)
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    compiled = kwargs.pop("compiled", None)
    if compiled is None:
        compiled = compile_scene(scene)

    def run(start, n):
        return simulate(scene, n, seed=int(seed), index_offset=start,
                        compiled=compiled, device=device, **kwargs)

    def stream():
        pool = ThreadPoolExecutor(max_workers=1)
        try:
            traced = 0
            n = min(bundle, num_rays)
            pending = pool.submit(run, traced, n)
            while traced < num_rays:
                result = pending.result()
                traced += n
                if traced < num_rays:
                    n = min(bundle, num_rays - traced)
                    pending = pool.submit(run, traced, n)
                yield result, traced
        finally:
            pool.shutdown(wait=True)

    return stream()
