"""``simulate``: the port's entry point, with the JAX package's signature.

Port of ``pvtrace_tpu.engine.api.simulate`` for lights lowered to
device samplers: fates, recorders, event-log histories, score-function
gradient sums (``score=True``) and pathwise channels (``pathwise=``).
The result is the port's copy of the JAX package's ``EngineResult`` with
the same ``data`` layout.
"""
import time

import numpy as np
import torch

from pvtrace_tpu_torch.engine import eventlog, rng, tracer
from pvtrace_tpu_torch.engine.compiler import EMIT_METHODS, compile_scene
from pvtrace_tpu_torch.engine.result import EngineResult, _RoundRobinSources
from pvtrace_tpu_torch.engine.tables import scene_tensors

_U32 = 2 ** 32 - 1
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


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
      is the kernel ``pvt_trace`` (float32 only); on "cpu" it is the
      eager PyTorch twin, in float32 or float64. There is no fallback
      from one to the other.
    * `dtype` None means float32.
    * Lights that need host emission raise NotImplementedError naming the
      ROADMAP item that brings them. `workers` is accepted and unused.
    * With `score`, ``data["fate_scores"]`` [11, CH] and, with recorders,
      ``data["rec_scores"]`` [R, CH] in the run's dtype, channels in the
      JAX package's layout: the components, then the nodes in preorder
      (``engine/score.py``), then one channel per entry of `pathwise`
      (``engine/pathwise.py``; resolved specs, as
      ``diff.transport.resolve_pathwise_params`` makes them). On the card
      a photon's score is float32 and the accumulators float64. Without
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
      kernel adds per-block float32 sums in float64).
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
    tic = time.perf_counter()
    fates, steps, tallies, log = tracer.trace(
        st, rng.key_words(seed), num_rays, index_offset=index_offset,
        lanes=lanes, maxsteps=maxsteps, emit_method=EMIT_METHODS[emit_method],
        maxpathlength=float("inf") if maxpathlength is None else float(maxpathlength),
        record_every=max(int(record_every), 0), max_events=int(max_events), score=bool(score),
        pathwise=tuple(tuple(p) for p in pathwise) if score else (),
    )
    fates = fates.cpu().numpy()
    if log is None:
        log_ints = np.full((0, max_events, eventlog.LOG_I), -1, np.int32)
        log_floats = np.zeros((0, max_events, eventlog.LOG_F), np_dtype)
    else:
        log_ints, log_floats = log["ints"].cpu().numpy(), log["floats"].cpu().numpy()
    elapsed = time.perf_counter() - tic

    data = {
        "rec_distinct": tallies["distinct"].cpu().numpy(),
        "rec_crossings": tallies["cross"].cpu().numpy(),
        "rec_sums": tallies["sums"].cpu().numpy().astype(np_dtype),
        "rec_bins": tallies["bins"].cpu().numpy(),
        "fates": fates,
        "counts": (log_ints[..., 0] >= 0).sum(axis=1).astype(np.int32),
        "steps": int(steps),
    }
    if score:
        data["fate_scores"] = tallies["fate_scores"].cpu().numpy().astype(np_dtype)
        if compiled.n_recorders > 0:
            data["rec_scores"] = tallies["rec_scores"][:compiled.n_recorders].cpu().numpy().astype(
                np_dtype)
    for i, name in enumerate(eventlog.LOG_INTS):
        data[name] = log_ints[..., i]
    for i, name in enumerate(eventlog.LOG_VECS):
        data[name] = log_floats[..., 3 * i:3 * i + 3]
    for i, name in enumerate(eventlog.LOG_SCALARS):
        data[name] = log_floats[..., 9 + i]
    sources = _RoundRobinSources(compiled.light_names, num_rays, offset=index_offset)
    return EngineResult(compiled, data, sources, max_events, record_every, elapsed)

