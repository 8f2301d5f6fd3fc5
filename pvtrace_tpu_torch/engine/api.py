"""``simulate``: the port's entry point, with the JAX package's signature.

Port of ``pvtrace_tpu.engine.api.simulate`` for the tallies-only path:
lights lowered to device samplers, fates and recorders, no event log, no
gradients. The result is the port's copy of the JAX package's
``EngineResult`` with the same ``data`` layout.
"""
import time

import numpy as np
import torch

from pvtrace_tpu_torch.engine import rng, tracer
from pvtrace_tpu_torch.engine.compiler import EMIT_METHODS, compile_scene
from pvtrace_tpu_torch.engine.result import EngineResult, _RoundRobinSources
from pvtrace_tpu_torch.engine.tables import scene_tensors

_U32 = 2 ** 32 - 1
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _check_options(record_every, score, pathwise):
    if record_every > 0:
        raise NotImplementedError(
            "record_every > 0 (event-log histories) is not ported yet: "
            "ROADMAP queue 1 item 9, kernel K11. Pass record_every=0."
        )
    if score:
        raise NotImplementedError(
            "score=True is not ported yet: ROADMAP queue 1 item 10, kernel K12."
        )
    if pathwise:
        raise NotImplementedError(
            "pathwise channels are not ported yet: ROADMAP queue 1 item 11, "
            "kernel K13."
        )


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
    * `record_every` > 0, `score`, `pathwise`, meshes and lights that
      need host emission raise NotImplementedError naming the ROADMAP
      item that brings them. `workers` and `max_events` are
      accepted and unused, as in the JAX package with record_every=0.
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
    _check_options(record_every, score, pathwise)
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

    tic = time.perf_counter()
    fates, steps, tallies = tracer.trace(
        st, rng.key_words(seed), num_rays, index_offset=index_offset,
        lanes=lanes, maxsteps=maxsteps, emit_method=EMIT_METHODS[emit_method],
        maxpathlength=float("inf") if maxpathlength is None else float(maxpathlength),
    )
    fates = fates.cpu().numpy()
    elapsed = time.perf_counter() - tic

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    data = {
        "rec_distinct": tallies["distinct"].cpu().numpy(),
        "rec_crossings": tallies["cross"].cpu().numpy(),
        "rec_sums": tallies["sums"].cpu().numpy().astype(np_dtype),
        "rec_bins": tallies["bins"].cpu().numpy(),
        "fates": fates,
        "counts": np.zeros(0, np.int64),
        "steps": int(steps),
    }
    for name in ("kind", "hit", "container", "adjacent", "component", "source"):
        data[name] = np.full((0, max_events), -1, np.int32)
    for name in ("position", "direction", "normal"):
        data[name] = np.zeros((0, max_events, 3), np_dtype)
    for name in ("wavelength", "travelled", "duration"):
        data[name] = np.zeros((0, max_events), np_dtype)
    sources = _RoundRobinSources(compiled.light_names, num_rays, offset=index_offset)
    return EngineResult(compiled, data, sources, max_events, record_every, elapsed)

