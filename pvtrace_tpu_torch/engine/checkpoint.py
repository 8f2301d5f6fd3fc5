"""Checkpointed mega-runs: exact resume by construction.

Port of ``pvtrace_tpu/engine/checkpoint.py``. A run is a sequence of
idempotent bundles, and the checkpoint is (accumulated tallies, seed,
bundle cursor). Every photon's random stream is a pure function of
(seed, global photon id) and bundle ``k`` owns photon ids ``[k*bundle,
(k+1)*bundle)``, so resuming from a checkpoint reproduces an
uninterrupted run: there is nothing else to save.

Checkpoints are written atomically (tmp file + rename) after every
bundle, so a crash at any point loses at most one bundle of work. The
file has the JAX package's npz keys and version, and a scene's
``content_digest`` is the same in both packages, so a checkpoint written
by either resumes in the other.
"""
import collections
import os
import tempfile
import time

import numpy as np

from pvtrace_tpu_torch.engine.api import _check_budget, simulate
from pvtrace_tpu_torch.engine.compiler import compile_scene
from pvtrace_tpu_torch.engine.result import RecorderResult
from pvtrace_tpu_torch.light.event import Event

CHECKPOINT_VERSION = 1
# The bundle of a new run when none is given (the JAX package's default).
DEFAULT_BUNDLE = 16_000_000


class AccumulatedResult:
    """Tallies accumulated over many bundles.

    Offers the recorder/fate interface of ``EngineResult`` (histories
    are per-bundle and are not accumulated — recorders are the
    O(bins)-memory way to observe a mega-run). Integer tallies are int64
    and float sums float64, added on the host.
    """

    def __init__(self, compiled, distinct, crossings, sums, bins, fates,
                 traced, num_rays, seed, bundle, elapsed=0.0,
                 fate_scores=None):
        self.compiled = compiled
        self._distinct = np.asarray(distinct, dtype=np.int64)
        self._crossings = np.asarray(crossings, dtype=np.int64)
        self._sums = np.asarray(sums, dtype=np.float64)
        self._bins = np.asarray(bins, dtype=np.int64)
        self._fates = np.asarray(fates, dtype=np.int64)
        self._fate_scores = (
            None if fate_scores is None
            else np.asarray(fate_scores, dtype=np.float64)
        )
        self.traced = int(traced)
        self.num_rays = int(num_rays)
        self.seed = int(seed)
        self.bundle = int(bundle)
        self.elapsed = float(elapsed)

    @property
    def complete(self):
        return self.traced >= self.num_rays

    @property
    def recorders(self):
        compiled = self.compiled
        results = {}
        for r, spec in enumerate(compiled.recorder_specs):
            bins = []
            start = compiled.rec_hist_start[r]
            for h in range(len(spec.histograms)):
                row = compiled.hist_specs[start + h]
                na, nb, offset = row[3], row[4], row[9]
                bins.append(self._bins[offset:offset + na * nb])
            results[spec.name] = RecorderResult(
                spec,
                self._distinct[r],
                self._crossings[r],
                self._sums[r].reshape(4, 2),
                bins,
            )
        return results

    def fate_counts(self):
        out = collections.Counter()
        for value in (Event.EXIT, Event.NONRADIATIVE, Event.REACT, Event.KILL):
            if self._fates[value.value]:
                out[value] = int(self._fates[value.value])
        if self._fates[10]:
            out["NO_HIT"] = int(self._fates[10])
        return out

    def fate_gradients(self, wrt="components"):
        """(fractions, gradients) over the traced photons so far — see
        ``pvtrace_tpu_torch.diff.transport.fate_gradients`` (same ``wrt``
        channel selection). Requires the run to have been made with
        ``score=True``."""
        from pvtrace_tpu_torch.diff.transport import _slice_channels

        if self._fate_scores is None:
            raise ValueError("Run with score=True to accumulate scores.")
        n = max(self.traced, 1)
        scores = _slice_channels(
            self._fate_scores, int(self.compiled.n_components), wrt
        )
        fractions, gradients = {}, {}
        for event in (Event.EXIT, Event.NONRADIATIVE, Event.REACT,
                      Event.KILL):
            fractions[event] = self._fates[event.value] / n
            gradients[event] = scores[event.value] / n
        return fractions, gradients

    # -- persistence ----------------------------------------------------

    def save(self, path):
        """Atomically write the checkpoint to `path` (npz)."""
        directory = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
        try:
            extra = {}
            if self._fate_scores is not None:
                extra["fate_scores"] = self._fate_scores
            with os.fdopen(fd, "wb") as fp:
                np.savez(
                    fp,
                    version=CHECKPOINT_VERSION,
                    digest=self.compiled.content_digest,
                    distinct=self._distinct,
                    crossings=self._crossings,
                    sums=self._sums,
                    bins=self._bins,
                    fates=self._fates,
                    traced=self.traced,
                    num_rays=self.num_rays,
                    seed=self.seed,
                    bundle=self.bundle,
                    elapsed=self.elapsed,
                    **extra,
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path, compiled):
        with np.load(path, allow_pickle=False) as data:
            if int(data["version"]) != CHECKPOINT_VERSION:
                raise ValueError(
                    f"Unsupported checkpoint version {int(data['version'])}"
                )
            digest = str(data["digest"])
            if digest != compiled.content_digest:
                raise ValueError(
                    "Checkpoint was written for a different scene "
                    f"(digest {digest[:12]}… != {compiled.content_digest[:12]}…)."
                )
            return cls(
                compiled,
                data["distinct"], data["crossings"], data["sums"],
                data["bins"], data["fates"],
                int(data["traced"]), int(data["num_rays"]),
                int(data["seed"]), int(data["bundle"]),
                float(data["elapsed"]),
                fate_scores=(
                    data["fate_scores"] if "fate_scores" in data else None
                ),
            )


def simulate_checkpointed(
    scene,
    num_rays,
    checkpoint,
    bundle=None,
    seed=None,
    resume=True,
    stop_after_bundles=None,
    mesh=None,
    device="cuda",
    **kwargs,
):
    """Trace `num_rays` in bundles, checkpointing after each bundle.

    If `checkpoint` exists and `resume` is true, the run continues from
    the saved cursor; the union of the two partial runs is identical to
    an uninterrupted run with the same seed (bundle k passes its global
    start index as ``index_offset`` under ONE base seed, exactly as
    ``simulate_stream`` does, so every photon's stream is a pure
    function of (seed, global photon id)).

    `stop_after_bundles` bounds how many bundles this call traces
    (for staged runs and tests); the checkpoint stays resumable.

    `bundle` trades crash-loss window against per-call overhead: each
    bundle pays one launch and one fetch, so bigger bundles run faster
    but lose more work on a crash. None means 16,000,000 for a new run
    and the stored bundle on a resume; a `bundle` that differs from the
    stored one raises. (The JAX package's default moved from 1M to 16M,
    so there a checkpoint made at the old default resumes only with an
    explicit ``bundle=``.)

    The run is on `device` (the card unless "cpu"); `kwargs` pass through
    to ``engine.simulate``. Photon ids ``[0, num_rays)`` must lie below
    2**32 - 1, checked before any work (the JAX package lets them reach
    2**32).

    ``mesh`` (``parallel.make_photon_mesh()``) shards each bundle over
    its process group through ``parallel.shard_simulate``, on
    ``mesh.device`` (`device` must name it; `num_rays` and `bundle` must
    be multiples of ``mesh.size``). Rank 0 writes the checkpoint; every
    rank reads it on a resume. Because per-photon keys fold the global
    photon index, the checkpoint is TOPOLOGY-PORTABLE: a run checkpointed
    on one mesh resumes bit-exactly on another mesh or on a single
    device, and vice versa.

    Returns an `AccumulatedResult`.
    """
    _check_budget(num_rays, 0)
    compiled = kwargs.pop("compiled", None)
    if compiled is None:
        compiled = compile_scene(scene)

    state = None
    if resume and checkpoint and os.path.exists(checkpoint):
        state = AccumulatedResult.load(checkpoint, compiled)
        if state.num_rays != num_rays or bundle not in (None, state.bundle):
            raise ValueError(
                "Checkpoint run shape mismatch: saved "
                f"(num_rays={state.num_rays}, bundle={state.bundle}), "
                f"requested (num_rays={num_rays}, bundle={bundle})."
            )
        if seed is not None and state.seed != seed:
            raise ValueError(
                f"Checkpoint seed {state.seed} != requested seed {seed}."
            )
        bundle = state.bundle
    elif bundle is None:
        bundle = DEFAULT_BUNDLE
    if mesh is not None and (num_rays % mesh.size or bundle % mesh.size):
        raise ValueError(
            f"num_rays ({num_rays}) and bundle ({bundle}) must be "
            f"multiples of the mesh size ({mesh.size})."
        )
    score = bool(kwargs.get("score"))
    if state is None:
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        n_rec = max(compiled.n_recorders, 1)
        state = AccumulatedResult(
            compiled,
            np.zeros(n_rec, dtype=np.int64),
            np.zeros(n_rec, dtype=np.int64),
            np.zeros((n_rec, 4, 2), dtype=np.float64),
            np.zeros(int(compiled.total_bins), dtype=np.int64),
            np.zeros(11, dtype=np.int64),
            traced=0,
            num_rays=num_rays,
            seed=seed,
            bundle=bundle,
            fate_scores=(
                np.zeros((
                    11,
                    compiled.n_components + len(compiled.nodes)
                    + len(tuple(kwargs.get("pathwise") or ())),
                ))
                if score else None
            ),
        )
    elif score and state._fate_scores is None:
        raise ValueError(
            "Checkpoint was written without score accumulation."
        )

    writes = checkpoint and (mesh is None or mesh.rank == 0)
    bundles_done = 0
    while state.traced < num_rays:
        if stop_after_bundles is not None and bundles_done >= stop_after_bundles:
            break
        n = min(bundle, num_rays - state.traced)
        if mesh is not None:
            from pvtrace_tpu_torch.parallel.shard import shard_simulate

            tic = time.perf_counter()
            data = shard_simulate(
                scene, n, mesh, seed=state.seed, index_offset=state.traced,
                compiled=compiled, device=device, **kwargs,
            )
            bundle_elapsed = time.perf_counter() - tic
        else:
            result = simulate(
                scene, n, seed=state.seed, index_offset=state.traced,
                compiled=compiled, device=device, **kwargs,
            )
            data = result.data
            bundle_elapsed = result.elapsed
        n_rec = max(compiled.n_recorders, 1)
        state._distinct += data["rec_distinct"]
        state._crossings += data["rec_crossings"]
        state._sums += data["rec_sums"].reshape(n_rec, 4, 2)
        state._bins += data["rec_bins"]
        state._fates += data["fates"]
        if score:
            state._fate_scores += data["fate_scores"]
        state.traced += n
        state.elapsed += bundle_elapsed
        bundles_done += 1
        if writes:
            state.save(checkpoint)

    return state
