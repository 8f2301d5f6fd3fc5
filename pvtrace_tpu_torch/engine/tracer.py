"""K7 and K8: the trace loop with fate counts and lane regeneration.

Port of ``trace_bundle_device_emit``, ``_run``, ``body_fast`` and, with
an event log, ``body`` (pvtrace_tpu/engine/tracer.py): fates, recorder tallies (K9,
``engine/tally.py``), the event log of every ``record_every``-th photon
(K11, ``engine/eventlog.py``) and, with ``score``, the score channels
(K12, ``engine/score.py``): each lane carries its photon's path score
[CH], zeroed on refill, adds the step's contributions after the step,
folds it into ``fate_scores`` at termination, then hands it to the
recorders. With ``pathwise`` channels (K13, ``engine/pathwise.py``) the
score row has one more channel each, and the lane also carries their
tangents [C, 7], zeroed on refill: the step is linearized, and the
channels' contributions join the others before the fold. ``trace``
runs the CUDA kernel ``pvt_trace`` for tensors on a CUDA device and the
eager twin ``trace_eager`` for tensors on the CPU (the kernel wrapper
decides, by the tensors' device).

The eager twin mirrors the JAX loop step for step: a wavefront of
``lanes`` photons advances in lockstep; after every step dead lanes are
refilled with the next photon ids by an exclusive prefix sum
(``cand = next + rank``, bounded by ``index_offset + n``), re-keyed from
the same seed and re-emitted, and the recorders they had matched are
forgotten; with a log, their slots are remapped and their GENERATE
records written. Every photon's random streams are a pure function of
(seed, pid, its own step count), so the fate counts, integer tallies and
logs do not depend on the lane count, and match the JAX package's photon
for photon.
"""
import torch

from pvtrace_tpu_torch.engine import eventlog, pathwise as path, physics, rng, tally
from pvtrace_tpu_torch.engine import score as score_ch
from pvtrace_tpu_torch.engine.emit import emit

# Runs of the eager twin: a run can show that it went through the kernel.
eager_runs = 0


def initial_state(st, seed_words, pids):
    """Keys and freshly emitted state of photons `pids` (int64)."""
    k0, k1 = rng.photon_keys(seed_words, pids)
    (px, py, pz), (dx, dy, dz), wav = emit(st, (k0, k1), pids)
    zero = torch.zeros_like(px)
    return {
        "px": px, "py": py, "pz": pz, "dx": dx, "dy": dy, "dz": dz,
        "wav": wav, "trav": zero, "dur": zero.clone(),
        "source": torch.full_like(pids, -1, dtype=torch.int32),
        "alive": torch.ones_like(pids, dtype=torch.bool),
        "count": torch.zeros_like(pids, dtype=torch.int32),
        "k0": k0, "k1": k1,
    }


def step_state(st, s, maxsteps, emit_method, maxpathlength=float("inf"), alive=None,
               want_extras=False, want_score=False):
    """One loop step of lanes `s`: count the step, draw, take the physics
    step, of the lanes `alive` (default ``s["alive"]``; the event budget
    kills lanes after their step is counted). Returns the new state
    (keys carried over) with the flags, with `want_extras` the log's
    extras and with `want_score` the score channels' inputs."""
    count = s["count"] + s["alive"].to(torch.int32)
    u = rng.draw8(s["k0"], s["k1"], count.long(), s["px"].dtype)
    out = physics.step(
        st, dict(s, count=count, alive=s["alive"] if alive is None else alive), u,
        maxsteps, emit_method, maxpathlength, want_extras, want_score,
    )
    out["k0"], out["k1"] = s["k0"], s["k1"]
    return out


def trace_eager(st, seed_words, n, index_offset=0, lanes=None, maxsteps=1000,
                emit_method=0, maxpathlength=float("inf"), record_every=0, max_events=128,
                score=False, per_photon=False, pathwise=()):
    """Trace photons ``index_offset + [0, n)`` with the eager twin.

    Returns (fates, steps, tallies, log): int64 fate counts [11], the
    number of loop steps taken, the recorder tallies (``tally.empty``'s
    dict, with `score` also ``fate_scores`` and ``rec_scores``) and, with
    ``record_every > 0``, the event log of ``ceil(n / record_every)``
    slots (``eventlog.empty``'s dict), else None. With `score` and
    `per_photon` the tallies also hold each photon's record at its last
    fold, photon ``index_offset + k`` in column k: ``photon_scores`` [CH,
    n], ``photon_fate`` and ``photon_steps`` [n] (int64; -1 and 0 where
    it never folded) and ``photon_slack`` [CH, n]. `pathwise` (resolved
    specs, used with `score` only, as in the JAX package) appends the
    pathwise channels to CH."""
    global eager_runs
    eager_runs += 1
    device = st["node_f"].device
    B = n if lanes is None or lanes >= n else lanes
    pids = index_offset + torch.arange(B, device=device, dtype=torch.int64)
    s = initial_state(st, seed_words, pids)
    nxt, total = index_offset + B, index_offset + n
    fates = torch.zeros(physics.N_FATES, dtype=torch.int64, device=device)
    specs = tuple(pathwise) if score else ()
    CH = score_ch.n_channels(st, len(specs)) if score else 0
    tallies = tally.empty(st, B, CH)
    if score:
        s["score"] = torch.zeros((CH, B), dtype=s["px"].dtype, device=device)
        s["slack"] = torch.zeros((CH, B), dtype=torch.float64, device=device)
    if specs:
        s["tang"] = torch.zeros((len(specs), 7, B), dtype=s["px"].dtype, device=device)
    record = score and per_photon
    if record:
        pid = pids.clone()
        tallies.update(
            photon_scores=torch.zeros((CH, n), dtype=s["px"].dtype, device=device),
            photon_fate=torch.full((n,), -1, dtype=torch.int64, device=device),
            photon_steps=torch.zeros(n, dtype=torch.int64, device=device),
            photon_slack=torch.zeros((CH, n), dtype=torch.float64, device=device),
        )
    log = None
    if record_every > 0:
        S = eventlog.n_slots(n, record_every)
        first_rec = eventlog.first_recorded(index_offset, record_every)
        log = eventlog.empty(S, max_events, s["px"].dtype, device)
        slot = eventlog.slots(pids, record_every, first_rec, S)
        nevents = eventlog.record_generate(
            log, torch.zeros_like(slot), slot, torch.ones_like(s["alive"]), s
        )
    fate_slots = (
        ("exit_mask", physics.EV_EXIT),
        ("losing", physics.EV_NONRADIATIVE),
        ("reacting", physics.EV_REACT),
        ("kills", physics.EV_KILL),
        ("no_hit_term", physics.FATE_NO_HIT),
    )
    steps = 0
    while bool(s["alive"].any()):
        steps += 1
        alive, killed = s["alive"], None
        if log is not None:
            killed, nevents = eventlog.budget_kill(log, nevents, slot, s)
            fates[physics.EV_KILL] += killed.sum()
            alive = alive & ~killed
        if specs:
            out, jv = path.step_state(st, s, specs, maxsteps, emit_method, maxpathlength, alive,
                                      log is not None)
        else:
            out = step_state(st, s, maxsteps, emit_method, maxpathlength, alive,
                             log is not None, score)
        for name, fate in fate_slots:
            fates[fate] += out[name].sum()
        if score:
            ds, slack = score_ch.contributions(st, out, with_slack=True)
            if specs:
                ds_pw, out["tang"], slack_pw = path.contributions(
                    out, jv, (s["dx"], s["dy"], s["dz"]), with_slack=True)
                ds, slack = torch.cat([ds, ds_pw]), torch.cat([slack, slack_pw])
            out["score"], out["slack"] = s["score"] + ds, s["slack"] + slack
            idx, at = score_ch.fold(tallies, out["score"], out, killed, out["slack"])
            if record and idx.numel():
                p = pid[idx] - index_offset
                tallies["photon_scores"][:, p] = out["score"][:, idx]
                tallies["photon_fate"][p] = at
                tallies["photon_steps"][p] = out["count"][idx].long()
                tallies["photon_slack"][:, p] = out["slack"][:, idx]
        tally.tally(tallies, st, out, out.get("score"), out.get("slack"))
        if log is not None:
            nevents = eventlog.record_step(log, nevents, slot, s, out)
        s = {k: out[k] for k in s}
        if B < n:
            dead = ~s["alive"]
            cand = nxt + torch.cumsum(dead, 0) - 1
            refill = dead & (cand < total)
            idx = refill.nonzero()[:, 0]
            if idx.numel():
                fresh = initial_state(st, seed_words, cand[idx])
                for k, v in fresh.items():
                    s[k] = s[k].index_put((idx,), v)
                if score:
                    s["score"][:, idx] = 0.0
                    s["slack"][:, idx] = 0.0
                if specs:
                    s["tang"][:, :, idx] = 0.0
                if record:
                    pid[idx] = cand[idx]
                tally.reset_seen(tallies, idx)
                nxt += idx.numel()
                if log is not None:
                    slot = slot.index_put((idx,), eventlog.slots(cand[idx], record_every,
                                                                 first_rec, S))
                    nevents = eventlog.record_generate(
                        log, nevents.index_put((idx,), torch.zeros_like(idx, dtype=torch.int32)),
                        slot, refill, s,
                    )
    return fates, steps, tallies, log


def trace(st, seed_words, n, index_offset=0, lanes=None, maxsteps=1000,
          emit_method=0, maxpathlength=float("inf"), record_every=0, max_events=128,
          score=False, pathwise=()):
    """Trace photons ``index_offset + [0, n)`` through the wrapper of
    ``pvt_trace``: the CUDA kernel for scene tensors on a CUDA device,
    ``trace_eager`` for CPU tensors.

    Returns (fates, steps, tallies, log). On the kernel path `steps` is
    the largest per-photon step count; on the eager path it is the number
    of wavefront steps (the JAX package's count of loop-body steps)."""
    from pvtrace_tpu_torch import kernels

    return kernels.trace(
        st, seed_words, n, index_offset, lanes, maxsteps, emit_method,
        maxpathlength, record_every, max_events, score, pathwise=pathwise,
    )
