"""K7 and K8: the trace loop with fate counts and lane regeneration.

Port of ``trace_bundle_device_emit``, ``_run`` and ``body_fast``
(pvtrace_tpu/engine/tracer.py) for the tallies-only path: no event log,
no score; fates and recorder tallies (K9, ``engine/tally.py``). ``trace``
runs the CUDA kernel ``pvt_trace`` for tensors on a CUDA device and the
eager twin ``trace_eager`` for tensors on the CPU (the kernel wrapper
decides, by the tensors' device).

The eager twin mirrors the JAX loop step for step: a wavefront of
``lanes`` photons advances in lockstep; after every step dead lanes are
refilled with the next photon ids by an exclusive prefix sum
(``cand = next + rank``, bounded by ``index_offset + n``), re-keyed from
the same seed and re-emitted, and the recorders they had matched are
forgotten. Every photon's random streams are a pure function of (seed,
pid, its own step count), so the fate counts and integer tallies do not
depend on the lane count, and match the JAX package's photon for photon.
"""
import torch

from pvtrace_tpu_torch.engine import physics, rng, tally
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


def step_state(st, s, maxsteps, emit_method, maxpathlength=float("inf")):
    """One loop step of lanes `s`: count the step, draw, take the physics
    step. Returns the new state (keys carried over) with the flags."""
    count = s["count"] + s["alive"].to(torch.int32)
    u = rng.draw8(s["k0"], s["k1"], count.long(), s["px"].dtype)
    out = physics.step(
        st, dict(s, count=count), u, maxsteps, emit_method, maxpathlength
    )
    out["k0"], out["k1"] = s["k0"], s["k1"]
    return out


def trace_eager(st, seed_words, n, index_offset=0, lanes=None, maxsteps=1000,
                emit_method=0, maxpathlength=float("inf")):
    """Trace photons ``index_offset + [0, n)`` with the eager twin.

    Returns (fates, steps, tallies): int64 fate counts [11], the number of
    loop steps taken, and the recorder tallies (``tally.empty``'s dict)."""
    global eager_runs
    eager_runs += 1
    device = st["node_f"].device
    B = n if lanes is None or lanes >= n else lanes
    pids = index_offset + torch.arange(B, device=device, dtype=torch.int64)
    s = initial_state(st, seed_words, pids)
    nxt, total = index_offset + B, index_offset + n
    fates = torch.zeros(physics.N_FATES, dtype=torch.int64, device=device)
    tallies = tally.empty(st, B)
    slots = (
        ("exit_mask", physics.EV_EXIT),
        ("losing", physics.EV_NONRADIATIVE),
        ("reacting", physics.EV_REACT),
        ("kills", physics.EV_KILL),
        ("no_hit_term", physics.FATE_NO_HIT),
    )
    steps = 0
    while bool(s["alive"].any()):
        steps += 1
        out = step_state(st, s, maxsteps, emit_method, maxpathlength)
        for name, slot in slots:
            fates[slot] += out[name].sum()
        tally.tally(tallies, st, out)
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
                tally.reset_seen(tallies, idx)
                nxt += idx.numel()
    return fates, steps, tallies


def trace(st, seed_words, n, index_offset=0, lanes=None, maxsteps=1000,
          emit_method=0, maxpathlength=float("inf")):
    """Trace photons ``index_offset + [0, n)`` through the wrapper of
    ``pvt_trace``: the CUDA kernel for scene tensors on a CUDA device,
    ``trace_eager`` for CPU tensors.

    Returns (fates, steps, tallies). On the kernel path `steps` is the
    largest per-photon step count; on the eager path it is the number of
    wavefront steps (the JAX package's count of loop-body steps)."""
    from pvtrace_tpu_torch import kernels

    return kernels.trace(
        st, seed_words, n, index_offset, lanes, maxsteps, emit_method,
        maxpathlength,
    )
