"""K11: the event log of recorded photons, the eager twin.

Port of ``_empty_log``, ``_record`` and the log calls of ``body``
(pvtrace_tpu/engine/tracer.py). With ``record_every = k > 0`` every
photon whose id is a multiple of k is recorded, in slot ``(pid -
first_rec) // k`` of ``ceil(n / k)`` slots, ``first_rec`` being the first
multiple of k at or after the run's ``index_offset``. A slot's row holds
up to ``max_events`` packed records, six ints (``LOG_INTS``) and twelve
floats (``LOG_VECS`` then ``LOG_SCALARS``); ints are -1 and floats 0
where nothing was written. ``nevents`` counts a lane's records; a
record is written only where ``slot < S`` and ``nevents < max_events``
(the JAX package's log has one more row, where its scatter sends the
lanes that write nothing).
"""
import torch

from pvtrace_tpu_torch.engine.tables import LOG_F, LOG_I
from pvtrace_tpu_torch.light.event import Event

LOG_INTS = ("kind", "hit", "container", "adjacent", "component", "source")  # LOG_I
LOG_VECS = ("position", "direction", "normal")  # floats [..., 0:9]
LOG_SCALARS = ("wavelength", "travelled", "duration")  # floats [..., 9:12]


def n_slots(n, record_every):
    """Slots of a run of n photons: ceil(n / k), 0 without a log."""
    return -(-n // record_every) if record_every > 0 else 0


def first_recorded(index_offset, record_every):
    """The first multiple of `record_every` at or after `index_offset`."""
    return (index_offset + record_every - 1) // record_every * record_every


def slots(pids, record_every, first_rec, S):
    """Slot of each photon id: S (not recorded) unless it is a multiple of
    `record_every`."""
    return torch.where(
        pids % record_every == 0, (pids - first_rec) // record_every, S
    ).to(torch.int32)


def empty(S, max_events, dtype, device):
    """A log of S slots: ints -1, floats 0."""
    return {
        "ints": torch.full((S, max_events, LOG_I), -1, dtype=torch.int32, device=device),
        "floats": torch.zeros((S, max_events, LOG_F), dtype=dtype, device=device),
    }


def _lanes(value, like):
    return value if isinstance(value, torch.Tensor) else torch.full_like(like, value)


def record(log, nevents, slot, mask, kind, hit, container, adjacent, component, source,
           pos, direction, normal, wavelength, travelled, duration):
    """Write one record for each lane of `mask` that has a slot and room
    left, in place. Ints may be python ints (the same for every lane);
    `pos`, `direction` and `normal` (None: zeros) are component triples.
    Returns the new ``nevents``."""
    S, E = log["ints"].shape[:2]
    write = mask & (slot < S) & (nevents < E)
    idx = write.nonzero()[:, 0]
    if idx.numel():
        ints = torch.stack(
            [_lanes(v, slot)[idx] for v in (kind, hit, container, adjacent, component, source)],
            dim=1,
        )
        zero = torch.zeros_like(wavelength)
        vecs = (*pos, *direction, *(normal if normal is not None else (zero, zero, zero)))
        floats = torch.stack([v[idx] for v in (*vecs, wavelength, travelled, duration)], dim=1)
        row, col = slot[idx].long(), nevents[idx].long()
        log["ints"][row, col] = ints
        log["floats"][row, col] = floats.to(log["floats"].dtype)
    return nevents + write.to(torch.int32)


def record_generate(log, nevents, slot, mask, s):
    """GENERATE records of the freshly emitted lanes `mask` of state `s`."""
    zero = torch.zeros_like(s["wav"])
    return record(
        log, nevents, slot, mask, Event.GENERATE.value, -1, -1, -1, -1, -1,
        (s["px"], s["py"], s["pz"]), (s["dx"], s["dy"], s["dz"]), None, s["wav"], zero, zero,
    )


def budget_kill(log, nevents, slot, s):
    """The event-budget kill before a step: a live recorded lane with
    ``nevents >= max_events - 1`` is logged as KILL from its state `s`
    and dies. Returns (the killed lanes, the new nevents)."""
    S, E = log["ints"].shape[:2]
    kill = s["alive"] & (slot < S) & (nevents >= E - 1)
    nevents = record(
        log, nevents, slot, kill, Event.KILL.value, -1, -1, -1, -1, s["source"],
        (s["px"], s["py"], s["pz"]), (s["dx"], s["dy"], s["dz"]), None, s["wav"], s["trav"],
        s["dur"],
    )
    return kill, nevents


def record_step(log, nevents, slot, s, r):
    """The records of one step in the JAX package's order: KILL (step or
    path cap), EXIT, ABSORB, EMIT, SCATTER, REACT, NONRADIATIVE, KILL (no
    adjacent node), REFLECT, TRANSMIT. `s` holds the lanes before the
    step, `r` is ``physics.step``'s output with its extras. Every record
    takes the position and path length after the step; the caps' KILL,
    EXIT and ABSORB take the incoming direction, EXIT and ABSORB the
    duration at the hit point, ABSORB the incoming wavelength and the
    source before the step; only REFLECT and TRANSMIT carry the surface's
    world normal. Returns the new nevents."""
    pos = (r["px"], r["py"], r["pz"])
    d_in, d_out = (s["dx"], s["dy"], s["dz"]), (r["dx"], r["dy"], r["dz"])
    normal = (r["wnx"], r["wny"], r["wnz"])
    hit, cont, adj, comp = r["hit"], r["container"], r["adjacent"], r["comp_id"]
    after = (r["source"], d_out, None, r["wav"], r["dur"])
    for mask, kind, h, a, c, (src, direction, nrm, wav, dur) in (
        ("kill_max", Event.KILL, -1, -1, -1, (s["source"], d_in, None, r["wav"], r["dur"])),
        ("exit_mask", Event.EXIT, hit, adj, -1, (r["source"], d_in, None, r["wav"], r["dur_adv"])),
        ("absorbed", Event.ABSORB, -1, -1, comp,
         (r["source_pre"], d_in, None, s["wav"], r["dur_adv"])),
        ("emitting", Event.EMIT, -1, -1, comp, after),
        ("scattering", Event.SCATTER, -1, -1, comp, after),
        ("reacting", Event.REACT, -1, -1, comp, after),
        ("losing", Event.NONRADIATIVE, -1, -1, comp, after),
        ("adj_bad", Event.KILL, hit, -1, -1, after),
        ("reflecting", Event.REFLECT, hit, adj, -1, (r["source"], d_out, normal, r["wav"], r["dur"])),
        ("transmitting", Event.TRANSMIT, hit, adj, -1,
         (r["source"], d_out, normal, r["wav"], r["dur"])),
    ):
        nevents = record(log, nevents, slot, r[mask], kind.value, h, cont, a, c, src, pos,
                         direction, nrm, wav, r["trav"], dur)
    return nevents
