"""K3, K4 and K6: one physics step of every lane, the eager twin.

Port of ``physics_core`` (pvtrace_tpu/engine/tracer.py ``_run``). The
JAX function is generated per scene; this one is table-driven, a loop
over the node records in node order, as the CUDA kernel's ``step_one``
is. One step:

1. intersect every node (strict ``<`` nearest-two update in node order,
   then candidate order); container = the nearest node with exactly one
   forward hit, the hit node when there is one hit in all. A mesh node
   (K10) gives its nearest two triangle hits as candidates, counts every
   hit, and keeps the face normal of its nearest hit: that, not a
   normal computed from the hit point, is its surface normal below;
2. NO_HIT, then KILL on ``count > maxsteps`` or the path-length cap;
3. free path ``-log1p(-u0) / alpha`` against the boundary distance,
   advance, then component roulette, quantum-yield coin, phase, emission
   with ``p1`` truncation, delays and reactors;
4. at a surface: normal of the hit node, facet override, Fresnel / TIR,
   reflect, refract, pass through or Lambertian;
5. the recorder selectors (K9's inputs): which event a recorder may
   count (``sel``, a recorder.EVENTS tag or SEL_NONE), on which node
   (``tnode``), whether the world normal applies (``have_n``), and the
   hit surface's world normal and incidence cosine on surface events.
   The JAX package computes them only when a scene has recorders; the
   port computes them on every step. An ``adj_bad`` lane is counted as
   KILL and stays alive, as in the reference (ROADMAP queue 3);
6. with ``want_extras``, what the event log (K11) records besides: the
   masks of each event, the component, the adjacent node, the duration
   after the advance and the source before the volume event (EXTRAS);
7. with ``want_score``, what the score channels (K12, ``engine/score.py``)
   read (SCORE_EXTRAS): the container's spectral slots at the incoming
   wavelength, the lanes that moved (alive after the no-hit and kill
   masks) and how far, the volume event, the two refractive indices and
   the reflectivity after the overrides of a surface event, and whether
   its reflect/transmit was a Fresnel coin (not TIR, no override); and
   what the pathwise channels (K13, ``engine/pathwise.py``) read besides:
   the nearest hit's distance ``t0``, the container's total attenuation
   ``alpha`` and the incidence cosine at the nearest hit along the pre-step
   direction ``c_hit`` (on every lane: it conditions t0's tangent).

``params`` replaces the nodes' refractive indices (``"nidx"``, a tensor
[N]) and geometry parameters (``"gp"``, N triples of floats or 0-dim
tensors), the JAX function's ``nidx`` / ``gp``: the pathwise channels
differentiate the step in them with ``torch.autograd.forward_ad``. Where
the reference clips or takes an absolute value on that path, the step
uses ``engine/ties.py``, which has the reference's derivatives.
"""
import math

import torch

from pvtrace_tpu_torch.engine import compiler as comp
from pvtrace_tpu_torch.engine import geometry, spectral, ties
from pvtrace_tpu_torch.engine import tables as T
from pvtrace_tpu_torch.engine.device_emit import hg_mu
from pvtrace_tpu_torch.engine.recorder import EVENTS

ALPHA_ZERO = 1e-8
C_CM_PER_S = 2.99792458e10
_INF = float("inf")

# Fate counter slots (light.event.Event values; 10 = left without a hit)
EV_NONRADIATIVE, EV_EXIT, EV_REACT, EV_KILL = 4, 7, 8, 9
FATE_NO_HIT = 10
N_FATES = 11

# Facet override modes (material.surface OVERRIDE_* values)
OVR_MIRROR, OVR_ABSORB, OVR_LAMBERTIAN = 0, 1, 2

# Recorder selectors (recorder.EVENTS tags); SEL_NONE: nothing to count
REC_ENTERING, REC_ESCAPING = EVENTS["entering"], EVENTS["escaping"]
REC_REFLECTED, REC_LOST = EVENTS["reflected"], EVENTS["lost"]
REC_REACTED, REC_KILLED, REC_EXIT = EVENTS["reacted"], EVENTS["killed"], EVENTS["exit"]
SEL_NONE = -1

STATE_FLOATS = ("px", "py", "pz", "dx", "dy", "dz", "wav", "trav", "dur")
FLAGS = ("exit_mask", "losing", "reacting", "kills", "no_hit_term")
# Per-lane outputs for the recorders: int32 node and selector, bool flags,
# and the world normal and incidence cosine of the hit surface on surface
# events (0 on other lanes).
SELECTORS = ("sel", "tnode")
EVENT_FLAGS = ("have_n", "surface_event")
SURFACE = ("wnx", "wny", "wnz", "c_in")
# The event log's extra per-lane outputs (want_extras)
EXTRAS = (
    "adjacent", "comp_id", "absorbed", "emitting", "scattering", "kill_max",
    "adj_bad", "reflecting", "transmitting", "dur_adv", "source_pre",
)
# The score channels' extra per-lane outputs (want_score); "slot_vals" is
# [B, W], the container's slots.
SCORE_EXTRAS = (
    "slot_vals", "moving", "advance", "absorbed", "comp_id", "adjacent", "n1r", "n2r",
    "refl_r", "fres_coin", "reflecting", "transmitting", "t0", "alpha", "c_hit",
)


def node_params(st):
    """The nodes' refractive indices [N] and geometry parameters (N
    triples of floats), the defaults of ``step``'s `params`."""
    return {"nidx": st["node_f"][:, T.NF_NIDX],
            "gp": [row[T.NF_GP:T.NF_GP + 3] for row in st["rows"]["node_f"]]}


def step(st, s, u, maxsteps, emit_method, maxpathlength=_INF, want_extras=False,
         want_score=False, params=None):
    """One step of lanes `s` (dict of STATE_FLOATS, ``source``, ``alive``
    and ``count``, already incremented) with uniforms ``u[0..7]``.

    Returns the new state plus the per-lane FLAGS, ``hit``,
    ``container``, SELECTORS, EVENT_FLAGS and SURFACE, with `want_extras`
    the EXTRAS and with `want_score` the SCORE_EXTRAS; `params` as the module
    doc says."""
    meta = st["meta"]
    if params is None:
        params = node_params(st)
    nidx, gp = params["nidx"], params["gp"]
    N, L = meta["n_nodes"], meta["grid_n"]
    node_f, node_i = st["rows"]["node_f"], st["rows"]["node_i"]
    px, py, pz = s["px"], s["py"], s["pz"]
    dxv, dyv, dzv = s["dx"], s["dy"], s["dz"]
    wav, trav, dur = s["wav"], s["trav"], s["dur"]
    source, alive, count = s["source"], s["alive"], s["count"]
    inf = torch.full_like(px, _INF)
    izero = torch.zeros_like(count)

    # -- K3: nearest two forward hits, container, adjacent --------------
    t1, t2, n1, n2 = inf, inf, izero, izero
    nhits, cont_t, cont_n = izero, inf, izero
    frames, mesh_normals = [], {}
    for n in range(N):
        R = node_f[n][T.NF_W2L:T.NF_W2L + 12]
        o = (
            R[0] * px + R[1] * py + R[2] * pz + R[3],
            R[4] * px + R[5] * py + R[6] * pz + R[7],
            R[8] * px + R[9] * py + R[10] * pz + R[11],
        )
        d = (
            R[0] * dxv + R[1] * dyv + R[2] * dzv,
            R[4] * dxv + R[5] * dyv + R[6] * dzv,
            R[8] * dxv + R[9] * dyv + R[10] * dzv,
        )
        frames.append((o, d))
        if node_i[n][T.NI_GEOM] == comp.GEOM_MESH:
            first = node_i[n][T.NI_TRI0]
            tmin_n, mt2, cnt_n, mesh_normals[n] = geometry.mesh_nearest_two(
                st["tri_f"][first:first + node_i[n][T.NI_NTRI]], o, d, node_f[n][T.NF_EPS]
            )
            cands = [(tmin_n, cnt_n >= 1), (mt2, cnt_n >= 2)]
        else:
            cands = geometry.intersect(
                node_i[n][T.NI_GEOM], gp[n], o, d, node_f[n][T.NF_EPS],
            )
            cnt_n = sum(valid.to(torch.int32) for _, valid in cands)
            tmin_n = inf
        for t, valid in cands:
            tv = torch.where(valid, t, _INF)
            tmin_n = torch.minimum(tmin_n, tv)
            isfirst = tv < t1
            issecond = ~isfirst & (tv < t2)
            t2 = torch.where(isfirst, t1, torch.where(issecond, tv, t2))
            n2 = torch.where(isfirst, n1, torch.where(issecond, n, n2))
            t1 = torch.where(isfirst, tv, t1)
            n1 = torch.where(isfirst, n, n1)
        nhits = nhits + cnt_n
        is_cand = (cnt_n == 1) & (tmin_n < cont_t)
        cont_t = torch.where(is_cand, tmin_n, cont_t)
        cont_n = torch.where(is_cand, n, cont_n)

    hit, t0 = n1, t1
    container = torch.where(torch.isfinite(cont_t), cont_n, hit)
    adjacent = torch.where(container == hit, n2, hit)
    container = torch.where(nhits == 1, hit, container)
    adjacent = torch.where(nhits == 1, -1, adjacent)

    no_hit_term = alive & (nhits == 0)
    alive = alive & (nhits != 0)
    kill_max = alive & (count > maxsteps)
    if math.isfinite(maxpathlength):
        kill_max = kill_max | (alive & (trav > maxpathlength))
    alive = alive & ~kill_max

    node_it = st["node_i"]
    cl = container.long()
    n_cont = nidx[cl]
    exit_mask = alive & (hit == meta["root_id"])

    # -- K5b + K6: free path, advance, volume events --------------------
    i0, frac = spectral.grid_index(wav, meta["grid_x0"], meta["grid_dx"], L)
    slots = spectral.slots(st, cl, i0, frac)
    K = node_it[cl, T.NI_NCOMP]
    alpha = torch.where(
        K > 0, slots.gather(1, (K - 1).clamp(min=0).long()[:, None])[:, 0], 0.0
    )
    depth = torch.where(
        alpha > ALPHA_ZERO,
        -torch.log1p(-u[0]) / ties.clip(alpha, 1e-30),
        _INF,
    )
    absorbed = alive & ~exit_mask & (depth < t0)
    advance = torch.where(absorbed, depth, t0)
    px = torch.where(alive, px + dxv * advance, px)
    py = torch.where(alive, py + dyv * advance, py)
    pz = torch.where(alive, pz + dzv * advance, pz)
    trav = torch.where(alive, trav + advance, trav)
    dur = torch.where(alive, dur + advance * n_cont / C_CM_PER_S, dur)
    dur_adv, source_pre = dur, source

    target = u[1] * alpha
    ordinal = izero
    max_k = max(row[T.NI_NCOMP] for row in node_i)
    for k in range(max_k - 1):
        ordinal = ordinal + ((k < K - 1) & (slots[:, k] < target)).to(torch.int32)
    comp_id = torch.where(K > 0, node_it[cl, T.NI_COMP0] + ordinal, -1)
    has_c = comp_id >= 0
    cid = comp_id.clamp(min=0).long()
    cf, ci = st["comp_f"][cid], st["comp_i"][cid]
    ctype = torch.where(has_c, ci[:, T.CI_TYPE], -1)

    def attr(col):
        return torch.where(has_c, cf[:, col], 0.0)

    is_lum = ctype == comp.COMP_LUMINOPHORE
    can_radiate = is_lum | (ctype == comp.COMP_SCATTERER)
    radiative = absorbed & can_radiate & (u[2] < attr(T.CF_QY))

    ptype = ci[:, T.CI_PHASE]
    mu = torch.where(
        ptype == comp.PHASE_HENYEY_GREENSTEIN,
        hg_mu(cf[:, T.CF_PHASE], 2.0 * u[3] - 1.0),
        2.0 * u[3] - 1.0,
    )
    s_cone = torch.sqrt(u[3]) * cf[:, T.CF_SIN_PHASE]
    mu = torch.where(
        ptype == comp.PHASE_CONE,
        torch.sqrt(torch.clamp(1.0 - s_cone * s_cone, min=0.0)),
        mu,
    )
    s_t = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
    phi = 2.0 * math.pi * u[4]
    ndx, ndy, ndz = s_t * torch.cos(phi), s_t * torch.sin(phi), mu

    emitting = radiative & is_lum
    if meta["n_lum"] > 0:
        if emit_method == comp.EMIT_FULL:
            p1 = torch.zeros_like(px)
        else:
            w = ci[:, T.CI_P1] + (0 if emit_method == comp.EMIT_KT else 1)
            p1 = torch.where(
                is_lum, slots.gather(1, w.clamp(min=0).long()[:, None])[:, 0], 0.0
            )
        gamma = p1 + (1.0 - p1) * u[5]
        lum = torch.where(has_c, ci[:, T.CI_LUM], 0).long()
        new_wav = spectral.emission_icdf(st, lum, gamma)
        tau_rad = attr(T.CF_TAU_RAD)
        rad_delay = torch.where(tau_rad > 0.0, -torch.log1p(-u[6]) * tau_rad, 0.0)
        wav = torch.where(emitting, new_wav, wav)
        dur = torch.where(emitting, dur + rad_delay, dur)

    dxv = torch.where(radiative, ndx, dxv)
    dyv = torch.where(radiative, ndy, dyv)
    dzv = torch.where(radiative, ndz, dzv)
    source = torch.where(radiative, comp_id, source)

    nonrad = absorbed & ~radiative
    tau_nr = attr(T.CF_TAU_NR)
    nr_delay = torch.where(tau_nr > 0.0, -torch.log1p(-u[6]) * tau_nr, 0.0)
    dur = torch.where(nonrad, dur + nr_delay, dur)
    reacting = nonrad & (ctype == comp.COMP_REACTOR)
    losing = nonrad & ~reacting

    # -- K4 + K6: surface interaction -----------------------------------
    surf = alive & ~exit_mask & ~absorbed
    adj_bad = surf & (adjacent < 0)
    surf = surf & ~adj_bad

    ovr_f, ovr_i = st["rows"]["ovr_f"], st["rows"]["ovr_i"]
    wnx, wny, wnz = torch.zeros_like(px), torch.zeros_like(px), torch.ones_like(px)
    ovr_mode = torch.full_like(count, comp.OVR_NONE)
    for n in range(N):
        (lox, loy, loz), (ldx, ldy, ldz) = frames[n]
        if n in mesh_normals:
            nx_n, ny_n, nz_n = mesh_normals[n]
        else:
            nx_n, ny_n, nz_n = geometry.local_normal(
                node_i[n][T.NI_GEOM], gp[n], (lox + t0 * ldx, loy + t0 * ldy, loz + t0 * ldz),
            )
        Rw = node_f[n][T.NF_L2W:T.NF_L2W + 9]
        here = hit == n
        wnx = torch.where(here, Rw[0] * nx_n + Rw[1] * ny_n + Rw[2] * nz_n, wnx)
        wny = torch.where(here, Rw[3] * nx_n + Rw[4] * ny_n + Rw[5] * nz_n, wny)
        wnz = torch.where(here, Rw[6] * nx_n + Rw[7] * ny_n + Rw[8] * nz_n, wnz)
        first = node_i[n][T.NI_OVR0]
        if node_i[n][T.NI_NOVR]:
            mode_n = torch.full_like(count, comp.OVR_NONE)
            for o in range(first, first + node_i[n][T.NI_NOVR]):
                ox0, oy0, oz0, atol = ovr_f[o]
                match = (
                    (torch.abs(nx_n - ox0) <= atol)
                    & (torch.abs(ny_n - oy0) <= atol)
                    & (torch.abs(nz_n - oz0) <= atol)
                )
                mode_n = torch.where((mode_n < 0) & match, ovr_i[o], mode_n)
            ovr_mode = torch.where(here, mode_n, ovr_mode)

    ddot = wnx * dxv + wny * dyv + wnz * dzv
    c_in = ties.clip(ties.abs_(ddot), 0.0, 1.0)
    flip = torch.where(ddot < 0.0, -1.0, torch.ones_like(ddot))
    nax, nay, naz = wnx * flip, wny * flip, wnz * flip

    n1r = n_cont
    n2r = torch.where(adjacent >= 0, nidx[adjacent.clamp(min=0).long()], 1.0)
    is_fresnel = node_it[hit.long(), T.NI_SURF] == comp.SURF_FRESNEL
    s2 = ties.clip(1.0 - c_in * c_in, 0.0, 1.0)
    ratio = n1r / n2r
    tir = (n2r < n1r) & (s2 * ratio * ratio > 1.0)
    kterm = torch.sqrt(ties.clip(1.0 - ratio * ratio * s2, 0.0))
    rs = ((n1r * c_in - n2r * kterm) / (n1r * c_in + n2r * kterm)) ** 2
    rp = ((n1r * kterm - n2r * c_in) / (n1r * kterm + n2r * c_in)) ** 2
    r = torch.where(tir, 1.0, ties.clip(0.5 * (rs + rp), 0.0, 1.0))
    r = torch.where(is_fresnel, r, 0.0)
    r = torch.where((ovr_mode == OVR_MIRROR) | (ovr_mode == OVR_LAMBERTIAN), 1.0, r)
    r = torch.where(ovr_mode == OVR_ABSORB, 0.0, r)

    reflecting = surf & (u[7] < r)
    transmitting = surf & ~reflecting

    two_d = 2.0 * c_in
    rfx = dxv - two_d * nax
    rfy = dyv - two_d * nay
    rfz = dzv - two_d * naz
    if OVR_LAMBERTIAN in ovr_i:
        st_l = torch.sqrt(u[3])
        ct_l = torch.sqrt(torch.clamp(1.0 - u[3], min=0.0))
        phi_l = 2.0 * math.pi * u[4]
        lx = st_l * torch.cos(phi_l)
        ly = st_l * torch.sin(phi_l)
        axx, axy, axz = -nax, -nay, -naz
        sign = torch.where(axz >= 0.0, 1.0, -torch.ones_like(axz))
        a_ = -1.0 / (sign + axz)
        b_ = axx * axy * a_
        t1x = 1.0 + sign * axx * axx * a_
        t1y = sign * b_
        t1z = -sign * axx
        t2x = b_
        t2y = sign + axy * axy * a_
        t2z = -axy
        lam = ovr_mode == OVR_LAMBERTIAN
        rfx = torch.where(lam, lx * t1x + ly * t2x + ct_l * axx, rfx)
        rfy = torch.where(lam, lx * t1y + ly * t2y + ct_l * axy, rfy)
        rfz = torch.where(lam, lx * t1z + ly * t2z + ct_l * axz, rfz)

    cterm = torch.sqrt(ties.clip(1.0 - ratio * ratio * (1.0 - c_in * c_in), 0.0))
    scale = cterm - ratio * c_in
    pass_through = ~is_fresnel | (ovr_mode == OVR_ABSORB)
    txd = torch.where(pass_through, dxv, ratio * dxv + scale * nax)
    tyd = torch.where(pass_through, dyv, ratio * dyv + scale * nay)
    tzd = torch.where(pass_through, dzv, ratio * dzv + scale * naz)
    dxv = torch.where(reflecting, rfx, torch.where(transmitting, txd, dxv))
    dyv = torch.where(reflecting, rfy, torch.where(transmitting, tyd, dyv))
    dzv = torch.where(reflecting, rfz, torch.where(transmitting, tzd, dzv))

    # -- recorder selectors, in the JAX package's order (tracer.py) -----
    sel = torch.full_like(count, SEL_NONE)
    tnode = torch.full_like(count, -1)
    sel = torch.where(kill_max, REC_KILLED, sel)
    tnode = torch.where(kill_max, container, tnode)
    sel = torch.where(exit_mask, REC_EXIT, sel)
    tnode = torch.where(exit_mask, hit, tnode)
    sel = torch.where(reacting, REC_REACTED, sel)
    sel = torch.where(losing, REC_LOST, sel)
    tnode = torch.where(reacting | losing, container, tnode)
    refl_tally = reflecting & (container != hit)
    sel = torch.where(refl_tally, REC_REFLECTED, sel)
    tnode = torch.where(refl_tally, hit, tnode)
    sel = torch.where(
        transmitting, torch.where(container == hit, REC_ESCAPING, REC_ENTERING).to(sel.dtype),
        sel,
    )
    tnode = torch.where(transmitting, hit, tnode)
    have_n = exit_mask | refl_tally | transmitting
    surface_event = exit_mask | reflecting | transmitting

    out = {
        "px": px, "py": py, "pz": pz, "dx": dxv, "dy": dyv, "dz": dzv,
        "wav": wav, "trav": trav, "dur": dur, "source": source,
        "alive": alive & ~exit_mask & ~nonrad, "count": count,
        "exit_mask": exit_mask, "losing": losing, "reacting": reacting,
        "kills": kill_max | adj_bad, "no_hit_term": no_hit_term,
        "hit": hit, "container": container,
        "sel": sel, "tnode": tnode, "have_n": have_n, "surface_event": surface_event,
        "wnx": torch.where(surface_event, wnx, 0.0),
        "wny": torch.where(surface_event, wny, 0.0),
        "wnz": torch.where(surface_event, wnz, 0.0),
        "c_in": torch.where(surface_event, c_in, 0.0),
    }
    if want_extras:
        out.update(
            adjacent=adjacent, comp_id=comp_id, absorbed=absorbed, emitting=emitting,
            scattering=radiative & ~is_lum, kill_max=kill_max, adj_bad=adj_bad,
            reflecting=reflecting, transmitting=transmitting, dur_adv=dur_adv,
            source_pre=source_pre,
        )
    if want_score:
        out.update(
            slot_vals=slots, moving=alive, advance=advance, absorbed=absorbed, comp_id=comp_id,
            adjacent=adjacent, n1r=n1r, n2r=n2r, refl_r=r,
            fres_coin=is_fresnel & ~tir & (ovr_mode == comp.OVR_NONE),
            reflecting=reflecting, transmitting=transmitting, t0=t0, alpha=alpha,
            c_hit=torch.abs(wnx * s["dx"] + wny * s["dy"] + wnz * s["dz"]),
        )
    return out
