"""K12: score-function (likelihood-ratio) channels, the eager twin.

Port of the score block of ``body`` and of ``_fresnel_R_scalar`` /
``_fresnel_dR`` (pvtrace_tpu/engine/tracer.py). A photon carries one
score per channel, ``d log p(path) / d theta``, in the JAX package's
layout: channels ``[0, n_comps)`` are the log-scales of the components'
coefficients, ``[n_comps, n_comps + n_nodes)`` the refractive indices of
the nodes in preorder. Per step:

* component channel c, on lanes that moved (alive after the no-hit and
  kill masks): ``-a_c * advance``, where ``a_c = cums[k] - cums[k-1]`` is
  c's attenuation among the container's cumulative slots at the incoming
  wavelength (0 where c is not in the container), plus 1 where the
  photon was absorbed by c;
* node channel k, on Fresnel coin lanes (a reflect or transmit that was
  neither TIR nor a facet override): ``nan_to_num(dR/dn1 * branch)``
  where k is the container and ``nan_to_num(dR/dn2 * branch)`` where it
  is the adjacent node, with ``branch = 1/max(R, 1e-12)`` on a reflection
  and ``-1/max(1-R, 1e-12)`` on a transmission.

At termination (``fold``) the photon's score goes into ``fate_scores``
[11, CH] at its fate; the recorders add it at a photon's first match
(``tally.tally``). A lane that is counted as KILL for lacking an
adjacent node stays alive, as in the reference (ROADMAP queue 3), and
its score is folded again at its later fate.

Beside each score the twin carries its ``slack``: how far a float32
computation of the same score (the CUDA kernel's) may honestly differ,
for the on-card checks (``kernels/check.py``). A component channel's step
term is a difference of two spectral slots times a distance that one of
them sets, and K5a rounds a slot to 1e-5 of its fit's scale, at most the
scene's largest attenuation F: SLACK_SPECTRAL * F per cm moved. A node
channel's term dR/dn * branch is a sum of O(1) terms that cancel, times
1/P (P being R on a reflection and 1 - R on a transmission), and
ill-conditioned near the critical angle (dR/dn grows as 1/sqrt(x), x =
1 - (n1/n2)^2 sin^2): FRESNEL_ROUNDING * (|branch| + (1/x + 1/P) *
|term|). At grazing incidence the term is about proportional to the
incidence cosine c, and c itself is ill-conditioned: a near-tangent ray's
hit on a curved surface moves along the ray, and the normal with it, so
two float32 computations can give c's that differ by GRAZING_ROUNDING / c
(measured on the H100: 1.2e-4 at c = 0.02 on a cylinder's barrel); the
term gets GRAZING_ROUNDING / c^2 of its size more, down to c = GRAZING_C
(2.5 % of the term). Below GRAZING_C that share stays at its cap, and
the lane-by-lane check leaves such lanes out and counts them
(``kernels/check.py``). Where the reflectivity is below FRESNEL_ROUNDING
(two equal or nearly equal indices, as touching or nested nodes of one
glass have) the amplitudes cancel: the partials are 0 in exact arithmetic
and rounding in float32, which grows as 1/c^3 at grazing incidence (at
most 3.4e-7 / c^3 at equal indices from 1.05 to 1.9); the floor there is
FRESNEL_ROUNDING * |branch| / c^3, c down to GRAZING_C.
"""
import torch

from pvtrace_tpu_torch.engine import physics
from pvtrace_tpu_torch.engine import tables as T

SLACK_SPECTRAL = 3e-5
FRESNEL_ROUNDING = 1e-6
GRAZING_ROUNDING = 1e-5
GRAZING_C = 0.02


def n_channels(st, n_path=0):
    """Score channels of a scene: components, then nodes in preorder, then
    `n_path` pathwise channels (``engine/pathwise.py``)."""
    return st["meta"]["n_comps"] + st["meta"]["n_nodes"] + n_path


def fresnel_R(n1, n2, c):
    """Unpolarised Fresnel reflectivity at incidence cosine `c` from index
    `n1` into `n2` (the reference's ``_fresnel_R_scalar``, elementwise)."""
    s2 = torch.clamp(1.0 - c * c, 0.0, 1.0)
    ratio = n1 / n2
    k = torch.sqrt(torch.clamp(1.0 - ratio * ratio * s2, min=0.0))
    rs = ((n1 * c - n2 * k) / (n1 * c + n2 * k)) ** 2
    rp = ((n1 * k - n2 * c) / (n1 * k + n2 * c)) ** 2
    return 0.5 * (rs + rp)


def fresnel_dR(n1, n2, c):
    """(dR/dn1, dR/dn2) of ``fresnel_R``, written out: the derivatives
    that the reference takes with ``jax.vmap(jax.grad)``, including its
    rule for the clip of ``1 - ratio^2 s2`` at 0 (slope 1 above, 1/2 at
    the tie, 0 below). Where that term is 0 the square root's slope is
    infinite and the partials are inf or NaN, as the reference's are; the
    score block takes ``nan_to_num`` of them."""
    s2 = torch.clamp(1.0 - c * c, 0.0, 1.0)
    ratio = n1 / n2
    x = 1.0 - ratio * ratio * s2
    slope = torch.where(x > 0.0, 1.0, torch.where(x == 0.0, 0.5, 0.0))
    k = torch.sqrt(torch.clamp(x, min=0.0))
    half_over_k = 0.5 / k
    A, B = n1 * c - n2 * k, n1 * c + n2 * k
    C, D = n1 * k - n2 * c, n1 * k + n2 * c
    qs, qp = A / B, C / D

    def partial(dratio, dn1, dn2):
        dk = slope * (-(2.0 * ratio * dratio) * s2) * half_over_k
        dA = dn1 * c - (dn2 * k + n2 * dk)
        dB = dn1 * c + (dn2 * k + n2 * dk)
        dC = (dn1 * k + n1 * dk) - dn2 * c
        dD = (dn1 * k + n1 * dk) + dn2 * c
        dqs = dA / B - dB * A / (B * B)
        dqp = dC / D - dD * C / (D * D)
        return 0.5 * (2.0 * qs * dqs + 2.0 * qp * dqp)

    one, zero = torch.ones_like(n1), torch.zeros_like(n1)
    return partial(1.0 / n2, one, zero), partial(-n1 / (n2 * n2), zero, one)


def attenuation_scale(st):
    """F: the largest total attenuation (a container's last spectral slot)
    of any node on the wavelength grid, from the K5b table; kept in
    ``st["meta"]`` after the first call."""
    meta = st["meta"]
    if "attenuation_scale" not in meta:
        N, L, W = meta["n_nodes"], meta["grid_n"], meta["pack_width"]
        pack = st["spec_pack"].reshape(N, L, W, 2)
        meta["attenuation_scale"] = max(
            (float(pack[n, :, row[T.NI_NCOMP] - 1].abs().max())
             for n, row in enumerate(st["rows"]["node_i"]) if row[T.NI_NCOMP]), default=0.0)
    return meta["attenuation_scale"]


def conditioning(out):
    """Per lane, the relative error (float64) that a float32 computation
    of a surface event's Fresnel term may have (the module docstring):
    the critical angle and 1/P, and grazing incidence down to GRAZING_C."""
    ratio = out["n1r"].double() / out["n2r"].double()
    c = out["c_in"].double()
    x = 1.0 - ratio * ratio * torch.clamp(1.0 - c * c, 0.0, 1.0)
    r = out["refl_r"].double()
    p = torch.where(out["reflecting"], r, 1.0 - r)
    return FRESNEL_ROUNDING * (1.0 / x.clamp(min=1e-300) + 1.0 / p.clamp(min=1e-300)) \
        + GRAZING_ROUNDING / (c * c).clamp(min=GRAZING_C ** 2)


def contributions(st, out, with_slack=False):
    """This step's score contributions [CH, B] from ``physics.step``'s
    output with ``want_score``; with `with_slack`, also their slack
    [CH, B] (float64, the module docstring)."""
    meta = st["meta"]
    C, N = meta["n_comps"], meta["n_nodes"]
    adv = out["advance"]
    B = adv.shape[0]
    ds = torch.zeros((C + N, B), dtype=adv.dtype, device=adv.device)
    slack = torch.zeros((C + N, B), dtype=torch.float64, device=adv.device)
    lanes = torch.arange(B, device=adv.device)
    cont = out["container"].long()
    if C:
        per_cm = SLACK_SPECTRAL * attenuation_scale(st) if with_slack else 0.0
        node_it = st["node_i"]
        K, comp0 = node_it[cont, T.NI_NCOMP], node_it[cont, T.NI_COMP0]
        cums = out["slot_vals"]
        moving = out["moving"]
        max_k = max(row[T.NI_NCOMP] for row in st["rows"]["node_i"])
        for k in range(max_k):
            here = moving & (k < K)
            a = cums[:, k] - cums[:, k - 1] if k > 0 else cums[:, 0]
            ds[(comp0 + k).long()[here], lanes[here]] = (-a * adv)[here]
            slack[(comp0 + k).long()[here], lanes[here]] = per_cm * adv[here].double()
        hit = out["absorbed"]
        ds[out["comp_id"].long()[hit], lanes[hit]] += 1.0
    dR1, dR2 = fresnel_dR(out["n1r"], out["n2r"], out["c_in"])
    r = out["refl_r"]
    refl = out["reflecting"]
    coin = out["fres_coin"] & (refl | out["transmitting"])
    branch = torch.where(refl, 1.0 / torch.clamp(r, min=1e-12),
                         -1.0 / torch.clamp(1.0 - r, min=1e-12))
    w1 = torch.nan_to_num(dR1 * branch)[coin]
    w2 = torch.nan_to_num(dR2 * branch)
    ds[C + cont[coin], lanes[coin]] = w1
    adj = coin & (out["adjacent"] >= 0)
    ds[C + out["adjacent"].long()[adj], lanes[adj]] = w2[adj]
    if not with_slack:
        return ds
    cond = conditioning(out)
    c = out["c_in"].double().clamp(min=GRAZING_C)
    cancel = torch.where(r.double() < FRESNEL_ROUNDING, 1.0 / (c * c * c), 0.0)
    floor = FRESNEL_ROUNDING * branch.double().abs() * (1.0 + cancel)
    slack[C + cont[coin], lanes[coin]] = floor[coin] + cond[coin] * w1.double().abs()
    slack[C + out["adjacent"].long()[adj], lanes[adj]] = floor[adj] \
        + cond[adj] * w2[adj].double().abs()
    return ds, slack


# Termination masks of ``physics.step`` and their fates; a later mask wins
# (the reference's order: EXIT, NONRADIATIVE, REACT, the two KILLs,
# NO_HIT, then the event budget's KILL).
FOLD = (
    ("exit_mask", physics.EV_EXIT),
    ("losing", physics.EV_NONRADIATIVE),
    ("reacting", physics.EV_REACT),
    ("kills", physics.EV_KILL),
    ("no_hit_term", physics.FATE_NO_HIT),
)


def fold(t, score, out, budget_kill=None, slack=None):
    """Add the score [CH, B] of every lane that terminated this step
    (`out`: ``physics.step``'s flags; `budget_kill`: lanes the event
    budget killed before it) into tallies `t` at its fate, in place:
    ``fate_scores`` [11, CH], the magnitudes into ``fate_abs``, the largest
    magnitude of each channel into ``score_max`` [CH], and with `slack`
    [CH, B] the lanes' slack into ``fate_slack``. Returns the folded lanes
    and their fates (int64 [F] each)."""
    term = torch.zeros_like(out["exit_mask"])
    fate = torch.zeros_like(out["container"])
    masks = [(out[name], f) for name, f in FOLD]
    if budget_kill is not None:
        masks.append((budget_kill, physics.EV_KILL))
    for mask, f in masks:
        term = term | mask
        fate = torch.where(mask, f, fate)
    idx = term.nonzero()[:, 0]
    if idx.numel():
        rows, at = score[:, idx].T.to(t["fate_scores"].dtype), fate[idx].long()
        t["fate_scores"].index_add_(0, at, rows)
        t["fate_abs"].index_add_(0, at, rows.abs())
        t["score_max"] = torch.maximum(t["score_max"], rows.abs().amax(0))
        if slack is not None:
            t["fate_slack"].index_add_(0, at, slack[:, idx].T.to(t["fate_slack"].dtype))
    return idx, fate[idx].long()
