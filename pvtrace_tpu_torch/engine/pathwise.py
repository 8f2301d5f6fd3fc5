"""K13: pathwise (hybrid) gradient channels, the eager twin.

Port of the pathwise block of ``body`` (pvtrace_tpu/engine/tracer.py):
the ``jax.linearize`` of ``physics_core`` in the channels' parameters and
the seven continuous photon coordinates, and the hybrid channels built
on it. A channel is ``("n", k)``, the refractive index of node k, or
``("geom", k, j)``, geometry parameter j of node k (a box's size along
axis j, a sphere's radius, a cylinder's length or radius):
``diff.transport.resolve_pathwise_params`` makes them from the user's
specs.

Each lane carries per channel the tangent of (px, py, pz, dx, dy, dz,
wav) in the channel's parameter, zero at emission and on refill. A step
is linearized with ``torch.autograd.forward_ad``, once per channel, with
the uniforms held fixed (``step_jvp``): that gives the new coordinates'
tangents and those of the nearest hit's distance ``t0``, the container's
attenuation ``alpha`` and the reflectivity ``refl_r``. Where the
reference clips or takes an absolute value, ``physics.step`` uses
``engine/ties.py``, which has JAX's derivatives at the bounds.

``contributions`` then adds per channel, as the reference does:

* survival, on lanes that moved to a boundary: ``-d(alpha t0)``;
* collision, on absorbed lanes with a finite ``t0``:
  ``e^{-a t0} d(alpha t0) / max(-expm1(-a t0), 1e-12)``;
* the Fresnel coin, with the full dR: ``nan_to_num(d refl_r * branch)``,
  ``branch`` as the K12 channels' (``engine/score.py``);

and moves the absorption point with the boundary under the
truncated-density reparameterization: on collision lanes the position
tangent gains ``dt0 * rep_fac`` along the pre-step direction. Every
tangent is taken through ``nan_to_num`` (an infinite slope, from a square
root at 0, becomes the dtype's largest value, as in the reference).

The channels follow the K12 channels in a photon's score row (``n_comps
+ n_nodes + ci``), so the fold and the recorders carry them unchanged.
Beside each contribution the twin gives its slack for the on-card checks
(``kernels/check.py``): the terms' magnitudes times PATH_ROUNDING plus
their conditioning: on a Fresnel coin what ``score.conditioning`` gives
the K12 term (the critical angle, 1/P, grazing incidence), on another lane
that moved the grazing part alone, at the incidence cosine of the nearest
hit (``grazing``). The share is
capped at SLACK_CAP (2.5 %, the grazing cap of K12); a lane past it is
left out of the lane-by-lane check and counted there, and a photon past it
may part from the twin in the photon-by-photon check, which counts it.
"""
import torch
import torch.autograd.forward_ad as fwAD

from pvtrace_tpu_torch.engine import physics, rng
from pvtrace_tpu_torch.engine import score as score_ch

COORDS = ("px", "py", "pz", "dx", "dy", "dz", "wav")
# The linear map's outputs: the new coordinates, then t0, alpha, refl_r.
OUTPUTS = COORDS + ("t0", "alpha", "refl_r")
PATH_ROUNDING = 1e-5
SLACK_CAP = 0.025


def seeded_params(st, spec):
    """``physics.step``'s params with a unit tangent in channel `spec`
    (inside a ``forward_ad.dual_level``)."""
    params = physics.node_params(st)
    nidx = params["nidx"]
    if spec[0] == "n":
        seed = torch.zeros_like(nidx)
        seed[int(spec[1])] = 1.0
        params["nidx"] = fwAD.make_dual(nidx, seed)
    else:
        k, j = int(spec[1]), int(spec[2])
        row = list(params["gp"][k])
        value = torch.tensor(row[j], dtype=nidx.dtype, device=nidx.device)
        row[j] = fwAD.make_dual(value, torch.ones_like(value))
        params["gp"][k] = row
    return params


def step_jvp(st, s, u, specs, tang, maxsteps, emit_method, maxpathlength=float("inf"),
             want_extras=False):
    """One physics step of lanes `s` (``count`` already incremented) with
    uniforms `u`, linearized: (out, jv), ``physics.step``'s output with
    ``want_score`` (and `want_extras`), and jv[name] [C, B], the raw
    tangent of each of OUTPUTS per channel, the lanes' tangents `tang`
    [C, 7, B] and the channel's unit tangent pushed through the step."""
    out, jv = None, {name: [] for name in OUTPUTS}
    for ci, spec in enumerate(specs):
        with fwAD.dual_level():
            sd = dict(s)
            for k, name in enumerate(COORDS):
                sd[name] = fwAD.make_dual(s[name], tang[ci, k])
            res = physics.step(st, sd, u, maxsteps, emit_method, maxpathlength, want_extras,
                               True, seeded_params(st, spec))
            for name in OUTPUTS:
                primal, tangent = fwAD.unpack_dual(res[name])
                jv[name].append(torch.zeros_like(primal) if tangent is None else tangent)
            if out is None:
                out = {k: fwAD.unpack_dual(v).primal if isinstance(v, torch.Tensor) else v
                       for k, v in res.items()}
    return out, {name: torch.stack(v) for name, v in jv.items()}


def step_state(st, s, specs, maxsteps, emit_method, maxpathlength=float("inf"), alive=None,
               want_extras=False):
    """``tracer.step_state`` with the channels' tangents ``s["tang"]``:
    (out, jv) as ``step_jvp``."""
    count = s["count"] + s["alive"].to(torch.int32)
    u = rng.draw8(s["k0"], s["k1"], count.long(), s["px"].dtype)
    lanes = dict(s, count=count, alive=s["alive"] if alive is None else alive)
    out, jv = step_jvp(st, lanes, u, specs, s["tang"], maxsteps, emit_method, maxpathlength,
                       want_extras)
    out["k0"], out["k1"] = s["k0"], s["k1"]
    return out, jv


def grazing(out):
    """Per lane, the relative error (float64) that rounding near a grazing
    hit gives t0's tangent: ``score.GRAZING_ROUNDING / c_hit^2``, capped
    at ``score.GRAZING_C``; 0 on lanes that did not move."""
    c = out["c_hit"].double()
    return torch.where(out["moving"], score_ch.GRAZING_ROUNDING
                       / (c * c).clamp(min=score_ch.GRAZING_C ** 2), 0.0)


def contributions(out, jv, d_pre, with_slack=False):
    """This step's pathwise contributions [C, B] and the lanes' new
    tangents [C, 7, B] from ``step_jvp``'s (out, jv) and the pre-step
    directions `d_pre` (dx, dy, dz); with `with_slack`, also the
    contributions' slack [C, B] (float64, the module docstring)."""
    t0, alpha, adv = out["t0"], out["alpha"], out["advance"]
    surv = out["moving"] & ~out["absorbed"]
    finite_t0 = torch.isfinite(t0)
    t0_fin = torch.where(finite_t0, t0, 0.0)
    a_t0 = alpha * t0_fin
    coll_denom = torch.clamp(-torch.expm1(-a_t0), min=1e-12)
    coll = out["absorbed"] & finite_t0
    rep_fac = torch.exp(torch.clamp(alpha * (adv - t0_fin), max=0.0)) \
        * (-torch.expm1(-alpha * adv)) / coll_denom
    r, refl = out["refl_r"], out["reflecting"]
    coin = out["fres_coin"] & (refl | out["transmitting"])
    branch = torch.where(refl, 1.0 / torch.clamp(r, min=1e-12),
                         -1.0 / torch.clamp(1.0 - r, min=1e-12))
    dt0 = torch.nan_to_num(jv["t0"])
    d_at0 = torch.nan_to_num(jv["alpha"]) * t0_fin + alpha * dt0
    survive = torch.where(surv, -d_at0, 0.0)
    collide = torch.where(coll, torch.exp(-a_t0) * d_at0 / coll_denom, 0.0)
    fresnel = torch.where(coin, torch.nan_to_num(jv["refl_r"] * branch), 0.0)
    ds = survive + collide + fresnel
    shift = torch.where(coll, dt0 * rep_fac, 0.0)
    tang = torch.stack([torch.nan_to_num(jv[name]) for name in COORDS], 1)
    tang[:, :3] += shift[:, None, :] * torch.stack(d_pre)[None]
    if not with_slack:
        return ds, tang
    cond = torch.where(coin, score_ch.conditioning(out), grazing(out))
    slack = (survive.double().abs() + collide.double().abs() + fresnel.double().abs()) \
        * torch.clamp(PATH_ROUNDING + cond, max=SLACK_CAP)
    return ds, tang, slack
