"""K5a: piecewise-Chebyshev spectral surrogates, the eager twin.

Port of ``_clenshaw`` and ``_eval_fit``, ``spec_slots_cheb`` and
``icdf_cheb``, and the lamp-spectrum fit in ``_device_emit_flat``
(pvtrace_tpu/engine/tracer.py), reading the flat ``cheb_*`` tensors of
``tables.scene_tensors``. Each lane evaluates its own fit at its own t.

The JAX function evaluates every segment of a piecewise fit and selects
with masks: the first segment takes ``t < b``, the last ``t >= a``, a
middle one ``a <= t < b``, a later match overrides an earlier one, and
any log segment that matches wins over the linear ones. Here each lane
finds that one segment by the same masks and evaluates only it: one
Clenshaw chain of the segment's degree on ``clip((t - a) * 2/(b - a) - 1,
-1, 1)`` (global fits take t unmapped), then ``exp(v) - off`` on a log
segment. The CUDA kernel's ``cheb_eval`` does the same per thread.
"""
import torch

from pvtrace_tpu_torch.engine import tables as T
from pvtrace_tpu_torch.engine import ties


def _segment(st, fit, t):
    """Index of each lane's segment by the reference's masks (-1: none)."""
    fi = st["cheb_fit_i"][fit]
    nseg, seg0 = fi[:, T.FI_NSEG, None], fi[:, T.FI_SEG0, None]
    seg_f, seg_i = st["cheb_seg_f"], st["cheb_seg_i"]
    j = torch.arange(st["meta"]["cheb_max_seg"], device=t.device, dtype=fi.dtype)
    s = (seg0 + j).clamp(max=seg_f.shape[0] - 1).long()  # [B, max_seg]
    a, b, tt = seg_f[s, T.SF_A], seg_f[s, T.SF_B], t[:, None]
    m = torch.where(j == nseg - 1, tt >= a, (tt >= a) & (tt < b))
    m = torch.where(j == 0, (tt < b) | (nseg == 1), m) & (j < nseg)
    is_log = seg_i[s, T.SI_KIND] == T.FIT_LOG
    last_log = torch.where(m & is_log, j, -1).amax(1)
    last_lin = torch.where(m & ~is_log, j, -1).amax(1)
    j_sel = torch.where(last_log >= 0, last_log, last_lin)
    return torch.where(j_sel >= 0, seg0[:, 0] + j_sel, -1).long()


def eval_fits(st, fit, t):
    """Values at `t` of the fits `fit` (int64 fit indices, per lane)."""
    s = _segment(st, fit, t)
    found = s >= 0
    s = s.clamp(min=0)
    seg_f, seg_i, coef = st["cheb_seg_f"], st["cheb_seg_i"], st["cheb_coef"]
    ts = torch.where(
        st["cheb_fit_i"][fit, T.FI_KIND] == T.FIT_PW,
        ties.clip((t - seg_f[s, T.SF_A]) * seg_f[s, T.SF_SCALE] - 1.0, -1.0, 1.0),
        t,
    )
    deg, c0 = seg_i[s, T.SI_DEG], seg_i[s, T.SI_COEF0].long()
    b1 = torch.zeros_like(t)
    b2 = b1
    top = int(deg.max()) if deg.numel() else 0
    for k in range(top, 0, -1):
        c = coef[(c0 + k).clamp(max=coef.shape[0] - 1)]
        on = k <= deg
        b1, b2 = torch.where(on, 2.0 * ts * b1 - b2 + c, b1), torch.where(on, b1, b2)
    v = ts * b1 - b2 + coef[c0]
    v = torch.where(seg_i[s, T.SI_KIND] == T.FIT_LOG, torch.exp(v) - st["cheb_fit_f"][fit], v)
    return torch.where(found, v, 0.0)


def spec_slots(st, container, i0, frac):
    """All W spectral slot values of each lane's container: [B, W].

    A slot is the sum of its fits (a cumulative slot sums its components'
    fits) at ``t = (i0 + frac) * 2 / (L - 1) - 1``. Every component and
    slot fit is evaluated once per lane, as the JAX function shares one
    evaluation of a component between the slots that sum it."""
    meta = st["meta"]
    W, F = meta["pack_width"], meta["cheb_icdf0"]
    t = (i0.to(frac.dtype) + frac) * (2.0 / (meta["grid_n"] - 1)) - 1.0
    B = t.shape[0]
    if F == 0:
        return torch.zeros((B, W), dtype=t.dtype, device=t.device)
    fits = torch.arange(F, device=t.device).repeat(B)
    vals = eval_fits(st, fits, t.repeat_interleave(F)).reshape(B, F)
    slot, ref = st["cheb_slot"], st["cheb_ref"]
    out = []
    for w in range(W):
        first, count = slot[container * W + w].unbind(1)
        acc = torch.zeros_like(t)
        for q in range(meta["cheb_max_refs"]):
            fit = ref[(first + q).clamp(max=ref.shape[0] - 1)].long()
            acc = torch.where(q < count, acc + vals.gather(1, fit[:, None])[:, 0], acc)
        out.append(acc)
    return torch.stack(out, 1)


def icdf(st, lum, gamma):
    """Emission wavelengths of luminophore rows `lum` at probabilities
    `gamma`."""
    return eval_fits(st, st["meta"]["cheb_icdf0"] + lum, 2.0 * gamma - 1.0)


def light_icdf(st, row, u):
    """Lamp wavelengths of light-spectrum row `row` (an int) at uniforms `u`."""
    fit = torch.full_like(u, st["meta"]["cheb_light0"] + row, dtype=torch.int64)
    return eval_fits(st, fit, 2.0 * u - 1.0)
