"""K5b: exact spectral lookups by linear interpolation, the eager twin.

Port of ``spec_slots_gather`` and ``icdf_gather`` (pvtrace_tpu/engine/
tracer.py ``_run``) and of the lamp-spectrum ICDF lerp in
``_device_emit_flat``: the JAX package's ``PVTRACE_TPU_NO_CHEB`` path.
The piecewise-Chebyshev surrogates (K5a) are not ported yet.
"""
import torch


def grid_index(wav, x0, dx, L):
    """(i0, frac) of wavelengths on the uniform grid: i0 truncates toward
    zero and is clipped to [0, L-2]; frac is clipped to [0, 1]. The float
    is clamped before the integer cast (the same index for every finite
    value, and no out-of-range cast)."""
    posf = (wav - x0) / dx
    i0 = torch.clamp(posf, 0, L - 2).to(torch.int32)
    frac = torch.clamp(posf - i0.to(wav.dtype), 0.0, 1.0)
    return i0, frac


def spec_slots(spec_pack, container, i0, frac, L):
    """All W slot values of each lane's container row: [B, W]."""
    N = spec_pack.shape[0] // L
    row = torch.clamp(container, 0, N - 1) * L + i0
    packed = spec_pack[row]
    lo, hi = packed[:, 0::2], packed[:, 1::2]
    return lo + frac[:, None] * (hi - lo)


def lerp_pairs(pairs, base, M, gamma):
    """Inverse-CDF lerp in rows [base, base + M) of a pairs table at
    probabilities `gamma`; the fraction is not clipped. `base` may be an
    int or a tensor of per-lane row offsets."""
    gposf = gamma * (M - 1)
    j0 = torch.clamp(gposf, 0, M - 2).to(torch.int32)
    gfrac = gposf - j0.to(gamma.dtype)
    prow = pairs[base + j0]
    return prow[:, 0] + gfrac * (prow[:, 1] - prow[:, 0])
