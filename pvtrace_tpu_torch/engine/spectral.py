"""K5a or K5b: the spectral lookups of a step and of emission, eager twin.

K5b is the exact table lerp: port of ``spec_slots_gather`` and
``icdf_gather`` (pvtrace_tpu/engine/tracer.py ``_run``) and of the
lamp-spectrum ICDF lerp in ``_device_emit_flat``, the JAX package's
``PVTRACE_TPU_NO_CHEB`` path. K5a is the piecewise-Chebyshev surrogate
(``engine/chebyshev.py``). ``slots``, ``emission_icdf`` and
``light_icdf`` take K5a where ``scene_tensors`` says the JAX package
would (``meta["cheb_spec"]``, ``"cheb_icdf"``, ``"cheb_light"``).
"""
import torch

from pvtrace_tpu_torch.engine import chebyshev


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


def slots(st, container, i0, frac):
    """The spectral slots of each lane's container, K5a or K5b: [B, W]."""
    if st["meta"]["cheb_spec"]:
        return chebyshev.spec_slots(st, container, i0, frac)
    return spec_slots(st["spec_pack"], container, i0.long(), frac, st["meta"]["grid_n"])


def emission_icdf(st, lum, gamma):
    """Emission wavelengths of luminophore rows `lum` (int64) at `gamma`."""
    if st["meta"]["cheb_icdf"]:
        return chebyshev.icdf(st, lum, gamma)
    M = st["meta"]["icdf_n"]
    return lerp_pairs(st["ems_icdf_pairs"], lum * M, M, gamma)


def light_icdf(st, row, u):
    """Lamp wavelengths of light-spectrum row `row` (an int) at uniforms `u`."""
    if st["meta"]["cheb_light"]:
        return chebyshev.light_icdf(st, row, u)
    M = st["meta"]["icdf_n"]
    return lerp_pairs(st["light_icdf_pairs"], row * M, M, u)
