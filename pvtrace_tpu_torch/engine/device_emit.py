"""K2: device emission, the eager twin.

Port of ``_device_emit_flat`` (pvtrace_tpu/engine/tracer.py). Each
photon takes the light ``pid % n_lights``, draws six uniforms from its
emission stream and samples a wavelength (constant, or a lerp in
``light_icdf_pairs``), a local position (point, rect, circle, cube) and
a local direction (default, cone, isotropic, Lambertian, HG), then
applies the light's baked local-to-world matrix. A spectral light's
wavelength is its Chebyshev fit (K5a) or the table lerp (K5b), by the
JAX package's rule (``spectral.light_icdf``). A scene whose lights the
compiler could not lower has no light rows: its photons come from a
host bundle (``engine/emit.py``), and emission here refuses it.
"""
import math

import torch

from pvtrace_tpu_torch.engine import rng, spectral
from pvtrace_tpu_torch.engine import tables as T
from pvtrace_tpu_torch.engine.compiler import CompiledScene as C


NO_DEVICE_LIGHTS = (
    "the scene's lights were not lowered to device samplers (host emission): "
    "trace a bundle from engine.emit.emit_bundle"
)


def emit(st, keys, pids):
    """Initial (pos, dir, wav) of photons `pids` with keys `keys`.

    `st` is the dict of ``tables.scene_tensors``. Returns ((px, py, pz),
    (dx, dy, dz), wav) in the scene dtype."""
    f = st["node_f"].dtype
    pk0, pk1 = keys
    u = rng.draw(pk0, pk1, torch.zeros_like(pids), 16, 3, f)
    light_f, light_i = st["rows"]["light_f"], st["rows"]["light_i"]
    n_lights = len(light_i)
    if n_lights == 0:
        raise ValueError(NO_DEVICE_LIGHTS)
    light_id = pids % n_lights
    zeros = torch.zeros_like(u[0])
    out = None
    for li in range(n_lights):
        lf, (wkind, pkind, dkind, row) = light_f[li], light_i[li]
        if wkind == C.WAV_CONST:
            w_l = torch.full_like(zeros, lf[T.LF_WAV])
        else:
            w_l = spectral.light_icdf(st, row, u[0])
        a, b, c = lf[T.LF_POS:T.LF_POS + 3]
        if pkind == C.POS_DEFAULT:
            lx, ly, lz = zeros, zeros, zeros
        elif pkind == C.POS_RECT:
            lx = (2.0 * u[1] - 1.0) * a
            ly = (2.0 * u[2] - 1.0) * b
            lz = zeros
        elif pkind == C.POS_CIRCLE:
            r = torch.sqrt(u[1]) * a
            ang = 2.0 * math.pi * u[2]
            lx, ly, lz = r * torch.cos(ang), r * torch.sin(ang), zeros
        else:
            lx = (2.0 * u[1] - 1.0) * a
            ly = (2.0 * u[2] - 1.0) * b
            lz = (2.0 * u[3] - 1.0) * c
        phi = 2.0 * math.pi * u[5]
        if dkind == C.DIR_DEFAULT:
            ldx, ldy, ldz = zeros, zeros, zeros + 1.0
        else:
            if dkind == C.DIR_CONE:
                s = torch.sqrt(u[4]) * lf[T.LF_SIN_DIR]
                mu = torch.sqrt(torch.clamp(1.0 - s * s, min=0.0))
                s_t = s
            elif dkind == C.DIR_ISOTROPIC:
                mu = 2.0 * u[4] - 1.0
                s_t = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
            elif dkind == C.DIR_LAMBERTIAN:
                s_t = torch.sqrt(u[4])
                mu = torch.sqrt(torch.clamp(1.0 - u[4], min=0.0))
            else:
                mu = hg_mu(lf[T.LF_DIR], 2.0 * u[4] - 1.0)
                s_t = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
            ldx, ldy, ldz = s_t * torch.cos(phi), s_t * torch.sin(phi), mu
        m = lf[T.LF_MAT:T.LF_MAT + 12]
        world = (
            m[0] * lx + m[1] * ly + m[2] * lz + m[3],
            m[4] * lx + m[5] * ly + m[6] * lz + m[7],
            m[8] * lx + m[9] * ly + m[10] * lz + m[11],
            m[0] * ldx + m[1] * ldy + m[2] * ldz,
            m[4] * ldx + m[5] * ldy + m[6] * ldz,
            m[8] * ldx + m[9] * ldy + m[10] * ldz,
            w_l,
        )
        if out is None:
            out = world
        else:
            here = light_id == li
            out = tuple(torch.where(here, w, o) for w, o in zip(world, out))
    px, py, pz, dx, dy, dz, wav = out
    return (px, py, pz), (dx, dy, dz), wav


def hg_mu(g, s):
    """Henyey-Greenstein cosine for s = 2u - 1 (|g| >= 1e-12)."""
    mu = (1.0 + g * g - ((1.0 - g * g) / (1.0 + g * s)) ** 2) / (2.0 * g)
    return torch.clamp(mu, -1.0, 1.0)
