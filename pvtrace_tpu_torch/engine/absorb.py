"""K15: the first-pass Beer–Lambert surrogate, the plain-PyTorch twin.

Port of ``_chord_fn`` and ``absorbed_fraction_fn`` (pvtrace_tpu/diff/
transport.py). A photon (world position, direction, wavelength) crosses
every absorbing node on a straight line; its optical depth is
``sum_n alpha_n(wav) * chord_n``, with ``alpha_n`` the node's summed
attenuation lerped on the spectral grid, and its absorbed weight is
``1 - exp(-c * depth)`` for the concentration scale ``c =
exp(log_concentration)``. The chord is the length of the ray's forward
part inside a box (slab intervals), a sphere (the quadratic) or a capped
z-cylinder (barrel interval intersected with the cap slab), by the JAX
formulas in float32.

``table`` lays the absorbing nodes out for the CUDA kernel
``pvt_absorbed`` (``kernels/csrc/diff.cuh``, the same arithmetic): per
node its world-to-local rows and geometry constants (``AF`` float32
columns; the constants the JAX function takes as python floats are
rounded to float32 here, as JAX rounds them where it uses them), its
geometry type, and its attenuation on the grid.
"""
import numpy as np
import torch

from pvtrace_tpu_torch.engine import compiler as comp

# Columns of table["node_f"]: world-to-local rows (12), then the geometry
# constants: box half-extents (3); sphere r^2; cylinder half-length,
# radius^2 and -half-length.
AF_W2L, AF_G, AF = 0, 12, 16
BIG = 1e30


def absorbing_nodes(compiled):
    """Nodes with at least one component (the JAX ``_absorbing_nodes``)."""
    nodes = [i for i in range(len(compiled.nodes)) if compiled.comp_count[i] > 0]
    if not nodes:
        raise ValueError("Scene has no absorbing node.")
    return nodes


def table(compiled, device="cpu"):
    """The absorbing nodes of `compiled` as tensors on `device`:
    ``node_f`` [A, AF] float32, ``node_i`` [A] int32 geometry types,
    ``alpha`` [A, L] float32, and ``meta`` (grid x0, dx and L)."""
    nodes = absorbing_nodes(compiled)
    node_f = np.zeros((len(nodes), AF), np.float32)
    node_i = np.zeros(len(nodes), np.int32)
    for row, node in enumerate(nodes):
        gtype = int(compiled.geom_type[node])
        if gtype not in (comp.GEOM_BOX, comp.GEOM_SPHERE, comp.GEOM_CYLINDER):
            raise NotImplementedError(f"chord for geometry type {gtype}")
        node_f[row, AF_W2L:AF_W2L + 12] = np.asarray(
            compiled.world_to_local[node], np.float32)[:3].ravel()
        gp = np.asarray(compiled.geom_params[node], np.float64)
        if gtype == comp.GEOM_BOX:
            g = 0.5 * gp[:3]
        elif gtype == comp.GEOM_SPHERE:
            g = [gp[0] * gp[0], 0.0, 0.0]
        else:
            g = [0.5 * gp[0], gp[1] * gp[1], -0.5 * gp[0]]
        node_f[row, AF_G:AF_G + 3] = np.asarray(g, np.float64).astype(np.float32)
        node_i[row] = gtype
    alpha = np.stack([np.asarray(compiled.node_alpha[n], np.float32) for n in nodes])
    return {
        "node_f": torch.as_tensor(node_f, device=device),
        "node_i": torch.as_tensor(node_i, device=device),
        "alpha": torch.as_tensor(alpha, device=device),
        "meta": {"x0": float(compiled.grid_x0), "dx": float(compiled.grid_dx),
                 "L": int(compiled.grid_n)},
    }


def chord(gtype, g, o, d):
    """Straight-line chord of rays (local origins `o`, directions `d`:
    [P, 3]) through a node of type `gtype` with float32 constants `g`."""
    if gtype == comp.GEOM_BOX:
        half = g[:3]
        safe = torch.where(torch.abs(d) < 1e-20, 1e-20, d)
        t1 = (-half - o) / safe
        t2 = (half - o) / safe
        tmin = torch.minimum(t1, t2).amax(dim=-1)
        tmax = torch.maximum(t1, t2).amin(dim=-1)
    elif gtype == comp.GEOM_SPHERE:
        b = 2.0 * (d * o).sum(dim=-1)
        cq = (o * o).sum(dim=-1) - g[0]
        disc = b * b - 4.0 * cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tmin = (-b - sq) / 2.0
        tmax = torch.where(disc >= 0, (-b + sq) / 2.0, -1.0)
    else:
        half, r2, neg_half = g[0], g[1], g[2]
        ox, oy, oz = o.unbind(-1)
        dx, dy, dz = d.unbind(-1)
        a = dx * dx + dy * dy
        b = 2.0 * (ox * dx + oy * dy)
        cq = ox * ox + oy * oy - r2
        disc = b * b - 4.0 * a * cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        a_safe = torch.clamp(a, min=1e-20)
        axial = a < 1e-20
        in_barrel = cq < 0.0
        bar_lo = torch.where(axial, torch.where(in_barrel, -BIG, BIG), (-b - sq) / (2 * a_safe))
        bar_hi = torch.where(axial, torch.where(in_barrel, BIG, -BIG), (-b + sq) / (2 * a_safe))
        bar_hi = torch.where(~axial & (disc < 0.0), -BIG, bar_hi)
        dz_safe = torch.where(torch.abs(dz) < 1e-20, 1e-20, dz)
        z1 = (neg_half - oz) / dz_safe
        z2 = (half - oz) / dz_safe
        flat = torch.abs(dz) < 1e-20
        in_slab = torch.abs(oz) < half
        cap_lo = torch.where(flat, torch.where(in_slab, -BIG, BIG), torch.minimum(z1, z2))
        cap_hi = torch.where(flat, torch.where(in_slab, BIG, -BIG), torch.maximum(z1, z2))
        tmin = torch.maximum(bar_lo, cap_lo)
        tmax = torch.minimum(bar_hi, cap_hi)
    inside = torch.clamp(tmax - torch.clamp(tmin, min=0.0), min=0.0)
    return torch.where(tmax > 0.0, inside, 0.0)


def depth(tab, pos, direction, wav):
    """Optical depth at concentration scale 1 of photons [P]: the sum over
    the absorbing nodes of the lerped attenuation times the chord."""
    m = tab["meta"]
    posf = torch.clamp((wav - m["x0"]) / m["dx"], 0.0, m["L"] - 1.0)
    i0 = torch.clamp(posf.to(torch.int32), 0, m["L"] - 2).long()
    frac = posf - i0.to(posf.dtype)
    total = torch.zeros_like(wav)
    for row, gtype in enumerate(tab["node_i"].tolist()):
        f = tab["node_f"][row]
        R = f[AF_W2L:AF_W2L + 12].reshape(3, 4)
        o = pos @ R[:, :3].T + R[:, 3]
        d = direction @ R[:, :3].T
        alpha_row = tab["alpha"][row]
        alpha = alpha_row[i0] * (1 - frac) + alpha_row[i0 + 1] * frac
        total = total + alpha * chord(gtype, f[AF_G:AF_G + 3], o, d)
    return total


def weight(c, dep):
    """Absorbed weights ``1 - exp(-c * depth)``."""
    return 1.0 - torch.exp(-c * dep)


def grad_log_concentration(c, dep, grad_w):
    """``sum_i grad_w[i] * dw_i / d log c = sum_i grad_w[i] * c * depth_i
    * exp(-c * depth_i)``: the backward pass in ``log_concentration``."""
    return (grad_w * (c * dep * torch.exp(-c * dep))).sum()
