"""K3 and K4 per geometry: forward hits and outward normals, the eager twin.

Port of ``_intersect_node_static`` and ``_local_normal_static``
(pvtrace_tpu/engine/tracer.py) for boxes, spheres and capped cylinders,
in the node's local frame. Parameters are python floats read from the
node record (``tables.NF_GP``); rays are component triples of tensors.
"""
import torch

from pvtrace_tpu_torch.engine.compiler import GEOM_BOX, GEOM_SPHERE

_INF = float("inf")


def intersect(gtype, params, o, d, eps):
    """Forward-hit candidates [(t, valid), ...] in candidate order: box
    (tmin, tmax), sphere (near, far), cylinder (barrel near, barrel far,
    cap -z, cap +z)."""
    ox, oy, oz = o
    dx, dy, dz = d
    if gtype == GEOM_BOX:
        tmin = torch.full_like(ox, -_INF)
        tmax = torch.full_like(ox, _INF)
        miss = torch.zeros_like(ox, dtype=torch.bool)
        for oo, dd, size in ((ox, dx, params[0]), (oy, dy, params[1]), (oz, dz, params[2])):
            h = 0.5 * size
            par = torch.abs(dd) < 1e-30
            inv = 1.0 / torch.where(par, 1.0, dd)
            t1 = (-h - oo) * inv
            t2 = (h - oo) * inv
            lo = torch.where(par, -_INF, torch.minimum(t1, t2))
            hi = torch.where(par, _INF, torch.maximum(t1, t2))
            miss = miss | (par & ((oo < -h) | (oo > h)))
            tmin = torch.maximum(tmin, lo)
            tmax = torch.minimum(tmax, hi)
        ok = (tmax >= tmin) & ~miss
        return [(tmin, ok & (tmin > eps)), (tmax, ok & (tmax > eps))]
    if gtype == GEOM_SPHERE:
        radius = params[0]
        a = dx * dx + dy * dy + dz * dz
        b = 2.0 * (dx * ox + dy * oy + dz * oz)
        c = ox * ox + oy * oy + oz * oz - radius * radius
        disc = b * b - 4.0 * a * c
        ok = disc >= 0.0
        sq = torch.sqrt(torch.where(ok, disc, 0.0))
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        return [(t1, ok & (t1 > eps)), (t2, ok & (t2 > eps))]
    length, radius = params[0], params[1]
    half = 0.5 * length
    a = dx * dx + dy * dy
    hasb = a > 1e-30
    sa = torch.where(hasb, a, 1.0)
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - 4.0 * a * c
    ok = hasb & (disc >= 0.0)
    sq = torch.sqrt(torch.where(disc >= 0.0, disc, 0.0))
    tb1 = (-b - sq) / (2.0 * sa)
    tb2 = (-b + sq) / (2.0 * sa)
    zb1 = oz + tb1 * dz
    zb2 = oz + tb2 * dz
    out = [
        (tb1, ok & (zb1 > -half) & (zb1 < half) & (tb1 > eps)),
        (tb2, ok & (zb2 > -half) & (zb2 < half) & (tb2 > eps)),
    ]
    hasc = torch.abs(dz) > 1e-30
    sdz = torch.where(hasc, dz, 1.0)
    for zcap in (-half, half):
        t = (zcap - oz) / sdz
        r2 = (ox + t * dx) ** 2 + (oy + t * dy) ** 2
        out.append((t, hasc & (r2 <= radius * radius) & (t > eps)))
    return out


def local_normal(gtype, params, p):
    """Outward local normal at local point `p`; the box takes the first
    face of least distance in the order -x, +x, -y, +y, -z, +z."""
    px, py, pz = p
    if gtype == GEOM_BOX:
        hx, hy, hz = 0.5 * params[0], 0.5 * params[1], 0.5 * params[2]
        faces = (
            (torch.abs(px + hx), (-1.0, 0.0, 0.0)),
            (torch.abs(px - hx), (1.0, 0.0, 0.0)),
            (torch.abs(py + hy), (0.0, -1.0, 0.0)),
            (torch.abs(py - hy), (0.0, 1.0, 0.0)),
            (torch.abs(pz + hz), (0.0, 0.0, -1.0)),
            (torch.abs(pz - hz), (0.0, 0.0, 1.0)),
        )
        best = faces[0][0]
        nx, ny, nz = (torch.full_like(px, v) for v in faces[0][1])
        for dist, (vx, vy, vz) in faces[1:]:
            closer = dist < best
            nx = torch.where(closer, vx, nx)
            ny = torch.where(closer, vy, ny)
            nz = torch.where(closer, vz, nz)
            best = torch.minimum(best, dist)
        return nx, ny, nz
    if gtype == GEOM_SPHERE:
        mag = torch.sqrt(px * px + py * py + pz * pz)
        mag = torch.where(mag == 0.0, 1.0, mag)
        return px / mag, py / mag, pz / mag
    half = 0.5 * params[0]
    atol = 1e-8 + 1e-5 * abs(half)
    bottom = torch.abs(pz + half) <= atol
    top = torch.abs(pz - half) <= atol
    cap = bottom | top
    r = torch.sqrt(px * px + py * py)
    sr = torch.where(r == 0.0, 1.0, r)
    nx = torch.where(cap, 0.0, px / sr)
    ny = torch.where(cap, 0.0, py / sr)
    nz = torch.where(bottom, -1.0, torch.where(top, 1.0, torch.zeros_like(pz)))
    return nx, ny, nz
