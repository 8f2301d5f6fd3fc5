"""K3, K4 and K10 per geometry: forward hits and outward normals, the
eager twin.

Port of ``_intersect_node_static``, ``_local_normal_static`` and
``_mesh_nearest_two`` (pvtrace_tpu/engine/tracer.py) for boxes, spheres,
capped cylinders and triangle meshes, in the node's local frame.
Parameters are python floats read from the node record
(``tables.NF_GP``) or 0-dim tensors, triangles rows of ``tables.TRI_F``;
rays are component triples of tensors. The box's slab test takes its
minima and maxima from ``engine/ties.py`` (the reference's tangents).
"""
import torch

from pvtrace_tpu_torch.engine import ties
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
            lo = torch.where(par, -_INF, ties.minimum(t1, t2))
            hi = torch.where(par, _INF, ties.maximum(t1, t2))
            miss = miss | (par & ((oo < -h) | (oo > h)))
            tmin = ties.maximum(tmin, lo)
            tmax = ties.minimum(tmax, hi)
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


def mesh_nearest_two(tri, o, d, eps):
    """Möller–Trumbore over the triangles `tri` ([T, TRI_F] rows v0, e1,
    e2, face normal): the nearest two forward hits (t1, t2; inf where
    there are fewer), the number of forward hits and the face normal of
    the nearest (0, 0, 1 where there is none).

    The JAX function's tolerances: ``|det| > 1e-14``, ``u, v >= -1e-12``,
    ``u + v <= 1 + 1e-12``, ``t > eps``. It keeps the nearest two by
    strict ``<`` in triangle order, so a tie keeps the earlier triangle
    (its normal included), and counts every hit: there is no dedup of a
    hit on an edge two triangles share. The triangles are a second axis
    of every product, each element computed as the JAX function computes
    it."""
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    a0, a1, a2, e10, e11, e12, e20, e21, e22 = (tri[None, :, k] for k in range(9))
    pvx = dy * e22 - dz * e21
    pvy = dz * e20 - dx * e22
    pvz = dx * e21 - dy * e20
    det = e10 * pvx + e11 * pvy + e12 * pvz
    ok = torch.abs(det) > 1e-14
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvx = ox - a0
    tvy = oy - a1
    tvz = oz - a2
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e12 - tvz * e11
    qvy = tvz * e10 - tvx * e12
    qvz = tvx * e11 - tvy * e10
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    th = (e20 * qvx + e21 * qvy + e22 * qvz) * inv
    hit = ok & (u >= -1e-12) & (v >= -1e-12) & (u + v <= 1.0 + 1e-12) & (th > eps)
    tv = torch.where(hit, th, _INF)
    t1, first = tv.min(1)  # the first of equal minima
    t2 = tv.scatter(1, first[:, None], _INF).min(1).values
    found = t1 < _INF
    normal = tuple(
        torch.where(found, tri[first, 9 + k], 1.0 if k == 2 else 0.0) for k in range(3)
    )
    return t1, t2, hit.sum(1, dtype=torch.int32), normal
