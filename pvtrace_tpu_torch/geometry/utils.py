"""Geometry helper math for the host-side (numpy) API and oracle tracer.

Parity: reference ``pvtrace/geometry/utils.py`` — EPS semantics, analytic
AABB/cylinder intersections, vector helpers. Implemented from scratch with
exact analytic forms (the reference routes boxes through trimesh; we do
not need that detour because the AABB solve is closed-form).
"""
import numpy as np

# Absolute tolerance for "on surface" / "zero distance" comparisons in the
# float64 host path (reference geometry/utils.py:12 uses eps*1000).
EPS_ZERO = np.finfo(float).eps * 1000


def close_to_zero(value) -> bool:
    return bool(np.all(np.absolute(value) < EPS_ZERO))


def points_equal(point1, point2) -> bool:
    return close_to_zero(distance_between(point1, point2))


def floats_close(a, b) -> bool:
    return close_to_zero(a - b)


def allinrange(x, x_range) -> bool:
    """True when every element of `x` lies inside [x_range[0], x_range[1]]."""
    x = np.atleast_1d(np.asarray(x, dtype=float))
    return not np.any((x < x_range[0]) | (x > x_range[1]))


def flip(vector):
    return -np.asarray(vector)


def magnitude(vector):
    v = np.asarray(vector, dtype=float)
    return float(np.sqrt(v @ v))


def norm(vector):
    v = np.asarray(vector, dtype=float)
    return v / np.linalg.norm(v)


def angle_between(normal, vector) -> float:
    normal = np.asarray(normal, dtype=float)
    vector = np.asarray(vector, dtype=float)
    if np.allclose(normal, vector):
        return 0.0
    if np.allclose(-normal, vector):
        return float(np.pi)
    return float(np.arccos(np.clip(np.dot(normal, vector), -1.0, 1.0)))


def smallest_angle_between(normal, vector) -> float:
    rads = angle_between(normal, vector)
    return float(np.arctan2(np.sin(rads), np.cos(rads)))


def distance_between(point1, point2) -> float:
    return float(np.linalg.norm(np.asarray(point1, dtype=float) - np.asarray(point2)))


def intersection_point_is_ahead(ray_position, ray_direction, intersection_point):
    """True when the point lies further along the ray than its origin."""
    d = np.asarray(ray_direction, dtype=float)
    return (d @ np.asarray(intersection_point) - d @ np.asarray(ray_position)) > EPS_ZERO


def on_aabb_surface(size, point, centre=(0.0, 0.0, 0.0), atol=EPS_ZERO):
    """Surface test for an axis-aligned box.

    Returns (bool, surface-index list); indices order is
    (xmin, xmax, ymin, ymax, zmin, zmax), matching the reference
    (geometry/utils.py:15-62).
    """
    point = np.asarray(point, dtype=float)
    centre = np.asarray(centre, dtype=float)
    half = 0.5 * np.asarray(size, dtype=float)
    lo = centre - half
    hi = centre + half
    dists = np.empty(6)
    dists[0::2] = np.abs(point - lo)
    dists[1::2] = np.abs(point - hi)
    tests = dists < (atol / 2)
    surfaces = np.where(tests)[0].tolist()
    return bool(np.any(tests)), surfaces


def aabb_intersection(min_point, max_point, ray_position, ray_direction):
    """Slab-method ray/AABB intersection.

    Returns a tuple of forward intersection points (t >= 0) sorted by
    distance, or None when the ray misses (reference geometry/utils.py:65).
    """
    o = np.asarray(ray_position, dtype=float)
    d = np.asarray(ray_direction, dtype=float)
    lo = np.asarray(min_point, dtype=float)
    hi = np.asarray(max_point, dtype=float)

    tmin, tmax = -np.inf, np.inf
    for axis in range(3):
        if abs(d[axis]) < 1e-300:
            if o[axis] < lo[axis] or o[axis] > hi[axis]:
                return None
        else:
            inv = 1.0 / d[axis]
            t1 = (lo[axis] - o[axis]) * inv
            t2 = (hi[axis] - o[axis]) * inv
            if t1 > t2:
                t1, t2 = t2, t1
            tmin = max(tmin, t1)
            tmax = min(tmax, t2)
    if tmax < tmin:
        return None
    hits = []
    if tmin >= 0.0:
        hits.append(tuple((o + tmin * d).tolist()))
    if tmax >= 0.0:
        hits.append(tuple((o + tmax * d).tolist()))
    return tuple(hits)


def ray_z_cylinder(length, radius, ray_origin, ray_direction):
    """Ray intersections with a z-aligned capped cylinder centred at origin.

    Returns (points, distances) sorted by distance with only forward
    (t >= 0) hits, matching the reference (geometry/utils.py:131-350):
    barrel hits must satisfy |z| < length/2 strictly, cap hits must lie
    strictly inside the cap radius.
    """
    o = np.asarray(ray_origin, dtype=float)
    d = np.asarray(ray_direction, dtype=float)
    half = 0.5 * length

    candidates = []

    a = d[0] * d[0] + d[1] * d[1]
    if a > 1e-300:
        b = 2.0 * (o[0] * d[0] + o[1] * d[1])
        c = o[0] * o[0] + o[1] * o[1] - radius * radius
        disc = b * b - 4.0 * a * c
        if disc >= 0.0:
            sq = np.sqrt(disc)
            for t in ((-b - sq) / (2 * a), (-b + sq) / (2 * a)):
                if t >= 0.0:
                    p = o + t * d
                    if -half < p[2] < half:
                        candidates.append((tuple(p.tolist()), float(t)))

    if abs(d[2]) > 1e-300:
        for zcap in (-half, half):
            t = (zcap - o[2]) / d[2]
            if t >= 0.0 and np.isfinite(t):
                p = o + t * d
                if np.sqrt(p[0] ** 2 + p[1] ** 2) < radius:
                    candidates.append((tuple(p.tolist()), float(t)))

    candidates.sort(key=lambda pair: pair[1])
    if not candidates:
        return ([], [])
    points = tuple(p for p, _ in candidates)
    distances = tuple(t for _, t in candidates)
    return points, distances
