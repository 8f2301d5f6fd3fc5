"""Analytic ray/sphere geometry.

Parity: reference ``pvtrace/geometry/sphere.py`` (quadratic solve, centre
at local origin, forward hits only, outward normals).
"""
import numpy as np

from pvtrace_tpu_torch.geometry.geometry import Geometry
from pvtrace_tpu_torch.geometry.utils import EPS_ZERO


class Sphere(Geometry):
    """A sphere of given radius centred at (0, 0, 0) in its own frame."""

    def __init__(self, radius, material=None):
        super(Sphere, self).__init__()
        self.radius = radius
        self._material = material

    @property
    def material(self):
        return self._material

    @material.setter
    def material(self, new_value):
        self._material = new_value

    def is_on_surface(self, point):
        r = np.linalg.norm(np.asarray(point, dtype=float))
        return bool(abs(r - self.radius) < EPS_ZERO)

    def contains(self, point):
        r = np.linalg.norm(np.asarray(point, dtype=float))
        return bool(self.radius - (r + EPS_ZERO) > 0.0)

    def intersections(self, origin, direction):
        o = np.asarray(origin, dtype=float)
        d = np.asarray(direction, dtype=float)
        a = d @ d
        b = 2.0 * (d @ o)
        c = o @ o - self.radius ** 2
        disc = b * b - 4.0 * a * c
        if disc < 0.0:
            return tuple()
        if np.isclose(disc, 0.0):
            ts = [-b / (2.0 * a)]
        else:
            sq = np.sqrt(disc)
            ts = sorted([(-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)])
        hits = tuple(
            tuple((o + t * d).tolist()) for t in ts if t >= 0.0
        )
        return hits

    def normal(self, surface_point):
        p = np.asarray(surface_point, dtype=float)
        return tuple((p / np.linalg.norm(p)).tolist())

    def is_entering(self, surface_point, direction) -> bool:
        if not self.is_on_surface(surface_point):
            raise ValueError("Point is not on surface.")
        return bool(np.dot(self.normal(surface_point), direction) < 0.0)
