"""Axis-aligned box geometry with exact analytic intersections.

Parity: reference ``pvtrace/geometry/box.py`` — same NORMALS facet
ordering and ``on_aabb_surface`` semantics. The reference routes boxes
through a trimesh mesh; this implementation is a pure slab solve, which
is both exact and what the device tables compile to.
"""
import numpy as np

from pvtrace_tpu_torch.common.errors import GeometryError
from pvtrace_tpu_torch.geometry.geometry import Geometry
from pvtrace_tpu_torch.geometry.utils import EPS_ZERO, aabb_intersection, on_aabb_surface

# Outward surface normals for facets (xmin, xmax, ymin, ymax, zmin, zmax)
NORMALS = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


class Box(Geometry):
    """An axis-aligned box with centre (0, 0, 0) and given side lengths."""

    def __init__(self, size, material=None):
        """Parameters
        ----------
        size : tuple of float
            Side lengths (length, width, height).
        """
        super(Box, self).__init__()
        self._size = np.asarray(size, dtype=float)
        self.size = tuple(self._size.tolist())
        self._material = material

    @property
    def material(self):
        return self._material

    @material.setter
    def material(self, new_value):
        self._material = new_value

    def is_on_surface(self, point):
        on_surf, _ = on_aabb_surface(self._size, point, atol=2 * EPS_ZERO)
        return bool(on_surf)

    def contains(self, point):
        p = np.abs(np.asarray(point, dtype=float))
        half = 0.5 * self._size
        return bool(np.all(half - (p + EPS_ZERO) > 0.0))

    def intersections(self, origin, direction):
        half = 0.5 * self._size
        hits = aabb_intersection(-half, half, origin, direction)
        if hits is None:
            return tuple()
        return hits

    def normal(self, surface_point):
        on_surf, surf_indexes = on_aabb_surface(
            self._size, surface_point, atol=2 * EPS_ZERO
        )
        if not on_surf:
            raise GeometryError(
                "Point is not on surface. Is the point in the local frame?",
                {"point": surface_point, "geometry": self},
            )
        if len(surf_indexes) != 1:
            raise GeometryError(
                "Point is on multiple surfaces.",
                {"point": surface_point, "geometry": self},
            )
        return NORMALS[surf_indexes[0]]

    def is_entering(self, surface_point, direction) -> bool:
        if not self.is_on_surface(surface_point):
            raise GeometryError("Point is not on surface.")
        return bool(np.dot(self.normal(surface_point), direction) < 0.0)
