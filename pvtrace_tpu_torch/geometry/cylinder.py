"""Capped cylinder primitive (local z axis, centred at the origin).

Role parity with the reference's ``pvtrace/geometry/cylinder.py``. The
analytic barrel-quadratic + cap-plane solve lives in
``geometry.utils.ray_z_cylinder`` (shared with the host oracle); the
device tracer carries its own vectorised version.
"""
import numpy as np

from pvtrace_tpu_torch.common.errors import GeometryError
from pvtrace_tpu_torch.geometry.geometry import Geometry
from pvtrace_tpu_torch.geometry.utils import close_to_zero, norm, ray_z_cylinder

# Any fixed direction works for the surface-membership probe ray; only
# the distance of the nearest hit matters.
_PROBE = norm((1, 1, 1))


class Cylinder(Geometry):
    """Capped cylinder: ``length`` along local z, circular cross-section
    of ``radius``, caps at z = +-length/2."""

    def __init__(self, length, radius, material=None):
        super(Cylinder, self).__init__()
        self.length = length
        self.radius = radius
        self._material = material

    @property
    def material(self):
        return self._material

    @material.setter
    def material(self, new_value):
        self._material = new_value

    @property
    def _half(self):
        return 0.5 * self.length

    def _axis_distance(self, point):
        """Distance of `point` from the cylinder axis."""
        return float(np.hypot(point[0], point[1]))

    def contains(self, point):
        inside_caps = -self._half < point[2] < self._half
        return bool(inside_caps and self._axis_distance(point) < self.radius)

    def is_on_surface(self, point):
        _, distances = ray_z_cylinder(
            self.length, self.radius, point, _PROBE
        )
        return bool(len(distances) and close_to_zero(distances[0]))

    def intersections(self, origin, direction):
        hits, _ = ray_z_cylinder(self.length, self.radius, origin, direction)
        return hits

    def normal(self, surface_point):
        """Outward surface normal: +-z on the caps, radial on the barrel."""
        for cap_sign in (-1.0, 1.0):
            if np.isclose(surface_point[2], cap_sign * self._half):
                return (0.0, 0.0, cap_sign)
        if np.isclose(self._axis_distance(surface_point), self.radius):
            radial = np.array([surface_point[0], surface_point[1], 0.0])
            return tuple(norm(radial).tolist())
        raise GeometryError("Not a surface point.")

    def is_entering(self, surface_point, direction) -> bool:
        if not self.is_on_surface(surface_point):
            raise GeometryError("Not a surface point.")
        return bool(self.normal(surface_point) @ np.asarray(direction) < 0.0)
