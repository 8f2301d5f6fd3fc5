"""Immutable ray record.

Parity: reference ``pvtrace/light/ray.py`` (frozen dataclass with
position/direction/wavelength/travelled/duration/source; ``propagate``
advances position and accumulates time of flight; units are centimetres).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

# Distance units in pvtrace_tpu are centimetres (reference light/ray.py:12).
speed_of_light_cm_per_s = 299792458.0 * 100.0


@dataclass(frozen=True)
class Ray:
    """A ray of light.

    Attributes
    ----------
    position : tuple of float
        The (x, y, z) position.
    direction : tuple of float
        Direction unit vector (n_i, n_j, n_k).
    wavelength : float
        The wavelength in nanometers.
    travelled : float
        Total propagation distance, updated by `propagate`.
    duration : float
        Total time propagating, including radiative lifetimes of emissive
        states visited.
    source : str
        Identifier of the light source or luminophore that emitted the ray.
    """

    position: tuple
    direction: tuple
    wavelength: Optional[float]
    travelled: float = 0.0
    duration: float = 0.0
    source: Optional[str] = None

    def __repr__(self):
        fmt = lambda v: "({})".format(", ".join("%.2f" % x for x in v))
        return "Ray(pos=%s, dir=%s, nm=%.2f)" % (
            fmt(self.position), fmt(self.direction), self.wavelength,
        )

    def propagate(self, distance: float, refractive_index: float) -> "Ray":
        """Move the ray `distance` along its direction.

        Time of flight accumulates as distance * n / c, matching the
        reference (light/ray.py:52-75).
        """
        moved = np.asarray(self.position) + distance * np.asarray(self.direction)
        flight_time = distance * refractive_index / speed_of_light_cm_per_s
        return replace(
            self,
            position=tuple(moved.tolist()),
            travelled=self.travelled + distance,
            duration=self.duration + flight_time,
        )

    def representation(self, from_node, to_node) -> "Ray":
        """Re-express the ray in another node's coordinate system."""
        new_position = from_node.point_to_node(self.position, to_node)
        new_direction = from_node.vector_to_node(self.direction, to_node)
        return replace(self, position=new_position, direction=new_direction)
