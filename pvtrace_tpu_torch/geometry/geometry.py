"""Abstract protocol implemented by every shape.

Parity: reference ``pvtrace/geometry/geometry.py:16-58``.
"""
import abc
from typing import Sequence


class Geometry(abc.ABC):
    """A three-dimensional shape attached to a scene Node.

    All methods take and return values in the shape's local frame.
    """

    @property
    @abc.abstractmethod
    def material(self):
        """The material attached to this geometry."""

    @abc.abstractmethod
    def is_on_surface(self, point: tuple) -> bool:
        """True when the point lies on the surface."""

    @abc.abstractmethod
    def contains(self, point: tuple) -> bool:
        """True when the point lies strictly inside the shape."""

    @abc.abstractmethod
    def intersections(self, position: tuple, direction: tuple) -> Sequence[tuple]:
        """Forward intersection points sorted by distance from origin."""

    @abc.abstractmethod
    def normal(self, surface_point: tuple) -> tuple:
        """Outward unit surface normal at `surface_point`."""

    @abc.abstractmethod
    def is_entering(self, surface_point: tuple, direction: tuple) -> bool:
        """True when a ray at `surface_point` heading along `direction`
        enters the shape (negative dot product with the outward normal)."""
