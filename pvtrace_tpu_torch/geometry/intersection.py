"""Ray-surface hit records.

Role parity with the reference's ``pvtrace/geometry/intersection.py``
(a ``(coordsys, point, hit, distance)`` record with frame conversion),
implemented here as an immutable NamedTuple so hits can be built and
re-framed cheaply inside the host-side oracle tracer.
"""
from typing import NamedTuple, Tuple

import numpy as np

from pvtrace_tpu_torch.geometry.utils import floats_close


class Intersection(NamedTuple):
    """A single ray-surface hit.

    ``point`` is expressed in the frame of ``coordsys`` (which need not
    be the node that owns the surface); ``hit`` is the node whose
    geometry contains the point; ``distance`` is measured from the ray
    origin along its direction and is frame-independent for the rigid
    transforms this framework allows.
    """

    coordsys: object
    point: Tuple[float, ...]
    hit: object
    distance: float

    def to(self, frame) -> "Intersection":
        """The same hit with ``point`` re-expressed in ``frame``."""
        moved = self.coordsys.point_to_node(self.point, frame)
        return self._replace(coordsys=frame, point=moved)

    def __eq__(self, other):
        if not isinstance(other, tuple) or len(other) != 4:
            return NotImplemented
        return (
            self.coordsys is other[0]
            and np.allclose(self.point, other[1])
            and self.hit is other[2]
            and floats_close(self.distance, other[3])
        )

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq
