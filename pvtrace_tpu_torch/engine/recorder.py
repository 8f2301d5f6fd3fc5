"""Tally specifications: what to count, where, and how to bin it.

Role parity with the reference's ``pvtrace/engine/recorder.py``. A
recorder declares a stream of photon-surface or photon-volume
interactions on one scene node and the statistics to keep about them.
Storage is O(bins): the device engine lowers each recorder to flat
accumulator arrays (distinct-ray count, raw crossing count, four moment
pairs, histogram bins) updated with masked scatter-adds each wavefront
step and ``psum``-reduced across chips.

Distinct-ray counting mirrors the ``DISTINCT throw_id`` CLI queries: a
trapped photon crossing the same face repeatedly is one ray (its first
interaction supplies the histogrammed values) but every crossing still
increments the crossings counter.
"""
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

#: Histogrammable photon properties -> device column index. x/y/z are
#: positions in the local frame of the node owning the recorder;
#: wavelength is nm, angle the radians between the incident direction
#: and the surface normal, duration seconds, pathlength centimetres.
PROPERTIES = {
    name: column
    for column, name in enumerate(
        ("wavelength", "angle", "duration", "pathlength", "x", "y", "z")
    )
}

#: Selector name -> device tag. The first three are surface selectors
#: (transmitted in, transmitted out, bounced off) matching the CLI
#: count semantics; lost/reacted/killed fire on terminal events inside
#: the node volume; exit fires when a photon leaves through the root.
EVENTS = {
    name: tag
    for tag, name in enumerate(
        (
            "entering",
            "escaping",
            "reflected",
            "lost",
            "reacted",
            "killed",
            "exit",
        )
    )
}


@dataclass(frozen=True)
class Histogram:
    """Uniform 1D binning of one photon property over [start, stop)."""

    prop: str
    start: float
    stop: float
    bins: int

    def __post_init__(self):
        if self.prop not in PROPERTIES:
            raise ValueError(
                f"Unknown property {self.prop!r}; use one of "
                f"{sorted(PROPERTIES)}"
            )
        object.__setattr__(self, "start", float(self.start))
        object.__setattr__(self, "stop", float(self.stop))
        object.__setattr__(self, "bins", int(self.bins))
        if not self.stop > self.start:
            raise ValueError("Histogram range requires stop > start.")
        if self.bins < 1:
            raise ValueError("Histogram requires at least one bin.")


class Heatmap:
    """Joint 2D binning of two photon properties (axes ``a`` and ``b``)."""

    def __init__(self, prop_a, prop_b, range_a, range_b):
        self.a = Histogram(prop_a, *range_a)
        self.b = Histogram(prop_b, *range_b)

    def __repr__(self):
        return f"Heatmap({self.a!r}, {self.b!r})"


@dataclass
class Recorder:
    """One named tally stream attached to a scene node.

    ``event`` picks the selector (see :data:`EVENTS`). A surface
    recorder may be restricted to a single facet by giving the outward
    normal it must match within ``atol`` per component (the CLI's
    --nx/--ny/--nz filters). ``histograms`` lists Histogram/Heatmap
    specs binned from each distinct ray's first matching interaction.
    """

    name: str
    event: str = "entering"
    facet: Optional[Tuple[float, ...]] = None
    atol: float = 1e-6
    histograms: Sequence = field(default_factory=list)

    def __post_init__(self):
        if self.event not in EVENTS:
            raise ValueError(
                f"Unknown event {self.event!r}; use one of {sorted(EVENTS)}"
            )
        if self.facet is not None:
            self.facet = tuple(float(c) for c in self.facet)
        self.atol = float(self.atol)
        self.histograms = list(self.histograms)
        bad = [
            h for h in self.histograms
            if not isinstance(h, (Histogram, Heatmap))
        ]
        if bad:
            raise ValueError(
                "histograms must contain Histogram or Heatmap objects."
            )

    def __repr__(self):
        return f"Recorder({self.name!r}, event={self.event!r})"
