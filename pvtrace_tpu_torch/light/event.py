"""The event vocabulary shared by both tracers, the recorders, the
device event log and the persistence layer.

The member NAMES and integer VALUES are a public contract with the
reference ecosystem (they appear verbatim in the SQLite ``event``
table, in YAML recorder selectors and in the device-side packed event
logs) and must not change. Everything else about how events are
produced differs: the device tracer emits them as masked lanes of a
wavefront step rather than per-ray generator yields.
"""
from enum import Enum


class Event(Enum):
    """What happened to a photon at one step of its history."""

    #: Photon created by a light source (always the first entry).
    GENERATE = 0
    #: Bounced off a surface (Fresnel coin, TIR, or a mirror override).
    REFLECT = 1
    #: Crossed a surface into the adjacent material (Snell-bent).
    TRANSMIT = 2
    #: Absorbed by a material component (interim — re-emission may follow).
    ABSORB = 3
    #: Absorbed and lost as heat (terminal).
    NONRADIATIVE = 4
    #: Re-emitted by a non-luminescent scatterer at the same wavelength.
    SCATTER = 5
    #: Re-emitted by a luminophore at a sampled (red-shifted) wavelength.
    EMIT = 6
    #: Left the scene through the root node's surface (terminal).
    EXIT = 7
    #: Absorbed by a Reactor component — photochemistry (terminal).
    REACT = 8
    #: Terminated by the tracer: step/pathlength/event budget (terminal).
    KILL = 9
