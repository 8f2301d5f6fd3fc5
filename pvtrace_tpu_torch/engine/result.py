"""Result objects of ``simulate``: a copy of the JAX package's.

``_axis_edges``, ``RecorderResult``, ``EngineResult`` and
``_RoundRobinSources`` copied from ``pvtrace_tpu/engine/api.py`` (with
``MOMENT_PROPERTIES``); only the imports differ.
"""
import collections

import numpy as np

from pvtrace_tpu_torch.engine.recorder import Heatmap
from pvtrace_tpu_torch.light.event import Event
from pvtrace_tpu_torch.light.ray import Ray

# Properties with always-on moment accumulators, in tally order
MOMENT_PROPERTIES = ("wavelength", "angle", "duration", "pathlength")


def _axis_edges(axis):
    return np.linspace(axis.start, axis.stop, axis.bins + 1)


class RecorderResult:
    """One recorder's accumulated statistics.

    Two counters: ``rays`` is distinct photons (first matching
    interaction only — a trapped photon bouncing off the same face many
    times is one ray) and ``crossings`` is every matching interaction.
    The moment pairs and histogram bins accumulate per distinct ray.
    """

    def __init__(self, spec, rays, crossings, moments, bins):
        self.spec = spec
        self.rays = int(rays)
        self.crossings = int(crossings)
        self._moments = np.asarray(moments, dtype=float)  # (4, 2)
        self._bins = bins  # list of arrays matching spec.histograms

    def _stats(self, prop):
        """(mean, population variance) of a moment property, or NaNs."""
        if self.rays == 0:
            return float("nan"), float("nan")
        total, squares = self._moments[MOMENT_PROPERTIES.index(prop)]
        mu = total / self.rays
        return mu, max(squares / self.rays - mu * mu, 0.0)

    def mean(self, prop):
        return self._stats(prop)[0]

    def std(self, prop):
        """Population standard deviation of `prop` over recorded rays."""
        return float(np.sqrt(self._stats(prop)[1]))

    def error(self, prop):
        """Standard error of the mean of `prop`."""
        if self.rays == 0:
            return float("nan")
        return self.std(prop) / np.sqrt(self.rays)

    def histogram(self, index=0):
        """(edges, counts) for 1D or (edges_a, edges_b, counts) for 2D."""
        spec = self.spec.histograms[index]
        counts = np.asarray(self._bins[index])
        if not isinstance(spec, Heatmap):
            return _axis_edges(spec), counts
        grid = counts.reshape(spec.a.bins, spec.b.bins)
        return _axis_edges(spec.a), _axis_edges(spec.b), grid

    def __repr__(self):
        return (
            f"RecorderResult({self.spec.name!r}, rays={self.rays}, "
            f"crossings={self.crossings})"
        )


class EngineResult:
    """Results of tracing a bundle of rays.

    Recorder tallies cover every traced ray (`recorders`); full event
    histories exist for every `record_every`-th ray (`histories()`).
    """

    def __init__(self, compiled, data, sources, max_events, record_every, elapsed):
        self.compiled = compiled
        self.data = data
        self.sources = sources
        self.max_events = max_events
        self.record_every = record_every
        self.elapsed = elapsed

    @property
    def num_rays(self):
        return len(self.sources)

    @property
    def num_recorded(self):
        return len(self.data["counts"])

    @property
    def recorded_indices(self):
        if self.record_every <= 0:
            return np.zeros(0, dtype=np.int64)
        return np.arange(0, self.num_rays, self.record_every, dtype=np.int64)

    @property
    def recorders(self):
        """Dict of recorder name -> RecorderResult, sliced out of the
        engine's flat accumulator arrays."""
        compiled = self.compiled
        flat_bins = self.data["rec_bins"]

        def slices(r, spec):
            start = compiled.rec_hist_start[r]
            for h in range(len(spec.histograms)):
                row = compiled.hist_specs[start + h]
                na, nb, offset = row[3], row[4], row[9]
                yield flat_bins[offset:offset + na * nb]

        return {
            spec.name: RecorderResult(
                spec,
                self.data["rec_distinct"][r],
                self.data["rec_crossings"][r],
                self.data["rec_sums"][r].reshape(4, 2),
                list(slices(r, spec)),
            )
            for r, spec in enumerate(compiled.recorder_specs)
        }

    def fate_counts(self):
        """Counter of terminal fates over EVERY traced ray (lossless,
        unlike `event_counts` which covers only recorded histories).
        Index 10 counts rays that left the scene without further hits."""
        fates = self.data["fates"]
        out = collections.Counter()
        for value in (Event.EXIT, Event.NONRADIATIVE, Event.REACT, Event.KILL):
            if fates[value.value]:
                out[value] = int(fates[value.value])
        if fates[10]:
            out["NO_HIT"] = int(fates[10])
        return out

    def event_counts(self):
        """Counter of logged events by Event member (recorded rays only)."""
        counts = self.data["counts"]
        if len(counts) == 0:
            return collections.Counter()
        kinds = self.data["kind"]
        mask = np.arange(self.max_events)[None, :] < counts[:, None]
        values, tallies = np.unique(kinds[mask], return_counts=True)
        return collections.Counter(
            {Event(int(v)): int(t) for v, t in zip(values, tallies)}
        )

    def _node_name(self, index):
        return self.compiled.node_names[index] if index >= 0 else None

    def _component_name(self, index):
        return self.compiled.component_names[index] if index >= 0 else None

    def _log_entry(self, j, k, launch_source):
        """One (Ray, Event, metadata) tuple from event-log slot (j, k)."""
        d = self.data
        component_id = int(d["source"][j, k])
        ray = Ray(
            position=tuple(np.asarray(d["position"][j, k]).tolist()),
            direction=tuple(np.asarray(d["direction"][j, k]).tolist()),
            wavelength=float(d["wavelength"][j, k]),
            travelled=float(d["travelled"][j, k]),
            duration=float(d["duration"][j, k]),
            source=(
                launch_source if component_id < 0
                else self._component_name(component_id)
            ),
        )
        event = Event(int(d["kind"][j, k]))
        metadata = {
            key: lookup(int(d[key][j, k]))
            for key, lookup in (
                ("hit", self._node_name),
                ("container", self._node_name),
                ("adjacent", self._node_name),
                ("component", self._component_name),
            )
        }
        if event in (Event.REFLECT, Event.TRANSMIT):
            metadata["normal"] = tuple(np.asarray(d["normal"][j, k]).tolist())
        return ray, event, metadata

    def histories(self):
        """Yields one history per recorded ray: [(Ray, Event, metadata)]."""
        counts = self.data["counts"]
        indices = self.recorded_indices
        for j in range(self.num_recorded):
            launch_source = self.sources[int(indices[j])]
            yield [
                self._log_entry(j, k, launch_source)
                for k in range(int(counts[j]))
            ]


class _RoundRobinSources:
    """Lazy `sources` sequence: light names cycled over the bundle
    (building a python list of 10^6+ strings is host-time we don't
    spend). `offset` is the bundle's global photon-index offset so
    streamed bundles label sources exactly like one big call."""

    def __init__(self, names, n, offset=0):
        self._names = list(names)
        self._n = n
        self._offset = offset

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._names[(self._offset + i) % len(self._names)]

