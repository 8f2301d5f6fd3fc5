"""Host-side recorder tallies, computed by columnar reduction.

A copy of ``pvtrace_tpu/engine/tally.py``; only the imports differ. The
port's tests and ``chip_smoke.py`` hold the kernel's recorder tallies to
the tallies this module recomputes from the kernel's own event log.

Role parity with the reference's ``pvtrace/engine/tally.py`` (the
pure-Python recorder oracle), but a different machine: instead of
walking ``(ray, event, metadata)`` tuples per recorder per event, the
histories are packed ONCE into flat numpy columns (event kind, interned
node ids, positions, directions, normals) and every recorder is then
evaluated as a handful of vectorized boolean masks and bincounts over
those columns — the same columnar shape the device tracer uses, which
makes the two easy to cross-check.

Used to tally scenes the device engine cannot compile, and by the test
suite to validate the engine's device tallies exactly against its own
event logs.
"""
import numpy as np

from pvtrace_tpu_torch.engine.recorder import Heatmap
from pvtrace_tpu_torch.engine.result import RecorderResult
from pvtrace_tpu_torch.light.event import Event

_NO_NODE = -1


class _Columns:
    """Flat per-event arrays for a batch of histories.

    Node names are interned to integer ids so selector masks are pure
    integer comparisons. ``incident`` is the direction with which the
    photon arrived at the event (the previous segment's direction for
    surface events, the ray's own for EXIT), matching the angle
    convention of the device tracer.
    """

    def __init__(self, scene, histories):
        ids = {}
        for node in scene.root.iter_preorder():
            ids[node.name] = len(ids)
        self.node_id = ids

        ray, kind = [], []
        hit, container, adjacent = [], [], []
        pos, incident, normal, has_normal = [], [], [], []
        wavelength, travelled, duration = [], [], []

        def intern(name):
            return ids.get(name, _NO_NODE) if name else _NO_NODE

        nodes_by_name = {
            node.name: node for node in scene.root.iter_preorder()
        }
        root = scene.root
        for r, history in enumerate(histories):
            prev_direction = None
            for step, event, meta in history:
                meta = meta or {}
                ray.append(r)
                kind.append(event.value)
                hit.append(intern(meta.get("hit")))
                container.append(intern(meta.get("container")))
                adjacent.append(intern(meta.get("adjacent")))
                pos.append(step.position)
                if event == Event.EXIT:
                    incident.append(step.direction)
                else:
                    incident.append(
                        prev_direction
                        if prev_direction is not None
                        else step.direction
                    )
                n = meta.get("normal")
                if n is None and event == Event.EXIT:
                    # Surface normal of the node the photon left through,
                    # reconstructed from its geometry (device logs carry
                    # the normal; oracle histories do not).
                    exit_node = nodes_by_name.get(meta.get("hit"))
                    geometry = getattr(exit_node, "geometry", None)
                    if geometry is not None:
                        local = (
                            tuple(step.position)
                            if exit_node is root
                            else root.point_to_node(step.position, exit_node)
                        )
                        n = exit_node.vector_to_node(
                            geometry.normal(local), root
                        )
                has_normal.append(n is not None)
                normal.append(n if n is not None else (0.0, 0.0, 0.0))
                wavelength.append(step.wavelength)
                travelled.append(step.travelled)
                duration.append(step.duration)
                prev_direction = step.direction

        self.ray = np.asarray(ray, dtype=np.int64)
        self.kind = np.asarray(kind, dtype=np.int64)
        self.hit = np.asarray(hit, dtype=np.int64)
        self.container = np.asarray(container, dtype=np.int64)
        self.adjacent = np.asarray(adjacent, dtype=np.int64)
        self.pos = np.asarray(pos, dtype=float).reshape(-1, 3)
        self.incident = np.asarray(incident, dtype=float).reshape(-1, 3)
        self.normal = np.asarray(normal, dtype=float).reshape(-1, 3)
        self.has_normal = np.asarray(has_normal, dtype=bool)
        self.wavelength = np.asarray(wavelength, dtype=float)
        self.travelled = np.asarray(travelled, dtype=float)
        self.duration = np.asarray(duration, dtype=float)

    def selector_mask(self, recorder, nid):
        """Boolean row mask implementing the recorder's event selector."""
        sel = recorder.event
        if sel == "entering":
            base = (self.kind == Event.TRANSMIT.value) & (self.adjacent == nid)
        elif sel == "escaping":
            base = (self.kind == Event.TRANSMIT.value) & (self.container == nid)
        elif sel == "reflected":
            base = (self.kind == Event.REFLECT.value) & (self.adjacent == nid)
        elif sel == "lost":
            return (self.kind == Event.NONRADIATIVE.value) & (self.container == nid)
        elif sel == "reacted":
            return (self.kind == Event.REACT.value) & (self.container == nid)
        elif sel == "killed":
            return (self.kind == Event.KILL.value) & (self.container == nid)
        elif sel == "exit":
            return (self.kind == Event.EXIT.value) & (self.hit == nid)
        else:  # pragma: no cover - Recorder validates on construction
            raise ValueError(f"Unknown selector {sel!r}")
        return base & (self.hit == nid)

    def facet_mask(self, recorder):
        """Rows whose outward normal matches the recorder's facet."""
        if recorder.facet is None:
            return np.ones(len(self.kind), dtype=bool)
        want = np.asarray(recorder.facet, dtype=float)
        close = np.abs(self.normal - want) <= recorder.atol
        return self.has_normal & close.all(axis=1)


def _bin_columns(values, axis):
    """Truncate-toward-zero bin indices; -1 where out of range.

    Matches the device tracer's binning: a value an epsilon below
    ``start`` truncates to bin 0 (int() semantics), anything at or past
    ``stop`` is dropped.
    """
    frac = (values - axis.start) / (axis.stop - axis.start) * axis.bins
    index = np.fix(frac).astype(np.int64)
    index[(index < 0) | (index >= axis.bins)] = -1
    return index


def _accumulate(pairs, group, cols, root):
    """Resolve distinct-ray claims for one shared recorder name.

    The reference walks events outer, recorders inner, and lets the
    FIRST matching (event, recorder) pair claim the ray for that name.
    Columnar equivalent: gather candidate (row, pair) indices for every
    pair in the group, order them lexicographically by (row, pair
    position), and keep each ray's first candidate.
    """
    cand_rows, cand_pairs, masks = [], [], []
    for position in group:
        _, recorder, tally = pairs[position]
        nid = cols.node_id[pairs[position][0].name]
        mask = cols.selector_mask(recorder, nid) & cols.facet_mask(recorder)
        masks.append(mask)
        rows = np.nonzero(mask)[0]
        cand_rows.append(rows)
        cand_pairs.append(np.full(len(rows), position, dtype=np.int64))

    for mask, position in zip(masks, group):
        pairs[position][2].crossings += int(mask.sum())

    rows = np.concatenate(cand_rows) if cand_rows else np.empty(0, np.int64)
    if rows.size == 0:
        return
    which = np.concatenate(cand_pairs)
    order = np.lexsort((which, rows))
    rows, which = rows[order], which[order]
    _, first = np.unique(cols.ray[rows], return_index=True)
    rows, which = rows[first], which[first]

    for position in group:
        node, recorder, tally = pairs[position]
        claimed = rows[which == position]
        if claimed.size == 0:
            continue
        tally.add_rows(cols, claimed, node, root)


class _Accumulator:
    """Running sums for one recorder: counts, moments, histogram bins."""

    def __init__(self, recorder):
        self.spec = recorder
        self.crossings = 0
        self.rays = 0
        self.moments = np.zeros((4, 2))
        self.bins = [
            np.zeros(
                h.a.bins * h.b.bins if isinstance(h, Heatmap) else h.bins,
                dtype=np.int64,
            )
            for h in recorder.histograms
        ]

    def add_rows(self, cols, rows, node, root):
        self.rays += int(rows.size)

        cos = np.abs(
            np.einsum("ij,ij->i", cols.incident[rows], cols.normal[rows])
        )
        angle = np.where(
            cols.has_normal[rows], np.arccos(np.minimum(cos, 1.0)), 0.0
        )
        if node is root:
            local = cols.pos[rows]
        else:
            frame = root.transformation_to(node)
            local = cols.pos[rows] @ frame[:3, :3].T + frame[:3, 3]

        values = {
            "wavelength": cols.wavelength[rows],
            "angle": angle,
            "duration": cols.duration[rows],
            "pathlength": cols.travelled[rows],
            "x": local[:, 0],
            "y": local[:, 1],
            "z": local[:, 2],
        }
        for m, prop in enumerate(
            ("wavelength", "angle", "duration", "pathlength")
        ):
            self.moments[m, 0] += values[prop].sum()
            self.moments[m, 1] += np.square(values[prop]).sum()

        for spec, bins in zip(self.spec.histograms, self.bins):
            if isinstance(spec, Heatmap):
                ia = _bin_columns(values[spec.a.prop], spec.a)
                ib = _bin_columns(values[spec.b.prop], spec.b)
                ok = (ia >= 0) & (ib >= 0)
                flat = ia[ok] * spec.b.bins + ib[ok]
            else:
                flat = _bin_columns(values[spec.prop], spec)
                flat = flat[flat >= 0]
            bins += np.bincount(flat, minlength=len(bins)).astype(np.int64)


def tally_histories(scene, histories):
    """Tally recorder statistics from ray histories.

    ``histories`` yields one history per ray: a sequence of
    ``(ray, event, metadata)`` tuples from ``photon_tracer.step_forward``
    or ``EngineResult.histories``. Returns a dict mapping recorder name
    to :class:`~pvtrace_tpu.engine.api.RecorderResult`.
    """
    root = scene.root
    pairs = []
    by_name = {}
    for node in root.iter_preorder():
        for recorder in getattr(node, "recorders", []):
            by_name.setdefault(recorder.name, []).append(len(pairs))
            pairs.append((node, recorder, _Accumulator(recorder)))

    cols = _Columns(scene, histories)
    for group in by_name.values():
        _accumulate(pairs, group, cols, root)

    return {
        recorder.name: RecorderResult(
            recorder, tally.rays, tally.crossings, tally.moments, tally.bins
        )
        for _, recorder, tally in pairs
    }
