"""Crafted rays through the bundle form of the trace, against the oracle.

``scenes.random_scene(seed, matched=True)`` has every node index-matched
to the world, with no component and no override: every crossing of its
crafted rays (``built.rays``: from node centres at every nesting level,
across the faces touching boxes share, from outside toward the nodes) is
then a deterministic TRANSMIT, so the event log of ``kernels.trace(...,
bundle=..., record_every=1)`` (the kernel on the card, the twin on the
CPU, or the host build's) and the oracle's ``step_forward`` must agree
record by record (``compare``): kind, container, adjacent node, position,
and the hit node, which must be one whose surface lies at the event point
(at a face two touching boxes share, either of the two, as rounding orders
their equal distances; the JAX package's ``tests/test_touching_engine.py``
checks no hit there either). The tests run it on the CPU,
``chip_smoke.py`` phase 38 on the card.
"""
import numpy as np
import torch

from pvtrace_tpu_torch import kernels
from pvtrace_tpu_torch.algorithm import photon_tracer
from pvtrace_tpu_torch.engine import compile_scene, rng, tracer
from pvtrace_tpu_torch.engine.compiler import EMIT_METHODS
from pvtrace_tpu_torch.kernels.check import require
from pvtrace_tpu_torch.light.event import Event
from pvtrace_tpu_torch.light.ray import Ray

# log["ints"] fields (eventlog.LOG_INTS)
KIND, HIT, CONTAINER, ADJACENT = 0, 1, 2, 3
MAX_EVENTS = 64
WAVELENGTH = 555.0
# Positions against the oracle's: within 1e-9 of the scene's scale in
# float64; in float32 within 1e-4 at the scale of 10 of the JAX package's
# touching goldens, growing with the scene (a float32 position of the
# world's size rounds to scale * 6e-8 on every operation).
POS_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def options(built):
    """The kernel arguments of `built`'s run options."""
    o = built.options
    return {"maxsteps": o["maxsteps"], "emit_method": EMIT_METHODS[o["emit_method"]],
            "maxpathlength": float("inf") if o["maxpathlength"] is None
            else float(o["maxpathlength"])}


def coincident(built, compiled):
    """The checks' arguments for `built`'s touching boxes, `compiled` its
    scene: ``coincident``, their node indices, and ``probes``, the recorder
    indices of each probe pair (``random_scene(probes=True)``; empty
    without)."""
    names = [spec.name for spec in compiled.recorder_specs]
    return {"coincident": {compiled.node_names.index(name) for name in built.coincident},
            "probes": [(names.index(a), names.index(b)) for a, b in built.probes]}


def crafted_bundle(built, dtype, device="cpu"):
    """The crafted rays of `built` as a [7, n] bundle of `dtype`."""
    starts, dirs = built.rays
    wav = np.full(len(starts), WAVELENGTH)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return torch.from_numpy(tracer.bundle_rows(starts, dirs, wav, np_dtype)).to(device)


def trace_crafted(built, st, seed):
    """The crafted rays through ``kernels.trace(bundle=..., record_every=1)``
    on the scene tensors' device (the kernel on the card, the twin on the
    CPU) under `built`'s options: (ints, floats, counts) of the log, on the
    CPU."""
    bundle = crafted_bundle(built, st["node_f"].dtype, st["node_f"].device)
    _, _, _, log = kernels.trace(st, rng.key_words(seed), bundle.shape[1], record_every=1,
                                 max_events=MAX_EVENTS, bundle=bundle, **options(built))
    return log["ints"].cpu(), log["floats"].cpu(), log["counts"].cpu()


def repeats(events, tol):
    """The records that repeat the crossing before them: the same TRANSMIT
    or REFLECT (hit, container and adjacent node) at the same point, of
    (kind, hit, container, adjacent, position) tuples. The oracle skips a
    hit only within ``EPS_ZERO`` (2.2e-13 cm) of the ray's start, an
    absolute tolerance, so a ray that crosses a surface far from where it
    started can meet that surface again a few 1e-12 cm on and cross it a
    second time. The float32 engine (the JAX package's alike) finds the
    first surface after a free path of tens of centimetres with an error
    in t above that node's tolerance (3e-5 cm for a node under 1 cm: the
    quadratic's cancellation grows with the squared distance), and may
    cross it twice too. Both are reference faults (ROADMAP queue 3)."""
    out = []
    for k in range(2, len(events)):
        (e0, *m0, p0), (e1, *m1, p1) = events[k - 1], events[k]
        if e1 == e0 and e1 in (Event.TRANSMIT, Event.REFLECT) and m0 == m1 \
                and np.linalg.norm(np.subtract(p0, p1)) <= tol:
            out.append(k)
    return out


def oracle_records(built, start, d, maxsteps):
    """One crafted ray's ``step_forward`` events (the oracle, float64,
    `built`'s options but `maxsteps`) as (kind, hit, container, adjacent,
    position) tuples."""
    o = built.options
    ray = Ray(position=tuple(start), direction=tuple(d), wavelength=WAVELENGTH)
    events = photon_tracer.step_forward(
        built.scene, ray, maxsteps=maxsteps,
        maxpathlength=np.inf if o["maxpathlength"] is None else o["maxpathlength"],
        emit_method=o["emit_method"])
    return [(e, m and m.get("hit"), m and m["container"], m and m.get("adjacent"),
             tuple(r.position)) for r, e, m in events]


def engine_records(log, j, names):
    """Photon j's records of an event log as ``oracle_records`` gives them."""
    ints, floats, counts = log

    def name(i):
        return None if int(i) < 0 else names[int(i)]

    return [(Event(int(row[KIND])), name(row[HIT]), name(row[CONTAINER]), name(row[ADJACENT]),
             tuple(floats[j, k, :3].double().tolist()))
            for k, row in enumerate(ints[j, :int(counts[j])])]


def _free_path(records, k):
    return float(np.linalg.norm(np.subtract(records[k][4], records[k - 1][4])))


def surfaces_at(scene, before, at, tol):
    """Names of the nodes whose surface lies where a ray `before` meets the
    point `at` (the oracle's intersections along it at that distance)."""
    distance = float(np.linalg.norm(np.subtract(at, before.position)))
    return {x.hit.name for x in scene.intersections(before.position, before.direction)
            if abs(x.distance - distance) <= tol}


def compare(built, log, dtype, np_seed=0):
    """The event log (ints, floats, counts) of the crafted rays against
    the oracle's events (``oracle_records``), record by record (the module
    doc), each side's repeated crossings (``repeats``) left out: the
    engine's only in float32 and only after a free path of more than half
    the world's radius. A repeat takes a step, so the oracle walks with
    the step cap moved by the difference of the two sides' repeats. In
    float32 a cap's KILL right after such a crossing may name the node
    the photon came from as its container. Returns the counts of the
    records compared, of the crossings of faces that touching boxes
    share, and of the oracle's and the engine's repeats."""
    names = compile_scene(built.scene).node_names
    f32 = dtype == torch.float32
    tol = POS_TOL[dtype] * (max(1.0, built.scale / 10.0) if f32 else built.scale)
    on_surface = 1e-9 * built.scale
    long_path = 0.5 * built.scale
    np.random.seed(np_seed)
    counted = {"records": 0, "shared": 0, "oracle": 0, "engine": 0}
    for j, (start, d) in enumerate(zip(*built.rays)):
        got = engine_records(log, j, names)
        skip_got = [k for k in repeats(got, tol) if f32 and _free_path(got, k - 1) > long_path]
        cap, extra = built.options["maxsteps"] - len(skip_got), 0
        ref = oracle_records(built, start, d, cap)
        while len(repeats(ref, on_surface)) > extra:
            extra = len(repeats(ref, on_surface))
            ref = oracle_records(built, start, d, cap + extra)
        skip_ref = repeats(ref, on_surface)
        got = [r for k, r in enumerate(got) if k not in skip_got]
        ref = [r for k, r in enumerate(ref) if k not in skip_ref]
        counted["oracle"] += len(skip_ref)
        counted["engine"] += len(skip_got)
        require([r[0] for r in got] == [r[0] for r in ref],
                f"crafted ray {j}: events {got} against the oracle's {ref}")
        require(got[0][2] is None, f"crafted ray {j}: GENERATE logs a container")
        for k in range(1, len(ref)):
            (event, hit, container, adjacent, pos), row = ref[k], got[k]
            where = f"crafted ray {j} record {k}: {row} against the oracle's {ref[k]}"
            require(np.abs(np.subtract(row[4], pos)).max() <= tol, f"{where}: position")
            if event == Event.KILL:
                require(row[1] is None and row[3] is None, where)
                late = f32 and k >= 2 and _free_path(ref, k - 1) > long_path
                require(row[2] == container or late and row[2] == ref[k - 1][2], where)
            else:
                require(row[2:4] == (container, adjacent), where)
            if event in (Event.TRANSMIT, Event.REFLECT, Event.EXIT):
                way = np.subtract(pos, ref[k - 1][4])
                before = Ray(position=ref[k - 1][4], direction=tuple(way / np.linalg.norm(way)),
                             wavelength=WAVELENGTH)
                at = surfaces_at(built.scene, before, pos, on_surface)
                require(hit in at and row[1] in at, f"{where}: surfaces there {at}")
                counted["shared"] += len(at) > 1
            counted["records"] += 1
    return counted


