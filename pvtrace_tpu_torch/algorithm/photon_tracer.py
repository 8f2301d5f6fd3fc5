"""Per-ray oracle tracer: slow, fully general, host-only.

Role parity with the reference's ``pvtrace/algorithm/photon_tracer.py``:
this is the physics ground truth the device engine is validated against
(container inference from intersection parity, EXIT at the root
surface, Beer-Lambert free paths against the boundary distance,
component roulette, quantum-yield branch, Fresnel/delegate surfaces),
and the fallback for scenes the compiler rejects.

Structured as one dispatch per step outcome: each ``_on_*`` handler
consumes the current ray plus hit information and returns the events to
yield and whether the walk continues. The Monte-Carlo draws all live in
the material/surface objects, so the oracle samples the same
distributions in the same order as the reference implementation.
"""
import numpy as np

from pvtrace_tpu_torch.geometry.utils import close_to_zero, distance_between
from pvtrace_tpu_torch.light.event import Event
from pvtrace_tpu_torch.material.component import Luminophore, Reactor, Scatterer


def find_container(intersections):
    """The node the ray is currently inside.

    A ray is inside exactly those nodes whose surfaces it will cross an
    odd number of times; with watertight geometry that means nodes hit
    exactly once. Of those, the nearest surface belongs to the
    innermost enclosing node — the container.
    """
    if len(intersections) == 1:
        return intersections[0].hit
    crossings = {}
    for x in intersections:
        crossings[x.hit] = crossings.get(x.hit, 0) + 1
    best, best_distance = None, None
    for x in intersections:
        if crossings[x.hit] != 1:
            continue
        if best is None or x.distance < best_distance:
            best, best_distance = x.hit, x.distance
    return best


def next_hit(scene, ray):
    """The next surface along the ray.

    Returns ``(hit_node, (container, adjacent), point, distance)`` in
    the root frame, or None when the ray leaves all geometry. Hits
    within EPS of the ray origin are its current surface and are
    skipped.
    """
    candidates = [
        x.to(scene.root)
        for x in scene.intersections(ray.position, ray.direction)
        if not close_to_zero(x.distance)
    ]
    if not candidates:
        return None
    first = candidates[0]
    if len(candidates) == 1:
        # Only one surface left: the ray is inside it and about to leave.
        return first.hit, (first.hit, None), first.point, first.distance
    container = find_container(candidates)
    # The far side of the interface: either the next surface out (when
    # leaving the container) or the hit node itself (when entering it).
    adjacent = candidates[1].hit if container is first.hit else first.hit
    distance = distance_between(ray.position, first.point)
    return first.hit, (container, adjacent), first.point, distance


def _on_kill(ray, container, count):
    meta = {
        "maxsteps": count,
        "maxpathlength": ray.travelled,
        "container": container.name,
    }
    return ray, [(ray, Event.KILL, meta)], False


def _on_exit(ray, hit, container, adjacent, distance):
    n = container.geometry.material.refractive_index
    out = ray.propagate(distance, n)
    meta = {
        "hit": hit.name,
        "container": container.name,
        "adjacent": None if adjacent is None else adjacent.name,
    }
    return out, [(out, Event.EXIT, meta)], False


def _on_absorb(scene, ray, container, at_distance, emit_method):
    """Volume interaction: absorbed at `at_distance` inside `container`.

    Radiative components re-emit (EMIT for luminophores, SCATTER for
    plain scatterers, sampled in the container frame); non-radiative
    ones terminate the walk as REACT or NONRADIATIVE.
    """
    material = container.geometry.material
    ray = ray.propagate(at_distance, material.refractive_index)
    component = material.component(ray.wavelength)
    where = {"component": component.name, "container": container.name}
    events = [(ray, Event.ABSORB, dict(where))]

    if not component.is_radiative(ray):
        ray = component.nonradiative_absorb(ray)
        kind = Event.REACT if isinstance(component, Reactor) \
            else Event.NONRADIATIVE
        events.append((ray, kind, dict(where)))
        return ray, events, False

    local = ray.representation(scene.root, container)
    ray = component.emit(local, method=emit_method) \
        .representation(container, scene.root)
    if isinstance(component, Luminophore):
        kind = Event.EMIT
    elif isinstance(component, Scatterer):
        kind = Event.SCATTER
    else:
        raise ValueError("Unknown component")
    where["emit_method"] = emit_method
    events.append((ray, kind, where))
    return ray, events, True


def _on_surface(scene, ray, hit, container, adjacent, distance):
    """Interface interaction: the surface delegate decides reflection
    vs transmission, computed in the hit node's frame."""
    ray = ray.propagate(distance, container.geometry.material.refractive_index)
    geometry = hit.geometry
    local = ray.representation(scene.root, hit)
    normal = hit.vector_to_node(geometry.normal(local.position), scene.root)
    surface = geometry.material.surface

    if surface.is_reflected(local, geometry, container, adjacent):
        ray = surface.reflect(local, geometry, container, adjacent) \
            .representation(hit, scene.root)
        kind = Event.REFLECT
        far_name = None if adjacent is None else adjacent.name
    else:
        ray = surface.transmit(local, geometry, container, adjacent) \
            .representation(hit, scene.root)
        kind = Event.TRANSMIT
        far_name = adjacent.name
    meta = {
        "hit": hit.name,
        "container": container.name,
        "adjacent": far_name,
        "normal": normal,
    }
    return ray, [(ray, kind, meta)], True


def step_forward(scene, ray, maxsteps=1000, maxpathlength=np.inf,
                 emit_method="kT"):
    """Generator of ``(Ray, Event, metadata)`` tuples — the physics loop."""
    yield (ray, Event.GENERATE, None)
    count = 0
    walking = True
    while walking:
        count += 1
        info = next_hit(scene, ray)
        if info is None:
            return
        hit, (container, adjacent), _, distance = info

        if count > maxsteps or ray.travelled > maxpathlength:
            outcome = _on_kill(ray, container, count)
        elif hit is scene.root:
            outcome = _on_exit(ray, hit, container, adjacent, distance)
        else:
            material = container.geometry.material
            absorbed, at_distance = material.is_absorbed(ray, distance)
            if absorbed:
                outcome = _on_absorb(
                    scene, ray, container, at_distance, emit_method
                )
            else:
                outcome = _on_surface(
                    scene, ray, hit, container, adjacent, distance
                )
        ray, events, walking = outcome
        yield from events


def follow(scene, ray, maxsteps=1000, maxpathlength=np.inf, emit_method="kT"):
    """Trace one ray to termination; returns ``[(Ray, Event), ...]``."""
    return [
        (step_ray, event)
        for step_ray, event, _ in step_forward(
            scene, ray,
            maxsteps=maxsteps,
            maxpathlength=maxpathlength,
            emit_method=emit_method,
        )
    ]
