"""Scene: root of the node graph plus emission/intersection/simulate APIs.

Parity: reference ``pvtrace/scene/scene.py`` — round-robin light
emission, forward-filtered distance-sorted intersections, and the
multiprocessing `simulate` entry point with per-worker reseeding. The
multiprocessing path exists for oracle-tracer compatibility; large runs
should use ``pvtrace_tpu_torch.engine.simulate``, which traces on the
card.
"""
from __future__ import annotations

import multiprocessing
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from pvtrace_tpu_torch.light.event import Event
from pvtrace_tpu_torch.light.light import Light
from pvtrace_tpu_torch.geometry.utils import intersection_point_is_ahead
from pvtrace_tpu_torch.scene.node import Node


# Events that always mark an "end ray" regardless of which node was hit.
_ALWAYS_END = frozenset(
    {Event.GENERATE, Event.NONRADIATIVE, Event.REACT, Event.KILL, Event.EXIT}
)


def do_simulation(scene, num_rays, seed):
    """Worker function for multiprocessing."""
    from pvtrace_tpu_torch.algorithm import photon_tracer

    if seed is not None:
        np.random.seed(seed)
    return [photon_tracer.follow(scene, ray) for ray in scene.emit(num_rays)]


def is_end_ray(event, metadata):
    """Classify whether an event is an "end ray": generation, terminal
    events, and surface interactions at a node's own boundary (reflected
    off it, transmitted into it, or escaped out of it)."""
    if event in _ALWAYS_END:
        return True
    hit = metadata.get("hit") if metadata else None
    if event is Event.REFLECT:
        return hit == metadata["adjacent"]
    if event is Event.TRANSMIT:
        return hit in (metadata["adjacent"], metadata["container"])
    return False  # volume events (ABSORB / EMIT / SCATTER) are interior


def do_simulation_add_to_queue(scene, num_rays, seed, queue, end_rays):
    """Worker function that streams results into a queue."""
    from pvtrace_tpu_torch.algorithm import photon_tracer

    if seed is not None:
        np.random.seed(seed)
    pid = os.getpid()
    for idx, ray in enumerate(scene.emit(num_rays)):
        for stepped, event, metadata in photon_tracer.step_forward(scene, ray):
            if end_rays and not is_end_ray(event, metadata):
                continue
            queue.put((pid, idx, stepped, event, metadata))
    return pid


class Scene(object):
    """A scene graph of nodes."""

    def __init__(self, root=None):
        super(Scene, self).__init__()
        self.root = root

    def finalise_nodes(self):
        """Hook kept for API parity (bounding-box preparation)."""
        # The analytic primitives and compiled device tables do not need
        # cached bounding boxes.
        return None

    @property
    def light_nodes(self) -> Sequence[Node]:
        """All nodes carrying a Light, in level order."""
        return [
            node
            for node in self.root.iter_levelorder()
            if isinstance(node.light, Light)
        ]

    @property
    def component_nodes(self):
        """All material components used in the scene, in level order."""
        found = []
        for node in self.root.iter_levelorder():
            if node.geometry and node.geometry.material:
                found.extend(node.geometry.material.components)
        return found

    def emit(self, num_rays):
        """Yield rays in the world (root) frame, cycling between lights."""
        lights = self.light_nodes
        for idx in range(num_rays):
            light = lights[idx % len(lights)]
            for ray in light.emit(1):
                yield ray.representation(light, self.root)

    def intersections(self, ray_origin, ray_direction) -> Sequence[Tuple]:
        """Forward intersections of the ray (root frame) with the scene,
        sorted by distance."""
        root = self.root
        if root is None:
            return tuple()
        all_intersections = root.intersections(ray_origin, ray_direction)
        all_intersections = map(lambda x: x.to(root), all_intersections)
        all_intersections = tuple(
            x
            for x in all_intersections
            if intersection_point_is_ahead(ray_origin, ray_direction, x.point)
        )
        origin = np.asarray(ray_origin, dtype=float)
        return tuple(
            sorted(
                all_intersections,
                key=lambda i: float(np.linalg.norm(np.asarray(i.point) - origin)),
            )
        )

    def simulate(
        self,
        num_rays: int,
        workers: Optional[int] = None,
        seed: Optional[int] = None,
        queue=None,
        end_rays: Optional[bool] = False,
    ):
        """Trace `num_rays` with the oracle tracer, optionally across
        multiple processes (per-worker reseeding; a fixed seed requires
        workers=1, reference scene.py:197-313)."""
        if workers is None:
            workers = max(1, multiprocessing.cpu_count() // 2)

        if workers == 1 or num_rays // workers == 0:
            if queue:
                return do_simulation_add_to_queue(
                    self, num_rays, seed, queue, end_rays
                )
            return do_simulation(self, num_rays, seed)

        num_rays_per_worker = num_rays // workers
        remainder = num_rays - num_rays_per_worker * workers
        rays = [num_rays_per_worker] * workers
        rays[0] += remainder
        if seed is None:
            seeds = np.random.randint(0, (2 ** 31) - 1, workers)
        else:
            raise ValueError(
                "Seed must be None to ensure different quasi-random sequences "
                "in each process"
            )

        pool = multiprocessing.Pool(processes=workers)
        try:
            if queue:
                proxies = [
                    pool.apply_async(
                        do_simulation_add_to_queue,
                        (self, rays[idx], seeds[idx], queue, end_rays),
                    )
                    for idx in range(workers)
                ]
                [p.get() for p in proxies]
                return None
            proxies = [
                pool.apply_async(do_simulation, (self, rays[idx], seeds[idx]))
                for idx in range(workers)
            ]
            results = []
            for proxy in proxies:
                results.extend(proxy.get())
            return results
        finally:
            pool.close()
            pool.join()
