"""K14: the photon axis sharded over processes, tallies all-reduced.

Port of ``pvtrace_tpu/parallel/shard.py``. The JAX package shards the
photon batch over a device mesh with ``shard_map``; here the mesh is a
``torch.distributed`` process group with one process per device
(``parallel/distributed.py``):

* the scene tensors are small and every rank builds its own on its
  device;
* rank r traces its share of the photon ids with the same kernel as a
  single run, ``pvt_trace`` (or the eager twin on the CPU): with device
  emission the ids ``index_offset + r * n / W + [0, n / W)``, with a host
  bundle its own slice of the bundle from ``index_offset + r * B_local``
  (``per_shard``'s ``axis_index`` offset);
* every tally accumulator is then summed over the ranks, the step count
  maxed (``_all_reduce_tallies``, the counterpart of ``_psum_all`` and
  the ``pmax``).

Per-photon keys fold the global photon index, so the integer tallies
equal a single run's bit for bit and the float sums agree up to the
order of their additions.

K14 has no hand-written kernel: in the JAX package it is an XLA
collective (``jax.lax.psum``), not Pallas code, and here it is the
``torch.distributed`` collective of the group's backend, NCCL between
cards or gloo. Each rank's trace is the hand-written ``pvt_trace*``.
"""
import numpy as np
import torch
import torch.distributed as dist

from pvtrace_tpu_torch.engine import rng, tracer
from pvtrace_tpu_torch.engine.api import _TORCH_DTYPES, _check_budget, tally_data
from pvtrace_tpu_torch.engine.compiler import EMIT_METHODS, compile_scene
from pvtrace_tpu_torch.engine.emit import emit_bundle
from pvtrace_tpu_torch.engine.tables import scene_tensors

# The integer and the float accumulators of a run, in the order they are
# packed for the all-reduce.
INT_TALLIES = ("fates", "distinct", "cross", "bins")
FLOAT_TALLIES = ("sums", "fate_scores", "rec_scores")

# The all-reduces of tallies since the last reset: calls of
# torch.distributed.all_reduce and the bytes they reduced.
reduce_stats = {"calls": 0, "bytes": 0}


class PhotonMesh:
    """The ranks that share a run's photon axis: the process `group`
    (None for one process on its own), this process's `rank` in it, its
    `size` and the `device` this process traces on. ``fate_gradients``
    reads ``mesh.size`` where the JAX package reads ``mesh.devices.size``."""

    def __init__(self, group, rank, size, device):
        self.group, self.rank, self.size = group, rank, size
        self.device = torch.device(device)

    def __repr__(self):
        return (f"PhotonMesh(rank={self.rank}, size={self.size}, device={self.device}, "
                f"backend={dist.get_backend(self.group) if self.group is not None else None})")


def make_photon_mesh(device="cuda", group=None, axis_name="photons"):
    """The photon mesh over the process group `group` (default: the whole
    world once ``init_distributed`` has joined one, else this process
    alone), this process tracing on `device`. `axis_name` is accepted, as
    the JAX package's, and unused: a group has one axis."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return PhotonMesh(None, 0, 1, device)
    return PhotonMesh(group, dist.get_rank(group), dist.get_world_size(group), device)


def _all_reduce_tallies(mesh, tallies, steps):
    """Sum every accumulator of `tallies` over the mesh (``fates``,
    ``distinct``, ``cross``, ``bins``, ``sums`` and, with score,
    ``fate_scores`` and ``rec_scores``) and take the largest `steps`.
    Returns (tallies with those sums, steps). The integers go in one
    int64 buffer, the floats in one float64 buffer: two all_reduce(SUM)
    and one all_reduce(MAX), on the card with NCCL, on CPU copies (a few
    KB) with any other backend. Nothing is reduced for a mesh of one
    process without a group."""
    ints = [name for name in INT_TALLIES if name in tallies]
    floats = [name for name in FLOAT_TALLIES if name in tallies]
    if mesh.group is None:
        return {name: tallies[name] for name in ints + floats}, int(steps)
    on_card = dist.get_backend(mesh.group) == "nccl"
    where = tallies["fates"].device if on_card else torch.device("cpu")
    int_buf = torch.cat([tallies[name].reshape(-1).to(where, torch.int64) for name in ints])
    float_buf = torch.cat([tallies[name].reshape(-1).to(where, torch.float64) for name in floats])
    top = torch.tensor([int(steps)], device=where, dtype=torch.int64)
    dist.all_reduce(int_buf, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(float_buf, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.group)
    reduce_stats["calls"] += 3
    reduce_stats["bytes"] += 8 * (int_buf.numel() + float_buf.numel() + 1)
    out = {}
    for names, buf in ((ints, int_buf), (floats, float_buf)):
        start = 0
        for name in names:
            ref = tallies[name]
            out[name] = buf[start:start + ref.numel()].reshape(ref.shape).to(ref.device, ref.dtype)
            start += ref.numel()
    return out, int(top.item())


def _check_tallies_only(record_every):
    if record_every:
        raise ValueError(
            "sharded runs are tallies-only (record_every=0); use engine.simulate for "
            "event-log histories."
        )


def _run(st, seed, n, index_offset, options, bundle=None, lanes=None):
    """One rank's trace: (tallies with ``fates``, steps)."""
    fates, steps, tallies, _ = tracer.trace(
        st, rng.key_words(seed), n, index_offset=index_offset, lanes=lanes, bundle=bundle,
        **options,
    )
    return dict(tallies, fates=fates), steps


def _trace_options(maxsteps=1000, maxpathlength=None, emit_method="kT", score=False,
                   pathwise=()):
    if emit_method not in EMIT_METHODS:
        raise ValueError(f"emit_method must be one of {sorted(EMIT_METHODS)}")
    return {
        "maxsteps": maxsteps, "emit_method": EMIT_METHODS[emit_method],
        "maxpathlength": float("inf") if maxpathlength is None else float(maxpathlength),
        "score": bool(score), "pathwise": tuple(tuple(p) for p in pathwise) if score else (),
    }


def shard_trace(compiled, mesh, record_every=0, **options):
    """The sharded trace of host-emitted bundles.

    Returns fn(st, bundle, seed, index_offset=0) -> (tallies, steps):
    each rank passes ITS slice of the global bundle (``tracer.
    check_bundle``'s [7, B_local] on ``mesh.device``; the global bundle is
    the ranks' slices in rank order) and the scene tensors `st` on its
    device; photon ``index_offset + rank * B_local + k`` starts from its
    column k, and every accumulator (score sums included) comes back
    summed over the mesh. `options` are ``simulate``'s maxsteps,
    maxpathlength, emit_method, score and pathwise. Event histories are
    not recorded on the sharded path (`record_every` must be 0)."""
    _check_tallies_only(record_every)
    opts = _trace_options(**options)

    def traced(st, bundle, seed, index_offset=0):
        local = bundle.shape[-1]
        tallies, steps = _run(st, seed, local, index_offset + mesh.rank * local, opts,
                              bundle=bundle)
        return _all_reduce_tallies(mesh, tallies, steps)

    return traced


def shard_trace_device_emit(compiled, mesh, lanes=None, record_every=0, **options):
    """The sharded trace with device emission and regeneration.

    Returns fn(st, n_rays, seed, index_offset=0) -> (tallies, steps).
    `n_rays`, the global budget on every rank, must be a multiple of the
    mesh size; rank r emits and traces the ids ``index_offset + r * n_rays
    / W + [0, n_rays / W)`` on its device (on the card ``pvt_trace``'s
    persistent threads refill themselves; on the CPU the twin's `lanes`
    are refilled), and every accumulator comes back summed over the mesh.
    `options` as ``shard_trace``'s."""
    _check_tallies_only(record_every)
    if not compiled.lights_supported:
        raise ValueError("Scene lights are not supported for device-side emission.")
    opts = _trace_options(**options)

    def traced(st, n_rays, seed, index_offset=0):
        if int(n_rays) % mesh.size != 0:
            raise ValueError(
                f"n_rays ({n_rays}) must be a multiple of the mesh size ({mesh.size})."
            )
        local = int(n_rays) // mesh.size
        tallies, steps = _run(st, seed, local, index_offset + mesh.rank * local, opts,
                              lanes=lanes)
        return _all_reduce_tallies(mesh, tallies, steps)

    return traced


def shard_simulate(scene, num_rays, mesh, seed=None, maxsteps=1000, maxpathlength=None,
                   max_events=128, emit_method="kT", dtype=None, compiled=None, lanes="auto",
                   score=False, pathwise=(), index_offset=0, axis_name="photons", workers=None,
                   record_every=0, device=None):
    """Sharded analogue of ``engine.simulate`` (tallies only).

    Traces `num_rays` with the photon axis split over `mesh` (every rank
    calls it with the same arguments) and every tally accumulator summed
    over the ranks; returns ``engine.simulate(record_every=0)``'s data
    keys ``rec_distinct``, ``rec_crossings``, ``rec_sums``, ``rec_bins``,
    ``fates``, ``steps`` and, with ``score=True``, ``fate_scores`` and
    (with recorders) ``rec_scores``, the same on every rank. Per-photon
    keys fold the global photon index, so the integer tallies equal
    ``engine.simulate``'s of the same seed bit for bit; float sums agree
    up to summation order.

    As in the JAX package: `num_rays` must be a multiple of the mesh size;
    the budget is checked before any work; scenes whose lights compile to
    device samplers emit on the device, others emit one host bundle
    (``np.random``) and shard it, on one process only (each process's
    bundle would differ); `record_every` must stay 0; `workers` and
    `axis_name` are accepted and unused. The run is on ``mesh.device``
    (`device`, when given, must name it); `dtype` None means float32, and
    float64 runs the float64 builds on the card. `lanes` as
    ``simulate``'s.
    """
    _check_tallies_only(record_every)
    _check_budget(num_rays, index_offset)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    if compiled is None:
        compiled = compile_scene(scene)
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    if int(num_rays) % mesh.size != 0:
        raise ValueError(
            f"num_rays ({num_rays}) must be a multiple of the mesh size ({mesh.size})."
        )
    dtype = _TORCH_DTYPES[np.dtype(np.float32 if dtype is None else dtype)]
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    st = scene_tensors(compiled, dtype=dtype, device=mesh.device)
    options = dict(maxsteps=maxsteps, maxpathlength=maxpathlength, emit_method=emit_method,
                   score=score, pathwise=pathwise)
    local = int(num_rays) // mesh.size

    if compiled.lights_supported:
        if lanes == "auto":
            lanes = min(local, 1 << 18) if mesh.device.type == "cpu" else None
        traced = shard_trace_device_emit(compiled, mesh, lanes=lanes, **options)
        tallies, steps = traced(st, num_rays, seed, index_offset)
    else:
        if mesh.size > 1:
            raise ValueError(
                "Host-emitted scenes cannot shard_simulate across processes: each "
                "process's np.random bundle would differ. Use lights the compiler lowers "
                "to device samplers, or emit and shard the bundle explicitly with "
                "shard_trace."
            )
        pos, direction, wav, _ = emit_bundle(scene, num_rays)
        bundle = torch.from_numpy(tracer.bundle_rows(pos, direction, wav, np_dtype)).to(mesh.device)
        traced = shard_trace(compiled, mesh, **options)
        tallies, steps = traced(st, bundle, seed, index_offset)

    return tally_data(compiled, tallies["fates"], steps, tallies, np_dtype, score)
