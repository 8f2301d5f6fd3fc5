"""Multi-process runs on ``torch.distributed``: one process per device.

Port of ``pvtrace_tpu/parallel/distributed.py``. Every process calls
:func:`init_distributed`, after which :func:`global_photon_mesh` is the
photon mesh of the whole world and the sharded entry points of
``parallel.shard`` split the photon axis over it. Their only
communication is the all-reduce of the tallies (``shard.
_all_reduce_tallies``); per-photon keys fold the global photon index, so
the integer tallies do not depend on how many processes take part.

Divergences from the JAX package:

* **One process per device.** A JAX process drives every device of its
  host, and one process can hold a mesh of 8 devices; here a mesh of 8
  devices is a world of 8 processes, each with its own device (``torchrun
  --nproc-per-node=8`` on one host, with the NCCL backend). A world of one
  traces on one device.
* **No ``globalize`` or ``localize``.** The JAX package lifts host-local
  arrays to global ``jax.Array``s for a multi-process ``jit`` and back.
  Torch has no global arrays: each process passes its own tensors on its
  own device, and the collectives are explicit.
* **The backend is the caller's.** NCCL reduces CUDA tensors between
  cards; gloo reduces CPU tensors (the CPU tests' two processes, or two
  processes that share one card, which NCCL refuses). Nothing switches
  one for the other.
"""
import os

import torch
import torch.distributed as dist


def is_multiprocess():
    """Whether this process is one of a world of more than one."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def init_distributed(backend=None, init_method=None, world_size=None, rank=None,
                     device="cuda", timeout=None):
    """Join (or create) the process group of a multi-process run.

    Call once per process before any sharded call. With no arguments the
    values come from torch's standard environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them);
    `init_method` (``"tcp://host:port"``) takes the place of the first two.
    Without an address or `init_method` and with no world of more than one,
    it is a no-op, as in the JAX package, so library code can call it
    unconditionally.

    `backend` None means ``"nccl"`` when `device` is CUDA and ``"gloo"``
    on the CPU; a backend given is used as it is. With NCCL the process
    takes the card ``LOCAL_RANK`` (0 without it). Blocks until every
    process has joined.
    """
    if dist.is_initialized():
        return
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and "MASTER_ADDR" not in os.environ and world_size in (None, 1):
        return  # one process, no address: nothing to join
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size or 1,
        rank=rank or 0, **kwargs,
    )


def shutdown_distributed():
    """Leave the process group (safe to call when not joined)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_photon_mesh(device="cuda", axis_name="photons"):
    """The photon mesh over every process of the world, this process on
    `device`."""
    from pvtrace_tpu_torch.parallel.shard import make_photon_mesh

    return make_photon_mesh(device=device, axis_name=axis_name)
