"""Multi-process runs (K14): the photon axis sharded over a
``torch.distributed`` process group, one process per device, and every
tally all-reduced (``parallel/shard.py``, ``parallel/distributed.py``)."""
from pvtrace_tpu_torch.parallel.distributed import (
    global_photon_mesh,
    init_distributed,
    is_multiprocess,
    shutdown_distributed,
)
from pvtrace_tpu_torch.parallel.shard import (
    make_photon_mesh,
    shard_simulate,
    shard_trace,
    shard_trace_device_emit,
)

__all__ = [
    "global_photon_mesh",
    "init_distributed",
    "is_multiprocess",
    "make_photon_mesh",
    "shard_simulate",
    "shard_trace",
    "shard_trace_device_emit",
    "shutdown_distributed",
]
