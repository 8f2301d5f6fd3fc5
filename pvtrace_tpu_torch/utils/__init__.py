"""Cross-cutting utilities: profiling, throughput metering, memory."""
from pvtrace_tpu_torch.utils.profiling import (  # noqa: F401
    ThroughputMeter,
    Timer,
    device_memory_stats,
    trace_profile,
)
