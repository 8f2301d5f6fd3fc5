"""Profiling and observability.

Port of ``pvtrace_tpu.utils.profiling``. ``Timer`` and
``ThroughputMeter`` are the JAX package's. ``trace_profile`` captures a
``torch.profiler`` trace (CPU and CUDA activity) where the JAX package
captures a ``jax.profiler`` one, and ``device_memory_stats`` reads the
CUDA caching allocator in the keys that JAX's accelerator devices report.
Both run on the card unless the caller passes ``device="cpu"``; without a
card the default raises.
"""
import contextlib
import time

from pvtrace_tpu_torch.engine.api import require_device


class Timer:
    """Wall-clock context: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self.elapsed = 0.0
        self._tic = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._tic
        return False


class ThroughputMeter:
    """Accumulates (photons, seconds) samples; reports photons/s.

    Use per bundle/stream to observe steady-state throughput separately
    from compile time: the first sample (compile + trace) is reported
    as `first_sample_rate`, the rest as `steady_rate`.
    """

    def __init__(self):
        self.samples = []  # (photons, seconds)

    def add(self, photons, seconds):
        self.samples.append((int(photons), float(seconds)))

    @contextlib.contextmanager
    def measure(self, photons):
        tic = time.perf_counter()
        yield
        self.add(photons, time.perf_counter() - tic)

    @property
    def photons(self):
        return sum(n for n, _ in self.samples)

    @property
    def seconds(self):
        return sum(s for _, s in self.samples)

    @property
    def rate(self):
        """Overall photons/s including the first (compiling) sample."""
        return self.photons / self.seconds if self.seconds > 0 else 0.0

    @property
    def first_sample_rate(self):
        if not self.samples:
            return 0.0
        n, s = self.samples[0]
        return n / s if s > 0 else 0.0

    @property
    def steady_rate(self):
        """photons/s excluding the first sample (compile amortised)."""
        if len(self.samples) < 2:
            return self.rate
        n = sum(k for k, _ in self.samples[1:])
        s = sum(t for _, t in self.samples[1:])
        return n / s if s > 0 else 0.0

    def summary(self):
        return {
            "photons": self.photons,
            "seconds": round(self.seconds, 6),
            "rate": round(self.rate, 1),
            "steady_rate": round(self.steady_rate, 1),
            "samples": len(self.samples),
        }


@contextlib.contextmanager
def trace_profile(log_dir, device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed block.

    On a CUDA `device` the trace holds CPU and CUDA activity (the
    kernels' launches and their time on the card, through CUPTI); on
    "cpu" the CPU's alone. ``tensorboard_trace_handler`` writes it under
    `log_dir` as a Chrome trace (``*.pt.trace.json``), which TensorBoard's
    profile plugin and Perfetto open. Run once before profiling so that
    the kernels are built.
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if require_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def device_memory_stats(device="cuda"):
    """Memory statistics of `device` in bytes: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved`` (torch's caching allocator)
    and ``bytes_limit`` (the card's total memory); ``{}`` for the CPU, as
    JAX's CPU device gives."""
    device = require_device(device)
    if device.type != "cuda":
        return {}
    import torch

    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_reserved": torch.cuda.memory_reserved(device),
        "bytes_limit": total,
    }
