"""The port's profiling utilities (``pvtrace_tpu_torch.utils``).

``Timer`` and ``ThroughputMeter`` against the JAX package's on the same
samples; ``trace_profile`` writes a ``torch.profiler`` trace that names
the eager twin's ops; ``device_memory_stats`` is ``{}`` on the CPU, as
JAX's CPU device reports. Neither runs on the CPU unless asked: without
CUDA their default device raises. The ``gpu`` test runs on the card with
``python -m pytest --noconftest tests/test_torch_utils.py -m gpu``.
"""
import glob
import json
import time

import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch.utils import (  # noqa: E402
    ThroughputMeter,
    Timer,
    device_memory_stats,
    trace_profile,
)

cap_threads()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")


SAMPLES = {
    "compile then steady": [(1000, 2.0), (4000, 1.0), (4000, 1.0)],
    "one sample": [(123456, 0.25)],
    "no samples": [],
    "zero seconds": [(10, 0.0), (20, 0.0)],
    "uneven": [(1, 1e-6), (2 ** 27, 0.0751), (2 ** 20, 0.003)],
}
# The eager twin's threefry (engine/rng.py): rotates and xors on uint32
# words, which only a trace of the twin's run holds.
THREEFRY_OPS = {"aten::__xor__", "aten::__lshift__", "aten::__rshift__"}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_meters_give_the_jax_packages_summaries(name):
    from pvtrace_tpu.utils import ThroughputMeter as JaxMeter

    got, ref = ThroughputMeter(), JaxMeter()
    for photons, seconds in SAMPLES[name]:
        got.add(photons, seconds)
        ref.add(photons, seconds)
    assert got.summary() == ref.summary()
    for key in ("photons", "seconds", "rate", "first_sample_rate", "steady_rate"):
        assert getattr(got, key) == getattr(ref, key), key


def test_timer_and_measure():
    with Timer() as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    meter = ThroughputMeter()
    meter.add(1000, 2.0)
    with meter.measure(100):
        pass
    assert meter.photons == 1100 and meter.summary()["samples"] == 2


def test_device_memory_stats_on_the_cpu_is_empty():
    assert device_memory_stats(device="cpu") == {}


def test_trace_profile_names_the_twins_ops(tmp_path):
    from pvtrace_tpu_torch import engine, scenes

    scene = scenes.lsc_slab()
    with trace_profile(tmp_path, device="cpu"):
        result = engine.simulate(scene, 64, seed=1, record_every=0, device="cpu")
    assert int(result.data["fates"].sum()) == 64
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert THREEFRY_OPS <= names
    assert not [e for e in events if e.get("cat") == "kernel"]


def test_without_cuda_the_default_device_raises(tmp_path, no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        device_memory_stats()
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace_profile(tmp_path):
            pytest.fail("the block ran without the card")
    assert not list(tmp_path.iterdir())


@pytest.mark.gpu
def test_device_memory_stats_on_the_card(card):
    before = device_memory_stats()
    keep = torch.empty(1 << 20, device="cuda")
    stats = device_memory_stats()
    assert sorted(stats) == ["bytes_in_use", "bytes_limit", "bytes_reserved",
                             "peak_bytes_in_use"]
    assert stats["bytes_in_use"] >= before["bytes_in_use"] + keep.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] >= stats["bytes_reserved"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
