"""The port's engine: scene tensors, the eager twins and ``simulate``.

    from pvtrace_tpu_torch import engine
    result = engine.simulate(scene, 1_000_000, record_every=0)   # on "cuda"
    result.fate_counts(), result.recorders

Lights the compiler lowers to device samplers are emitted inside the
trace (``device_emit.py``, K2); others are emitted on the host by
``emit.py::emit_bundle`` and traced as a bundle (K8's trace_bundle
entry). ``simulate_stream`` and ``simulate_checkpointed`` trace a budget
in bundles whose union equals one run. ``pvtrace_tpu_torch.parallel``
shards ``simulate``'s photon axis over processes.
"""
from pvtrace_tpu_torch.engine.api import is_available, simulate, simulate_stream
from pvtrace_tpu_torch.engine.checkpoint import AccumulatedResult, simulate_checkpointed
from pvtrace_tpu_torch.engine.compiler import CompiledScene, UnsupportedSceneError, compile_scene
from pvtrace_tpu_torch.engine.history_tally import tally_histories
from pvtrace_tpu_torch.engine.recorder import Heatmap, Histogram, Recorder
from pvtrace_tpu_torch.engine.result import EngineResult, RecorderResult
from pvtrace_tpu_torch.engine.tables import scene_tensors

# The JAX package's names in its order, then the port's own.
__all__ = [
    "EngineResult",
    "RecorderResult",
    "is_available",
    "simulate",
    "simulate_stream",
    "AccumulatedResult",
    "simulate_checkpointed",
    "CompiledScene",
    "UnsupportedSceneError",
    "compile_scene",
    "Heatmap",
    "Histogram",
    "Recorder",
    "tally_histories",
    "scene_tensors",
]
