"""The port's engine: scene tensors, the eager twins and ``simulate``.

    from pvtrace_tpu_torch import engine
    result = engine.simulate(scene, 1_000_000, record_every=0)   # on "cuda"
    result.fate_counts(), result.recorders

Lights the compiler lowers to device samplers are emitted inside the
trace (``device_emit.py``, K2); others are emitted on the host by
``emit.py::emit_bundle`` and traced as a bundle (K8's trace_bundle
entry). ``pvtrace_tpu_torch.parallel`` shards ``simulate``'s photon axis
over processes.
"""
from pvtrace_tpu_torch.engine.api import simulate
from pvtrace_tpu_torch.engine.compiler import CompiledScene, UnsupportedSceneError, compile_scene
from pvtrace_tpu_torch.engine.recorder import Heatmap, Histogram, Recorder
from pvtrace_tpu_torch.engine.result import EngineResult, RecorderResult
from pvtrace_tpu_torch.engine.tables import scene_tensors

__all__ = [
    "CompiledScene",
    "EngineResult",
    "Heatmap",
    "Histogram",
    "Recorder",
    "RecorderResult",
    "UnsupportedSceneError",
    "compile_scene",
    "scene_tensors",
    "simulate",
]
