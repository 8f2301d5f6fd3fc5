"""ctypes wrappers of the hand-written CUDA kernels (csrc/tracer.cu).

Each wrapper takes the scene tensors of ``engine.tables.scene_tensors``:

* on the CPU it runs the kernel's plain-PyTorch twin;
* on a CUDA device it checks device, dtype, shape and contiguity,
  allocates its outputs, launches on ``torch.cuda.current_stream()``,
  raises if the launch failed, and adds one to ``launches[name]``.
  There is no fallback: a CUDA tensor the kernel does not take raises.

The kernels cover float32 only; float64 CUDA tensors raise
NotImplementedError. The library is built by ``build.build()`` at the
first launch.
"""
import ctypes

import torch

from pvtrace_tpu_torch.engine import physics, tracer
from pvtrace_tpu_torch.kernels import build

# Launches of each kernel since the last reset(), and the thread count of
# the last pvt_trace launch.
launches = {"pvt_emit": 0, "pvt_step": 0, "pvt_trace": 0}
last_trace_threads = 0

_SCENE_PTRS = (
    "node_f", "node_i", "comp_f", "comp_i", "ovr_f", "ovr_i", "light_f",
    "light_i", "spec_pack", "ems_icdf_pairs", "light_icdf_pairs",
)
_STATE_PTRS = physics.STATE_FLOATS + ("source", "count", "alive", "k0", "k1")
_FLAG_PTRS = ("hit", "container") + physics.FLAGS


class _Scene(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _SCENE_PTRS] + [
        (name, ctypes.c_int) for name in (
            "n_nodes", "root_id", "n_lights", "n_lum", "grid_n", "icdf_n",
            "pack_width", "maxsteps", "emit_method",
        )
    ] + [(name, ctypes.c_float) for name in ("grid_x0", "grid_dx", "maxpathlength")]


class _State(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _STATE_PTRS]


class _Flags(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _FLAG_PTRS]


_lib = None


def reset():
    for name in launches:
        launches[name] = 0


def library():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        path, _ = build.build()
        lib = ctypes.CDLL(str(path))
        vp, u32, u64, i64 = ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_longlong
        lib.pvt_emit.argtypes = [vp, u32, u32, u64, i64, vp, vp]
        lib.pvt_step.argtypes = [vp, vp, vp, vp, i64, vp]
        lib.pvt_trace.argtypes = [vp, u32, u32, u64, i64, vp, vp, vp, vp, vp]
        for fn in (lib.pvt_emit, lib.pvt_step, lib.pvt_trace):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cpu(st):
    return st["node_f"].device.type == "cpu"


def _check_scene(st):
    dev = st["node_f"].device
    if dev.type != "cuda":
        raise ValueError(f"kernels need CUDA tensors, got {dev}")
    if st["node_f"].dtype != torch.float32:
        raise NotImplementedError(
            "the CUDA kernels cover float32 only; use float32 scene tensors"
        )
    for name in _SCENE_PTRS:
        t = st[name]
        want = torch.int32 if name.endswith("_i") else torch.float32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"scene tensor {name}: need contiguous {want} on {dev}")


def _scene(st, maxsteps, emit_method, maxpathlength):
    meta = st["meta"]
    return _Scene(
        *(st[name].data_ptr() for name in _SCENE_PTRS),
        meta["n_nodes"], meta["root_id"], meta["n_lights"], meta["n_lum"],
        meta["grid_n"], meta["icdf_n"], meta["pack_width"], int(maxsteps),
        int(emit_method), meta["grid_x0"], meta["grid_dx"], float(maxpathlength),
    )


def _empty_state(B, device):
    f = dict(device=device, dtype=torch.float32)
    s = {name: torch.empty(B, **f) for name in physics.STATE_FLOATS}
    s["source"] = torch.empty(B, device=device, dtype=torch.int32)
    s["count"] = torch.empty(B, device=device, dtype=torch.int32)
    s["alive"] = torch.empty(B, device=device, dtype=torch.bool)
    s["k0"] = torch.empty(B, device=device, dtype=torch.int64)
    s["k1"] = torch.empty(B, device=device, dtype=torch.int64)
    return s


def _struct(cls, tensors, names):
    return cls(*(tensors[name].data_ptr() for name in names))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")


def emit(st, seed_words, index_offset, B):
    """Keys and initial state of photons ``index_offset + [0, B)``."""
    if _on_cpu(st):
        pids = index_offset + torch.arange(B, dtype=torch.int64)
        return tracer.initial_state(st, seed_words, pids)
    _check_scene(st)
    out = _empty_state(B, st["node_f"].device)
    sc = _scene(st, 0, 0, float("inf"))
    rc = library().pvt_emit(
        ctypes.byref(sc), seed_words[0], seed_words[1], index_offset, B,
        ctypes.byref(_struct(_State, out, _STATE_PTRS)), _stream(),
    )
    _raise_on(rc, "pvt_emit")
    launches["pvt_emit"] += 1
    return out


def step(st, s, maxsteps=1000, emit_method=0, maxpathlength=float("inf")):
    """One loop step of lanes `s`: the new state with the per-lane flags,
    ``hit`` and ``container`` (the twin's ``tracer.step_state``)."""
    if _on_cpu(st):
        return tracer.step_state(st, s, maxsteps, emit_method, maxpathlength)
    _check_scene(st)
    dev = st["node_f"].device
    B = s["px"].shape[0]
    want = _empty_state(B, dev)
    for name in _STATE_PTRS:
        t = s[name]
        if t.shape != (B,) or t.dtype != want[name].dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"state {name}: need contiguous {want[name].dtype} [{B}] on {dev}")
    flags = {name: torch.empty(B, device=dev, dtype=torch.bool) for name in physics.FLAGS}
    flags["hit"] = torch.empty(B, device=dev, dtype=torch.int32)
    flags["container"] = torch.empty(B, device=dev, dtype=torch.int32)
    sc = _scene(st, maxsteps, emit_method, maxpathlength)
    rc = library().pvt_step(
        ctypes.byref(sc), ctypes.byref(_struct(_State, s, _STATE_PTRS)),
        ctypes.byref(_struct(_State, want, _STATE_PTRS)),
        ctypes.byref(_struct(_Flags, flags, _FLAG_PTRS)), B, _stream(),
    )
    _raise_on(rc, "pvt_step")
    launches["pvt_step"] += 1
    return dict(want, **flags)


def trace(st, seed_words, n, index_offset=0, lanes=None, maxsteps=1000,
          emit_method=0, maxpathlength=float("inf")):
    """Trace photons ``index_offset + [0, n)``; returns (fates, steps).

    On the card, `lanes` caps the persistent kernel's thread count (None:
    the resident capacity) and `steps` is the largest per-photon step
    count, where the eager twin reports its number of wavefront steps."""
    if _on_cpu(st):
        return tracer.trace_eager(
            st, seed_words, n, index_offset, lanes, maxsteps, emit_method,
            maxpathlength,
        )
    _check_scene(st)
    dev = st["node_f"].device
    nxt = torch.full((1,), index_offset, device=dev, dtype=torch.int64)
    fates = torch.zeros(physics.N_FATES, device=dev, dtype=torch.int64)
    longest = torch.zeros(1, device=dev, dtype=torch.int32)
    threads = ctypes.c_longlong(0)
    sc = _scene(st, maxsteps, emit_method, maxpathlength)
    rc = library().pvt_trace(
        ctypes.byref(sc), seed_words[0], seed_words[1], index_offset + n,
        n if lanes is None else min(lanes, n), nxt.data_ptr(),
        fates.data_ptr(), longest.data_ptr(), ctypes.byref(threads), _stream(),
    )
    _raise_on(rc, "pvt_trace")
    launches["pvt_trace"] += 1
    global last_trace_threads
    last_trace_threads = threads.value
    return fates, int(longest.item())
