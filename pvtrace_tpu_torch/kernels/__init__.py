"""ctypes wrappers of the hand-written CUDA kernels (csrc/tracer.cu,
csrc/score.cu, csrc/pathwise.cu, csrc/diff.cu).

Each wrapper takes the scene tensors of ``engine.tables.scene_tensors``
(``log_pack`` a trace's event log):

* on the CPU it runs the kernel's plain-PyTorch twin;
* on a CUDA device it checks device, dtype, shape and contiguity,
  allocates its outputs, launches on ``torch.cuda.current_stream()``,
  raises if the launch failed, and adds one to ``launches[name]``.
  There is no fallback: a CUDA tensor the kernel does not take raises.

The dtype of the scene tensors picks the library: float32 launches the
float32 libraries, float64 the float64 build of the trace library
(``tracer_f64``: ``pvt_emit``, ``pvt_step``, ``pvt_trace`` in every mode
without scores, ``pvt_cheb``, ``pvt_tally``, ``pvt_mesh``, ``pvt_draws``,
``pvt_log_pack``), whose launches count under the same names. The score,
pathwise and K15 kernels cover float32 only: their wrappers raise
NotImplementedError for float64 CUDA tensors (ROADMAP queue 1, float64
gradients). Nothing converts a float64 run to float32 or moves it to the
CPU. Each library is built by ``build.build()`` at its first launch.
"""
import ctypes

import torch

from pvtrace_tpu_torch.engine import absorb, chebyshev, device_emit, eventlog, geometry, physics
from pvtrace_tpu_torch.engine import rng, tally, tracer
from pvtrace_tpu_torch.engine import pathwise as path
from pvtrace_tpu_torch.engine import score as score_ch
from pvtrace_tpu_torch.engine import tables as T
from pvtrace_tpu_torch.kernels import build

# Launches of each kernel since the last reset() ("pvt_trace_log": those
# launches of pvt_trace that wrote an event log; "pvt_trace_score": those
# with score channels; "pvt_trace_pathwise": those with pathwise channels
# as well; "pvt_trace_bundle": those that started from a host bundle), and
# the trace launches' summed time on the card (ms, as in last_trace, by
# the same names: "pvt_trace" all of them). What the last pvt_trace launch
# reported: its thread count, the dynamic shared memory of a block,
# whether the recorder bins, the score sums, the K5a table ("shared_cheb"),
# the threads' score and tangent rows ("shared_rows") and the mesh
# triangles ("shared_tris") were in shared memory (else in device memory),
# the steps its photons took in all, the
# lane-steps of its warps' turns (32 a turn of each warp: a lane without a
# photon idles through its warp's turn) and the share of them that traced
# a photon (``lane_efficiency``), and its time on the card (CUDA events,
# ms); and where the last pvt_cheb launch read the table.
launches = {"pvt_emit": 0, "pvt_step": 0, "pvt_trace": 0, "pvt_cheb": 0, "pvt_tally": 0,
            "pvt_mesh": 0, "pvt_trace_log": 0, "pvt_trace_score": 0, "pvt_score": 0,
            "pvt_fresnel": 0, "pvt_trace_pathwise": 0, "pvt_pathwise": 0, "pvt_absorbed": 0,
            "pvt_absorbed_grad": 0, "pvt_trace_bundle": 0, "pvt_draws": 0, "pvt_log_pack": 0}
launch_ms = {"pvt_trace": 0.0, "pvt_trace_score": 0.0, "pvt_trace_pathwise": 0.0}
# Of those, the launches of the float64 build (``tracer_f64``), by the same
# names.
launches_f64 = {name: 0 for name in ("pvt_emit", "pvt_step", "pvt_trace", "pvt_cheb",
                                     "pvt_tally", "pvt_mesh", "pvt_trace_log", "pvt_trace_bundle",
                                     "pvt_draws", "pvt_log_pack")}
last_trace = {"threads": 0, "shared_bytes": 0, "shared_bins": 0, "shared_scores": 0,
              "shared_cheb": 0, "shared_rows": 0, "shared_tris": 0, "total_steps": 0,
              "lane_steps": 0, "lane_efficiency": 0.0, "ms": 0.0, "library": ""}
last_cheb = {"shared_cheb": 0}
# CUDA events around the last pvt_log_pack launch (its time once the
# stream has passed them: ``pack_ms``).
last_pack = {"events": None}
# A trace block's threads (tracer.cuh's kBlock).
BLOCK = 256
# tracer.cuh's kWarpGroup: pvt_tally, and pvt_trace's launch with
# recorders alone, add a scene's recorder events by the warp rule
# (tally_warp) when one of its facet groups holds more recorders than
# this, else each lane its own (tally_event); every other trace launch
# takes the lane rule (tally_rule, trace_rule).
WARP_GROUP = 12
# What a trace launch's info[1..6] report (tracer.cuh's layout_info).
_PLACEMENT = ("shared_bytes", "shared_bins", "shared_scores", "shared_cheb", "shared_rows",
              "shared_tris")

_SCENE_PTRS = (
    "node_f", "node_i", "comp_f", "comp_i", "ovr_f", "ovr_i", "tri_f", "light_f",
    "light_i", "spec_pack", "ems_icdf_pairs", "light_icdf_pairs", "cheb_slot", "cheb_ref",
    "cheb_pack", "rec_f", "rec_i", "hist_f", "hist_i", "rec_csr", "rec_ids",
)
_SCENE_INTS = (
    "node_i", "comp_i", "ovr_i", "light_i", "cheb_slot", "cheb_ref", "cheb_pack", "rec_i",
    "hist_i", "rec_csr", "rec_ids",
)
_SCENE_META_INTS = (
    "n_nodes", "root_id", "n_lights", "n_lum", "grid_n", "icdf_n", "pack_width", "n_tris",
)
# K9's facet groups, at the end of the struct (the first two int32).
_SCENE_GROUPS = ("rec_grp", "grp_pos", "grp_f")
_STATE_PTRS = physics.STATE_FLOATS + ("source", "count", "alive", "k0", "k1")
_FLAG_PTRS = ("hit", "container") + physics.FLAGS + physics.SELECTORS \
    + physics.EVENT_FLAGS + physics.SURFACE
_TALLY_PTRS = ("distinct", "cross", "bins", "sums")


def _scene_fields(real):
    """PvtScene's fields, its reals of ctypes type `real`."""
    return [(name, ctypes.c_void_p) for name in _SCENE_PTRS] + [
        (name, ctypes.c_int) for name in _SCENE_META_INTS + (
            "maxsteps", "emit_method", "cheb_spec", "cheb_icdf", "cheb_light",
            "cheb_icdf0", "cheb_light0", "cheb_words", "n_rec", "total_bins",
        )
    ] + [
        (name, real) for name in ("grid_x0", "grid_dx", "maxpathlength", "cheb_tscale")
    ] + [(name, ctypes.c_void_p) for name in _SCENE_GROUPS] + [
        (name, ctypes.c_int) for name in ("n_grp", "grp_max")]


class _Scene(ctypes.Structure):
    _fields_ = _scene_fields(ctypes.c_float)


class _Scene64(ctypes.Structure):
    """PvtScene of the float64 build (tracer.cuh with -DPVT_F64)."""
    _fields_ = _scene_fields(ctypes.c_double)


class _State(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _STATE_PTRS]


class _Flags(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _FLAG_PTRS]


class _TallyOut(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _TALLY_PTRS]


class _Log(ctypes.Structure):
    _fields_ = [
        ("ints", ctypes.c_void_p), ("floats", ctypes.c_void_p), ("n_slots", ctypes.c_longlong),
        ("max_events", ctypes.c_int), ("every", ctypes.c_uint), ("first", ctypes.c_ulonglong),
        ("counts", ctypes.c_void_p),
    ]


class _Score(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_void_p), ("fate_scores", ctypes.c_void_p),
        ("rec_scores", ctypes.c_void_p), ("stride", ctypes.c_longlong), ("ch", ctypes.c_int),
        ("n_comps", ctypes.c_int), ("shared", ctypes.c_int), ("photon", ctypes.c_void_p),
        ("photon_n", ctypes.c_longlong), ("tang", ctypes.c_void_p), ("path", ctypes.c_void_p),
        ("n_path", ctypes.c_int), ("shared_rows", ctypes.c_int),
    ]


class _Path(ctypes.Structure):
    _fields_ = [
        ("path", ctypes.c_void_p), ("n", ctypes.c_int), ("tin", ctypes.c_void_p),
        ("tout", ctypes.c_void_p), ("jv", ctypes.c_void_p), ("ds", ctypes.c_void_p),
    ]


class _Bundle(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("first", ctypes.c_ulonglong)]


class _Absorbers(ctypes.Structure):
    _fields_ = [
        ("node_f", ctypes.c_void_p), ("node_i", ctypes.c_void_p), ("alpha", ctypes.c_void_p),
        ("n", ctypes.c_int), ("grid_n", ctypes.c_int), ("x0", ctypes.c_float),
        ("dx", ctypes.c_float),
    ]


_VP, _U32, _U64, _I32, _I64 = (
    ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_longlong
)
# Each library's entry points and their argument types.
_ENTRIES = {
    "tracer": {
        "pvt_emit": [_VP, _U32, _U32, _U64, _I64, _VP, _VP],
        "pvt_step": [_VP, _VP, _VP, _VP, _I64, _VP],
        "pvt_cheb": [_VP, _I32, _VP, _I64, _VP, _VP, _I32, _VP, _VP],
        "pvt_tally": [_VP, _VP, _VP, _VP, _I64, _VP, _VP, _VP],
        "pvt_trace": [_VP, _U32, _U32, _U64, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP],
        "pvt_mesh": [_VP, _I32, ctypes.c_float, _VP, _VP, _I64, _VP, _VP, _VP, _VP, _VP],
        "pvt_layout": [_VP, _I32, _VP, _VP],
        "pvt_draws": [_U32, _U32, _VP, _VP, _U32, _VP, _VP, _VP, _VP, _I64, _VP, _VP, _VP, _VP,
                      _VP],
        "pvt_log_pack": [_VP, _VP, _VP, _VP, _VP],
    },
    "score": {
        "pvt_score": [_VP, _VP, _VP, _VP, _I64, _VP, _VP, _VP],
        "pvt_fresnel": [_VP, _VP, _VP, _I64, _VP, _VP, _VP],
        "pvt_trace_score": [_VP, _U32, _U32, _U64, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                            _VP, _VP, _VP],
    },
    "pathwise": {
        "pvt_pathwise": [_VP, _VP, _VP, _VP, _I64, _VP, _VP, _VP],
        "pvt_trace_pathwise": [_VP, _U32, _U32, _U64, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                               _VP, _VP, _VP],
    },
    "diff": {
        "pvt_absorbed": [_VP, _VP, _VP, _VP, _VP, _I64, _VP, _VP, _VP],
        "pvt_absorbed_grad": [_VP, _VP, _VP, _I64, _I32, _VP, _VP],
    },
}
# The float64 build of the trace library: the same entries, pvt_mesh's
# tolerance a double.
_ENTRIES["tracer_f64"] = dict(
    _ENTRIES["tracer"],
    pvt_mesh=[_VP, _I32, ctypes.c_double, _VP, _VP, _I64, _VP, _VP, _VP, _VP, _VP])
_libs = {}
# What float64 is refused by: the libraries without a float64 build.
F64_GRADIENTS = ("float64 on the card covers pvt_trace and the kernels of tracer.cu only; the "
                 "score, pathwise and Beer-Lambert kernels are float32 (ROADMAP queue 1, "
                 "float64 gradients): use float32, or device='cpu' for the float64 twin")


def tally_rule(meta):
    """The rule by which pvt_tally adds the events of a scene whose
    tensors have `meta`: "tally_warp" or "tally_event" (tracer.cuh's
    tally_rule)."""
    return "tally_warp" if meta["grp_max"] > WARP_GROUP else "tally_event"


def reset():
    for counts in (launches, launches_f64):
        for name in counts:
            counts[name] = 0
    for name in launch_ms:
        launch_ms[name] = 0.0


def library(name="tracer"):
    """The loaded kernel library `name` (build.LIBRARIES), built first if
    needed."""
    if name not in _libs:
        path, _ = build.build(name)
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in _ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def _on_cpu(st):
    return st["node_f"].device.type == "cpu"


def tracer_library(dtype):
    """The trace library of real type `dtype`: "tracer" (float32) or
    "tracer_f64" (float64)."""
    if dtype == torch.float32:
        return "tracer"
    if dtype == torch.float64:
        return "tracer_f64"
    raise ValueError(f"the kernels take float32 or float64, got {dtype}")


def _check_scene(st, lib="tracer"):
    """Check CUDA scene tensors `st` for the library of `lib`'s kind
    ("tracer", or a float32-only one: "score", "pathwise"); returns the
    library to launch, by the tensors' dtype."""
    dev, dtype = st["node_f"].device, st["node_f"].dtype
    if dev.type != "cuda":
        raise ValueError(f"kernels need CUDA tensors, got {dev}")
    traced = tracer_library(dtype)
    if dtype == torch.float64 and lib != "tracer":
        raise NotImplementedError(F64_GRADIENTS)
    lib = traced if lib == "tracer" else lib
    word = torch.int64 if dtype == torch.float64 else torch.int32
    for name in _SCENE_PTRS + _SCENE_GROUPS:
        t = st[name]
        want = word if name == "cheb_pack" else torch.int32 \
            if name in _SCENE_INTS + _SCENE_GROUPS[:2] else dtype
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"scene tensor {name}: need contiguous {want} on {dev}")
    if st["cheb_pack"].data_ptr() % 16:
        raise ValueError("scene tensor cheb_pack: the kernels read it 16 bytes at a time; "
                         "need it 16-byte aligned")
    return lib


def _scene(st, maxsteps, emit_method, maxpathlength):
    """The PvtScene of scene tensors `st`, of the build of their dtype."""
    meta = st["meta"]
    cls = _Scene64 if st["node_f"].dtype == torch.float64 else _Scene
    return cls(
        *(st[name].data_ptr() for name in _SCENE_PTRS),
        *(meta[name] for name in _SCENE_META_INTS), int(maxsteps), int(emit_method),
        int(meta["cheb_spec"]), int(meta["cheb_icdf"]), int(meta["cheb_light"]),
        meta["cheb_icdf0"], meta["cheb_light0"], meta["cheb_words"], meta["n_rec"],
        meta["total_bins"],
        meta["grid_x0"], meta["grid_dx"], float(maxpathlength),
        2.0 / (meta["grid_n"] - 1), *(st[name].data_ptr() for name in _SCENE_GROUPS),
        meta["n_grp"], meta["grp_max"],
    )


def _empty_state(B, device, dtype=torch.float32):
    f = dict(device=device, dtype=dtype)
    s = {name: torch.empty(B, **f) for name in physics.STATE_FLOATS}
    s["source"] = torch.empty(B, device=device, dtype=torch.int32)
    s["count"] = torch.empty(B, device=device, dtype=torch.int32)
    s["alive"] = torch.empty(B, device=device, dtype=torch.bool)
    s["k0"] = torch.empty(B, device=device, dtype=torch.int64)
    s["k1"] = torch.empty(B, device=device, dtype=torch.int64)
    return s


def _empty_flags(B, device, real=torch.float32):
    flags = {}
    for names, dtype in (
        (("hit", "container") + physics.SELECTORS, torch.int32),
        (physics.FLAGS + physics.EVENT_FLAGS, torch.bool),
        (physics.SURFACE, real),
    ):
        flags.update({name: torch.empty(B, device=device, dtype=dtype) for name in names})
    return flags


def _check_lanes(tensors, want, B, dev):
    for name, ref in want.items():
        t = tensors[name]
        if t.shape != (B,) or t.dtype != ref.dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"lane input {name}: need contiguous {ref.dtype} [{B}] on {dev}")


def _struct(cls, tensors, names):
    return cls(*(tensors[name].data_ptr() for name in names))


def zero_tally_out(st):
    """Zeroed device outputs of K9: int64 (u64 bits) counts and bins, and
    float64 sums (at least one entry each, so no pointer is null)."""
    meta, dev = st["meta"], st["node_f"].device
    R = max(meta["n_rec"], 1)
    z = dict(device=dev, dtype=torch.int64)
    return {
        "distinct": torch.zeros(R, **z), "cross": torch.zeros(R, **z),
        "bins": torch.zeros(max(meta["total_bins"], 1), **z),
        "sums": torch.zeros((R, 8), device=dev, dtype=torch.float64),
    }


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")


def _launched(name, lib):
    """Count a launch of `name` from library `lib`."""
    launches[name] += 1
    if lib == "tracer_f64":
        launches_f64[name] += 1


def _check_device_lights(st):
    """Device emission needs the scene's lights as device samplers."""
    if not st["meta"]["n_lights"]:
        raise ValueError(device_emit.NO_DEVICE_LIGHTS)


def emit(st, seed_words, index_offset, B):
    """Keys and initial state of photons ``index_offset + [0, B)``."""
    if _on_cpu(st):
        pids = index_offset + torch.arange(B, dtype=torch.int64)
        return tracer.initial_state(st, seed_words, pids)
    lib = _check_scene(st)
    _check_device_lights(st)
    out = _empty_state(B, st["node_f"].device, st["node_f"].dtype)
    sc = _scene(st, 0, 0, float("inf"))
    rc = library(lib).pvt_emit(
        ctypes.byref(sc), seed_words[0], seed_words[1], index_offset, B,
        ctypes.byref(_struct(_State, out, _STATE_PTRS)), _stream(),
    )
    _raise_on(rc, "pvt_emit")
    _launched("pvt_emit", lib)
    return out


def draws(seed_words, base, dead, need, k0, k1, count, mask, dtype=torch.float32):
    """The trace kernel's draws on B lanes, each 32 a warp (the twin:
    ``rng.warp_draws``, whose arguments and results these are): per warp
    the refill of its `dead` lanes (photons base[w] + rank: keys and the
    emission pairs of `need`), per lane the words of `mask` of its step.
    Tensors: base int64 [B / 32], dead bool, k0 and k1 int64, count int32,
    mask uint8, each [B]. The uniforms come in `dtype`, the real type of
    the build that draws them (``tracer_f64`` for float64: the float32
    uniforms widened)."""
    if dead.device.type == "cpu":
        return rng.warp_draws(seed_words, base, dead, need, k0, k1, count, mask, dtype)
    B, dev = dead.numel(), dead.device
    if B % rng.WARP:
        raise ValueError(f"draws: {B} lanes, not a multiple of {rng.WARP}")
    given = {"dead": (dead, torch.bool), "k0": (k0, torch.int64), "k1": (k1, torch.int64),
             "count": (count, torch.int32), "mask": (mask, torch.uint8)}
    for name, (t, want) in given.items():
        if t.shape != (B,) or t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"draws: {name} needs contiguous {want} [{B}] on {dev}")
    W = B // rng.WARP
    if base.shape != (W,) or base.dtype != torch.int64 or base.device != dev:
        raise ValueError(f"draws: base needs int64 [{W}] on {dev}")
    keys = torch.empty((B, 2), device=dev, dtype=torch.int64)
    emit = torch.empty((B, 6), device=dev, dtype=dtype)
    words = torch.empty((B, 8), device=dev, dtype=dtype)
    calls = torch.empty(W, device=dev, dtype=torch.int32)
    rc = library(tracer_library(dtype)).pvt_draws(
        seed_words[0], seed_words[1], base.contiguous().data_ptr(), dead.data_ptr(), need,
        k0.data_ptr(), k1.data_ptr(), count.data_ptr(), mask.data_ptr(), B, keys.data_ptr(),
        emit.data_ptr(), words.data_ptr(), calls.data_ptr(), _stream(),
    )
    _raise_on(rc, "pvt_draws")
    _launched("pvt_draws", tracer_library(dtype))
    return keys, emit, words, calls


def step(st, s, maxsteps=1000, emit_method=0, maxpathlength=float("inf")):
    """One loop step of lanes `s`: the new state with the per-lane flags,
    ``hit``, ``container``, recorder selectors and surface normals (the
    twin's ``tracer.step_state``)."""
    if _on_cpu(st):
        return tracer.step_state(st, s, maxsteps, emit_method, maxpathlength)
    lib = _check_scene(st)
    dev, dtype = st["node_f"].device, st["node_f"].dtype
    B = s["px"].shape[0]
    want = _empty_state(B, dev, dtype)
    _check_lanes(s, want, B, dev)
    flags = _empty_flags(B, dev, dtype)
    sc = _scene(st, maxsteps, emit_method, maxpathlength)
    rc = library(lib).pvt_step(
        ctypes.byref(sc), ctypes.byref(_struct(_State, s, _STATE_PTRS)),
        ctypes.byref(_struct(_State, want, _STATE_PTRS)),
        ctypes.byref(_struct(_Flags, flags, _FLAG_PTRS)), B, _stream(),
    )
    _raise_on(rc, "pvt_step")
    _launched("pvt_step", lib)
    return dict(want, **flags)


def cheb(st, t, shared=True, segments=False):
    """Every K5a fit of the scene at the values `t`: [n_fits, len(t)]
    (the twin: ``chebyshev.eval_fits``), and with `segments` the int64
    index of the segment each value took (the row of ``cheb_seg_f``, -1
    for none; the twin: ``chebyshev._segment``). On the card the blocks
    stage the table in shared memory when `shared` and it fits
    (``last_cheb["shared_cheb"]``), else read it in device memory."""
    F = st["meta"]["cheb_n_fits"]
    if _on_cpu(st):
        fit = torch.arange(F, dtype=torch.int64).repeat_interleave(t.shape[0])
        out = chebyshev.eval_fits(st, fit, t.repeat(F)).reshape(F, -1)
        return (out, chebyshev._segment(st, fit, t.repeat(F)).reshape(F, -1)) if segments \
            else out
    lib = _check_scene(st)
    dtype = st["node_f"].dtype
    if t.dtype != dtype or t.device != st["node_f"].device or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError(f"t: need a contiguous {dtype} vector on the scene's device")
    out = torch.empty((F, t.shape[0]), device=t.device, dtype=dtype)
    seg = torch.empty((F, t.shape[0]), device=t.device, dtype=torch.int32) if segments else None
    placed = ctypes.c_int(0)
    sc = _scene(st, 0, 0, float("inf"))
    rc = library(lib).pvt_cheb(ctypes.byref(sc), F, t.data_ptr(), t.shape[0], out.data_ptr(),
                            seg.data_ptr() if segments else None, int(shared),
                            ctypes.byref(placed), _stream())
    _raise_on(rc, "pvt_cheb")
    _launched("pvt_cheb", lib)
    last_cheb["shared_cheb"] = placed.value
    return (out, seg.long()) if segments else out


def pack_seen(seen):
    """[B, R] bool -> [B, SEEN_WORDS] int32 words (bit j of word k is
    recorder 32k + j), the kernel's per-photon bitset."""
    B, R = seen.shape
    bits = torch.zeros((B, T.MAX_RECORDERS), dtype=torch.int64, device=seen.device)
    bits[:, :R] = seen.long()
    weights = torch.ones(32, dtype=torch.int64, device=seen.device) << torch.arange(
        32, device=seen.device
    )
    words = (bits.view(B, T.SEEN_WORDS, 32) * weights).sum(2)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_seen(words, R):
    """Inverse of ``pack_seen``: [B, R] bool."""
    w = words.long() & 0xFFFFFFFF
    bits = (w[:, :, None] >> torch.arange(32, device=words.device)) & 1
    return bits.reshape(words.shape[0], T.MAX_RECORDERS)[:, :R] != 0


def tally_step(t, st, out):
    """Add one step's events (`out`: post-step state, selectors and
    normals, as ``step`` returns them) to tallies `t` (``tally.empty``'s
    dict), in place: the twin ``tally.tally`` on the CPU, ``pvt_tally`` on
    the card. Returns whether the bins were accumulated in shared memory
    (None on the CPU)."""
    if _on_cpu(st):
        tally.tally(t, st, out)
        return None
    if not st["meta"]["n_rec"]:
        return None
    words = pack_seen(t["seen"]).contiguous()
    res = zero_tally_out(st)
    shared = launch_tally(st, out, words, res)
    R = t["seen"].shape[1]
    t["distinct"] += res["distinct"][:R]
    t["cross"] += res["cross"][:R]
    t["sums"] += res["sums"][:R].to(t["sums"].dtype)
    t["bins"] += res["bins"][:t["bins"].shape[0]]
    t["seen"] = unpack_seen(words, R)
    return shared


def launch_tally(st, out, words, res):
    """Launch pvt_tally on the events `out` with the seen words `words`
    ([B, SEEN_WORDS] int32, updated) into `res` (``zero_tally_out``'s
    dict, added to). Returns whether the bins were in shared memory."""
    lib = _check_scene(st)
    dev, dtype = st["node_f"].device, st["node_f"].dtype
    B = out["px"].shape[0]
    _check_lanes(out, dict(_empty_state(B, dev, dtype), **_empty_flags(B, dev, dtype)), B, dev)
    if words.shape != (B, T.SEEN_WORDS) or words.dtype != torch.int32 \
            or not words.is_contiguous():
        raise ValueError(f"seen words: need contiguous int32 [{B}, {T.SEEN_WORDS}]")
    shared = ctypes.c_int(0)
    sc = _scene(st, 0, 0, float("inf"))
    rc = library(lib).pvt_tally(
        ctypes.byref(sc), ctypes.byref(_struct(_State, out, _STATE_PTRS)),
        ctypes.byref(_struct(_Flags, out, _FLAG_PTRS)), words.data_ptr(), B,
        ctypes.byref(_struct(_TallyOut, res, _TALLY_PTRS)), ctypes.byref(shared), _stream(),
    )
    _raise_on(rc, "pvt_tally")
    _launched("pvt_tally", lib)
    return bool(shared.value)


def mesh_rows(st, node):
    """The triangle rows of mesh node `node` and its forward-hit tolerance."""
    row = st["rows"]["node_i"][node]
    first, count = row[T.NI_TRI0], row[T.NI_NTRI]
    if not count:
        raise ValueError(f"node {node} is not a mesh")
    return st["tri_f"][first:first + count], st["rows"]["node_f"][node][T.NF_EPS]


def mesh(st, node, o, d):
    """K10 for rays (o, d: [B, 3], the local frame of mesh node `node`):
    (t1, t2, count, normal [B, 3]), the twin ``geometry.mesh_nearest_two``
    on the CPU, ``pvt_mesh`` on the card."""
    tri, eps = mesh_rows(st, node)
    if _on_cpu(st):
        t1, t2, cnt, nrm = geometry.mesh_nearest_two(tri, o.unbind(1), d.unbind(1), eps)
        return t1, t2, cnt, torch.stack(nrm, dim=1)
    lib = _check_scene(st)
    B = o.shape[0]
    for name, t in (("o", o), ("d", d)):
        if t.shape != (B, 3) or t.dtype != tri.dtype or t.device != tri.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {tri.dtype} [B, 3] on {tri.device}")
    f = dict(device=o.device, dtype=tri.dtype)
    t1, t2, nrm = torch.empty(B, **f), torch.empty(B, **f), torch.empty((B, 3), **f)
    cnt = torch.empty(B, device=o.device, dtype=torch.int32)
    rc = library(lib).pvt_mesh(
        tri.data_ptr(), tri.shape[0], eps, o.data_ptr(), d.data_ptr(), B, t1.data_ptr(),
        t2.data_ptr(), cnt.data_ptr(), nrm.data_ptr(), _stream(),
    )
    _raise_on(rc, "pvt_mesh")
    _launched("pvt_mesh", lib)
    return t1, t2, cnt, nrm


def _log_desc(log, record_every=1, first=0):
    S, E = log["ints"].shape[:2]
    return _Log(log["ints"].data_ptr(), log["floats"].data_ptr(), S, E, max(record_every, 1),
                first, log["counts"].data_ptr())


def empty_log(n, record_every, max_events, index_offset, device, fill=True,
              dtype=torch.float32):
    """The kernel's event log for a run of n photons from `index_offset`:
    (the log dict of ``ceil(n / record_every)`` slots, its floats in
    `dtype`, and its ctypes descriptor); no slots without a log. The
    counts are zeroed; the ints and floats are -1 and 0
    (``eventlog.empty``), or with `fill` False left as ``torch.empty``
    gives them, as a launch takes them: nothing past a row's count is
    written or read."""
    S = eventlog.n_slots(n, record_every)
    if fill:
        log = eventlog.empty(S, max_events, dtype, device)
    else:
        log = {
            "ints": torch.empty((S, max_events, T.LOG_I), dtype=torch.int32, device=device),
            "floats": torch.empty((S, max_events, T.LOG_F), dtype=dtype, device=device),
            "counts": torch.zeros(S, dtype=torch.int32, device=device),
        }
    first = eventlog.first_recorded(index_offset, record_every) if S else 0
    return log, _log_desc(log, record_every, first)


def log_pack(log):
    """The first ``counts[s]`` records of each slot s of the event `log`
    (a trace's, with ``counts``), in slot order: (ints [N, LOG_I] int32,
    floats [N, LOG_F]). On the CPU ``eventlog.pack``; on the card the
    kernel ``pvt_log_pack`` of the build of the floats' dtype, which
    copies only those records (the offsets, the counts' exclusive sum, by
    ``torch.cumsum``)."""
    counts = log["counts"]
    if counts.device.type == "cpu":
        return eventlog.pack(log, counts)
    S, E = log["ints"].shape[:2]
    dev, real = counts.device, log["floats"].dtype
    lib = tracer_library(real)
    for name, dtype, shape in (("ints", torch.int32, (S, E, T.LOG_I)),
                               ("floats", real, (S, E, T.LOG_F)),
                               ("counts", torch.int32, (S,))):
        t = log[name]
        if t.shape != shape or t.dtype != dtype or t.device != dev or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"log_pack: {name} needs contiguous {dtype} {list(shape)} on {dev}, "
                             "16-byte aligned")
    offsets = torch.cumsum(counts, 0)
    N = int(offsets[-1]) if S else 0
    offsets -= counts
    ints = torch.empty((N, T.LOG_I), dtype=torch.int32, device=dev)
    floats = torch.empty((N, T.LOG_F), dtype=real, device=dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rc = library(lib).pvt_log_pack(ctypes.byref(_log_desc(log)), offsets.data_ptr(),
                                ints.data_ptr(), floats.data_ptr(), _stream())
    _raise_on(rc, "pvt_log_pack")
    stop.record()
    _launched("pvt_log_pack", lib)
    last_pack["events"] = (start, stop)
    return ints, floats


def pack_ms():
    """The last pvt_log_pack launch's time on the card (ms); waits for it."""
    start, stop = last_pack["events"]
    stop.synchronize()
    return start.elapsed_time(stop)


def trace(st, seed_words, n, index_offset=0, lanes=None, maxsteps=1000,
          emit_method=0, maxpathlength=float("inf"), record_every=0, max_events=128,
          score=False, per_photon=False, pathwise=(), bundle=None, shared_rows=True):
    """Trace photons ``index_offset + [0, n)``; returns (fates, steps,
    tallies, log), as ``tracer.trace_eager`` does.

    On the card, `lanes` caps the persistent kernel's thread count (None:
    the resident capacity), `steps` is the largest per-photon step count,
    where the eager twin reports its number of wavefront steps, and the
    tallies have no ``seen``. Float32 scene tensors launch the float32
    library, float64 ones ``tracer_f64`` (``last_trace["library"]``; no
    score channels). The float32 build's sums are float32 per block, moved
    into float64 totals every ``tables.SUMS_FLUSH`` distinct rays of a
    recorder and at the end (``check.SUMS_BOUND``); the float64 build adds
    its float64 sums a block and then into the totals. With ``record_every >
    0`` the kernel writes the event log of every record_every-th photon
    (``eventlog``'s layout, S rows, and ``counts``): the rows are not
    filled, so only the first ``counts[s]`` records of row s are set
    (``log_pack`` takes them). With `score` the launch is
    ``pvt_trace_score``, and the tallies also hold ``fate_scores`` [11, CH]
    and ``rec_scores`` [max(R, 1), CH] (float64 sums of float32 path
    scores) and ``fate_abs``, ``rec_abs``, the sums of their addends'
    magnitudes (``check.score_runs_bound``). A block keeps its score sums
    in shared memory when they fit beside its tallies, else it adds them
    straight to the totals (``last_trace["shared_scores"]`` says which).
    With `per_photon` (`score`, index_offset 0) the kernel also writes
    each photon's record, returned as the twin's ``photon_scores``,
    ``photon_fate`` and ``photon_steps`` (no ``photon_slack``). With
    `score` and `pathwise` (resolved specs) the launch is
    ``pvt_trace_pathwise``: CH gains one channel per spec, and each
    thread keeps its photon's tangents beside its score row. A block keeps
    its threads' rows in shared memory where they fit
    (``trace_layout``; ``last_trace["shared_rows"]``); `shared_rows`
    False keeps them in device memory, for the checks. With a `bundle`
    (``tracer.check_bundle``'s [7, n], contiguous, in the scene's dtype on
    the card)
    photon ``index_offset + k`` starts from its column k in place of
    device emission (K8's trace_bundle entry); without one, a scene
    without device lights is refused."""
    if _on_cpu(st):
        return tracer.trace_eager(
            st, seed_words, n, index_offset, lanes, maxsteps, emit_method,
            maxpathlength, record_every, max_events, score, per_photon, pathwise, bundle,
        )
    if per_photon and (not score or index_offset):
        raise ValueError("per_photon: needs score=True and index_offset 0")
    specs = tuple(pathwise) if score else ()
    name = "pvt_trace_pathwise" if specs else "pvt_trace_score" if score else "pvt_trace"
    lib = _check_scene(st, {"pvt_trace": "tracer", "pvt_trace_score": "score",
                            "pvt_trace_pathwise": "pathwise"}[name])
    dev, dtype = st["node_f"].device, st["node_f"].dtype
    if bundle is None:
        _check_device_lights(st)
        rows = _Bundle(None, 0, 0)
    else:
        tracer.check_bundle(bundle, n, dtype, dev)
        if not bundle.is_contiguous():
            raise ValueError(f"bundle: need a contiguous {dtype} [7, {n}] on {dev}")
        rows = _Bundle(bundle.data_ptr(), n, index_offset)
    threads = n if lanes is None else min(lanes, n)
    nxt = torch.full((1,), index_offset, device=dev, dtype=torch.int64)
    fates = torch.zeros(physics.N_FATES, device=dev, dtype=torch.int64)
    longest = torch.zeros(1, device=dev, dtype=torch.int32)
    steps = torch.zeros(2, device=dev, dtype=torch.int64)
    res = zero_tally_out(st)
    log, log_desc = empty_log(n, record_every, max_events, index_offset, dev, fill=False,
                              dtype=dtype)
    info = (ctypes.c_longlong * 7)()
    sc = _scene(st, maxsteps, emit_method, maxpathlength)
    args = (
        ctypes.byref(sc), seed_words[0], seed_words[1], index_offset + n, threads,
        nxt.data_ptr(), fates.data_ptr(), longest.data_ptr(), steps.data_ptr(),
        ctypes.byref(_struct(_TallyOut, res, _TALLY_PTRS)), ctypes.byref(log_desc),
    )
    if score:
        sums, desc = score_sums(st, resident_threads(dev, threads), specs)
        desc.shared_rows = int(shared_rows)
        if per_photon:
            CH = score_ch.n_channels(st, len(specs))
            photon = torch.zeros((CH + 2, n), device=dev, dtype=torch.float32)
            photon[CH] = -1.0
            desc.photon, desc.photon_n = photon.data_ptr(), n
        args += (ctypes.byref(desc),)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rc = getattr(library(lib), name)(*args, ctypes.byref(rows), info, _stream())
    _raise_on(rc, name)
    stop.record()
    _launched("pvt_trace", lib)
    if bundle is not None:
        _launched("pvt_trace_bundle", lib)
    if log_desc.n_slots:
        _launched("pvt_trace_log", lib)
    if name != "pvt_trace":
        launches[name] += 1
        res.update(score_results(sums))
    if per_photon:
        res.update(photon_scores=photon[:CH], photon_fate=photon[CH].long(),
                   photon_steps=photon[CH + 1].long())
    total_steps, lane_steps = steps.tolist()
    last_trace.update(
        threads=info[0], **_placement(info), total_steps=total_steps, lane_steps=lane_steps,
        lane_efficiency=total_steps / max(lane_steps, 1), ms=start.elapsed_time(stop),
        library=lib,
    )
    launch_ms["pvt_trace"] += last_trace["ms"]
    if name != "pvt_trace":
        launch_ms[name] += last_trace["ms"]
    res["bins"] = res["bins"][:st["meta"]["total_bins"]]
    return fates, int(longest.item()), res, log if log_desc.n_slots else None


def _placement(info):
    return {name: int(info[k + 1]) for k, name in enumerate(_PLACEMENT)}


def trace_layout(st, score=False, n_path=0, shared_rows=True, entry=None):
    """Where a block of a trace launch on the scene `st` would keep what
    it shares, as ``last_trace`` reports it after the launch: the block's
    dynamic shared memory (``shared_bytes``) and 1 or 0 for the recorder
    bins, the score sums, the K5a table and the threads' score and tangent
    rows (`shared_rows` False keeps the rows in device memory). The device
    code's ``trace_layout`` decides, through ``pvt_layout`` on the card or
    `entry`, the host build's ``h_layout``. Score and path channels as
    ``score_sums`` counts them."""
    desc = _Score(ch=score_ch.n_channels(st, n_path), n_path=n_path,
                  shared_rows=int(shared_rows))
    info = (ctypes.c_longlong * 7)()
    (entry or library(tracer_library(st["node_f"].dtype)).pvt_layout)(
        ctypes.byref(_scene(st, 0, 0, float("inf"))), int(st["meta"]["n_rec"] > 0),
        ctypes.byref(desc) if score else None, info)
    return _placement(info)


def resident_threads(device, threads):
    """The most threads pvt_trace can have resident on `device`, at most
    `threads`, in whole blocks of 256 (the rows a score run allocates)."""
    props = torch.cuda.get_device_properties(device)
    cap = props.multi_processor_count * props.max_threads_per_multi_processor
    return max(256, (min(threads, cap) + 255) // 256 * 256)


def score_sums(st, stride, pathwise=()):
    """Zeroed K12 outputs of a score launch with `stride` lanes: the
    per-lane rows [CH, stride] float32 and the float64 totals
    ``fate_scores`` [2, 11, CH] and ``rec_scores`` [2, max(R, 1), CH]
    (signed sums, then magnitudes), with their ctypes descriptor (no
    per-photon records; the launch decides where a block keeps its
    sums). With `pathwise` specs (K13), CH counts them, and the lanes'
    tangent rows [C, 7, stride] and the path table come too."""
    meta, dev = st["meta"], st["node_f"].device
    CH, R = score_ch.n_channels(st, len(pathwise)), max(meta["n_rec"], 1)
    sums = {
        "rows": torch.empty((CH, stride), device=dev, dtype=torch.float32),
        "fate": torch.zeros((2, physics.N_FATES, CH), device=dev, dtype=torch.float64),
        "rec": torch.zeros((2, R, CH), device=dev, dtype=torch.float64),
        "tang": torch.empty((len(pathwise), 7, stride), device=dev, dtype=torch.float32),
        "path": T.pathwise_table(pathwise, dev),
    }
    desc = _Score(sums["rows"].data_ptr(), sums["fate"].data_ptr(), sums["rec"].data_ptr(),
                  stride, CH, meta["n_comps"], 0, None, 0,
                  sums["tang"].data_ptr() if pathwise else None, sums["path"].data_ptr(),
                  len(pathwise))
    return sums, desc


def score_results(sums):
    """``fate_scores``, ``rec_scores`` and their magnitudes' sums
    ``fate_abs``, ``rec_abs`` of ``score_sums``' totals."""
    return {"fate_scores": sums["fate"][0], "fate_abs": sums["fate"][1],
            "rec_scores": sums["rec"][0], "rec_abs": sums["rec"][1]}


def score_step(st, s, scores, maxsteps=1000, emit_method=0, maxpathlength=float("inf")):
    """One loop step of lanes `s` with score channels: the stepped state
    and flags (as ``step``) with ``comp_id``, the absorbing component (-1
    for none), the lanes' new path scores (`scores` [CH, B] plus the
    step's contributions) and this step's folds, ``fate_scores`` and
    ``fate_abs`` [11, CH] in float64 (a dict). The twin
    (``score_step_twin``) on the CPU, ``pvt_score`` on the card."""
    CH = score_ch.n_channels(st)
    if _on_cpu(st):
        return score_step_twin(st, s, scores, maxsteps, emit_method, maxpathlength)
    _check_scene(st, "score")
    dev = st["node_f"].device
    B = s["px"].shape[0]
    want = _empty_state(B, dev)
    _check_lanes(s, want, B, dev)
    if scores.shape != (CH, B) or scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError(f"scores: need contiguous float32 [{CH}, {B}]")
    flags = _empty_flags(B, dev)
    flags["comp_id"] = torch.empty(B, device=dev, dtype=torch.int32)
    sums = {"rows": scores.clone(),
            "fate": torch.zeros((2, physics.N_FATES, CH), device=dev, dtype=torch.float64)}
    desc = _Score(sums["rows"].data_ptr(), sums["fate"].data_ptr(), sums["fate"].data_ptr(), B,
                  CH, st["meta"]["n_comps"], 0)
    sc = _scene(st, maxsteps, emit_method, maxpathlength)
    rc = library("score").pvt_score(
        ctypes.byref(sc), ctypes.byref(_struct(_State, s, _STATE_PTRS)),
        ctypes.byref(_struct(_State, want, _STATE_PTRS)),
        ctypes.byref(_struct(_Flags, flags, _FLAG_PTRS)), B, ctypes.byref(desc),
        flags["comp_id"].data_ptr(), _stream(),
    )
    _raise_on(rc, "pvt_score")
    launches["pvt_score"] += 1
    return dict(want, **flags), sums["rows"], {"fate_scores": sums["fate"][0],
                                               "fate_abs": sums["fate"][1]}


def score_step_twin(st, s, scores, maxsteps=1000, emit_method=0, maxpathlength=float("inf")):
    """The twin of ``pvt_score`` (``score_step``'s CPU path), on the
    tensors' device; ``out["slack"]`` is this step's slack and the folds
    also hold ``fate_slack`` (``score.py``)."""
    out = tracer.step_state(st, s, maxsteps, emit_method, maxpathlength, want_score=True)
    out["comp_id"] = torch.where(out["absorbed"], out["comp_id"], -1)
    ds, out["slack"] = score_ch.contributions(st, out, with_slack=True)
    new = scores + ds
    f = dict(dtype=torch.float64, device=new.device)
    CH = new.shape[0]
    t = {name: torch.zeros((physics.N_FATES, CH), **f)
         for name in ("fate_scores", "fate_abs", "fate_slack")}
    t["score_max"] = torch.zeros(CH, **f)
    score_ch.fold(t, new, out, slack=out["slack"])
    return out, new, t


def fresnel(n1, n2, c):
    """(dR/dn1, dR/dn2) of the Fresnel reflectivity at (n1, n2, c): the twin
    ``score.fresnel_dR`` on the CPU, ``pvt_fresnel`` (float32) on the card."""
    if n1.device.type == "cpu":
        return score_ch.fresnel_dR(n1, n2, c)
    _refuse_f64(n1, n2, c)
    for t in (n1, n2, c):
        if t.dtype != torch.float32 or t.dim() != 1 or t.shape != n1.shape \
                or not t.is_contiguous() or t.device != n1.device:
            raise ValueError("fresnel: need contiguous float32 vectors of one length on one card")
    d1, d2 = torch.empty_like(n1), torch.empty_like(n1)
    rc = library("score").pvt_fresnel(n1.data_ptr(), n2.data_ptr(), c.data_ptr(), n1.shape[0],
                                      d1.data_ptr(), d2.data_ptr(), _stream())
    _raise_on(rc, "pvt_fresnel")
    launches["pvt_fresnel"] += 1
    return d1, d2


def _refuse_f64(*tensors):
    """Float64 CUDA tensors have no kernel of the gradient libraries."""
    if any(t.dtype == torch.float64 for t in tensors):
        raise NotImplementedError(F64_GRADIENTS)


def _check_photons(tab, pos, direction, wav):
    _refuse_f64(tab["node_f"], pos, direction, wav)
    P, dev = wav.shape[0], tab["node_f"].device
    for name, t, shape in (("pos", pos, (P, 3)), ("dir", direction, (P, 3)), ("wav", wav, (P,))):
        if t.shape != shape or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 {list(shape)} on {dev}")


def absorbed(tab, pos, direction, wav, c):
    """K15 forward: (weights, optical depths) [P] of photons (pos, dir
    [P, 3], wav [P], float32) through the absorbing nodes `tab`
    (``absorb.table``) at concentration scale `c` (float32 [1], on the
    photons' device): the twin on the CPU, ``pvt_absorbed`` on the card."""
    if wav.device.type == "cpu":
        dep = absorb.depth(tab, pos, direction, wav)
        return absorb.weight(c, dep), dep
    _check_photons(tab, pos, direction, wav)
    if c.shape != (1,) or c.dtype != torch.float32 or c.device != wav.device:
        raise ValueError("c: need a float32 [1] on the photons' device")
    P = wav.shape[0]
    w, dep = torch.empty_like(wav), torch.empty_like(wav)
    m = tab["meta"]
    desc = _Absorbers(tab["node_f"].data_ptr(), tab["node_i"].data_ptr(),
                      tab["alpha"].data_ptr(), tab["node_i"].shape[0], m["L"], m["x0"], m["dx"])
    rc = library("diff").pvt_absorbed(ctypes.byref(desc), pos.data_ptr(), direction.data_ptr(),
                                      wav.data_ptr(), c.data_ptr(), P, w.data_ptr(),
                                      dep.data_ptr(), _stream())
    _raise_on(rc, "pvt_absorbed")
    launches["pvt_absorbed"] += 1
    return w, dep


def absorbed_grad(dep, grad_w, c):
    """K15 backward: ``sum_i grad_w[i] * c * dep[i] * exp(-c * dep[i])``,
    the gradient in log_concentration, as a float32 [1]: the twin on the
    CPU, ``pvt_absorbed_grad`` (float64 sum) on the card."""
    if dep.device.type == "cpu":
        return absorb.grad_log_concentration(c, dep, grad_w).reshape(1)
    _refuse_f64(dep, grad_w, c)
    for name, t in (("depth", dep), ("grad", grad_w)):
        if t.dtype != torch.float32 or t.shape != dep.shape or t.dim() != 1 \
                or not t.is_contiguous() or t.device != dep.device:
            raise ValueError(f"{name}: need a contiguous float32 vector on the card")
    out = torch.zeros(1, device=dep.device, dtype=torch.float64)
    blocks = 4 * torch.cuda.get_device_properties(dep.device).multi_processor_count
    rc = library("diff").pvt_absorbed_grad(dep.data_ptr(), grad_w.data_ptr(), c.data_ptr(),
                                           dep.shape[0], blocks, out.data_ptr(), _stream())
    _raise_on(rc, "pvt_absorbed_grad")
    launches["pvt_absorbed_grad"] += 1
    return out.to(torch.float32)


def pathwise_step(st, s, tang, specs, maxsteps=1000, emit_method=0,
                  maxpathlength=float("inf")):
    """One loop step of lanes `s` with the pathwise channels `specs`
    (resolved) and the lanes' tangents `tang` [C, 7, B]: the stepped state
    and flags (as ``step``) with ``comp_id`` (as ``score_step``), each
    channel's map [C, PATH_J, B] (the new coordinates' tangents, then those
    of t0, alpha and the reflectivity on surface events, through
    nan_to_num), contribution [C, B] and new tangents [C, 7, B]. The twin
    (``pathwise_step_twin``) on the CPU, ``pvt_pathwise`` on the card."""
    if _on_cpu(st):
        return pathwise_step_twin(st, s, tang, specs, maxsteps, emit_method, maxpathlength)
    _check_scene(st, "pathwise")
    dev = st["node_f"].device
    B, C = s["px"].shape[0], len(specs)
    want = _empty_state(B, dev)
    _check_lanes(s, want, B, dev)
    if tang.shape != (C, 7, B) or tang.dtype != torch.float32 or not tang.is_contiguous() \
            or tang.device != dev:
        raise ValueError(f"tangents: need contiguous float32 [{C}, 7, {B}] on {dev}")
    flags = _empty_flags(B, dev)
    flags["comp_id"] = torch.empty(B, device=dev, dtype=torch.int32)
    f = dict(device=dev, dtype=torch.float32)
    table = T.pathwise_table(specs, dev)
    jv, ds, tout = (torch.empty((C, T.PATH_J, B), **f), torch.empty((C, B), **f),
                    torch.empty((C, 7, B), **f))
    desc = _Path(table.data_ptr(), C, tang.data_ptr(), tout.data_ptr(), jv.data_ptr(),
                 ds.data_ptr())
    sc = _scene(st, maxsteps, emit_method, maxpathlength)
    rc = library("pathwise").pvt_pathwise(
        ctypes.byref(sc), ctypes.byref(_struct(_State, s, _STATE_PTRS)),
        ctypes.byref(_struct(_State, want, _STATE_PTRS)),
        ctypes.byref(_struct(_Flags, flags, _FLAG_PTRS)), B, ctypes.byref(desc),
        flags["comp_id"].data_ptr(), _stream(),
    )
    _raise_on(rc, "pvt_pathwise")
    launches["pvt_pathwise"] += 1
    return dict(want, **flags), jv, ds, tout


def pathwise_step_twin(st, s, tang, specs, maxsteps=1000, emit_method=0,
                       maxpathlength=float("inf")):
    """The twin of ``pvt_pathwise`` (``pathwise_step``'s CPU path), on the
    tensors' device; ``out["path_slack"]`` [C, B] is the contributions'
    slack and ``out["jv_raw"]`` the map before nan_to_num (a dict of [C,
    B] per ``pathwise.OUTPUTS``)."""
    out, jv = path.step_state(st, dict(s, tang=tang), specs, maxsteps, emit_method,
                              maxpathlength)
    out["comp_id"] = torch.where(out["absorbed"], out["comp_id"], -1)
    ds, tout, out["path_slack"] = path.contributions(out, jv, (s["dx"], s["dy"], s["dz"]),
                                                     with_slack=True)
    out["jv_raw"] = jv
    surface = out["reflecting"] | out["transmitting"]
    rows = [jv[name] for name in path.OUTPUTS[:-1]] + [torch.where(surface, jv["refl_r"], 0.0)]
    return out, torch.nan_to_num(torch.stack(rows, 1)), ds, tout
