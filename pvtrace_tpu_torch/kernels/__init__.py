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

from pvtrace_tpu_torch.engine import chebyshev, physics, tally, tracer
from pvtrace_tpu_torch.engine import tables as T
from pvtrace_tpu_torch.kernels import build

# Launches of each kernel since the last reset(), and what the last
# pvt_trace launch reported: its thread count, the dynamic shared memory
# of a block, whether the recorder bins were in shared memory, and the
# steps its photons took in all.
launches = {"pvt_emit": 0, "pvt_step": 0, "pvt_trace": 0, "pvt_cheb": 0, "pvt_tally": 0}
last_trace = {"threads": 0, "shared_bytes": 0, "shared_bins": 0, "total_steps": 0}

_SCENE_PTRS = (
    "node_f", "node_i", "comp_f", "comp_i", "ovr_f", "ovr_i", "light_f",
    "light_i", "spec_pack", "ems_icdf_pairs", "light_icdf_pairs",
    "cheb_fit_i", "cheb_fit_f", "cheb_seg_f", "cheb_seg_i", "cheb_coef",
    "cheb_slot", "cheb_ref", "rec_f", "rec_i", "hist_f", "hist_i", "rec_csr",
    "rec_ids",
)
_SCENE_INTS = (
    "node_i", "comp_i", "ovr_i", "light_i", "cheb_fit_i", "cheb_seg_i",
    "cheb_slot", "cheb_ref", "rec_i", "hist_i", "rec_csr", "rec_ids",
)
_SCENE_META_INTS = (
    "n_nodes", "root_id", "n_lights", "n_lum", "grid_n", "icdf_n", "pack_width",
)
_STATE_PTRS = physics.STATE_FLOATS + ("source", "count", "alive", "k0", "k1")
_FLAG_PTRS = ("hit", "container") + physics.FLAGS + physics.SELECTORS \
    + physics.EVENT_FLAGS + physics.SURFACE
_TALLY_PTRS = ("distinct", "cross", "bins", "sums")


class _Scene(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _SCENE_PTRS] + [
        (name, ctypes.c_int) for name in _SCENE_META_INTS + (
            "maxsteps", "emit_method", "cheb_spec", "cheb_icdf", "cheb_light",
            "cheb_icdf0", "cheb_light0", "n_rec", "total_bins",
        )
    ] + [
        (name, ctypes.c_float)
        for name in ("grid_x0", "grid_dx", "maxpathlength", "cheb_tscale")
    ]


class _State(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _STATE_PTRS]


class _Flags(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _FLAG_PTRS]


class _TallyOut(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _TALLY_PTRS]


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
        vp, u32, u64, i32, i64 = (
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_longlong
        )
        lib.pvt_emit.argtypes = [vp, u32, u32, u64, i64, vp, vp]
        lib.pvt_step.argtypes = [vp, vp, vp, vp, i64, vp]
        lib.pvt_cheb.argtypes = [vp, i32, vp, i64, vp, vp]
        lib.pvt_tally.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp]
        lib.pvt_trace.argtypes = [vp, u32, u32, u64, i64, vp, vp, vp, vp, vp, vp, vp]
        for fn in (lib.pvt_emit, lib.pvt_step, lib.pvt_cheb, lib.pvt_tally, lib.pvt_trace):
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
        want = torch.int32 if name in _SCENE_INTS else torch.float32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"scene tensor {name}: need contiguous {want} on {dev}")


def _scene(st, maxsteps, emit_method, maxpathlength):
    meta = st["meta"]
    return _Scene(
        *(st[name].data_ptr() for name in _SCENE_PTRS),
        *(meta[name] for name in _SCENE_META_INTS), int(maxsteps), int(emit_method),
        int(meta["cheb_spec"]), int(meta["cheb_icdf"]), int(meta["cheb_light"]),
        meta["cheb_icdf0"], meta["cheb_light0"], meta["n_rec"], meta["total_bins"],
        meta["grid_x0"], meta["grid_dx"], float(maxpathlength),
        2.0 / (meta["grid_n"] - 1),
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


def _empty_flags(B, device):
    flags = {}
    for names, dtype in (
        (("hit", "container") + physics.SELECTORS, torch.int32),
        (physics.FLAGS + physics.EVENT_FLAGS, torch.bool),
        (physics.SURFACE, torch.float32),
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
    ``hit``, ``container``, recorder selectors and surface normals (the
    twin's ``tracer.step_state``)."""
    if _on_cpu(st):
        return tracer.step_state(st, s, maxsteps, emit_method, maxpathlength)
    _check_scene(st)
    dev = st["node_f"].device
    B = s["px"].shape[0]
    want = _empty_state(B, dev)
    _check_lanes(s, want, B, dev)
    flags = _empty_flags(B, dev)
    sc = _scene(st, maxsteps, emit_method, maxpathlength)
    rc = library().pvt_step(
        ctypes.byref(sc), ctypes.byref(_struct(_State, s, _STATE_PTRS)),
        ctypes.byref(_struct(_State, want, _STATE_PTRS)),
        ctypes.byref(_struct(_Flags, flags, _FLAG_PTRS)), B, _stream(),
    )
    _raise_on(rc, "pvt_step")
    launches["pvt_step"] += 1
    return dict(want, **flags)


def cheb(st, t):
    """Every K5a fit of the scene at the values `t`: [n_fits, len(t)]
    (the twin: ``chebyshev.eval_fits``)."""
    F = st["meta"]["cheb_n_fits"]
    if _on_cpu(st):
        fit = torch.arange(F, dtype=torch.int64).repeat_interleave(t.shape[0])
        return chebyshev.eval_fits(st, fit, t.repeat(F)).reshape(F, -1)
    _check_scene(st)
    if t.dtype != torch.float32 or t.device != st["node_f"].device or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError("t: need a contiguous float32 vector on the scene's device")
    out = torch.empty((F, t.shape[0]), device=t.device, dtype=torch.float32)
    sc = _scene(st, 0, 0, float("inf"))
    rc = library().pvt_cheb(ctypes.byref(sc), F, t.data_ptr(), t.shape[0], out.data_ptr(),
                            _stream())
    _raise_on(rc, "pvt_cheb")
    launches["pvt_cheb"] += 1
    return out


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
    _check_scene(st)
    dev = st["node_f"].device
    B = out["px"].shape[0]
    _check_lanes(out, dict(_empty_state(B, dev), **_empty_flags(B, dev)), B, dev)
    if words.shape != (B, T.SEEN_WORDS) or words.dtype != torch.int32 \
            or not words.is_contiguous():
        raise ValueError(f"seen words: need contiguous int32 [{B}, {T.SEEN_WORDS}]")
    shared = ctypes.c_int(0)
    sc = _scene(st, 0, 0, float("inf"))
    rc = library().pvt_tally(
        ctypes.byref(sc), ctypes.byref(_struct(_State, out, _STATE_PTRS)),
        ctypes.byref(_struct(_Flags, out, _FLAG_PTRS)), words.data_ptr(), B,
        ctypes.byref(_struct(_TallyOut, res, _TALLY_PTRS)), ctypes.byref(shared), _stream(),
    )
    _raise_on(rc, "pvt_tally")
    launches["pvt_tally"] += 1
    return bool(shared.value)


def trace(st, seed_words, n, index_offset=0, lanes=None, maxsteps=1000,
          emit_method=0, maxpathlength=float("inf")):
    """Trace photons ``index_offset + [0, n)``; returns (fates, steps,
    tallies), as ``tracer.trace_eager`` does.

    On the card, `lanes` caps the persistent kernel's thread count (None:
    the resident capacity), `steps` is the largest per-photon step count,
    where the eager twin reports its number of wavefront steps, and the
    tallies have no ``seen``. Their sums are float32 per block, moved
    into float64 totals every ``tables.SUMS_FLUSH`` distinct rays of a
    recorder and at the end (``check.SUMS_BOUND``)."""
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
    total_steps = torch.zeros(1, device=dev, dtype=torch.int64)
    res = zero_tally_out(st)
    info = (ctypes.c_longlong * 3)()
    sc = _scene(st, maxsteps, emit_method, maxpathlength)
    rc = library().pvt_trace(
        ctypes.byref(sc), seed_words[0], seed_words[1], index_offset + n,
        n if lanes is None else min(lanes, n), nxt.data_ptr(),
        fates.data_ptr(), longest.data_ptr(), total_steps.data_ptr(),
        ctypes.byref(_struct(_TallyOut, res, _TALLY_PTRS)), info, _stream(),
    )
    _raise_on(rc, "pvt_trace")
    launches["pvt_trace"] += 1
    last_trace.update(
        threads=info[0], shared_bytes=info[1], shared_bins=info[2],
        total_steps=int(total_steps.item()),
    )
    res["bins"] = res["bins"][:st["meta"]["total_bins"]]
    return fates, int(longest.item()), res
