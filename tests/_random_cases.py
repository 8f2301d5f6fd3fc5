"""What the random-scene tests share: the suite's seeds, the crafted rays
through the g++ host build of the device code, and the host build against
the eager twin on a scene's options. The crafted rays' comparison with
the oracle is ``pvtrace_tpu_torch.kernels.crafted``'s, which
``chip_smoke.py`` runs on the card too.
"""
import ctypes

import torch

from pvtrace_tpu_torch import kernels
from pvtrace_tpu_torch.engine import compile_scene, physics, rng, tables, tracer
from pvtrace_tpu_torch.kernels import check
from pvtrace_tpu_torch.kernels.crafted import MAX_EVENTS, crafted_bundle, options

# The host build against the twin: float64 as tests/test_torch_f64.py
# (libm against torch's, an ulp or two carried through a few steps);
# float32 as tests/test_torch_kernels.py, its absolute part at the scale
# of the scene (about 10 roundings of a world-sized value).
HOST_RTOL = {torch.float64: 1e-9, torch.float32: 1e-4}
HOST_ATOL = {torch.float64: 1e-12, torch.float32: 1e-6}
# Photons whose discrete outcome an ulp may flip (tests/test_torch_f64.py).
ULP_PHOTONS = 4
# The suite's seeds, fixed before its first run: 0-19 on the CPU (and on
# the card), 20-31 on the card only (chip_smoke.py phase 38).
CPU_SEEDS = tuple(range(20))
CARD_SEEDS = tuple(range(20, 32))


def host_crafted(h, built, st, seed):
    """The crafted rays through the host build's ``trace_photon`` from the
    bundle, with the event log: (ints, floats, counts)."""
    bundle = crafted_bundle(built, st["node_f"].dtype)
    n = bundle.shape[1]
    log, desc = kernels.empty_log(n, 1, MAX_EVENTS, 0, "cpu", dtype=st["node_f"].dtype)
    fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
    o = options(built)
    sc = kernels._scene(st, o["maxsteps"], o["emit_method"], o["maxpathlength"])
    words = rng.key_words(seed)
    h.h_trace_bundle(ctypes.byref(sc), words[0], words[1], 0, n, ctypes.byref(desc),
                     fates.data_ptr(), ctypes.byref(kernels._Bundle(bundle.data_ptr(), n, 0)))
    assert int(fates.sum()) == n
    return log["ints"], log["floats"], log["counts"]


def assert_logs_equal(got, ref, dtype, scale):
    """Two event logs of the same photons: ints and counts equal, floats
    within the host build's bounds at the scene's `scale`."""
    assert torch.equal(got[2], ref[2])
    used = torch.arange(got[0].shape[1]) < ref[2][:, None]
    assert torch.equal(got[0][used], ref[0][used])
    torch.testing.assert_close(got[1][used], ref[1][used], rtol=HOST_RTOL[dtype],
                               atol=HOST_ATOL[dtype] * scale)


def _state(s):
    return ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS))


def assert_host_matches_twin(h, built, dtype, seed, B=1 << 12, steps=6, n=1 << 12):
    """The host build of tracer.cuh (`h`, of `dtype`) against the twin on
    `built`'s scene and options: ``emit_lane`` on B lanes and
    ``step_lane`` `steps` times from the twin's state, lane by lane (keys
    and discrete outcomes equal, floats within the bounds at the scene's
    scale), then ``trace_photon``'s fates at n photons within
    ULP_PHOTONS of the twin's. Returns the fates."""
    st = tables.scene_tensors(compile_scene(built.scene), dtype=dtype)
    o = options(built)
    sc = ctypes.byref(kernels._scene(st, o["maxsteps"], o["emit_method"], o["maxpathlength"]))
    words = rng.key_words(seed)
    rtol, atol = HOST_RTOL[dtype], HOST_ATOL[dtype] * built.scale
    out = kernels._empty_state(B, "cpu", dtype)
    h.h_emit(sc, words[0], words[1], 0, B, _state(out))
    s = tracer.initial_state(st, words, torch.arange(B))
    for name, ref in s.items():
        if ref.dtype.is_floating_point:
            torch.testing.assert_close(out[name], ref, rtol=rtol, atol=atol)
        else:
            assert torch.equal(out[name].long(), ref.long()), name
    for step in range(steps):
        ref = tracer.step_state(st, s, o["maxsteps"], o["emit_method"], o["maxpathlength"])
        got, flags = kernels._empty_state(B, "cpu", dtype), kernels._empty_flags(B, "cpu", dtype)
        h.h_step(sc, _state(s), _state(got),
                 ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B)
        got.update(flags)
        for name in check.DISCRETE:
            assert torch.equal(got[name].long(), ref[name].long()), (step, name)
        for name in physics.STATE_FLOATS + physics.SURFACE:
            torch.testing.assert_close(got[name], ref[name], rtol=rtol, atol=atol)
        s = ref
    fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
    _, no_log = kernels.empty_log(n, 0, 8, 0, "cpu", dtype=dtype)
    h.h_trace(sc, words[0], words[1], 0, n, ctypes.byref(no_log), fates.data_ptr())
    twin = tracer.trace_eager(st, words, n, lanes=1 << 10, **o)[0]
    assert int(fates.sum()) == n
    assert int((fates - twin).abs().max()) <= ULP_PHOTONS, (fates.tolist(), twin.tolist())
    return fates


def host_tallies(h, built, st, seed, n):
    """Photons [0, n) of `built` through the host build's ``trace_photon``
    one at a time (``h_trace_warp`` with no warps) under its options:
    (fates, the recorder tallies as ``tracer.trace_eager`` gives them)."""
    R, dtype = max(st["meta"]["n_rec"], 1), st["node_f"].dtype
    t = {"fates": torch.zeros(11, dtype=torch.int64), "cross": torch.zeros(R, dtype=torch.int64),
         "distinct": torch.zeros(R, dtype=torch.int32), "sums": torch.zeros(8 * R, dtype=dtype),
         "bins": torch.zeros(max(st["meta"]["total_bins"], 1), dtype=torch.int64),
         "sums64": torch.zeros(8 * R, dtype=torch.float64)}
    _, no_log = kernels.empty_log(n, 0, 8, 0, "cpu", dtype=dtype)
    o = options(built)
    sc = kernels._scene(st, o["maxsteps"], o["emit_method"], o["maxpathlength"])
    words, out = rng.key_words(seed), torch.zeros(3, dtype=torch.int64)
    h.h_trace_warp(ctypes.byref(sc), words[0], words[1], 0, n, 0, ctypes.byref(no_log),
                   t["fates"].data_ptr(), t["cross"].data_ptr(), t["sums"].data_ptr(),
                   t["distinct"].data_ptr(), t["bins"].data_ptr(), t["sums64"].data_ptr(), None,
                   0, 0, None, None, None, None, None, 0, None, out.data_ptr(), None)
    t["sums"] = (t["sums64"] + t["sums"].double()).view(R, 8)
    return t.pop("fates"), t
