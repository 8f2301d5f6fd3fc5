"""Float64: the float64 build of the trace device code against the twin
and the JAX package.

``tracer.cuh`` built with ``-DPVT_F64`` (every real a double, the
build of the card's ``tracer_f64`` library) for the host CPU
(``kernels/host.py``, ``build_library(f64=True)``), on float64 scene
tensors:

* its ctypes structures against the header's layout in both builds
  (offsets and sizes, compiled with the host C++ compiler);
* the float64 K5a pack (``cheb_pack``: int64 words of float64 bits)
  against the twin's fit records: layout, padding and alignment;
* emission and 6 steps on the slab, with K5a and with K5b, lane by lane
  against the float64 twin (discrete outcomes equal, floats within
  ``RTOL``), and the trace's fates at 4096 photons;
* K5a's segments and values at every breakpoint; K9's tallies by the lane
  and the warp rules (the double moment sums added straight, no float32
  partials); K10's nearest two hits; K11's records photon by photon and
  its pack; pvt_trace's loop on emulated warps against one photon at a
  time;
* the trace's fates against the JAX package's float64 ``simulate`` on
  the slab and the mixed scene (K5b, ``PVTRACE_TPU_NO_CHEB``, as in
  ``test_torch_simulate.py``), within ``ULP_PHOTONS``.

On the card ``test_torch_kernels.py`` (``gpu``) holds ``tracer_f64``'s
kernels to the float64 twin.
"""
import ctypes
import subprocess

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import chebyshev, compile_scene, eventlog, physics, rng  # noqa: E402
from pvtrace_tpu_torch.engine import tables, tally, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import build, check, host  # noqa: E402
from pvtrace_tpu_torch.scenes import (  # noqa: E402
    lsc_slab,
    lsc_slab_heatmap,
    lsc_slab_recorders,
    lsc_tiles,
    mesh_lsc,
    mesh_slab_fine,
    mesh_small,
    mixed_scene,
)

cap_threads()
F64 = torch.float64
# The float64 host build against the float64 twin, float by float: the
# same operations in the same order, but for libm (the twin's log1p, exp,
# sqrt, cos, sin, acos are torch's, the host build's the C library's,
# either within an ulp or two), which a few steps carry on through
# divisions by small distances: 1e-9 relative, far above the 1e-15 found
# and far below float32's 1e-7.
RTOL, ATOL = 1e-9, 1e-12
# Photons whose discrete outcome an ulp may flip between the host build
# and the JAX package (test_torch_simulate.py's bound).
ULP_PHOTONS = 4


@pytest.fixture(scope="module")
def h64(tmp_path_factory):
    """tracer.cuh built for the host with -DPVT_F64 (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host64"), f64=True)


def _f64(make):
    return tables.scene_tensors(compile_scene(make()), dtype=F64)


def _sc(st):
    return ctypes.byref(kernels._scene(st, 1000, 0, float("inf")))


def _state(s):
    return ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS))


# -- layout --------------------------------------------------------------

LAYOUT_PROGRAM = r"""
#include <stddef.h>
#include <stdio.h>
#include "tracer.cuh"
#define FIELD(S, f) printf(#S " " #f " %zu\n", offsetof(S, f));
int main() {
  printf("PvtScene size %zu\n", sizeof(PvtScene));
%s
  return 0;
}
"""


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
def test_scene_struct_offsets_match_ctypes(tmp_path, f64):
    """PvtScene's field offsets and size in the header compiled for each
    build (-DPVT_F64: its four reals doubles) equal those of the ctypes
    Structure the wrappers pass (``_Scene``, ``_Scene64``)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    cls = kernels._Scene64 if f64 else kernels._Scene
    fields = "\n".join(f"  FIELD(PvtScene, {name})" for name, _ in cls._fields_)
    src = tmp_path / "layout.cpp"
    src.write_text(LAYOUT_PROGRAM.replace("%s", fields))
    exe = tmp_path / "layout"
    subprocess.run([host.compiler(), "-std=c++17", *(["-DPVT_F64"] if f64 else []), "-I",
                    str(build.CSRC), "-o", str(exe), str(src)], check=True, capture_output=True,
                   timeout=300)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    got = {line.split()[1]: int(line.split()[2]) for line in out.splitlines() if line}
    assert got.pop("size") == ctypes.sizeof(cls)
    assert got == {name: getattr(cls, name).offset for name, _ in cls._fields_}
    real = ctypes.c_double if f64 else ctypes.c_float
    assert dict(cls._fields_)["grid_dx"] is real


@pytest.mark.parametrize("make", [lsc_slab, mixed_scene, lsc_tiles],
                         ids=["slab", "mixed", "tiles"])
def test_f64_cheb_pack_records_padding_and_alignment(make):
    """The float64 ``cheb_pack`` is the float32 one's layout in int64
    words: the same word offsets, counts and flags, each real the twin's
    float64 value by its bits (``off``, a, 2 / (b - a), the breakpoints,
    every coefficient from the highest degree down, from a four-word, that
    is 32-byte, boundary, padded with zeros to one), the whole a multiple
    of four words and 16-byte aligned."""
    compiled = compile_scene(make())
    st = tables.scene_tensors(compiled, dtype=F64)
    st32 = tables.scene_tensors(compiled, dtype=torch.float32)
    w = st["cheb_pack"].numpy()
    assert w.dtype == np.int64 and w.size == st["meta"]["cheb_words"] == st32["meta"]["cheb_words"]
    assert w.size % 4 == 0 and st["cheb_pack"].data_ptr() % 16 == 0
    f64 = w.view(np.float64)
    fit_i, fit_f = st["cheb_fit_i"].tolist(), st["cheb_fit_f"].numpy()
    seg_f, seg_i, coef = st["cheb_seg_f"].numpy(), st["cheb_seg_i"].numpy(), st["cheb_coef"]
    F, R = len(fit_i), tables.CHEB_REC
    w32 = st32["cheb_pack"].numpy()
    ints = np.zeros(w.size, bool)  # the words that hold integers
    ends = []
    for f, (kind, nseg, seg0) in enumerate(fit_i):
        fr = w[R * f:R * (f + 1)]
        assert fr[tables.FR_NSEG] == nseg and fr[tables.FR_SEG] == R * (F + seg0)
        ints[R * f + np.array([tables.FR_NSEG, tables.FR_SEG, tables.FR_BRK])] = True
        assert f64[R * f + tables.FR_OFF] == fit_f[f]
        if nseg > 1:
            brk = f64[fr[tables.FR_BRK]:fr[tables.FR_BRK] + nseg - 1]
            assert np.array_equal(brk, seg_f[seg0:seg0 + nseg - 1, tables.SF_B])
        for s in range(seg0, seg0 + nseg):
            at = R * (F + s)
            sr = w[at:at + R]
            ints[at + np.array([tables.SR_COEF, tables.SR_DEG])] = True
            assert f64[at + tables.SR_A] == seg_f[s, tables.SF_A]
            assert f64[at + tables.SR_SCALE] == seg_f[s, tables.SF_SCALE]
            info, deg = sr[tables.SR_DEG], seg_i[s, tables.SI_DEG]
            assert info & tables.SEG_DEG_MASK == deg
            assert bool(info & tables.SEG_LOG) == (seg_i[s, tables.SI_KIND] == tables.FIT_LOG)
            assert bool(info & tables.SEG_MAP) == (kind == tables.FIT_PW)
            c0, first = sr[tables.SR_COEF], seg_i[s, tables.SI_COEF0]
            assert c0 % 4 == 0
            want = coef[first:first + deg + 1].flip(0).numpy()
            assert np.array_equal(f64[c0:c0 + deg + 1], want)
            padded = c0 + deg + 1 + (-(deg + 1) % 4)
            assert not w[c0 + deg + 1:padded].any()
            ends.append(padded)
    assert max(ends) == w.size
    # Integer words as the float32 pack's; reals its float32 values widened.
    assert np.array_equal(w[ints], w32[ints])
    real = ~ints & (w32 != 0)
    assert np.array_equal(f64[real].astype(np.float32), w32.view(np.float32)[real])


# -- the device code against the twin -------------------------------------


def _spectra(monkeypatch, spectra, make=lsc_slab):
    if spectra == "K5b":
        monkeypatch.setenv("PVTRACE_TPU_NO_CHEB", "1")
    else:
        monkeypatch.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
    st = _f64(make)
    assert st["meta"]["cheb_spec"] == (spectra == "K5a")
    return st


@pytest.mark.parametrize("spectra", ["K5a", "K5b"])
def test_f64_device_code_matches_twin_on_host(h64, monkeypatch, spectra):
    """emit_lane, then step_lane six times from the twin's state, against
    the float64 twin lane by lane: keys and every discrete outcome equal,
    floats within RTOL; then the trace's fates at 4096 photons equal the
    twin's."""
    st, seed, B = _spectra(monkeypatch, spectra), rng.key_words(5), 1 << 12
    out = kernels._empty_state(B, "cpu", F64)
    h64.h_emit(_sc(st), seed[0], seed[1], 7, B, _state(out))
    twin = tracer.initial_state(st, seed, 7 + torch.arange(B))
    for name, ref in twin.items():
        if ref.dtype.is_floating_point:
            assert out[name].dtype == F64
            torch.testing.assert_close(out[name], ref, rtol=RTOL, atol=ATOL)
        else:
            assert torch.equal(out[name].long(), ref.long()), name
    s, moved = twin, 0
    for _ in range(6):
        ref = tracer.step_state(st, s, 1000, 0)
        got, flags = kernels._empty_state(B, "cpu", F64), kernels._empty_flags(B, "cpu", F64)
        h64.h_step(_sc(st), _state(s), _state(got),
                   ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B)
        got.update(flags)
        for name in check.DISCRETE:
            assert torch.equal(got[name].long(), ref[name].long()), name
        for name in physics.STATE_FLOATS + physics.SURFACE:
            torch.testing.assert_close(got[name], ref[name], rtol=RTOL, atol=ATOL)
        moved += int((ref["source"] != s["source"]).sum())
        s = ref
    assert moved > 0  # re-emissions: the K5a or K5b emission ICDF ran
    fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
    _, no_log = kernels.empty_log(4096, 0, 128, 0, "cpu")
    h64.h_trace(_sc(st), seed[0], seed[1], 0, 4096, ctypes.byref(no_log), fates.data_ptr())
    ref_fates = tracer.trace_eager(st, seed, 4096, lanes=512)[0]
    assert int(fates.sum()) == 4096 and torch.equal(fates, ref_fates), (fates, ref_fates)


@pytest.mark.parametrize("make", [lsc_slab, mixed_scene], ids=["slab", "mixed"])
def test_f64_cheb_matches_twin_on_host(h64, make):
    """cheb_lane of the float64 build (K5a's search over the float64
    breakpoints, the Clenshaw chain on float64 coefficients) against the
    twin: the same segment at every breakpoint, its float64 neighbours,
    the ends and NaN, and on a grid of t; values within 1e-12 of each
    fit's scale."""
    st = _f64(make)
    F = st["meta"]["cheb_n_fits"]
    t = torch.cat([torch.linspace(-1.0, 1.0, 4096, dtype=F64), check.cheb_points(st)])
    assert t.dtype == F64 and bool(torch.isin(st["cheb_seg_f"][:, tables.SF_B], t).all())
    n = t.shape[0]
    got, seg = torch.empty((F, n), dtype=F64), torch.empty((F, n), dtype=torch.int32)
    h64.h_cheb_seg(_sc(st), F, t.data_ptr(), n, got.data_ptr(), seg.data_ptr())
    fits = torch.arange(F).repeat_interleave(n)
    assert torch.equal(seg.long(), chebyshev._segment(st, fits, t.repeat(F)).reshape(F, -1))
    ref = chebyshev.eval_fits(st, fits, t.repeat(F)).reshape(F, -1)
    nan = ref.isnan()
    assert torch.equal(got.isnan(), nan)
    scale = ref.masked_fill(nan, 0.0).abs().amax(1, keepdim=True).clamp(min=1e-300)
    assert float(((got - ref).abs().masked_fill(nan, 0.0) / scale).max()) <= 1e-12


def _host_tally(entry, st, outs):
    """`entry` (h_tally or h_tally_warp of the float64 build) on the twin's
    steps `outs`: the accumulators (the double sums in ``sums``; ``sums64``
    stays zero) and the seen words after the last step."""
    R, total, B = st["meta"]["n_rec"], st["meta"]["total_bins"], outs[0]["px"].shape[0]
    acc = {"seen": torch.zeros((B, tables.SEEN_WORDS), dtype=torch.int32),
           "cross": torch.zeros(R, dtype=torch.int64), "sums": torch.zeros((R, 8), dtype=F64),
           "distinct": torch.zeros(R, dtype=torch.int32),
           "bins": torch.zeros(max(total, 1), dtype=torch.int64),
           "sums64": torch.zeros((R, 8), dtype=F64)}
    for out in outs:
        entry(_sc(st), _state(out),
              ctypes.byref(kernels._struct(kernels._Flags, out, kernels._FLAG_PTRS)),
              acc["seen"].data_ptr(), B, acc["cross"].data_ptr(), acc["sums"].data_ptr(),
              acc["distinct"].data_ptr(), acc["bins"].data_ptr(), acc["sums64"].data_ptr())
    return acc


@pytest.mark.parametrize("make", [lambda: lsc_slab_recorders(32), lambda: lsc_slab_recorders(256),
                                  lsc_slab_heatmap], ids=["R32", "R256", "heatmap"])
def test_f64_tallies_match_twin_on_host(h64, make):
    """K9 of the float64 build over 8 steps of 4096 lanes, both rules
    (tally_event lane by lane; the warp rule, whose moment adds are
    pvt_add8's double form), against the float64 twin fed the same steps:
    crossings, distinct rays, bins and seen bits equal, the moment sums
    added in float64 straight (no float32 partial moved to ``sums64``)
    within 1e-12 of the twin's (another order of the same double adds)."""
    st = _f64(make)
    B = 4096
    outs = [tracer.initial_state(st, rng.key_words(2), torch.arange(B))]
    for _ in range(8):
        outs.append(tracer.step_state(st, outs[-1], 1000, 0))
    twin = tally.empty(st, B)
    for out in outs[1:]:
        tally.tally(twin, st, out)
    assert int(twin["distinct"].sum()) > 0 and int(twin["bins"].sum()) > 0
    R = st["meta"]["n_rec"]
    for entry in (h64.h_tally, h64.h_tally_warp):
        acc = _host_tally(entry, st, outs[1:])
        assert torch.equal(acc["cross"], twin["cross"])
        assert torch.equal(acc["distinct"].long(), twin["distinct"])
        assert torch.equal(acc["bins"][:st["meta"]["total_bins"]], twin["bins"])
        assert torch.equal(kernels.unpack_seen(acc["seen"], R), twin["seen"])
        assert not bool(acc["sums64"].any())
        torch.testing.assert_close(acc["sums"], twin["sums"], rtol=1e-12, atol=0)


@pytest.mark.parametrize("staged", [0, 1], ids=["device_memory", "staged"])
@pytest.mark.parametrize("make", [mesh_lsc, mesh_slab_fine], ids=["hex_plate", "fine_slab"])
def test_f64_mesh_matches_twin_on_host(h64, make, staged):
    """mesh_lane of the float64 build against the float64 twin for 4096
    rays: hit counts equal, t1, t2 and the nearest hit's normal bit for
    bit (the same operations in the same order, no FMA contraction)."""
    st = _f64(make)
    tri, eps = kernels.mesh_rows(st, 1)
    o, d = (v.double().contiguous() for v in check.mesh_rays(st, 1, 4096, seed=7))
    B = o.shape[0]
    t1, t2, nrm = (torch.empty(B, dtype=F64), torch.empty(B, dtype=F64),
                   torch.empty((B, 3), dtype=F64))
    cnt = torch.empty(B, dtype=torch.int32)
    h64.h_mesh(tri.data_ptr(), tri.shape[0], staged, eps, o.data_ptr(), d.data_ptr(), B,
               t1.data_ptr(), t2.data_ptr(), cnt.data_ptr(), nrm.data_ptr())
    ref = kernels.mesh(st, 1, o, d)
    assert int((ref[2] >= 1).sum()) > B // 4
    for got, want in zip((t1, t2, cnt, nrm), ref):
        assert torch.equal(got, want)


def test_f64_mesh_lsc_trace_matches_twin_on_host(h64):
    """The mesh LSC (K10 every step, 7 recorders) traced by the float64
    build, 2048 photons: fates equal to the float64 twin's."""
    st, seed = _f64(mesh_lsc), rng.key_words(6)
    fates = torch.zeros(11, dtype=torch.int64)
    _, no_log = kernels.empty_log(2048, 0, 128, 0, "cpu")
    h64.h_trace(_sc(st), seed[0], seed[1], 0, 2048, ctypes.byref(no_log), fates.data_ptr())
    ref = tracer.trace_eager(st, seed, 2048, lanes=512)[0]
    assert int(ref[7]) > 0 and int(ref[4]) > 0 and torch.equal(fates, ref), (fates, ref)


@pytest.mark.parametrize("make, events", [(mesh_small, 8), (mesh_lsc, 128), (lsc_slab, 128)],
                         ids=["mesh_small-8", "mesh_lsc-128", "lsc_slab-128"])
def test_f64_log_matches_twin_on_host(h64, make, events):
    """The float64 build's logging trace (its records in double pairs)
    against the float64 twin's log, every other photon from 1: every
    photon's ints and counts equal, floats within RTOL; then its pack
    (``log_pack_slot``, each slot a warp of 32 lanes, rows unfilled as on
    the card) bit-equal to ``eventlog.pack`` of its own log."""
    st, seed, n = _f64(make), rng.key_words(4), 512
    log, desc = kernels.empty_log(n, 2, events, 1, "cpu", fill=False, dtype=F64)
    fates = torch.zeros(11, dtype=torch.int64)
    h64.h_trace(_sc(st), seed[0], seed[1], 1, 1 + n, ctypes.byref(desc), fates.data_ptr())
    ref_fates, _, _, ref = tracer.trace_eager(st, seed, n, 1, 256, record_every=2,
                                              max_events=events)
    assert torch.equal(fates, ref_fates)
    counts = log["counts"]
    assert torch.equal(counts, ref["counts"]) and int(counts.min()) >= 2
    ints, floats = check.dense_log(log)
    assert torch.equal(ints, ref["ints"])
    torch.testing.assert_close(floats, ref["floats"], rtol=RTOL, atol=ATOL)
    ref_ints, ref_floats = eventlog.pack(log, counts)
    offsets = torch.cumsum(counts, 0) - counts
    N = int(counts.sum())
    got_ints = torch.full((N, eventlog.LOG_I), 7, dtype=torch.int32)
    got_floats = torch.full((N, eventlog.LOG_F), 7.0, dtype=F64)
    h64.h_log_pack(ctypes.byref(desc), offsets.data_ptr(), got_ints.data_ptr(),
                   got_floats.data_ptr())
    assert torch.equal(got_ints, ref_ints)
    assert torch.equal(got_floats.view(torch.int64), ref_floats.view(torch.int64))


@pytest.mark.parametrize("make, log", [(lambda: lsc_slab_recorders(256), None),
                                       (mesh_small, (2, 8))], ids=["R256", "mesh_small-log"])
def test_f64_warp_loop_equals_photon_loop_on_host(h64, make, log):
    """pvt_trace's loop on 3 emulated warps (``trace_warps``; with 256
    recorders the warp rule, pvt_add8 on doubles) against one photon at a
    time, 1000 photons from 3: fates, steps, integer tallies and the log
    bit for bit, the double moment sums within 1e-12 (another order)."""
    st, seed, n, off = _f64(make), rng.key_words(8), 1000, 3
    every, events = log or (0, 128)
    R = max(st["meta"]["n_rec"], 1)
    runs = []
    for warps in (0, 3):
        lg, desc = kernels.empty_log(n, every, events, off, "cpu", dtype=F64)
        t = {"fates": torch.zeros(11, dtype=torch.int64),
             "cross": torch.zeros(R, dtype=torch.int64),
             "distinct": torch.zeros(R, dtype=torch.int32), "sums": torch.zeros(8 * R, dtype=F64),
             "bins": torch.zeros(max(st["meta"]["total_bins"], 1), dtype=torch.int64),
             "sums64": torch.zeros(8 * R, dtype=F64), "out": torch.zeros(3, dtype=torch.int64)}
        h64.h_trace_warp(
            _sc(st), seed[0], seed[1], off, off + n, warps, ctypes.byref(desc),
            t["fates"].data_ptr(), t["cross"].data_ptr(), t["sums"].data_ptr(),
            t["distinct"].data_ptr(), t["bins"].data_ptr(), t["sums64"].data_ptr(), None, 0,
            st["meta"]["n_comps"], None, None, None, None, None, 0, None, t["out"].data_ptr(),
            None)
        runs.append(dict(t, log=lg))
    ref, got = runs
    assert int(got["fates"].sum()) == n and torch.equal(got["fates"], ref["fates"])
    assert torch.equal(got["out"][[0, 2]], ref["out"][[0, 2]])
    for name in ("cross", "distinct", "bins"):
        assert torch.equal(got[name], ref[name]), name
    torch.testing.assert_close(got["sums"], ref["sums"], rtol=1e-12, atol=0)
    if log:
        assert torch.equal(got["log"]["ints"], ref["log"]["ints"])
        assert torch.equal(got["log"]["floats"].view(torch.int64),
                           ref["log"]["floats"].view(torch.int64))
    else:
        assert int(got["distinct"].sum()) > 0


# -- against the JAX package ---------------------------------------------


@pytest.fixture(scope="module", params=["slab", "mixed"])
def jax_f64_runs(request):
    """(scene name, port scene maker, n, seed, the JAX package's float64
    fates) at K5b (PVTRACE_TPU_NO_CHEB; an empty JAX tracer cache, whose
    key ignores the variable)."""
    make, n = {"slab": (lsc_slab, 1 << 13), "mixed": (mixed_scene, 1 << 11)}[request.param]
    mp = pytest.MonkeyPatch()
    mp.setenv("PVTRACE_TPU_NO_CHEB", "1")
    mp.setattr(jax_api, "_TRACER_CACHE", {})
    try:
        ref = jax_engine.simulate(make(pvtrace_tpu), n, seed=5, record_every=0,
                                  dtype=np.float64).data["fates"]
        st = _f64(make)
    finally:
        mp.undo()
    assert not st["meta"]["cheb_spec"]
    return request.param, st, n, np.asarray(ref, dtype=np.int64)


def test_f64_host_build_fates_match_jax(h64, jax_f64_runs):
    """The float64 build's trace (trace_photon a photon, h_trace) of
    photons [0, n) against the JAX package's float64 ``simulate`` of the
    same seed: the same photons take the same streams, so each fate count
    agrees within ULP_PHOTONS."""
    name, st, n, ref = jax_f64_runs
    seed = rng.key_words(5)
    fates = torch.zeros(11, dtype=torch.int64)
    _, no_log = kernels.empty_log(n, 0, 128, 0, "cpu")
    h64.h_trace(_sc(st), seed[0], seed[1], 0, n, ctypes.byref(no_log), fates.data_ptr())
    got = fates.numpy()
    assert got.sum() == n and ref.sum() == n
    assert np.abs(got - ref).max() <= ULP_PHOTONS, (name, got.tolist(), ref.tolist())
    assert got[7] > 0 and got[4] > 0
