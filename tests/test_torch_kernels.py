"""The CUDA kernels: layout and arithmetic here, the kernels on the card.

On the CPU:

* the record layout and the structs of ``kernels/csrc/tracer.cuh`` match
  the Python side (``engine/tables.py``, the ctypes Structures);
* the device code of ``tracer.cuh`` (``emit_lane``, ``step_lane``,
  ``trace_photon``, host-callable by design) is compiled with the host
  C++ compiler (``kernels/host.py``) and held against the eager twin, at
  the scene's defaults (Chebyshev spectra, K5a) and with the table lerp
  (K5b, ``PVTRACE_TPU_NO_CHEB``); pvt_trace's loop on emulated warps
  (``trace_warps``) equals ``trace_photon`` one photon at a time;
* the wrappers take the twin for CPU tensors and count no launch.

On the card (marked ``gpu``, skipped without CUDA): phases 2-4, 6-9,
12-14, 16-22, 24-25 and 36 (float64, ``tracer_f64``) of
``chip_smoke.py`` at a small size, on both spectral paths, and the
float64 gradients', device-emission and bad-bundle refusals. This file
imports no JAX, so it runs there with ``--noconftest``.
"""
import ctypes
import re

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.kernels import check  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, eventlog, physics, rng, simulate, tables, tally  # noqa: E402
from pvtrace_tpu_torch.engine import tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import build, host  # noqa: E402
from pvtrace_tpu_torch.engine import score as score_ch  # noqa: E402
from pvtrace_tpu_torch.engine.emit import emit_bundle  # noqa: E402
from pvtrace_tpu_torch.scenes import (  # noqa: E402
    lsc_slab,
    lsc_slab_heatmap,
    lsc_slab_host,
    lsc_slab_recorders,
    lsc_tiles,
    mesh_lsc,
    mesh_slab_fine,
    mesh_small,
    mixed_scene,
)

cap_threads()
HEADER = (build.CSRC / "tracer.cuh").read_text()


def _struct_fields(name, header=HEADER):
    body = re.search(r"struct %s \{(.*?)\};" % name, header, re.S).group(1)
    # The last identifier of each declarator: "unsigned char *a, *b;" -> a, b
    return [
        re.findall(r"\w+", part)[-1]
        for decl in body.split(";") if decl.strip()
        for part in decl.split(",")
    ]


def test_header_layout_matches_tables():
    defines = dict(re.findall(r"^#define ([A-Z_0-9]+) (\d+)$", HEADER, re.M))
    assert defines, "no layout defines found"
    for name, value in defines.items():
        assert tables.LAYOUT[name] == int(value), name
    for name in ("NODE_F", "NODE_I", "COMP_F", "COMP_I", "OVR_F", "LIGHT_F", "LIGHT_I"):
        assert name in defines


def test_diff_header_layout_matches_absorb():
    from pvtrace_tpu_torch.engine import absorb

    text = (build.CSRC / "diff.cuh").read_text()
    defines = dict(re.findall(r"^#define ([A-Z_0-9]+) (\d+)$", text, re.M))
    assert defines == {name: str(getattr(absorb, name)) for name in ("AF_W2L", "AF_G", "AF")}


def test_header_event_kinds_match_event():
    from pvtrace_tpu_torch.light.event import Event

    kinds = dict(re.findall(r"EV_([A-Z]+) = (\d+)", HEADER))
    assert {name: int(v) for name, v in kinds.items()} == {e.name: e.value for e in Event}


@pytest.mark.parametrize("struct, cls", [
    ("PvtScene", kernels._Scene), ("PvtScene", kernels._Scene64), ("PvtState", kernels._State),
    ("PvtFlags", kernels._Flags),
    ("PvtTallyOut", kernels._TallyOut), ("PvtLog", kernels._Log), ("PvtScore", kernels._Score),
    ("PvtAbsorbers", kernels._Absorbers), ("PvtPath", kernels._Path),
])
def test_header_structs_match_ctypes(struct, cls):
    header = (build.CSRC / ("diff.cuh" if struct == "PvtAbsorbers" else "tracer.cuh")).read_text()
    assert _struct_fields(struct, header) == [name for name, _ in cls._fields_]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


@pytest.fixture(scope="module")
def bench_f32():
    return tables.scene_tensors(compile_scene(lsc_slab()), dtype=torch.float32, device="cpu")


def _spectra_scene(monkeypatch, spectra, device="cpu", dtype=torch.float32):
    """The bench slab's tensors (float32 unless `dtype`) on spectral path
    `spectra` (K5a: the defaults; K5b: ``PVTRACE_TPU_NO_CHEB`` set)."""
    if spectra == "K5b":
        monkeypatch.setenv("PVTRACE_TPU_NO_CHEB", "1")
    else:
        monkeypatch.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
    st = tables.scene_tensors(compile_scene(lsc_slab()), dtype=dtype, device=device)
    cheb = spectra == "K5a"
    assert st["meta"]["cheb_spec"] == cheb and st["meta"]["cheb_icdf"] == cheb
    return st


@pytest.mark.parametrize("spectra", ["K5a", "K5b"])
def test_device_code_matches_twin_on_host(host_lib, monkeypatch, spectra):
    st, seed, B = _spectra_scene(monkeypatch, spectra), rng.key_words(5), 1 << 12
    sc = kernels._scene(st, 1000, 0, float("inf"))
    out = kernels._empty_state(B, "cpu")
    host_lib.h_emit(ctypes.byref(sc), seed[0], seed[1], 7, B,
                    ctypes.byref(kernels._struct(kernels._State, out, kernels._STATE_PTRS)))
    twin = tracer.initial_state(st, seed, 7 + torch.arange(B))
    for name, ref in twin.items():
        if ref.dtype.is_floating_point:
            torch.testing.assert_close(out[name], ref, rtol=0, atol=1e-6)
        else:
            assert torch.equal(out[name].long(), ref.long()), name

    s = twin
    for _ in range(6):
        ref = tracer.step_state(st, s, 1000, 0)
        got, flags = kernels._empty_state(B, "cpu"), kernels._empty_flags(B, "cpu")
        host_lib.h_step(
            ctypes.byref(sc),
            ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._State, got, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B,
        )
        got.update(flags)
        for name in check.DISCRETE:
            assert torch.equal(got[name].long(), ref[name].long()), name
        for name in physics.STATE_FLOATS + physics.SURFACE:
            torch.testing.assert_close(got[name], ref[name], rtol=1e-4, atol=1e-5)
        s = ref

    fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
    _, no_log = kernels.empty_log(4096, 0, 128, 0, "cpu")
    host_lib.h_trace(ctypes.byref(sc), seed[0], seed[1], 0, 4096, ctypes.byref(no_log),
                     fates.data_ptr())
    ref, _, _, _ = tracer.trace_eager(st, seed, 4096, lanes=512)
    assert int(fates.sum()) == 4096
    assert int((fates - ref).abs().max()) <= 2, (fates.tolist(), ref.tolist())


def test_device_code_with_many_components_matches_twin_on_host(host_lib):
    """Two tiles of six components each (``lsc_tiles``), more than a step
    holds in registers (``kHeldSlots``): the roulette evaluates the slots
    beyond again. The host-built step, lane by lane for 6 steps, and trace
    of 4096 photons against the twin."""
    st = tables.scene_tensors(compile_scene(lsc_tiles(tiles=2)), dtype=torch.float32)
    assert max(r[tables.NI_NCOMP] for r in st["rows"]["node_i"]) == 6
    seed, B = rng.key_words(6), 1 << 12
    sc = kernels._scene(st, 1000, 0, float("inf"))
    s = tracer.initial_state(st, seed, torch.arange(B))
    absorbed = 0
    for _ in range(6):
        ref = tracer.step_state(st, s, 1000, 0)
        got, flags = kernels._empty_state(B, "cpu"), kernels._empty_flags(B, "cpu")
        host_lib.h_step(
            ctypes.byref(sc),
            ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._State, got, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B,
        )
        got.update(flags)
        for name in check.DISCRETE:
            assert torch.equal(got[name].long(), ref[name].long()), name
        for name in physics.STATE_FLOATS + physics.SURFACE:
            torch.testing.assert_close(got[name], ref[name], rtol=1e-4, atol=1e-5)
        absorbed += int((ref["source"] != s["source"]).sum())
        s = ref
    assert absorbed > 0
    fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
    _, no_log = kernels.empty_log(4096, 0, 128, 0, "cpu")
    host_lib.h_trace(ctypes.byref(sc), seed[0], seed[1], 0, 4096, ctypes.byref(no_log),
                     fates.data_ptr())
    ref, _, _, _ = tracer.trace_eager(st, seed, 4096, lanes=512)
    assert int(fates.sum()) == 4096
    assert int((fates - ref).abs().max()) <= 2, (fates.tolist(), ref.tolist())


# The host model of pvt_trace's loop (``trace_warps``) against one photon
# at a time: each case's float32 scene and what its runs take (first
# photon id, the event log's (record_every, max_events), score channels, a
# host bundle). The mixed scene's Lambertian facet and lifetimes read u[3],
# u[4] at a surface event and u[6] at a volume event, and its two lamps all
# three emission pairs, which the slab's never do.
WARP_CASES = {
    "slab": dict(make=lsc_slab),
    "slab-host-bundle": dict(make=lsc_slab_host, bundle=True, off=5),
    "mesh_small-log": dict(make=mesh_small, off=2, log=(2, 8)),
    "slab-R32-score": dict(make=lambda: lsc_slab_recorders(32), score=True),
    # groups of up to 64 recorders and no scores: the warp rule
    # (tally_warp_host; trace_rule)
    "slab-R256": dict(make=lambda: lsc_slab_recorders(256)),
    "mixed": dict(make=mixed_scene, off=7),
    "mixed-log-score": dict(make=mixed_scene, score=True, log=(3, 16)),
}


@pytest.fixture(scope="module")
def warp_scenes():
    return {}


def _warp_scene(warp_scenes, case, n):
    """Scene tensors, first id and host bundle ([7, n] or None) of `case`."""
    spec = WARP_CASES[case]
    if case not in warp_scenes:
        scene = spec["make"]()
        warp_scenes[case] = (scene, tables.scene_tensors(compile_scene(scene),
                                                         dtype=torch.float32))
    scene, st = warp_scenes[case]
    bundle = None
    if spec.get("bundle"):
        np.random.seed(3)
        bundle = torch.from_numpy(tracer.bundle_rows(*emit_bundle(scene, n)[:3], np.float32))
    return st, spec.get("off", 0), bundle


def _host_warp_run(h, st, seed, off, n, warps, log=None, score=False, bundle=None):
    """``h_trace_warp``: photons [off, off + n) on `warps` emulated warps
    (0: one photon at a time); every output as tensors."""
    R, CH = max(st["meta"]["n_rec"], 1), score_ch.n_channels(st) if score else 0
    every, events = log or (0, 128)
    lg, desc = kernels.empty_log(n, every, events, off, "cpu")
    t = {"fates": torch.zeros(11, dtype=torch.int64), "cross": torch.zeros(R, dtype=torch.int64),
         "distinct": torch.zeros(R, dtype=torch.int32), "sums": torch.zeros(8 * R),
         "bins": torch.zeros(max(st["meta"]["total_bins"], 1), dtype=torch.int64),
         "sums64": torch.zeros(8 * R, dtype=torch.float64),
         "fate_scores": torch.zeros((2, 11, max(CH, 1)), dtype=torch.float64),
         "rec_scores": torch.zeros((2, R, max(CH, 1)), dtype=torch.float64),
         "photon": torch.zeros((CH + 2, n)), "out": torch.zeros(3, dtype=torch.int64),
         "started": torch.zeros(n, dtype=torch.int32)}
    rows = torch.zeros(max(CH, 1) * (32 * warps if warps else 1))
    bdesc = kernels._Bundle(bundle.data_ptr(), n, off) if bundle is not None else None
    h.h_trace_warp(
        ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed[0], seed[1], off, off + n,
        warps, ctypes.byref(desc), t["fates"].data_ptr(), t["cross"].data_ptr(),
        t["sums"].data_ptr(), t["distinct"].data_ptr(), t["bins"].data_ptr(),
        t["sums64"].data_ptr(), rows.data_ptr() if score else None, CH, st["meta"]["n_comps"],
        t["fate_scores"].data_ptr(), t["rec_scores"].data_ptr(),
        t["photon"].data_ptr() if score else None, None, None, 0,
        ctypes.byref(bdesc) if bdesc is not None else None, t["out"].data_ptr(),
        t["started"].data_ptr(),
    )
    t.update(log=lg, steps=int(t["out"][0]), lane_steps=int(t["out"][1]),
             longest=int(t["out"][2]))
    return t


@pytest.mark.parametrize("n, warps", [(1, 1), (31, 1), (32, 1), (33, 2), (4096, 3)])
@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_loop_equals_photon_loop_on_host(host_lib, warp_scenes, case, n, warps):
    """pvt_trace's loop (one step a turn on every lane, dead lanes refilled
    from one counter by rank: ``trace_warps``, host-built) against
    ``trace_photon`` one photon at a time, the run of ``h_trace``: every
    photon started once, and fates, steps, the longest photon, integer
    tallies, every log field and every photon's score record bit for bit;
    float sums within two orders' bounds (``check.SUMS_RUNS_RTOL``,
    ``check.score_runs_bound``)."""
    spec = WARP_CASES[case]
    st, off, bundle = _warp_scene(warp_scenes, case, n)
    seed, log, score = rng.key_words(8), spec.get("log"), spec.get("score", False)
    ref = _host_warp_run(host_lib, st, seed, off, n, 0, log, score, bundle)
    got = _host_warp_run(host_lib, st, seed, off, n, warps, log, score, bundle)
    assert torch.equal(got["started"], torch.ones(n, dtype=torch.int32))
    assert int(got["fates"].sum()) == n and torch.equal(got["fates"], ref["fates"])
    assert (got["steps"], got["longest"]) == (ref["steps"], ref["longest"])
    assert got["steps"] <= got["lane_steps"] and got["lane_steps"] % 32 == 0
    # The serial run is h_trace's (fates; with the log, the log too).
    if not score:
        fates = torch.zeros(11, dtype=torch.int64)
        lg, desc = kernels.empty_log(n, *(log or (0, 128)), off, "cpu")
        sc = ctypes.byref(kernels._scene(st, 1000, 0, float("inf")))
        bdesc = kernels._Bundle(bundle.data_ptr(), n, off) if bundle is not None else None
        host_lib.h_trace_bundle(sc, seed[0], seed[1], off, off + n, ctypes.byref(desc),
                                fates.data_ptr(), ctypes.byref(bdesc) if bdesc else None)
        assert torch.equal(fates, ref["fates"])
        if log:
            assert torch.equal(lg["ints"], ref["log"]["ints"])
    if log:
        assert int((got["log"]["ints"][..., 0] >= 0).sum()) >= 2
        for key in ("ints", "floats"):
            assert torch.equal(got["log"][key].view(torch.int32),
                               ref["log"][key].view(torch.int32)), key
    if st["meta"]["n_rec"]:
        for name in ("distinct", "cross", "bins"):
            assert torch.equal(got[name], ref[name]), name
        total = {k: t["sums64"] + t["sums"].double() for k, t in (("got", got), ("ref", ref))}
        assert torch.allclose(total["got"], total["ref"], rtol=check.SUMS_RUNS_RTOL, atol=0)
    if score:
        assert torch.equal(got["photon"].view(torch.int32), ref["photon"].view(torch.int32))
        assert bool((ref["photon"][-2] >= 0).all())
        for name, m in (("fate_scores", ref["fates"].double()),
                        ("rec_scores", ref["distinct"].double())):
            allow = check.score_runs_bound(m[:, None], ref[name][1])
            assert bool(((got[name] - ref[name]).abs() <= allow).all()), name
        if n == 4096:
            # The loop's lane-steps against the per-photon loop's it
            # replaces, from the same photons' steps.
            parent = check.per_photon_loop_efficiency(ref["photon"][-1])
            assert got["steps"] / got["lane_steps"] > parent


@pytest.mark.parametrize("make", [lsc_slab, mixed_scene, lsc_tiles],
                         ids=["slab", "mixed", "tiles"])
def test_cheb_pack_records_padding_and_alignment(make):
    """``cheb_pack`` holds the ``cheb_*`` records as tracer.cuh reads them
    (the ``CHEB_REC``, ``FR_*``, ``SR_*`` and ``SEG_*`` layout): a record
    per fit and per segment, each piecewise fit's interior breakpoints (its
    segments' b in float32), each segment's coefficients from the highest
    degree down from a 16-byte boundary, padded with zeros to one, the
    whole a multiple of 16 bytes and 16-byte aligned."""
    st = tables.scene_tensors(compile_scene(make()), dtype=torch.float32)
    w = st["cheb_pack"].numpy()
    f32 = w.view(np.float32)
    fit_i, fit_f = st["cheb_fit_i"].tolist(), st["cheb_fit_f"].numpy()
    seg_f, seg_i, coef = st["cheb_seg_f"].numpy(), st["cheb_seg_i"].numpy(), st["cheb_coef"]
    F, R = len(fit_i), tables.CHEB_REC
    assert R == 4 and w.size == st["meta"]["cheb_words"] and w.size % 4 == 0
    assert st["cheb_pack"].data_ptr() % 16 == 0
    ends = []
    for f, (kind, nseg, seg0) in enumerate(fit_i):
        fr = w[R * f:R * (f + 1)]
        assert fr[tables.FR_NSEG] == nseg and fr[tables.FR_SEG] == R * (F + seg0)
        assert f32[R * f + tables.FR_OFF] == np.float32(fit_f[f])
        if nseg > 1:
            brk = f32[fr[tables.FR_BRK]:fr[tables.FR_BRK] + nseg - 1]
            assert np.array_equal(brk, seg_f[seg0:seg0 + nseg - 1, tables.SF_B])
        for s in range(seg0, seg0 + nseg):
            sr = w[R * (F + s):R * (F + s + 1)]
            assert f32[R * (F + s) + tables.SR_A] == seg_f[s, tables.SF_A]
            assert f32[R * (F + s) + tables.SR_SCALE] == seg_f[s, tables.SF_SCALE]
            info, deg = sr[tables.SR_DEG], seg_i[s, tables.SI_DEG]
            assert info & tables.SEG_DEG_MASK == deg
            assert bool(info & tables.SEG_LOG) == (seg_i[s, tables.SI_KIND] == tables.FIT_LOG)
            assert bool(info & tables.SEG_MAP) == (kind == tables.FIT_PW)
            c0, first = sr[tables.SR_COEF], seg_i[s, tables.SI_COEF0]
            assert c0 % 4 == 0
            want = coef[first:first + deg + 1].flip(0).numpy()
            assert np.array_equal(f32[c0:c0 + deg + 1], want)
            padded = c0 + deg + 1 + (-(deg + 1) % 4)
            assert not w[c0 + deg + 1:padded].any()
            ends.append(padded)
    assert max(ends) == w.size


def test_wrappers_run_the_twin_on_cpu(bench_f32):
    st, seed = bench_f32, rng.key_words(3)
    kernels.reset()
    state = kernels.emit(st, seed, 5, 256)
    ref = tracer.initial_state(st, seed, 5 + torch.arange(256))
    for name in ref:
        assert torch.equal(state[name], ref[name]), name
    stepped = kernels.step(st, state)
    assert torch.equal(stepped["alive"], tracer.step_state(st, state, 1000, 0)["alive"])
    fates, _, _, _ = kernels.trace(st, seed, 300, lanes=64)
    assert torch.equal(fates, tracer.trace_eager(st, seed, 300, lanes=64)[0])
    _, _, _, log = kernels.trace(st, seed, 300, lanes=64, record_every=2, max_events=16)
    for got, ref in zip(kernels.log_pack(log), eventlog.pack(log, log["counts"])):
        assert got.shape[0] == int(log["counts"].sum()) and torch.equal(got, ref)
    values = kernels.cheb(st, torch.linspace(-1.0, 1.0, 5))
    assert values.shape == (st["meta"]["cheb_n_fits"], 5)
    rec = tables.scene_tensors(compile_scene(lsc_slab_recorders(8)))
    out = tracer.step_state(rec, tracer.initial_state(rec, seed, torch.arange(256)), 1000, 0)
    got, ref = tally.empty(rec, 256), tally.empty(rec, 256)
    assert kernels.tally_step(got, rec, out) is None
    tally.tally(ref, rec, out)
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    assert set(kernels.launches.values()) == {0}


def test_build_names_library_by_source_hash():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path()
    assert "-use_fast_math" not in build.NVCC_FLAGS and "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_functions_ignore_what_another_function_moves():
    """``build.functions`` (``build.py --against``) holds two libraries'
    functions equal where only what another function's change moves
    differs: the column padding and encodings, the library-wide label
    numbers and constant bank 4's slot order; a changed instruction
    differs."""
    sass = ("\tFunction : _Z1fv\n"
            "        /*0000*/ {pad}LDC.64 R2, c[0x4][{slot}] ;  /* 0x{enc}ff027b82 */\n"
            "        /*0010*/ {pad}@!P0 BRA `(.L_x_{label}) ;\n"
            ".L_x_{label}:\n"
            "        /*0020*/ {pad}{op} R4, R2, R2 ;\n")
    a = build.functions(sass.format(pad="  ", slot="RZ", enc="01000000", label=12, op="DADD"))
    b = build.functions(sass.format(pad="   ", slot="0x8", enc="01000200", label=40, op="DADD"))
    c = build.functions(sass.format(pad="  ", slot="RZ", enc="01000000", label=12, op="DMUL"))
    assert a == b and a != c


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    compiled = compile_scene(lsc_slab())
    return tables.scene_tensors(compiled, dtype=torch.float32, device="cuda")


def _cuda_spectra_scene(monkeypatch, spectra, dtype=torch.float32):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _spectra_scene(monkeypatch, spectra, "cuda", dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("spectra", ["K5a", "K5b"])
def test_emit_and_step_kernels_match_twin_on_card(monkeypatch, spectra):
    st = _cuda_spectra_scene(monkeypatch, spectra)
    state, rep = check.check_emit(st, rng.key_words(1), 1 << 16, reps=2)
    assert rep["max_abs_err"] <= 1e-5
    rep = check.check_step(st, state, steps=8, reps=2)
    assert rep["discrete_frac"] <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("spectra", ["K5a", "K5b"])
def test_trace_kernel_matches_twin_on_card(monkeypatch, spectra):
    st = _cuda_spectra_scene(monkeypatch, spectra)
    rep = check.check_trace(st, rng.key_words(1), 1 << 16, lanes=1 << 14)
    assert sum(rep["fates"]) == 1 << 16


@pytest.mark.gpu
def test_draws_kernel_matches_twin_on_card():
    """pvt_draws (phase 27) at 2**14 lanes: every word bit-equal to the twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rep = check.check_draws("cuda", 1 << 14, reps=1)
    assert rep["max_abs_err"] == 0.0 and kernels.launches["pvt_draws"] >= 3


@pytest.mark.gpu
def test_cheb_and_tally_kernels_match_twin_on_card(cuda_scene):
    rep = check.check_cheb(cuda_scene, n_t=4096, reps=2)
    assert rep["max_rel_err"] <= check.CHEB_RTOL
    st = tables.scene_tensors(compile_scene(lsc_slab_recorders(32)), device="cuda")
    state = tracer.initial_state(st, rng.key_words(1), torch.arange(1 << 14, device="cuda"))
    rep = check.check_tally(st, state, steps=8, reps=2)
    assert rep["max_rel_err"] <= check.SUMS_RTOL


@pytest.mark.gpu
def test_cheb_kernel_placements_match_twin_on_card(cuda_scene):
    """pvt_cheb with the slab's K5a table staged in shared memory and read
    in device memory, and with ``lsc_tiles``' table, too large for the
    budget, in device memory: segments and values against the twin."""
    for shared in (True, False):
        rep = check.check_cheb(cuda_scene, n_t=4096, reps=2, shared=shared)
        assert rep["shared_cheb"] == shared and rep["max_rel_err"] <= check.CHEB_RTOL
    tiles = tables.scene_tensors(compile_scene(lsc_tiles()), device="cuda")
    assert check.check_cheb(tiles, n_t=1024, reps=2)["shared_cheb"] == 0


@pytest.mark.gpu
def test_trace_kernel_places_k5a_table_by_budget_on_card(cuda_scene):
    """pvt_trace stages the slab's K5a table in shared memory and reads
    ``lsc_tiles``' in device memory; both against the twin."""
    check.check_trace(cuda_scene, rng.key_words(1), 1 << 14, lanes=1 << 12)
    assert kernels.last_trace["shared_cheb"] == 1
    tiles = tables.scene_tensors(compile_scene(lsc_tiles()), device="cuda")
    check.check_trace(tiles, rng.key_words(1), 1 << 14, lanes=1 << 12)
    assert kernels.last_trace["shared_cheb"] == 0


@pytest.mark.gpu
def test_recorder_trace_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for scene, shared_bins in ((lsc_slab_recorders(32), True), (lsc_slab_recorders(256), True),
                               (lsc_slab_heatmap(), False)):
        st = tables.scene_tensors(compile_scene(scene), device="cuda")
        rep = check.check_trace(st, rng.key_words(2), 1 << 16, lanes=1 << 14)
        assert rep["shared_bins"] == shared_bins


@pytest.mark.gpu
def test_simulate_on_card_goes_through_the_kernel(cuda_scene):
    kernels.reset()
    tracer.eager_runs = 0
    result = simulate(lsc_slab(), 1 << 16, seed=3, record_every=0)
    assert int(np.asarray(result.data["fates"]).sum()) == 1 << 16
    assert kernels.launches["pvt_trace"] == 1 and tracer.eager_runs == 0


def _cuda_tensors(make, dtype=torch.float32):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tables.scene_tensors(compile_scene(make()), dtype=dtype, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("make", [mesh_lsc, mesh_slab_fine], ids=["hex_plate", "fine_slab"])
def test_mesh_kernel_matches_twin_on_card(make):
    rep = check.check_mesh(_cuda_tensors(make), 1, 1 << 16, seed=1, reps=2)
    assert rep["max_rel_err"] <= check.MESH_RTOL


@pytest.mark.gpu
def test_mesh_trace_matches_twin_on_card():
    rep = check.check_trace(_cuda_tensors(mesh_lsc), rng.key_words(1), 1 << 16, lanes=1 << 14)
    assert sum(rep["fates"]) == 1 << 16 and kernels.last_trace["shared_tris"] == 1


def _many_groups_slab():
    """The slab with 64 "escaping" recorders on the axis facets, each with
    its own tolerance: 64 facet groups, past one seen word a lane."""
    from pvtrace_tpu_torch.engine.recorder import Histogram, Recorder
    from pvtrace_tpu_torch.scenes import _slab_node

    scene = lsc_slab()
    faces = [(0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)]
    _slab_node(scene).recorders = [
        Recorder(f"g{r:02d}", event="escaping", facet=faces[r % 6], atol=1e-6 * (1 + r),
                 histograms=[Histogram("wavelength", 400.0, 800.0, 8)]) for r in range(64)]
    return scene


@pytest.mark.gpu
@pytest.mark.parametrize("make", [lambda: lsc_slab_recorders(256), lsc_slab_heatmap,
                                  _many_groups_slab], ids=["R256", "heatmap", "groups"])
def test_tally_warp_matches_twin_on_card(make):
    """pvt_tally, by the rule pvt_trace takes for the scene: with 256
    recorders in 10 facet groups (the warp rule, tally_warp), with the
    heatmap's global 64-bit bins and with 64 groups of one recorder (the
    lane rule; seen bits past one word), on lanes that leave the last warp
    partial: integer tallies and seen bits equal to the twin's after every
    step, sums within SUMS_RTOL."""
    st = _cuda_tensors(make)
    state = tracer.initial_state(st, rng.key_words(1), torch.arange((1 << 14) + 5, device="cuda"))
    rep = check.check_tally(st, state, steps=8, reps=2)
    assert rep["max_rel_err"] <= check.SUMS_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("make, events", [(mesh_lsc, 128), (lsc_slab, 128), (mesh_lsc, 8)])
def test_log_kernel_matches_twin_on_card(make, events):
    rep = check.check_log(_cuda_tensors(make), rng.key_words(1), 1 << 12, max_events=events)
    assert rep["diverged"] <= check.LOG_DIVERGED * rep["slots"]


@pytest.mark.gpu
@pytest.mark.parametrize("make, events", [(mesh_lsc, 128), (mesh_lsc, 8), (lsc_slab, 128)])
def test_log_pack_and_fetch_match_twin_on_card(make, events):
    """pvt_log_pack against eventlog.pack on the kernel's log (bit-equal),
    the kernel's counts against its rows, and simulate(record_every=1)'s
    dense arrays against the CPU twin's: photons whose ints differ at most
    LOG_DIVERGED of them, the others' floats within LOG_RTOL of their
    column's scale, counts equal."""
    st = _cuda_tensors(make)
    _, _, _, log = kernels.trace(st, rng.key_words(3), 1 << 12, record_every=1,
                                 max_events=events)
    rep = check.check_log_pack(log, reps=2)
    assert kernels.launches["pvt_log_pack"] > 0 and rep["records"] == int(log["counts"].sum())
    ints, _ = check.dense_log(log)
    assert torch.equal(log["counts"], (ints[..., 0] >= 0).sum(1).to(torch.int32))
    assert check.check_fetch(make(), 1 << 12, max_events=events)["slots"] == 1 << 12


@pytest.mark.gpu
def test_mesh_and_log_on_card_go_through_the_kernel():
    """simulate of the mesh LSC, without and with the log, launches
    pvt_trace (the log instantiation for the second) and no eager run;
    the kernel's tallies equal those recomputed from its own log."""
    _cuda_tensors(mesh_lsc)
    scene = mesh_lsc()
    for every in (0, 1):
        kernels.reset()
        tracer.eager_runs = 0
        result = simulate(scene, 1 << 12, seed=3, record_every=every)
        assert int(np.asarray(result.data["fates"]).sum()) == 1 << 12
        assert kernels.launches["pvt_trace"] == 1 and tracer.eager_runs == 0
        assert kernels.launches["pvt_trace_log"] == every
    assert check.check_log_tallies(scene, result) <= check.LOG_SUMS_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("make", [lsc_slab, lambda: lsc_slab_recorders(256), mesh_lsc],
                         ids=["slab", "R256", "mesh_lsc"])
def test_float64_trace_matches_twin_on_card(make):
    """pvt_trace of the float64 build (``tracer_f64``) against the float64
    twin at 2**16 photons: fates and integer tallies within
    ``check.F64_PARTED``, the sums within the float64 summation bound;
    simulate(dtype=float64) launches tracer_f64 and no eager run."""
    st = _cuda_tensors(make, torch.float64)
    kernels.reset()
    rep = check.check_trace(st, rng.key_words(1), 1 << 16, lanes=1 << 14)
    assert kernels.last_trace["library"] == "tracer_f64" and kernels.launches_f64["pvt_trace"] == 2
    assert rep["max_abs_err"] <= check.F64_PARTED and rep["tally_max_diff"] <= check.F64_PARTED
    kernels.reset()
    tracer.eager_runs = 0
    result = simulate(make(), 1 << 14, seed=3, record_every=0, dtype=np.float64)
    assert result.data["rec_sums"].dtype == np.float64 and tracer.eager_runs == 0
    assert kernels.launches_f64["pvt_trace"] == kernels.launches["pvt_trace"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [0, 2], ids=["score", "pathwise"])
def test_float64_score_traces_match_twin_on_card(channels):
    """Float64 ``kernels.trace(score=True)`` (``pvt_trace_score`` of
    ``score_f64``) and with two pathwise channels (``pvt_trace_pathwise``
    of ``pathwise_f64``) against the float64 twin photon by photon at
    2**14 (``check.check_trace_scores``: the float64 bounds, at most
    ``check.F64_PARTED`` parted); counted in ``launches_f64``."""
    from pvtrace_tpu_torch.diff.transport import resolve_pathwise_params

    st = _cuda_tensors(lsc_slab, torch.float64)
    specs = resolve_pathwise_params(compile_scene(lsc_slab()),
                                    [("n", "lsc"), ("size", "lsc", 2)][:channels])
    name = "pvt_trace_pathwise" if channels else "pvt_trace_score"
    kernels.reset()
    rep = check.check_trace_scores(st, rng.key_words(1), 1 << 14, pathwise=specs)
    assert kernels.last_trace["library"] == ("pathwise_f64" if channels else "score_f64")
    assert kernels.launches_f64[name] == kernels.launches[name] == 2
    assert rep["parted"] <= check.F64_PARTED and rep["record_used"] <= 1.0
    assert rep["tallies"]["photon_scores"].dtype == torch.float64


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [0, 2], ids=["score", "pathwise"])
def test_float64_score_traces_take_five_blocks_of_128(channels):
    """The float64 score and pathwise trace kernels launch in blocks of
    ``kernels.score_block(torch.float64)`` (128) threads, five resident an
    SM on the slab (its blocks' shared bytes within the 44 KB budget),
    where the float32 ones take two blocks of 256."""
    from pvtrace_tpu_torch.diff.transport import resolve_pathwise_params

    sms = torch.cuda.get_device_properties(0).multi_processor_count if \
        torch.cuda.is_available() else 0
    specs = resolve_pathwise_params(compile_scene(lsc_slab()),
                                    [("n", "lsc"), ("size", "lsc", 2)][:channels])
    for dtype, per_sm in ((torch.float64, 5 * 128), (torch.float32, 2 * 256)):
        st = _cuda_tensors(lsc_slab, dtype)
        kernels.trace(st, rng.key_words(1), 1 << 20, score=True, pathwise=specs)
        assert kernels.score_block(dtype) * (5 if dtype == torch.float64 else 2) == per_sm
        assert kernels.last_trace["threads"] == per_sm * sms, (dtype, kernels.last_trace)
        assert kernels.last_trace["shared_bytes"] <= (44 if dtype == torch.float64 else 96) * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("make", [lambda: lsc_slab_recorders(32), lambda: lsc_slab_recorders(256),
                                  mesh_lsc, mesh_slab_fine],
                         ids=["R32", "R256", "mesh_lsc", "fine_slab"])
def test_float64_recorder_and_mesh_traces_take_five_blocks_of_128(make):
    """The float64 trace kernels with recorders or meshes (K9, K10; the
    mesh ones through K10's wide loop) against the float64 twin at 2**16:
    fates and integer tallies within ``check.F64_PARTED``; at 2**20 they
    launch blocks of 128 threads, five resident an SM, placed as
    ``kernels.trace_layout`` says within 44 KB (256 recorders' bins in
    device memory), from a host bundle too, where the same scene with the
    event log takes blocks of 128, four an SM (each launch reporting its
    instantiation)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count if \
        torch.cuda.is_available() else 0
    st = _cuda_tensors(make, torch.float64)
    rep = check.check_trace(st, rng.key_words(2), 1 << 16, lanes=1 << 14)
    assert rep["max_abs_err"] <= check.F64_PARTED and rep["tally_max_diff"] <= check.F64_PARTED
    kernels.trace(st, rng.key_words(2), 1 << 20)
    placed = check.check_layout(st, False, 0)
    assert placed["block"] == 128 and kernels.last_trace["threads"] == 5 * 128 * sms
    assert placed["shared_bytes"] <= 44 * 1024
    assert placed["shared_bins"] == int(0 < st["meta"]["n_rec"] < 256)
    kernels.trace(st, rng.key_words(2), 1 << 20, record_every=1000)
    assert kernels.last_trace["block"] == 128 and kernels.last_trace["threads"] == 4 * 128 * sms
    assert kernels.last_trace["instantiation"][3] == "1"
    np.random.seed(2)
    bundle = torch.from_numpy(tracer.bundle_rows(*emit_bundle(make(), 1 << 20)[:3],
                                                 np.float64)).cuda()
    kernels.trace(st, rng.key_words(2), 1 << 20, bundle=bundle)
    assert kernels.last_trace["block"] == 128 and kernels.last_trace["threads"] == 5 * 128 * sms
    assert kernels.last_trace["instantiation"][11] == "1"


@pytest.mark.gpu
def test_float64_fate_gradients_launch_score_f64():
    """``fate_gradients(dtype=np.float64)`` on the card runs through
    ``score_f64``'s ``pvt_trace_score``: no eager run, no float32 launch,
    finite gradients."""
    from pvtrace_tpu_torch.diff.transport import fate_gradients

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.reset()
    tracer.eager_runs = 0
    fractions, grads = fate_gradients(lsc_slab(), 1 << 16, seed=3, wrt="all", bundle=1 << 15,
                                      dtype=np.float64)
    assert kernels.launches_f64["pvt_trace_score"] == kernels.launches["pvt_trace_score"] == 2
    assert kernels.launches["pvt_trace"] == kernels.launches_f64["pvt_trace"]
    assert tracer.eager_runs == 0
    assert all(np.isfinite(g).all() for g in grads.values())


@pytest.mark.gpu
def test_float64_absorbed_kernels_match_plain_on_card():
    """``pvt_absorbed`` and ``pvt_absorbed_grad`` of ``diff_f64`` against the
    float64 plain version at 2**16 photons (``check.check_absorbed``:
    ``F64_RTOL``), and ``absorbed_fraction_fn``'s
    forward and backward on float64 photons launching them."""
    from pvtrace_tpu_torch.diff.transport import absorbed_fraction_fn
    from pvtrace_tpu_torch.engine import absorb

    st = _cuda_tensors(lsc_slab, torch.float64)
    compiled = compile_scene(lsc_slab())
    tab = absorb.table(compiled, "cuda", torch.float64)
    pos, d, wav = check.absorbed_photons(st, rng.key_words(1), 1 << 16)
    assert wav.dtype == torch.float64
    kernels.reset()
    rep = check.check_absorbed(tab, pos, d, wav, reps=2)
    assert rep["max_rel_err"] <= check.F64_RTOL
    assert kernels.launches_f64["pvt_absorbed"] > 0
    assert kernels.launches_f64["pvt_absorbed_grad"] > 0
    weight = absorbed_fraction_fn(compiled)
    kernels.reset()
    got = check.surrogate_sgd(lambda lc, p, dd, w: weight({"log_concentration": lc}, p, dd, w),
                              pos, d, wav)
    assert kernels.launches_f64["pvt_absorbed"] == kernels.launches_f64["pvt_absorbed_grad"] == 5
    ref = check.surrogate_sgd(
        lambda lc, p, dd, w: absorb.weight(torch.exp(lc), absorb.depth(tab, p, dd, w)), pos, d, wav)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=check.F64_RTOL,
                               atol=1e-15)


@pytest.mark.gpu
@pytest.mark.parametrize("spectra", ["K5a", "K5b"])
def test_float64_emit_and_step_kernels_match_twin_on_card(monkeypatch, spectra):
    st = _cuda_spectra_scene(monkeypatch, spectra, torch.float64)
    state, rep = check.check_emit(st, rng.key_words(1), 1 << 16, reps=2)
    assert rep["max_abs_err"] <= check.F64_ATOL and state["px"].dtype == torch.float64
    rep = check.check_step(st, state, steps=8, reps=2)
    assert rep["discrete_frac"] <= 1e-4 and kernels.launches_f64["pvt_step"] > 0


@pytest.mark.gpu
def test_float64_draws_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rep = check.check_draws("cuda", 1 << 14, reps=1, dtype=torch.float64)
    assert rep["max_abs_err"] == 0.0 and kernels.launches_f64["pvt_draws"] >= 3


@pytest.mark.gpu
def test_float64_cheb_and_tally_kernels_match_twin_on_card():
    """pvt_cheb of the float64 build in both placements (segments at every
    float64 breakpoint, values within CHEB_RTOL_F64) and pvt_tally with 32
    and 256 recorders (integers equal, sums within sums_bound_f64)."""
    st = _cuda_tensors(lsc_slab, torch.float64)
    for shared in (True, False):
        rep = check.check_cheb(st, n_t=4096, reps=2, shared=shared)
        assert rep["shared_cheb"] == shared and rep["max_rel_err"] <= check.CHEB_RTOL_F64
    for R in (32, 256):
        st = _cuda_tensors(lambda: lsc_slab_recorders(R), torch.float64)
        state = tracer.initial_state(st, rng.key_words(1), torch.arange(1 << 14, device="cuda"))
        check.check_tally(st, state, steps=8, reps=2)
    assert kernels.launches_f64["pvt_tally"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("make", [mesh_lsc, mesh_slab_fine], ids=["hex_plate", "fine_slab"])
def test_float64_mesh_kernel_matches_twin_on_card(make):
    rep = check.check_mesh(_cuda_tensors(make, torch.float64), 1, 1 << 16, seed=1, reps=2)
    assert rep["max_rel_err"] <= check.MESH_RTOL_F64


@pytest.mark.gpu
@pytest.mark.parametrize("make, events", [(mesh_lsc, 128), (mesh_lsc, 8), (lsc_slab, 128)])
def test_float64_log_and_log_pack_match_twin_on_card(make, events):
    """The float64 build's event log against the float64 twin photon by
    photon (at most F64_PARTED parted), its pvt_log_pack bit-equal to
    eventlog.pack, and simulate(record_every=1, dtype=float64)'s dense
    float64 arrays against the CPU twin's."""
    st = _cuda_tensors(make, torch.float64)
    rep = check.check_log(st, rng.key_words(1), 1 << 12, max_events=events)
    assert rep["diverged"] <= check.F64_PARTED and rep["log"]["floats"].dtype == torch.float64
    assert rep["pack"]["records"] == rep["records"] and kernels.launches_f64["pvt_log_pack"] > 0
    fetched = check.check_fetch(make(), 1 << 12, max_events=events, dtype=np.float64)
    assert fetched["diverged"] <= check.F64_PARTED


@pytest.mark.gpu
@pytest.mark.parametrize("make", [lsc_slab, mixed_scene], ids=["slab", "mixed"])
def test_score_kernel_matches_twin_on_card(make):
    st = _cuda_tensors(make)
    state = tracer.initial_state(st, rng.key_words(1), torch.arange(1 << 14, device="cuda"))
    rep = check.check_score(st, state, steps=8, reps=2)
    assert rep["discrete_frac"] <= 1e-4


@pytest.mark.gpu
def test_fresnel_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert check.check_fresnel("cuda", reps=2)["max_abs_err"] <= check.SCORE_RTOL


def _many_channels():
    """``lsc_slab_recorders(256)`` with three absorbing spheres that no
    light reaches: 10 score channels beside 256 recorders' tallies, more
    than a block's shared memory holds, so the score sums go straight to
    the totals."""
    from pvtrace_tpu_torch.scenes import api

    p = api()
    scene = lsc_slab_recorders(256)
    for k in range(3):
        ball = p.Node(name=f"ball{k}", parent=scene.root, geometry=p.Sphere(
            radius=0.5, material=p.Material(refractive_index=1.2,
                                            components=[p.Absorber(0.5)])))
        ball.translate((10.0, 4.0 * k - 2.0, -10.0))
    return scene


@pytest.mark.gpu
@pytest.mark.parametrize("make, shared", [
    (lsc_slab, True), (lambda: lsc_slab_recorders(32), True), (mesh_lsc, True),
    (_many_channels, False),
], ids=["slab", "rec32", "mesh", "global-sums"])
def test_score_trace_matches_twin_on_card(make, shared):
    st = _cuda_tensors(make)
    rep = check.check_trace_scores(st, rng.key_words(2), 1 << 16, lanes=1 << 14)
    assert rep["shared_scores"] == shared
    assert rep["record_used"] <= 1.0 and rep["sums_used"] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("specs", [(), [("n", "lsc"), ("size", "lsc", 2)]],
                         ids=["score", "pathwise"])
def test_score_rows_placements_on_card(specs):
    """The slab's score trace keeps its threads' rows in shared memory (as
    ``kernels.trace_layout`` says) and, forced into device memory, gives
    the same records bit for bit."""
    from pvtrace_tpu_torch.diff.transport import resolve_pathwise_params

    st = _cuda_tensors(lsc_slab)
    resolved = resolve_pathwise_params(compile_scene(lsc_slab()), specs)
    rep = check.check_trace_scores(st, rng.key_words(2), 1 << 16, lanes=1 << 14,
                                   pathwise=resolved)
    assert rep["shared_rows"] == 1 and rep["record_used"] <= 1.0
    rows = check.check_rows_placement(st, rng.key_words(2), 1 << 16, rep["tallies"], resolved,
                                      reps=1)
    assert rows["device"]["shared_rows"] == 0 and rows["placed"]["shared_rows"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("R, rows, cheb", [(256, 0, 1), (224, 1, 0)], ids=["R256", "R224"])
def test_score_rows_past_the_budget_on_card(R, rows, cheb):
    """Two pathwise channels' rows do not fit a block's budget at 256
    recorders (device memory), and fit with the K5a table in device memory
    at 224; either way the launch reports ``trace_layout``'s placement and
    the fates account for every photon."""
    from pvtrace_tpu_torch.diff.transport import resolve_pathwise_params

    make = lambda: lsc_slab_recorders(R)  # noqa: E731
    st = _cuda_tensors(make)
    resolved = resolve_pathwise_params(compile_scene(make()), [("n", "lsc"), ("size", "lsc", 2)])
    fates, _, _, _ = kernels.trace(st, rng.key_words(2), 1 << 14, score=True, pathwise=resolved)
    placed = check.check_layout(st, True, 2)
    assert (placed["shared_rows"], placed["shared_cheb"]) == (rows, cheb)
    assert int(fates.sum()) == 1 << 14


@pytest.mark.gpu
def test_gradient_path_on_card_goes_through_the_kernel():
    from pvtrace_tpu_torch.diff.transport import fate_gradients

    _cuda_tensors(lsc_slab)
    kernels.reset()
    tracer.eager_runs = 0
    fractions, grads = fate_gradients(lsc_slab(), 1 << 16, seed=3, wrt="all", bundle=1 << 15)
    assert kernels.launches["pvt_trace_score"] == 2 and tracer.eager_runs == 0
    assert all(np.isfinite(g).all() for g in grads.values())


@pytest.mark.gpu
def test_absorbed_kernels_match_plain_on_card():
    from pvtrace_tpu_torch.diff.transport import absorbed_fraction_fn
    from pvtrace_tpu_torch.engine import absorb

    st = _cuda_tensors(lsc_slab)
    compiled = compile_scene(lsc_slab())
    tab = absorb.table(compiled, "cuda")
    pos, d, wav = check.absorbed_photons(st, rng.key_words(1), 1 << 16)
    rep = check.check_absorbed(tab, pos, d, wav, reps=2)
    assert rep["max_rel_err"] <= check.ABSORBED_RTOL
    weight = absorbed_fraction_fn(compiled)
    kernels.reset()
    got = check.surrogate_sgd(lambda lc, p, dd, w: weight({"log_concentration": lc}, p, dd, w),
                              pos, d, wav)
    assert kernels.launches["pvt_absorbed"] == 5 and kernels.launches["pvt_absorbed_grad"] == 5
    ref = check.surrogate_sgd(
        lambda lc, p, dd, w: absorb.weight(torch.exp(lc), absorb.depth(tab, p, dd, w)), pos, d, wav)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-9)


@pytest.mark.gpu
def test_pathwise_step_matches_twin_on_card():
    from pvtrace_tpu_torch.diff.transport import resolve_pathwise_params

    st = _cuda_tensors(mixed_scene)
    specs = resolve_pathwise_params(compile_scene(mixed_scene()), [
        ("n", "plate"), ("size", "plate", 2), ("radius", "rod"), ("length", "rod")])
    lanes, _ = check.check_emit(st, rng.key_words(1), 1 << 16, reps=1)
    rep = check.check_pathwise(st, lanes, specs, steps=8, reps=2)
    assert rep["bound_used"] <= 1.0 and rep["left_out"] <= check.PATH_LEFT_OUT * 8 * (1 << 16)


@pytest.mark.gpu
@pytest.mark.parametrize("make, specs", [
    (lsc_slab, [("n", "lsc"), ("size", "lsc", 2)]),
    (lambda: lsc_slab_recorders(32), [("n", "lsc"), ("size", "lsc", 2)]),
    (mesh_lsc, [("n", "plate")]),
], ids=["slab", "rec32", "mesh"])
def test_pathwise_trace_matches_twin_on_card(make, specs):
    from pvtrace_tpu_torch.diff.transport import resolve_pathwise_params

    st = _cuda_tensors(make)
    resolved = resolve_pathwise_params(compile_scene(make()), specs)
    kernels.reset()
    rep = check.check_trace_scores(st, rng.key_words(2), 1 << 16, lanes=1 << 14,
                                   pathwise=resolved)
    assert kernels.launches["pvt_trace_pathwise"] == 2 and not kernels.launches["pvt_trace_score"]
    assert rep["record_used"] <= 1.0 and rep["sums_used"] <= 1.0


@pytest.mark.gpu
def test_pathwise_thickness_gradient_on_card():
    """d P(absorb) / d L of the index-matched absorber slab at 2**22
    photons on the card, through pvt_trace_pathwise: within 0.005 of
    alpha e^{-alpha L} (the JAX package's bound)."""
    from pvtrace_tpu_torch.diff.transport import fate_gradients
    from pvtrace_tpu_torch.light.event import Event
    from pvtrace_tpu_torch.scenes import pathwise_slab

    _cuda_tensors(lsc_slab)
    kernels.reset()
    tracer.eager_runs = 0
    _, grads = fate_gradients(pathwise_slab(False), 1 << 22, seed=3, wrt="pathwise",
                              pathwise=[("size", "slab", 2)])
    assert kernels.launches["pvt_trace_pathwise"] == 1 and tracer.eager_runs == 0
    assert abs(grads[Event.NONRADIATIVE][0] - 0.8 * np.exp(-0.8)) < 0.005


def _host_bundle_on_card(n, n_rec=4, np_seed=2):
    """float32 tensors of ``lsc_slab_host(n_rec=n_rec)`` and a host bundle
    of n photons, both on the card."""
    from pvtrace_tpu_torch.engine.emit import emit_bundle
    from pvtrace_tpu_torch.scenes import lsc_slab_host

    scene = lsc_slab_host(n_rec=n_rec)
    st = _cuda_tensors(lambda: scene)
    np.random.seed(np_seed)
    rows = tracer.bundle_rows(*emit_bundle(scene, n)[:3], np.float32)
    return st, torch.from_numpy(rows).cuda()


@pytest.mark.gpu
def test_bundle_trace_matches_twin_on_card():
    """pvt_trace in bundle mode against the twin fed the same host
    bundle (phase 24 small): fates and recorders (the check's two
    launches, the second timed, both in bundle mode), then with the log and
    with score channels."""
    st, bundle = _host_bundle_on_card(1 << 16)
    kernels.reset()
    rep = check.check_trace(st, rng.key_words(2), 1 << 16, lanes=1 << 14, bundle=bundle)
    assert sum(rep["fates"]) == 1 << 16 and kernels.launches["pvt_trace_bundle"] == 2
    rep = check.check_log(st, rng.key_words(2), 1 << 12, bundle=bundle[:, :1 << 12].contiguous())
    assert rep["diverged"] <= check.LOG_DIVERGED * rep["slots"]
    rep = check.check_trace_scores(st, rng.key_words(2), 1 << 16, lanes=1 << 14, bundle=bundle)
    assert rep["record_used"] <= 1.0 and rep["sums_used"] <= 1.0


@pytest.mark.gpu
def test_emitted_photons_as_a_bundle_are_bit_equal_on_card(cuda_scene):
    """pvt_emit's photons fed back as a bundle: the same fates as the
    device-emitted pvt_trace of the same seed and ids."""
    seed, n = rng.key_words(4), 1 << 16
    state = kernels.emit(cuda_scene, seed, 100, n)
    bundle = torch.stack([state[k] for k in tracer.BUNDLE_ROWS])
    emitted, _, _, _ = kernels.trace(cuda_scene, seed, n, index_offset=100)
    fed, _, _, _ = kernels.trace(cuda_scene, seed, n, index_offset=100, bundle=bundle)
    assert torch.equal(emitted, fed)


@pytest.mark.gpu
def test_device_emission_and_bad_bundles_refused_on_card():
    st, bundle = _host_bundle_on_card(64, n_rec=0)
    seed = rng.key_words(1)
    with pytest.raises(ValueError, match="host emission"):
        kernels.emit(st, seed, 0, 64)
    with pytest.raises(ValueError, match="host emission"):
        kernels.trace(st, seed, 64)
    for bad in (bundle.double(), bundle.cpu(), bundle[:, ::2], bundle.t().contiguous().t()):
        with pytest.raises(ValueError, match="bundle"):
            kernels.trace(st, seed, bad.shape[1], bundle=bad)


@pytest.mark.gpu
def test_host_emission_path_on_card_goes_through_the_kernel():
    from pvtrace_tpu_torch.scenes import lsc_slab_host

    _cuda_tensors(lsc_slab)
    kernels.reset()
    tracer.eager_runs = 0
    result = simulate(lsc_slab_host(), 1 << 16, seed=3, record_every=0)
    assert int(np.asarray(result.data["fates"]).sum()) == 1 << 16
    assert kernels.launches["pvt_trace"] == 1 and kernels.launches["pvt_trace_bundle"] == 1
    assert tracer.eager_runs == 0
