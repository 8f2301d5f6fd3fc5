"""The float64 main path's trace kernel (``tracer_f64``'s
``trace_kernel<0,0,0,0,0,0,0>``, and the bundle's, which runs the same
step) through the g++ ``-DPVT_F64`` host build of its device code.

Its step and start (``tracer.cuh::main_step``) hold their uniforms as
floats, widened where each is read, and take an angle's sine and cosine
from one ``sincos``. Each is held here to what it replaces, bit for bit:
the main path's start (``emit_one<true>``) to ``emit_lane``'s, its step
(uniforms held as floats and as doubles alike) to ``step_lane``'s on the
slab, the mixed scene and the random scenes without meshes, and
``pvt_sincos`` to ``pvt_sin`` and ``pvt_cos`` at every angle a trace
takes. Then pvt_trace's loop (``trace_warps``, emulated warps) on the
slab and random scenes 0-19 against the float64 eager twin (fates, the
longest photon) and, on the slab and the three smallest random scenes,
against the JAX package's float64 ``simulate`` at the defaults.
"""
import ctypes
import types

import numpy as np
import pytest

from _random_cases import CPU_SEEDS, ULP_PHOTONS
from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, physics, rng, tables, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import check, crafted, host  # noqa: E402
from pvtrace_tpu_torch.scenes import (lsc_slab, lsc_slab_recorders, mesh_lsc,  # noqa: E402
                                      mixed_scene, random_scene)

cap_threads()
F64 = torch.float64
SLAB_OPTIONS = {"maxsteps": 1000, "emit_method": "kT", "maxpathlength": None}
# The slab, the mixed scene (two lamps, a Lambertian facet, lifetimes)
# and the CPU's random scenes without meshes, whose trace takes the main
# path's step.
MAIN_SCENES = ["slab", "mixed"] + [f"random-{s}" for s in CPU_SEEDS if not any(
    g in random_scene(s).features["geometries"] for g in ("tetrahedron", "cube"))]
N = 1 << 12


@pytest.fixture(scope="module")
def h(tmp_path_factory):
    """tracer.cuh built for the host in float64 (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"), f64=True)


def _built(name):
    if name.startswith("random-"):
        return random_scene(int(name.split("-")[1]))
    make = {"slab": lsc_slab, "mixed": mixed_scene}[name]
    return types.SimpleNamespace(scene=make(), options=dict(SLAB_OPTIONS))


def _tensors(built):
    return tables.scene_tensors(compile_scene(built.scene), dtype=F64)


def _sc(st, built):
    o = crafted.options(built)
    return ctypes.byref(kernels._scene(st, o["maxsteps"], o["emit_method"], o["maxpathlength"]))


def _state(s):
    return ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS))


def _bits(x):
    """A float64 tensor's bits, so NaNs compare too."""
    return x.contiguous().view(torch.int64)


# The kernels with the event log or from a host bundle take the main
# path's start and step too (main_step): each case the scene and the
# recorder, log and mesh flags of the instantiation that the slab, the
# slab with 4 recorders (and the host-lit slab's bundle) and the mesh LSC
# launch with the log or from a bundle.
ELEVEN = {
    "slab-log": (lsc_slab, (0, 1, 0)),
    "R4-log": (lambda: lsc_slab_recorders(4), (1, 1, 0)),
    "R4-bundle": (lambda: lsc_slab_recorders(4), (1, 0, 0)),
    "mesh_lsc-log": (mesh_lsc, (1, 1, 1)),
    "mesh_lsc-bundle": (mesh_lsc, (1, 0, 1)),
    "mesh_lsc-log-no-recorders": (mesh_lsc, (0, 1, 1)),
    "mesh_lsc-bundle-no-recorders": (mesh_lsc, (0, 0, 1)),
}


@pytest.mark.parametrize("name", MAIN_SCENES + list(ELEVEN))
def test_main_start_and_step_equal_the_lanes(h, name):
    """The main path's start (``emit_one<true>``: float uniforms, sincos)
    bit-equal to ``emit_lane``'s on 4,096 photons; then six steps of the
    main path's step (``step_one`` without recorders, log or meshes, or
    with those of a kernel with the event log or from a host bundle, as
    ``ELEVEN`` gives them: sincos), its uniforms held as floats and as
    doubles, each bit-equal to ``step_lane``'s in every photon field and in
    its hit, container and fate flags."""
    if name in ELEVEN:
        make, (tally, log, mesh) = ELEVEN[name]
        built = types.SimpleNamespace(scene=make(), options=dict(SLAB_OPTIONS))
    else:
        built, (tally, log, mesh) = _built(name), (0, 0, 0)
    st = _tensors(built)
    assert bool(st["meta"]["n_tris"]) == bool(mesh)
    kind = tally | log << 1 | mesh << 2
    sc, words, B = _sc(st, built), rng.key_words(3), 1 << 12
    ref, got = kernels._empty_state(B, "cpu", F64), kernels._empty_state(B, "cpu", F64)
    h.h_emit(sc, words[0], words[1], 0, B, _state(ref))
    h.h_emit_main(sc, words[0], words[1], 0, B, _state(got))
    for k, v in ref.items():
        assert torch.equal(_bits(got[k]) if v.is_floating_point() else got[k], _bits(v)
                           if v.is_floating_point() else v), k
    s = ref
    for step in range(6):
        out = {}
        for entry, args in (("lane", ()), ("float", (1, kind)), ("double", (0, kind))):
            nxt, flags = kernels._empty_state(B, "cpu", F64), kernels._empty_flags(B, "cpu", F64)
            fl = ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS))
            fn = h.h_step if entry == "lane" else h.h_step_main
            fn(sc, _state(s), _state(nxt), fl, B, *args)
            out[entry] = (nxt, flags)
        lane = out["lane"]
        for entry in ("float", "double"):
            nxt, flags = out[entry]
            for k, v in lane[0].items():
                a, b = nxt[k], v
                if v.is_floating_point():
                    a, b = _bits(a), _bits(b)
                assert torch.equal(a, b), (step, entry, k)
            for k in ("hit", "container", "exit_mask", "losing", "reacting", "kills",
                      "no_hit_term"):
                assert torch.equal(flags[k], lane[1][k]), (step, entry, k)
        s = lane[0]
    assert int(s["alive"].sum()) < B


def _trace(h, built, st, seed, warps):
    """The host trace of photons [0, N) of `built` at `seed`, on `warps`
    emulated warps (``trace_warps``) or, with 0, one photon at a time
    (``trace_photon``): (fates, (steps in all, lane-steps, longest))."""
    R = max(st["meta"]["n_rec"], 1)
    bufs = [torch.zeros(R, dtype=torch.int64), torch.zeros(8 * R, dtype=F64),
            torch.zeros(R, dtype=torch.int32),
            torch.zeros(max(st["meta"]["total_bins"], 1), dtype=torch.int64),
            torch.zeros(8 * R, dtype=F64)]
    _, no_log = kernels.empty_log(N, 0, 8, 0, "cpu", dtype=F64)
    words, out = rng.key_words(seed), torch.zeros(3, dtype=torch.int64)
    fates = torch.zeros(physics.N_FATES, dtype=torch.int64)
    h.h_trace_warp(_sc(st, built), words[0], words[1], 0, N, warps, ctypes.byref(no_log),
                   fates.data_ptr(), *(b.data_ptr() for b in bufs), None, 0, 0, None, None,
                   None, None, None, 0, None, out.data_ptr(), None)
    return fates, tuple(int(v) for v in out)


@pytest.mark.parametrize("name", ["slab"] + [f"random-{s}" for s in CPU_SEEDS])
def test_main_trace_matches_twin(h, name):
    """pvt_trace's loop on four emulated warps (``trace_warps``; the main
    path's instantiation on a scene without recorders or meshes) against
    the float64 eager twin on 4,096 photons: every fate within
    ULP_PHOTONS and the longest photon's steps equal; and the same photons
    one at a time (``trace_photon``) equal to it in fates, steps in all and
    the longest photon."""
    built = _built(name)
    st = _tensors(built)
    fates, (steps, _, longest) = _trace(h, built, st, 11, 4)
    one, (steps1, _, longest1) = _trace(h, built, st, 11, 0)
    ref, ref_longest, _, _ = tracer.trace_eager(st, rng.key_words(11), N,
                                                **crafted.options(built))
    assert int(fates.sum()) == N and torch.equal(fates, one), (fates, one)
    assert (steps, longest) == (steps1, longest1)
    assert int((fates - ref).abs().max()) <= ULP_PHOTONS, (fates.tolist(), ref.tolist())
    assert longest == ref_longest, (longest, ref_longest)


@pytest.fixture(scope="module", params=["slab"] + [
    f"random-{s}" for s in sorted(CPU_SEEDS, key=lambda s: (random_scene(s).features["nodes"],
                                                              s))[:3]])
def jax_f64_fates(request):
    """(name, the JAX package's float64 fates at the defaults, K5a where
    its compiler fits the spectra) of photons [0, N) at seed 5."""
    name = request.param
    if name == "slab":
        scene, options = lsc_slab(pvtrace_tpu), dict(SLAB_OPTIONS)
    else:
        built = random_scene(int(name.split("-")[1]), pvtrace_tpu)
        scene, options = built.scene, built.options
    result = jax_engine.simulate(scene, N, seed=5, record_every=0, dtype=np.float64, **options)
    return name, np.asarray(result.data["fates"], dtype=np.int64)


def test_main_trace_matches_jax(h, jax_f64_fates):
    """The host build's trace (``trace_photon`` a photon, the main path's
    instantiation) of photons [0, N) against the JAX package's float64
    ``simulate`` of the same seed at the defaults: the same photons take the
    same streams, so each fate count agrees within ULP_PHOTONS."""
    name, ref = jax_f64_fates
    built = _built(name)
    st = _tensors(built)
    fates, _ = _trace(h, built, st, 5, 0)
    got = fates.numpy()
    assert got.sum() == N and ref.sum() == N
    assert np.abs(got - ref).max() <= ULP_PHOTONS, (name, got.tolist(), ref.tolist())


@pytest.mark.parametrize("wide", [0, 1], ids=["2piu", "wide"])
def test_sincos_equals_sin_and_cos(h, wide):
    """The host build's ``pvt_sincos`` bit-equal to ``pvt_sin`` and
    ``pvt_cos`` at every angle 2 pi u a trace takes (2**23, u a float32
    uniform) and at 2**24 angles over [-1e6, 1e6], the angles that
    ``python -m pvtrace_tpu_torch.kernels.variants --sincos`` checks on
    the card."""
    n = 1 << 24 if wide else 1 << 23
    assert h.h_sincos_differ(n, wide) == 0
