"""K13: the port's pathwise channels against the JAX package.

Both packages trace the same photons from the same seed, on the CPU, in
float64, at their defaults (Chebyshev spectra), with lane regeneration,
each from the scene built from its own classes, with the same resolved
pathwise specs: the fates are equal and the pathwise columns of
``fate_scores`` agree to 1e-9 of each channel's sum of |score| (the
port's ``fate_abs``). The tie helpers of ``engine/ties.py`` are held to
``jax.jvp`` at the bounds; the device code of ``tracer.cuh``
(``pathwise_lane``, ``trace_photon`` with pathwise channels, built for
the host) to the eager twin; the twin to its own refill contract and to
the analytic gradients of the absorber slabs.
"""
import ctypes

import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.diff.transport import resolve_pathwise_params as jax_resolve  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu.engine.compiler import compile_scene as jax_compile  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.diff.transport import fate_gradients, resolve_pathwise_params  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, pathwise, rng, score, tables, ties  # noqa: E402
from pvtrace_tpu_torch.engine import simulate, tracer  # noqa: E402
from pvtrace_tpu_torch.kernels import check, host  # noqa: E402
from pvtrace_tpu_torch.light.event import Event  # noqa: E402
from pvtrace_tpu_torch.scenes import (  # noqa: E402
    lsc_slab_recorders,
    mixed_scene,
    pathwise_slab,
    tilted_fresnel_slab,
)

cap_threads()
N, LANES = 2 ** 12, 2 ** 10
SCORE_RTOL = 1e-9
SCENES = {
    "tilted": (tilted_fresnel_slab, [("n", "slab")]),
    "fresnel-slab": (lambda ns=None: pathwise_slab(True, ns=ns), [("size", "slab", 2)]),
}
# The JAX package cannot take two geometry channels of one node (its
# ``core_t`` turns the node's parameters into a list at the first), so the
# mixed scene's rod is held to it by its radius and its index; its length
# channel is held to the twin by the device-code tests below and on the
# card. Its JAX compile with pathwise channels takes about 130 s on a CPU:
# that test is ``slow``.
MIXED_JAX_SPECS = [("n", "plate"), ("size", "plate", 2), ("radius", "rod"), ("n", "rod")]
MIXED_SPECS = [("n", "plate"), ("size", "plate", 2), ("radius", "rod"), ("length", "rod")]


def _simulate_with_tallies(monkeypatch, make, n, **kwargs):
    """The port's ``simulate(score=True)`` of `make()` on the CPU, and the
    trace's tallies (with the score magnitudes' sums)."""
    seen = {}
    trace = tracer.trace

    def spy(*args, **kw):
        out = trace(*args, **kw)
        seen["tallies"] = out[2]
        return out

    monkeypatch.setattr(tracer, "trace", spy)
    result = simulate(make(), n, score=True, device="cpu", **kwargs)
    monkeypatch.setattr(tracer, "trace", trace)
    return result, seen["tallies"]


def _float64_run(mp, make, specs):
    """(JAX data, port data, port tallies) of `make` with pathwise `specs`
    in float64, seed 5."""
    mp.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
    mp.setattr(jax_api, "_TRACER_CACHE", {})
    jax_scene = make(ns=pvtrace_tpu)
    jax_specs = jax_resolve(jax_compile(jax_scene), specs)
    specs_ = resolve_pathwise_params(compile_scene(make()), specs)
    assert specs_ == jax_specs
    kwargs = dict(seed=5, record_every=0, dtype=np.float64, lanes=LANES)
    ref = jax_engine.simulate(jax_scene, N, score=True, pathwise=jax_specs, **kwargs).data
    got, tallies = _simulate_with_tallies(mp, make, N, pathwise=specs_, **kwargs)
    return ref, got.data, tallies


@pytest.fixture(scope="module")
def float64_runs():
    """{scene: (JAX data, port data, port tallies)}: one JAX compile each."""
    with pytest.MonkeyPatch.context() as mp:
        return {name: _float64_run(mp, make, specs) for name, (make, specs) in SCENES.items()}


def _assert_pathwise_match(ref, got, tallies, C):
    np.testing.assert_array_equal(got["fates"], np.asarray(ref["fates"]))
    r, g = np.asarray(ref["fate_scores"]), got["fate_scores"]
    assert g.shape == r.shape and g.dtype == np.float64
    S = tallies["fate_abs"].numpy().sum(0)
    assert (np.abs(g - r) <= SCORE_RTOL * S).all(), np.abs(g - r).max(0)
    assert (np.abs(g[:, -C:]).sum(0) > 0).all()


@pytest.mark.parametrize("scene", list(SCENES))
def test_pathwise_float64_matches_jax(float64_runs, scene):
    _assert_pathwise_match(*float64_runs[scene], len(SCENES[scene][1]))


@pytest.mark.slow
def test_pathwise_float64_matches_jax_on_mixed_scene(monkeypatch):
    """The mixed scene (dye re-emission, K5a, HG, facet overrides, the
    cylinder's barrel and caps) with the plate's index and thickness and
    the rod's radius and index."""
    _assert_pathwise_match(*_float64_run(monkeypatch, mixed_scene, MIXED_JAX_SPECS),
                           len(MIXED_JAX_SPECS))


def test_pathwise_channel_layout(float64_runs):
    """``simulate(pathwise=...)`` appends one channel per spec after the
    components and nodes; ``fate_gradients`` slices them with
    wrt="pathwise", and "all" ends with them."""
    compiled = compile_scene(pathwise_slab(True))
    _, got, _ = float64_runs["fresnel-slab"]
    CH = compiled.n_components + len(compiled.nodes) + 1
    assert got["fate_scores"].shape == (11, CH)
    kwargs = dict(seed=2, pathwise=[("size", "slab", 2)], device="cpu", compiled=compiled)
    _, g_all = fate_gradients(pathwise_slab(True), 500, wrt="all", **kwargs)
    _, g_pw = fate_gradients(pathwise_slab(True), 500, wrt="pathwise", **kwargs)
    assert g_all[Event.EXIT].shape == (CH,) and g_pw[Event.EXIT].shape == (1,)
    assert g_pw[Event.EXIT][0] == g_all[Event.EXIT][-1] != 0.0
    assert pathwise.OUTPUTS[-3:] == ("t0", "alpha", "refl_r")


def _jax_jvp(fn, x):
    return float(jax.jvp(fn, (jnp.float64(x),), (jnp.float64(1.0),))[1])


def _torch_jvp(fn, x):
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        d = fwAD.make_dual(torch.tensor(x, dtype=torch.float64),
                           torch.tensor(1.0, dtype=torch.float64))
        y = fwAD.unpack_dual(fn(d))
        return float(y.primal), float(y.tangent)


@pytest.mark.parametrize("jax_fn, torch_fn, x", [
    (lambda v: jnp.clip(v, 0.0, 1.0), lambda v: ties.clip(v, 0.0, 1.0), 0.0),
    (lambda v: jnp.clip(v, 0.0, 1.0), lambda v: ties.clip(v, 0.0, 1.0), 1.0),
    (lambda v: jnp.clip(v, -1.0, 1.0), lambda v: ties.clip(v, -1.0, 1.0), -1.0),
    (lambda v: jnp.clip(v, 0.0, None), lambda v: ties.clip(v, 0.0), 0.0),
    (lambda v: jnp.clip(v, 0.0, 1.0), lambda v: ties.clip(v, 0.0, 1.0), 1.5),
    (jnp.abs, ties.abs_, 0.0),
    (jnp.abs, ties.abs_, -0.0),
    (lambda v: jnp.maximum(v, 0.0), lambda v: ties.maximum(v, torch.zeros_like(v)), 0.0),
    (lambda v: jnp.minimum(v, 2.0), lambda v: ties.minimum(v, torch.full_like(v, 2.0)), 2.0),
    # normal incidence: the step's c_in = clip(|ddot|, 0, 1) at ddot = -1
    (lambda v: jnp.clip(jnp.abs(v), 0.0, 1.0),
     lambda v: ties.clip(ties.abs_(v), 0.0, 1.0), -1.0),
], ids=["clip-0", "clip-1", "clip-minus-1", "clip-lower-only", "clip-outside", "abs-0",
        "abs-minus-0", "maximum-tie", "minimum-tie", "normal-incidence-c_in"])
def test_tie_helpers_match_jax_jvp(jax_fn, torch_fn, x):
    value, slope = _torch_jvp(torch_fn, x)
    assert value == float(jax_fn(jnp.float64(x)))
    assert slope == _jax_jvp(jax_fn, x)


def test_tie_minimum_keeps_the_slope_of_the_smaller():
    """``torch.minimum``'s forward-mode tangent cancels to 0 when the other
    operand's slope is huge (a box slab test nearly parallel to an axis);
    ``ties.minimum`` keeps the smaller operand's slope."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        a = fwAD.make_dual(torch.tensor([0.5], dtype=torch.float64),
                           torch.tensor([0.1], dtype=torch.float64))
        b = fwAD.make_dual(torch.tensor([5e16], dtype=torch.float64),
                           torch.tensor([3e33], dtype=torch.float64))
        assert float(fwAD.unpack_dual(ties.minimum(a, b)).tangent) == 0.1
        assert float(fwAD.unpack_dual(ties.maximum(b, a)).tangent) == 3e33


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh built for the host (skips without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


def _f32(make, specs):
    compiled = compile_scene(make())
    return (tables.scene_tensors(compiled, dtype=torch.float32),
            resolve_pathwise_params(compiled, specs))


def test_pathwise_lane_device_code_matches_twin(host_lib):
    """``pathwise_lane`` (pvt_pathwise's body) against the twin for 8 steps
    from the same lanes and tangents, on the mixed scene with four
    channels (the plate's index and thickness, the rod's radius and
    length): the steps equal; every output of each channel's map, its
    contribution and new tangents within 1e-5 of the twin's scale
    (``check.PATH_GROUPS``)."""
    st, specs = _f32(mixed_scene, MIXED_SPECS)
    B, C = 1 << 12, len(specs)
    sc = kernels._scene(st, 1000, 0, float("inf"))
    s = tracer.initial_state(st, rng.key_words(5), torch.arange(B))
    tang = torch.zeros((C, 7, B))
    table = tables.pathwise_table(specs)
    for _ in range(8):
        out, jv, ds, tout = kernels.pathwise_step(st, s, tang, specs)
        got, flags = kernels._empty_state(B, "cpu"), kernels._empty_flags(B, "cpu")
        comp = torch.empty(B, dtype=torch.int32)
        g_jv, g_ds, g_tout = torch.empty((C, tables.PATH_J, B)), torch.empty((C, B)), \
            torch.empty((C, 7, B))
        desc = kernels._Path(table.data_ptr(), C, tang.data_ptr(), g_tout.data_ptr(),
                             g_jv.data_ptr(), g_ds.data_ptr())
        host_lib.h_pathwise(
            ctypes.byref(sc), ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._State, got, kernels._STATE_PTRS)),
            ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B,
            ctypes.byref(desc), comp.data_ptr(),
        )
        got.update(flags, comp_id=comp)
        for name in check.DISCRETE + ("comp_id",):
            assert torch.equal(got[name].long(), out[name].long()), name
        ref = torch.cat([jv, ds[:, None], tout], 1).double()
        val = torch.cat([g_jv, g_ds[:, None], g_tout], 1).double()
        scale = ref.abs().amax(2, keepdim=True)
        for group in check.PATH_GROUPS:
            scale[:, group] = scale[:, group].amax(1, keepdim=True)
        assert float(((val - ref).abs() / scale.clamp(min=1e-30)).max()) <= 1e-5
        s, tang = {k: out[k] for k in s}, tout.contiguous()
    assert tang.abs().sum() > 0


@pytest.mark.parametrize("make, specs", [
    (mixed_scene, MIXED_SPECS),
    (lambda: lsc_slab_recorders(4), [("n", "lsc"), ("size", "lsc", 2)]),
    (tilted_fresnel_slab, [("n", "slab")]),
], ids=["mixed", "recorders", "tilted"])
def test_trace_photon_with_pathwise_matches_twin(host_lib, make, specs):
    """``trace_photon`` with pathwise channels (pvt_trace_pathwise's body)
    against the eager twin, 4096 photons: fates equal, each photon's
    record (K12 and pathwise channels) against the twin's by
    ``check.compare_score_records`` with at most 2 photons parted; with
    recorders, their rays equal."""
    st, resolved = _f32(make, specs)
    seed, n, C = rng.key_words(5), 4096, len(resolved)
    CH, R = score.n_channels(st, C), max(st["meta"]["n_rec"], 1)
    _, desc = kernels.empty_log(n, 0, 6, 0, "cpu")
    fates = torch.zeros(11, dtype=torch.int64)
    cross = torch.zeros(R, dtype=torch.int64)
    bins = torch.zeros(max(st["meta"]["total_bins"], 1), dtype=torch.int64)
    distinct, sums = torch.zeros(R, dtype=torch.int32), torch.zeros(8 * R)
    sums64 = torch.zeros(8 * R, dtype=torch.float64)
    row, tang = torch.zeros(CH), torch.zeros(7 * C)
    fate_scores = torch.zeros((2, 11, CH), dtype=torch.float64)
    rec_scores = torch.zeros((2, R, CH), dtype=torch.float64)
    photon = torch.zeros((CH + 2, n))
    photon[CH] = -1.0
    table = tables.pathwise_table(resolved)
    host_lib.h_trace_score(
        ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))), seed[0], seed[1], 0, n,
        ctypes.byref(desc), fates.data_ptr(), cross.data_ptr(), sums.data_ptr(),
        distinct.data_ptr(), bins.data_ptr(), sums64.data_ptr(), row.data_ptr(), CH,
        st["meta"]["n_comps"], fate_scores.data_ptr(), rec_scores.data_ptr(), photon.data_ptr(),
        tang.data_ptr(), table.data_ptr(), C,
    )
    ref, _, t, _ = tracer.trace_eager(st, seed, n, score=True, per_photon=True,
                                      pathwise=resolved)
    assert torch.equal(fates, ref)
    if st["meta"]["n_rec"]:
        assert torch.equal(distinct.long(), t["distinct"])
    got = {"fate_scores": fate_scores[0], "fate_abs": fate_scores[1],
           "rec_scores": rec_scores[0], "rec_abs": rec_scores[1],
           "photon_scores": photon[:CH], "photon_fate": photon[CH].long(),
           "photon_steps": photon[CH + 1].long()}
    rep = check.compare_score_records(got, t, fates, n, 2)
    assert rep["record_used"] <= 1.0 and rep["saturated"] == 0
    assert float(photon[CH - C:].abs().sum()) > 0


def test_fate_gradients_pathwise_survive_regeneration():
    """The twin's pathwise channels are pure functions of (seed, photon
    id): refilling 256 lanes gives the gradients of one lane per photon
    (the JAX package's ``test_pathwise_gradients_survive_regeneration_and
    _streaming``), and bundles of 1000 photons the same."""
    kw = dict(wrt="pathwise", pathwise=[("n", "slab")], dtype=np.float64, seed=9,
              device="cpu")
    f_full, g_full = fate_gradients(tilted_fresnel_slab(), N, bundle=None, lanes=None, **kw)
    f_regen, g_regen = fate_gradients(tilted_fresnel_slab(), N, bundle=None, lanes=256, **kw)
    f_stream, g_stream = fate_gradients(tilted_fresnel_slab(), N, bundle=1000, lanes=256, **kw)
    for event in (Event.EXIT, Event.NONRADIATIVE):
        assert f_full[event] == f_regen[event] == f_stream[event]
        np.testing.assert_allclose(g_regen[event], g_full[event], rtol=0, atol=1e-12)
        np.testing.assert_allclose(g_stream[event], g_full[event], rtol=0, atol=1e-12)
    assert g_full[Event.NONRADIATIVE][0] != 0.0


def _gradient_and_error(make, specs, n, seed):
    """d P(NONRADIATIVE) / d theta from the twin's per-photon records
    (centred as ``fate_gradients`` does) and its standard error."""
    compiled = compile_scene(make())
    st = tables.scene_tensors(compiled, dtype=torch.float64)
    resolved = resolve_pathwise_params(compiled, specs)
    _, _, t, _ = tracer.trace_eager(st, rng.key_words(seed), n, lanes=1 << 13, score=True,
                                    per_photon=True, pathwise=resolved)
    s = t["photon_scores"][-1].numpy()
    hit = (t["photon_fate"].numpy() == Event.NONRADIATIVE.value).astype(float)
    x = (hit - hit.mean()) * s
    return x.mean(), x.std() / np.sqrt(n)


@pytest.mark.parametrize("fresnel", [False, True], ids=["index-matched", "fresnel"])
def test_pathwise_thickness_gradient_matches_analytic(fresnel):
    """d P(absorb) / d L of the absorber slab (alpha 0.8, L 1) on the twin,
    2**15 photons: within 5 standard errors of alpha e^{-alpha L} behind a
    null surface, and of the geometric series in R = 0.04 with Fresnel
    surfaces (the JAX package's analytic values)."""
    alpha, T = 0.8, np.exp(-0.8)
    R = 0.04
    expect = -((1 - R) ** 2) / (1 - R * T) ** 2 * (-alpha * T) if fresnel else alpha * T
    got, err = _gradient_and_error(lambda: pathwise_slab(fresnel), [("size", "slab", 2)],
                                   1 << 15, 3)
    assert 0 < err < 0.01
    assert abs(got - expect) < 5 * err, (got, expect, err)


def _oblique_analytic(n, theta0, alpha, L):
    s, c1 = np.sin(theta0), np.cos(theta0)

    def P(n):
        st = s / n
        ct = np.sqrt(1 - st * st)
        rs = ((c1 - n * ct) / (c1 + n * ct)) ** 2
        rp = ((ct - n * c1) / (ct + n * c1)) ** 2
        R = 0.5 * (rs + rp)
        T = np.exp(-alpha * L / ct)
        return (1 - R) * (1 - T) / (1 - R * T)

    h = 1e-6
    return P(n), (P(n + h) - P(n - h)) / (2 * h)


@pytest.mark.slow
def test_pathwise_n_gradient_oblique_incidence():
    """The port's pathwise channel recovers the full d(fate)/dn at 30
    degrees incidence on the twin, 1e5 photons, with the JAX package's
    bounds (``tests/test_diff.py::test_pathwise_n_gradient_oblique
    _incidence``)."""
    p_true, dp_true = _oblique_analytic(1.5, np.radians(30.0), 0.5, 1.0)
    n = 100_000
    fr, gr = fate_gradients(tilted_fresnel_slab(), n, seed=3, wrt="pathwise",
                            pathwise=[("n", "slab")], dtype=np.float64, device="cpu")
    assert abs(fr[Event.NONRADIATIVE] - p_true) < 5 * np.sqrt(p_true * (1 - p_true) / n)
    assert abs(gr[Event.NONRADIATIVE][0] - dp_true) < 0.006
    assert abs(gr[Event.EXIT][0] + dp_true) < 0.008


def _host_records(host_lib, st, resolved, n=1024, stride=1, seed=5, sums=False):
    fates, rec, fate_scores = host.trace_score_records(host_lib, st, rng.key_words(seed), n,
                                                       resolved, stride)
    return (fates, rec, fate_scores) if sums else (fates, rec)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("make, specs", [
    (mixed_scene, MIXED_SPECS),
    (lambda: lsc_slab_recorders(4), [("n", "lsc"), ("size", "lsc", 2)]),
], ids=["mixed", "recorders"])
def test_pathwise_channel_record_does_not_depend_on_the_others(host_lib, make, specs):
    """A step's tangent map carries nothing from one channel to the next
    (the photon's wavelength-tangent flag is set by every channel alike):
    each channel's per-photon record is bit-equal run alone, beside the
    others, and with them in reverse order; so are the score channels,
    fates and steps."""
    st, resolved = _f32(make, specs)
    C = len(resolved)
    first = score.n_channels(st, 0)
    fates, rec = _host_records(host_lib, st, resolved)
    rev_fates, rev = _host_records(host_lib, st, resolved[::-1])
    assert torch.equal(fates, rev_fates)
    assert torch.equal(_bits(rec[:first]), _bits(rev[:first]))
    assert torch.equal(_bits(rec[-2:]), _bits(rev[-2:]))
    for i, spec in enumerate(resolved):
        alone_fates, alone = _host_records(host_lib, st, [spec])
        assert torch.equal(fates, alone_fates)
        assert torch.equal(_bits(rec[first + i]), _bits(alone[first])), spec
        assert torch.equal(_bits(rec[first + i]), _bits(rev[first + C - 1 - i])), spec
        assert torch.equal(_bits(rec[:first]), _bits(alone[:first]))
    assert float(rec[first:first + C].abs().sum()) > 0


@pytest.mark.parametrize("make, specs", [
    (mixed_scene, MIXED_SPECS),
    (lambda: lsc_slab_recorders(4), [("n", "lsc"), ("size", "lsc", 2)]),
    (tilted_fresnel_slab, [("n", "slab")]),
], ids=["mixed", "recorders", "tilted"])
def test_pathwise_records_equal_at_any_row_stride(host_lib, make, specs):
    """A thread's rows at stride 1 and at the block's stride (kBlock, the
    rows in shared memory) give the same records and folds bit for bit:
    only the addresses differ."""
    st, resolved = _f32(make, specs)
    fates, rec, sums = _host_records(host_lib, st, resolved, sums=True)
    block_fates, block, block_sums = _host_records(host_lib, st, resolved, stride=kernels.BLOCK,
                                                   sums=True)
    assert torch.equal(fates, block_fates) and torch.equal(_bits(rec), _bits(block))
    assert torch.equal(sums, block_sums) and float(sums[1, :, -len(resolved):].sum()) > 0


# Lanes built to tie, in pathwise_slab's 2x2x1 cm box at the origin (the
# world around it): through the vertical edge at x = y = -1 from outside
# (the slab test's entry bound ties between x and y) and from inside
# towards x = y = 1 (its exit bound ties), through the corner (-1, -1,
# -0.5) (a three-way tie), and straight down onto the top face (c_in = 1,
# 1 - c^2 = 0: the clips' bounds).
TIE_RAYS = [
    ((-2.0, -2.0, 0.0), (1.0, 1.0, 0.0)),
    ((0.0, 0.0, 0.0), (1.0, 1.0, 0.0)),
    ((-2.0, -2.0, -1.5), (1.0, 1.0, 1.0)),
    ((0.3, 0.2, 3.0), (0.0, 0.0, -1.0)),
]


def test_step_tangent_at_ties_matches_twin(host_lib):
    """``pathwise_lane``'s map (``step_tangent``, each channel's tangents) on
    lanes at ties of the box's slab test and at the clips' bounds, against
    the twin's (``engine/pathwise.py`` with ``engine/ties.py``): the steps
    equal, every map output within 1e-5 of its scale; 16 lanes a ray (their
    own uniforms: reflections, transmissions and absorptions), the same
    random tangents into every channel."""
    st, specs = _f32(lambda: pathwise_slab(True),
                     [("size", "slab", 0), ("size", "slab", 1), ("size", "slab", 2),
                      ("n", "slab")])
    per, C = 16, len(specs)
    B = per * len(TIE_RAYS)
    s = tracer.initial_state(st, rng.key_words(7), torch.arange(B))
    for r, (o, d) in enumerate(TIE_RAYS):
        lanes = slice(r * per, (r + 1) * per)
        d = torch.tensor(d, dtype=torch.float32)
        d = d / torch.linalg.vector_norm(d)
        for k, name in enumerate(("px", "py", "pz")):
            s[name][lanes] = o[k]
        for k, name in enumerate(("dx", "dy", "dz")):
            s[name][lanes] = d[k]
    tin = np.random.default_rng(8).normal(size=(1, 7, B)).astype(np.float32)
    tang = torch.from_numpy(np.repeat(tin, C, axis=0))
    tang[:, 6] = 0.0
    out, jv, ds, tout = kernels.pathwise_step(st, s, tang, specs)
    got, flags = kernels._empty_state(B, "cpu"), kernels._empty_flags(B, "cpu")
    comp = torch.empty(B, dtype=torch.int32)
    g_jv, g_ds, g_tout = torch.empty((C, tables.PATH_J, B)), torch.empty((C, B)), \
        torch.empty((C, 7, B))
    table = tables.pathwise_table(specs)
    desc = kernels._Path(table.data_ptr(), C, tang.data_ptr(), g_tout.data_ptr(),
                         g_jv.data_ptr(), g_ds.data_ptr())
    host_lib.h_pathwise(
        ctypes.byref(kernels._scene(st, 1000, 0, float("inf"))),
        ctypes.byref(kernels._struct(kernels._State, s, kernels._STATE_PTRS)),
        ctypes.byref(kernels._struct(kernels._State, got, kernels._STATE_PTRS)),
        ctypes.byref(kernels._struct(kernels._Flags, flags, kernels._FLAG_PTRS)), B,
        ctypes.byref(desc), comp.data_ptr(),
    )
    got.update(flags, comp_id=comp)
    for name in check.DISCRETE + ("comp_id",):
        assert torch.equal(got[name].long(), out[name].long()), name
    assert bool(torch.isfinite(out["t0"]).all()) and bool((out["hit"] == 1).all())
    surface = out["reflecting"] | out["transmitting"]
    assert bool((surface | out["absorbed"]).all()) and bool(surface[:per].all())
    assert bool(surface[-per:].all()) and bool((out["c_in"][-per:] == 1.0).all())
    ref, val = jv.double(), g_jv.double()
    scale = ref.abs().amax(2, keepdim=True).clamp(min=1e-30)
    assert float(((val - ref).abs() / scale).max()) <= 1e-5
    # At the edge the tie takes half of each axis's slope: t0 moves with the
    # box's x size by half of -1/2 per 1/d_x (channel 2, the z size, moves it
    # not at all), and by as much with its y size.
    t0 = tables.PATH_J - 3
    edge = g_jv[:, t0, :per].double()
    half = -0.25 * np.sqrt(2.0)
    np.testing.assert_allclose((edge[0] - edge[2]).numpy(), half, rtol=1e-5)
    np.testing.assert_allclose((edge[1] - edge[2]).numpy(), half, rtol=1e-5)

