"""The port's ``diff.transport``: score gradients and the K15 surrogate.

``fate_gradients`` runs on the eager twin here (``device="cpu"``), in
float64: on the null-surface absorber slab and on the normal-incidence
Fresnel slab it meets the analytic gradients of the JAX package's
``tests/test_diff.py`` within 5 standard errors, which the run computes
itself from the bundles it traces; its ``wrt`` slices and centring equal
``simulate(score=True)``'s ``fate_scores`` taken by hand, in both
packages; ``optimize_concentration`` on the scaled LSC of
``examples/optimize_lsc.py`` follows the JAX package's history. The
surrogate ``absorbed_fraction_fn`` (K15) matches the JAX function and
``jax.grad`` in float32, and its device code (``diff.cuh``, built for the
host) matches the twin.
"""
import ctypes

import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu.diff import transport as jax_transport  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu.engine.compiler import compile_scene as jax_compile_scene  # noqa: E402
from pvtrace_tpu_torch import kernels  # noqa: E402
from pvtrace_tpu_torch.diff import transport  # noqa: E402
from pvtrace_tpu_torch.engine import absorb, compile_scene, simulate  # noqa: E402
from pvtrace_tpu_torch.kernels import host  # noqa: E402
from pvtrace_tpu_torch.light.event import Event  # noqa: E402
from pvtrace_tpu_torch.scenes import absorber_slab, api, fresnel_slab, lsc_slab  # noqa: E402

cap_threads()
N_SLAB, BUNDLES = 2 ** 15, 16
N_LSC, LANES = 2 ** 12, 2 ** 10
OPT = dict(target=0.55, num_rays=N_LSC, iters=2, lr=8.0, seed=11, component=1,
           dtype=np.float64, lanes=LANES)


def _gradients_with_errors(monkeypatch, scene, event, channel, **kwargs):
    """``fate_gradients`` of `scene` at N_SLAB photons in BUNDLES bundles
    (twin, float64), the centred gradient of (`event`, `channel`) and its
    standard error over the bundles, each bundle's estimate centred as
    the whole is."""
    parts = []
    run = transport.simulate

    def spy(*args, **kw):
        result = run(*args, **kw)
        parts.append(result.data)
        return result

    monkeypatch.setattr(transport, "simulate", spy)
    fractions, gradients = transport.fate_gradients(
        scene, N_SLAB, seed=7, dtype=np.float64, device="cpu", bundle=N_SLAB // BUNDLES, **kwargs
    )
    n = N_SLAB // BUNDLES
    est = []
    for data in parts:
        s = data["fate_scores"][:, channel]
        est.append((s[event.value] - data["fates"][event.value] / n * s.sum()) / n)
    assert len(est) == BUNDLES
    return fractions, gradients, np.std(est, ddof=1) / np.sqrt(BUNDLES)


def test_fate_gradients_match_analytic_absorber_slab(monkeypatch):
    """d P(absorb) / d log(alpha) = alpha L exp(-alpha L) on the slab."""
    alpha, L = 0.8, 1.0
    fractions, grads, se = _gradients_with_errors(
        monkeypatch, absorber_slab(alpha), Event.NONRADIATIVE, 0)
    p_abs = 1.0 - np.exp(-alpha * L)
    assert abs(fractions[Event.NONRADIATIVE] - p_abs) < 5 * np.sqrt(p_abs * (1 - p_abs) / N_SLAB)
    expect = alpha * L * np.exp(-alpha * L)
    assert 0 < se < 0.02
    assert abs(grads[Event.NONRADIATIVE][0] - expect) < 5 * se, (grads, expect, se)
    np.testing.assert_allclose(grads[Event.EXIT][0], -grads[Event.NONRADIATIVE][0], rtol=1e-12)


def test_fate_gradients_match_analytic_fresnel_slab(monkeypatch):
    """d P(absorb) / d n_slab on the normal-incidence slab:
    P = (1-R)(1-T)/(1-RT), T = exp(-alpha L), R = ((n-1)/(n+1))^2."""
    n_slab, alpha, L = 1.5, 0.5, 1.0
    fractions, grads, se = _gradients_with_errors(
        monkeypatch, fresnel_slab(n_slab, alpha), Event.NONRADIATIVE, 1 + 1,
        wrt="refractive_index")
    R = ((n_slab - 1) / (n_slab + 1)) ** 2
    T = np.exp(-alpha * L)
    p_abs = (1 - R) * (1 - T) / (1 - R * T)
    assert abs(fractions[Event.NONRADIATIVE] - p_abs) < 5 * np.sqrt(p_abs * (1 - p_abs) / N_SLAB)
    expect = -((1 - T) ** 2) / (1 - R * T) ** 2 * 4 * (n_slab - 1) / (n_slab + 1) ** 3
    # Channels of wrt="refractive_index": one per node, preorder (world, slab).
    assert grads[Event.NONRADIATIVE].shape == (2,) and 0 < se < 0.01
    assert abs(grads[Event.NONRADIATIVE][1] - expect) < 5 * se, (grads, expect, se)


def _by_hand(data, n_comps, wrt, center):
    s = np.asarray(data["fate_scores"], np.float64)
    s = {"components": s[:, :n_comps], "refractive_index": s[:, n_comps:], "all": s}[wrt]
    f = np.asarray(data["fates"], np.float64)
    n = f.sum()
    if center:
        s = s - f[:, None] / n * s.sum(axis=0, keepdims=True)
    return s / n


@pytest.fixture(scope="module")
def jax_lsc_runs():
    """The JAX package on the LSC slab, float64: one ``simulate(score=True)``
    and the ``optimize_concentration`` run of OPT (its first iteration
    traces the same scene, so the two share a compile)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
        mp.setattr(jax_api, "_TRACER_CACHE", {})
        data = jax_api.simulate(lsc_slab(pvtrace_tpu), N_LSC, seed=11, record_every=0,
                                score=True, dtype=np.float64, lanes=LANES).data
        grads = {
            (wrt, center): jax_transport.fate_gradients(
                lsc_slab(pvtrace_tpu), N_LSC, seed=11, wrt=wrt, center=center,
                dtype=np.float64, lanes=LANES)[1]
            for wrt in ("components", "refractive_index", "all") for center in (False, True)
        }
        history = jax_transport.optimize_concentration(
            lambda scale: lsc_slab(pvtrace_tpu, scale), **OPT)[1]
    return data, grads, history


@pytest.mark.parametrize("wrt", ["components", "refractive_index", "all"])
def test_fate_gradients_slice_fate_scores(jax_lsc_runs, wrt):
    """Both packages: ``fate_gradients`` equals the hand-sliced, hand-centred
    ``fate_scores`` of ``simulate(score=True)`` of the same photons."""
    n_comps = compile_scene(lsc_slab()).n_components
    data = simulate(lsc_slab(), N_LSC, seed=11, record_every=0, score=True, dtype=np.float64,
                    lanes=LANES, device="cpu").data
    jax_data, jax_grads, _ = jax_lsc_runs
    for center in (False, True):
        _, grads = transport.fate_gradients(lsc_slab(), N_LSC, seed=11, wrt=wrt, center=center,
                                            dtype=np.float64, lanes=LANES, device="cpu")
        for ref_data, got in ((data, grads), (jax_data, jax_grads[(wrt, center)])):
            want = _by_hand(ref_data, n_comps, wrt, center)
            got = {event.value: v for event, v in got.items()}
            assert sorted(got) == [4, 7, 8, 9]
            for fate, value in got.items():
                np.testing.assert_allclose(value, want[fate], rtol=1e-12, atol=1e-15)


def test_optimize_concentration_matches_jax(jax_lsc_runs):
    """Two iterations on the scaled LSC: the port's history (log scale,
    loss fraction, loss) equals the JAX package's, to the photons whose
    fates differ (at most 4 of N_LSC in a fraction)."""
    _, _, ref = jax_lsc_runs
    _, got = transport.optimize_concentration(lambda scale: lsc_slab(scale_bg=scale),
                                              device="cpu", **OPT)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[1], r[1], rtol=0, atol=4.0 / N_LSC)
        np.testing.assert_allclose(g[0], r[0], rtol=1e-6, atol=1e-9)
    assert got[1][0] != 0.0


def test_unported_options_raise():
    """Options that raised here before they were ported now run: pathwise
    channels (``tests/test_torch_pathwise.py``) and the mesh, whose
    estimator on a process of its own equals the unsharded one
    (``tests/test_torch_parallel.py`` holds the sharded runs)."""
    from pvtrace_tpu_torch.parallel import make_photon_mesh

    kwargs = dict(seed=3, wrt="all", device="cpu", dtype=np.float64)
    f_mesh, g_mesh = transport.fate_gradients(absorber_slab(), 10,
                                              mesh=make_photon_mesh(device="cpu"), **kwargs)
    f_one, g_one = transport.fate_gradients(absorber_slab(), 10, **kwargs)
    assert f_mesh == f_one
    for event in g_one:
        np.testing.assert_array_equal(g_mesh[event], g_one[event])
    _, grads = transport.fate_gradients(absorber_slab(), 10, wrt="pathwise",
                                        pathwise=[("n", "slab")], device="cpu")
    assert grads[Event.EXIT].shape == (1,)


def _surrogate_scene(ns=None):
    """An absorbing box (two components), sphere and capped cylinder, each
    in an axis-aligned frame: 90-degree turns and offsets that float32
    holds exactly, so both packages take the same local rays (a rotated
    frame rounds the 3x3 product in another order in XLA than in torch,
    and a ray that grazes a cylinder's barrel turns that last bit into
    up to 3e-4 of its chord)."""
    p = api(ns)
    x = np.arange(400, 801, dtype=float)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=10.0, material=p.Material(refractive_index=1.0)))
    box = p.Node(name="box", parent=world, geometry=p.Box((2.0, 1.5, 1.0), material=p.Material(
        refractive_index=1.0, components=[
            p.Absorber(0.6),
            p.Luminophore(np.column_stack((x, p.lumogen_f_red_305.absorption(x) * 2.0)),
                          emission=np.column_stack((x, p.lumogen_f_red_305.emission(x))),
                          quantum_yield=0.9),
        ])))
    box.rotate(np.radians(90.0), (0.0, 0.0, 1.0))
    box.translate((0.25, 0.0, -2.0))
    ball = p.Node(name="ball", parent=world, geometry=p.Sphere(radius=1.2, material=p.Material(
        refractive_index=1.0, components=[p.Absorber(0.9)])))
    ball.translate((0.5, -0.25, 1.0))
    rod = p.Node(name="rod", parent=world, geometry=p.Cylinder(length=2.0, radius=0.7,
                 material=p.Material(refractive_index=1.0, components=[p.Absorber(1.3)])))
    rod.rotate(np.radians(90.0), (0.0, 1.0, 0.0))
    rod.translate((-0.375, 0.25, 3.25))
    p.Node(name="light", parent=world, light=p.Light())
    return p.Scene(world)


def _two_slabs(ns=None):
    """Two index-matched null-surface slabs in series (the JAX package's
    ``tests/test_diff.py::test_absorbed_fraction_sums_over_absorbing_nodes``)."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=10.0, material=p.Material(refractive_index=1.0)))
    for name, z, alpha in (("a", -1.0, 0.6), ("b", 1.0, 0.9)):
        slab = p.Node(name=name, parent=world, geometry=p.Box((2.0, 2.0, 1.0), material=p.Material(
            refractive_index=1.0, surface=p.Surface(delegate=p.NullSurfaceDelegate()),
            components=[p.Absorber(alpha)])))
        slab.translate((0.0, 0.0, z))
    p.Node(name="light", parent=world, light=p.Light())
    return p.Scene(world)


def _photons(P=4096, seed=3):
    """Rays from below the scenes, mostly upward, with wavelengths across
    the grid (numpy, float32)."""
    rng = np.random.default_rng(seed)
    pos = np.column_stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1.5, 1.5, P),
                           np.full(P, -6.0)]).astype(np.float32)
    d = rng.normal(size=(P, 3))
    d[:, 2] = np.abs(d[:, 2]) * 4.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return pos, d, rng.uniform(420.0, 780.0, P).astype(np.float32)


@pytest.mark.parametrize("make", [_surrogate_scene, _two_slabs], ids=["three-shapes", "two-slabs"])
def test_absorbed_fraction_matches_jax(make):
    """Weights to rtol 1e-6 in float32 and the gradient in log_concentration
    (cotangents uniform in [-1, 1]) within 1e-6 of the sum of its terms'
    magnitudes (float32 sums in another order); pos, dir and wav get no
    gradient."""
    pos, d, wav = _photons()
    g = np.random.default_rng(4).uniform(-1.0, 1.0, wav.shape[0]).astype(np.float32)
    jw = jax_transport.absorbed_fraction_fn(jax_compile_scene(make(pvtrace_tpu)))
    lc = np.float32(0.3)
    args = (jnp.asarray(pos), jnp.asarray(d), jnp.asarray(wav))
    ref = np.asarray(jw({"log_concentration": jnp.asarray(lc)}, *args))
    ref_g = float(jax.grad(lambda p: jnp.sum(jnp.asarray(g) * jw(p, *args)))(
        {"log_concentration": jnp.asarray(lc)})["log_concentration"])

    weight = transport.absorbed_fraction_fn(compile_scene(make()))
    t_lc = torch.tensor(lc, requires_grad=True)
    t_pos = torch.tensor(pos, requires_grad=True)
    got = weight({"log_concentration": t_lc}, t_pos, torch.tensor(d), torch.tensor(wav))
    assert (ref > 0).sum() > 500
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6, atol=0)
    grad, grad_pos = torch.autograd.grad((torch.tensor(g) * got).sum(), (t_lc, t_pos),
                                         allow_unused=True)
    assert grad_pos is None and grad.shape == t_lc.shape
    c = np.exp(lc)
    dep = -np.log1p(-ref.astype(np.float64)) / c
    terms = np.abs(g * c * dep * np.exp(-c * dep)).sum()
    assert abs(float(grad) - ref_g) <= 1e-6 * terms, (float(grad), ref_g, terms)


def test_absorbed_fraction_two_slabs_is_beer_lambert():
    """One ray straight through both slabs: 1 - exp(-(0.6 + 0.9))."""
    weight = transport.absorbed_fraction_fn(compile_scene(_two_slabs()))
    w = weight({"log_concentration": torch.tensor(0.0)}, torch.tensor([[0.0, 0.0, -5.0]]),
               torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([555.0]))
    assert abs(float(w[0]) - (1.0 - np.exp(-1.5))) < 2e-4


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The device code of tracer.cuh and diff.cuh built for the host (skips
    without g++)."""
    if host.compiler() is None:
        pytest.skip("no host C++ compiler")
    return host.build_library(tmp_path_factory.mktemp("host"))


@pytest.mark.parametrize("make", [_surrogate_scene, _two_slabs], ids=["three-shapes", "two-slabs"])
def test_absorbed_device_code_matches_twin(host_lib, make):
    """``absorbed_lane`` and ``absorbed_grad_lane`` (pvt_absorbed's bodies)
    against the plain version: weights and depths to rtol 1e-6, the
    gradient to 1e-6 of its terms' magnitudes."""
    tab = absorb.table(compile_scene(make()))
    pos, d, wav = (torch.tensor(v) for v in _photons())
    grad_w = torch.tensor(np.random.default_rng(5).uniform(-1.0, 1.0, wav.shape[0]),
                          dtype=torch.float32)
    c = torch.exp(torch.tensor([0.3]))
    m = tab["meta"]
    desc = kernels._Absorbers(tab["node_f"].data_ptr(), tab["node_i"].data_ptr(),
                              tab["alpha"].data_ptr(), tab["node_i"].shape[0], m["L"], m["x0"],
                              m["dx"])
    w, dep, grad = (torch.empty_like(wav) for _ in range(3))
    host_lib.h_absorbed(ctypes.byref(desc), pos.data_ptr(), d.data_ptr(), wav.data_ptr(),
                        c.data_ptr(), wav.shape[0], w.data_ptr(), dep.data_ptr(),
                        grad_w.data_ptr(), grad.data_ptr())
    ref_dep = absorb.depth(tab, pos, d, wav)
    torch.testing.assert_close(dep, ref_dep, rtol=1e-6, atol=0)
    torch.testing.assert_close(w, absorb.weight(c, ref_dep), rtol=1e-6, atol=0)
    terms = grad_w * (c * ref_dep * torch.exp(-c * ref_dep))
    assert abs(float(grad.double().sum() - terms.double().sum())) <= 1e-6 * float(terms.abs().sum())
    assert int((ref_dep > 0).sum()) > 500
