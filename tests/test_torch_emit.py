"""K2: the port's device emission against the JAX package, in float64.

Each package emits from the scene built from its own classes. The
spectral lights take the table lerp (K5b) with ``PVTRACE_TPU_NO_CHEB``
set, and the lamp spectrum's Chebyshev fit (K5a) at the defaults."""
import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import pvtrace_tpu  # noqa: E402
from pvtrace_tpu.engine import tracer as jt  # noqa: E402
from pvtrace_tpu.engine.compiler import compile_scene as jax_compile_scene  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, rng, tracer  # noqa: E402
from pvtrace_tpu_torch.engine.tables import scene_tensors  # noqa: E402
from pvtrace_tpu_torch.scenes import api, lsc_slab  # noqa: E402

cap_threads()
B = 4096
ATOL = 1e-12


def _spectrum(p):
    x = np.linspace(400.0, 700.0, 61)
    return p.SpectrumWavelengthMask(
        p.Distribution(x, np.exp(-0.5 * ((x - 560.0) / 40.0) ** 2)))


def _scene(p, *lights):
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=20.0, material=p.Material(refractive_index=1.0)),
    )
    p.Node(name="box",
           geometry=p.Box((2.0, 2.0, 2.0), material=p.Material(refractive_index=1.5)),
           parent=world)
    for i, light in enumerate(lights):
        node = p.Node(name=f"light{i}", light=light, parent=world)
        node.translate((0.3 * i, -0.2, 4.0))
        node.rotate(np.radians(170.0 - 7.0 * i), (1.0, 0.4, 0.0))
    return p.Scene(world)


# The lights of each test scene, from a package's scene-building names.
LIGHTS = {
    "bench": None,  # scenes.lsc_slab
    "rect_isotropic": lambda p: [
        p.Light(position=p.RectangularMask(1.0, 0.5), direction=p.isotropic)],
    "circle_lambertian": lambda p: [
        p.Light(position=p.CircularMask(0.7), direction=p.lambertian)],
    "cube_hg": lambda p: [
        p.Light(position=p.CubeMask(0.3, 0.4, 0.5), direction=p.HenyeyGreenstein(0.6))],
    "hg_flat": lambda p: [p.Light(direction=p.HenyeyGreenstein(0.0))],
    "spectral_cone": lambda p: [
        p.Light(wavelength=_spectrum(p), direction=p.Cone(np.radians(30.0)))],
    "round_robin": lambda p: [
        p.Light(position=p.RectangularMask(0.5, 0.5), direction=p.Cone(np.radians(10.0))),
        p.Light(wavelength=_spectrum(p), position=p.CircularMask(0.4),
                direction=p.HenyeyGreenstein(-0.3)),
        p.Light(position=p.CubeMask(0.1, 0.2, 0.3), direction=p.lambertian),
    ],
}


def _build(name, ns=None):
    """Scene `name` from the classes of package `ns` (None: the port)."""
    if LIGHTS[name] is None:
        return lsc_slab(ns)
    p = api(ns)
    return _scene(p, *LIGHTS[name](p))


def _check_emit(name):
    """Emission of 4096 photons of scene `name` from both packages."""
    jax_compiled = jax_compile_scene(_build(name, pvtrace_tpu))
    compiled = compile_scene(_build(name))
    assert compiled.lights_supported
    seed, offset = 11, 1000
    cfg = jt.make_config(jax_compiled, B, dtype=np.float64, record_every=0)
    pids, keys = jt._photon_keys(jax.random.PRNGKey(seed), B, offset)
    ref = jt._device_emit_flat(
        jax_compiled, cfg, jax_compiled.device_tables(np.float64), keys, pids
    )
    ref = [np.asarray(v) for v in (*ref[0], *ref[1], ref[2])]

    st = scene_tensors(compiled, dtype=torch.float64, device="cpu")
    got = tracer.initial_state(
        st, rng.key_words(seed), offset + torch.arange(B, dtype=torch.int64)
    )
    np.testing.assert_array_equal(np.asarray(keys[0]).astype(np.int64), got["k0"].numpy())
    np.testing.assert_array_equal(np.asarray(keys[1]).astype(np.int64), got["k1"].numpy())
    for r, key in zip(ref, ("px", "py", "pz", "dx", "dy", "dz", "wav")):
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0, atol=ATOL, err_msg=key)
    assert bool(got["alive"].all()) and int(got["count"].abs().sum()) == 0
    assert set(got["source"].tolist()) == {-1}
    return st


@pytest.mark.parametrize("name", sorted(LIGHTS))
def test_emit_matches_jax_float64(name, monkeypatch):
    # The JAX package's exact-lerp light ICDF path (K5b), read when
    # _device_emit_flat runs.
    monkeypatch.setenv("PVTRACE_TPU_NO_CHEB", "1")
    _check_emit(name)


@pytest.mark.parametrize("name", ["spectral_cone", "round_robin"])
def test_emit_at_defaults_matches_jax_float64(name, monkeypatch):
    # Both packages at their defaults: the lamp spectrum's Chebyshev fit.
    monkeypatch.delenv("PVTRACE_TPU_NO_CHEB", raising=False)
    st = _check_emit(name)
    assert st["meta"]["cheb_light"]
