"""K2: the port's device emission against the JAX package, in float64."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from pvtrace_tpu.engine import tracer as jt  # noqa: E402
from pvtrace_tpu.engine.compiler import compile_scene  # noqa: E402
from pvtrace_tpu_torch import (  # noqa: E402
    Box,
    CircularMask,
    Cone,
    CubeMask,
    Distribution,
    HenyeyGreenstein,
    Light,
    Material,
    Node,
    RectangularMask,
    Scene,
    Sphere,
    SpectrumWavelengthMask,
    isotropic,
    lambertian,
)
from pvtrace_tpu_torch.engine import rng, tracer  # noqa: E402
from pvtrace_tpu_torch.engine.tables import scene_tensors  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab  # noqa: E402

torch.set_num_threads(1)
B = 4096
ATOL = 1e-12


def _spectrum():
    x = np.linspace(400.0, 700.0, 61)
    return SpectrumWavelengthMask(Distribution(x, np.exp(-0.5 * ((x - 560.0) / 40.0) ** 2)))


def _scene(*lights):
    world = Node(
        name="world",
        geometry=Sphere(radius=20.0, material=Material(refractive_index=1.0)),
    )
    Node(name="box", geometry=Box((2.0, 2.0, 2.0), material=Material(refractive_index=1.5)),
         parent=world)
    for i, light in enumerate(lights):
        node = Node(name=f"light{i}", light=light, parent=world)
        node.translate((0.3 * i, -0.2, 4.0))
        node.rotate(np.radians(170.0 - 7.0 * i), (1.0, 0.4, 0.0))
    return Scene(world)


LIGHTS = {
    "bench": lsc_slab,
    "rect_isotropic": lambda: _scene(
        Light(position=RectangularMask(1.0, 0.5), direction=isotropic)),
    "circle_lambertian": lambda: _scene(
        Light(position=CircularMask(0.7), direction=lambertian)),
    "cube_hg": lambda: _scene(
        Light(position=CubeMask(0.3, 0.4, 0.5), direction=HenyeyGreenstein(0.6))),
    "hg_flat": lambda: _scene(Light(direction=HenyeyGreenstein(0.0))),
    "spectral_cone": lambda: _scene(
        Light(wavelength=_spectrum(), direction=Cone(np.radians(30.0)))),
    "round_robin": lambda: _scene(
        Light(position=RectangularMask(0.5, 0.5), direction=Cone(np.radians(10.0))),
        Light(wavelength=_spectrum(), position=CircularMask(0.4),
              direction=HenyeyGreenstein(-0.3)),
        Light(position=CubeMask(0.1, 0.2, 0.3), direction=lambertian),
    ),
}


@pytest.mark.parametrize("name", sorted(LIGHTS))
def test_emit_matches_jax_float64(name, monkeypatch):
    # The JAX package's exact-lerp light ICDF path (the port has no
    # Chebyshev surrogate yet); read when _device_emit_flat runs.
    monkeypatch.setenv("PVTRACE_TPU_NO_CHEB", "1")
    compiled = compile_scene(LIGHTS[name]())
    assert compiled.lights_supported
    seed, offset = 11, 1000
    cfg = jt.make_config(compiled, B, dtype=np.float64, record_every=0)
    pids, keys = jt._photon_keys(jax.random.PRNGKey(seed), B, offset)
    ref = jt._device_emit_flat(
        compiled, cfg, compiled.device_tables(np.float64), keys, pids
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
