"""The slice as a whole: the port's ``simulate`` against the JAX package.

Both packages trace the same photons from the same seed (threefry
streams, pid -> stream), so in float64 the fate counts agree photon for
photon, up to the rare photon whose discrete outcome an ulp flips. The
JAX package runs its exact table-lerp spectral path (PVTRACE_TPU_NO_CHEB,
read when a tracer is built, so each test gets an empty tracer cache).
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from pvtrace_tpu import engine as jax_engine  # noqa: E402
from pvtrace_tpu.engine import api as jax_api  # noqa: E402
from pvtrace_tpu.engine.recorder import Recorder  # noqa: E402
from pvtrace_tpu.geometry.mesh import Mesh  # noqa: E402
from pvtrace_tpu.material.surface import (  # noqa: E402
    OVERRIDE_ABSORB,
    OVERRIDE_LAMBERTIAN_MIRROR,
    OVERRIDE_MIRROR,
)
from pvtrace_tpu_torch import (  # noqa: E402
    Absorber,
    Box,
    CircularMask,
    Cone,
    Cylinder,
    FacetOverride,
    FacetOverrideSurfaceDelegate,
    HenyeyGreenstein,
    Light,
    Luminophore,
    Material,
    Node,
    Reactor,
    RectangularMask,
    Scatterer,
    Scene,
    Sphere,
    Surface,
    lumogen_f_red_305,
)
from pvtrace_tpu_torch.engine import simulate  # noqa: E402
from pvtrace_tpu_torch.scenes import lsc_slab  # noqa: E402

torch.set_num_threads(1)
FATE_NAMES = {4: "NONRADIATIVE", 7: "EXIT", 8: "REACT", 9: "KILL", 10: "NO_HIT"}


@pytest.fixture
def jax_exact_lerp(monkeypatch):
    monkeypatch.setenv("PVTRACE_TPU_NO_CHEB", "1")
    monkeypatch.setattr(jax_api, "_TRACER_CACHE", {})


def _mixed_scene():
    """A cylinder with an HG scatterer and a reactor beside a dyed plate
    whose faces carry mirror, absorb and Lambertian-mirror overrides; two
    lights, so photons alternate between them."""
    x = np.arange(400, 801, dtype=float)
    world = Node(
        name="world",
        geometry=Sphere(radius=12.0, material=Material(refractive_index=1.0)),
    )
    overrides = FacetOverrideSurfaceDelegate([
        FacetOverride((0.0, 0.0, -1.0), OVERRIDE_MIRROR),
        FacetOverride((1.0, 0.0, 0.0), OVERRIDE_ABSORB),
        FacetOverride((0.0, -1.0, 0.0), OVERRIDE_LAMBERTIAN_MIRROR),
    ])
    Node(
        name="plate",
        geometry=Box(
            (4.0, 4.0, 0.5),
            material=Material(
                refractive_index=1.5,
                surface=Surface(overrides),
                components=[
                    Luminophore(
                        coefficient=np.column_stack(
                            (x, lumogen_f_red_305.absorption(x) * 4.0)
                        ),
                        emission=np.column_stack((x, lumogen_f_red_305.emission(x))),
                        quantum_yield=0.95,
                        tau_rad=1e-9,
                        name="dye",
                    ),
                    Scatterer(0.2, phase_function=HenyeyGreenstein(0.5), name="haze"),
                ],
            ),
        ),
        parent=world,
    )
    rod = Node(
        name="rod",
        geometry=Cylinder(
            length=2.0, radius=0.6,
            material=Material(
                refractive_index=1.4,
                components=[
                    Reactor(0.6, name="reactor"),
                    Scatterer(0.8, phase_function=HenyeyGreenstein(-0.4), name="hg"),
                    Absorber(0.1, tau_nr=2e-9, name="grey"),
                ],
            ),
        ),
        parent=world,
    )
    rod.translate((0.0, 0.0, 3.0))
    rod.rotate(np.radians(90.0), (1.0, 0.0, 0.0))
    top = Node(
        name="top-lamp",
        light=Light(position=RectangularMask(1.5, 1.5), direction=Cone(np.radians(25.0))),
        parent=world,
    )
    top.translate((0.0, 0.0, 6.0))
    top.rotate(np.radians(180.0), (1.0, 0.0, 0.0))
    side = Node(name="side-lamp", light=Light(position=CircularMask(0.4)), parent=world)
    side.translate((-4.0, 0.0, 3.0))
    side.rotate(np.radians(90.0), (0.0, 1.0, 0.0))
    return Scene(world)


def _fates(result):
    fates = np.asarray(result.data["fates"], dtype=np.int64)
    assert fates.shape == (11,)
    return fates


def _assert_float64_parity(scene, n, **kwargs):
    ref = _fates(jax_engine.simulate(scene, n, seed=5, record_every=0,
                                     dtype=np.float64, **kwargs))
    got = _fates(simulate(scene, n, seed=5, record_every=0, dtype=np.float64,
                          device="cpu", **kwargs))
    assert ref.sum() == n and got.sum() == n
    assert np.abs(got - ref).max() <= 4, (got.tolist(), ref.tolist())
    return got


@pytest.mark.parametrize("n, lanes", [(2 ** 13, 2 ** 10), (2 ** 11, None)])
def test_bench_scene_float64_matches_jax(n, lanes, jax_exact_lerp):
    got = _assert_float64_parity(lsc_slab(), n, lanes=lanes)
    assert set(np.flatnonzero(got)) <= {4, 7, 9}


@pytest.mark.parametrize("n, lanes", [(2 ** 13, 2 ** 10), (2 ** 11, None)])
def test_bench_scene_float32_agrees_with_jax(n, lanes, jax_exact_lerp):
    scene = lsc_slab()
    # The JAX package traces float32 with 64-bit mode off, as its bench
    # does: with jax_enable_x64 on, its float32 regeneration loop fails
    # (float64 emission constants promote the loop carry).
    with jax.enable_x64(False):
        ref = _fates(jax_engine.simulate(scene, n, seed=9, record_every=0,
                                         dtype=np.float32, lanes=lanes))
    got = _fates(simulate(scene, n, seed=9, record_every=0, dtype=np.float32,
                          lanes=lanes, device="cpu"))
    assert ref.sum() == n and got.sum() == n
    for slot in FATE_NAMES:
        pooled = (ref[slot] + got[slot]) / (2.0 * n)
        if pooled == 0.0:
            continue
        z = abs(ref[slot] - got[slot]) / n / np.sqrt(pooled * (1 - pooled) * 2.0 / n)
        assert z < 5, (FATE_NAMES[slot], got.tolist(), ref.tolist())


@pytest.mark.parametrize("options", [
    {"emit_method": "kT"},
    {"emit_method": "redshift", "maxpathlength": 6.0},
    {"emit_method": "full", "maxsteps": 6},
], ids=["kT", "redshift-pathcap", "full-stepcap"])
def test_mixed_scene_float64_matches_jax(options, jax_exact_lerp):
    got = _assert_float64_parity(_mixed_scene(), 2 ** 11, lanes=2 ** 9, **options)
    assert got[7] > 0 and got[4] > 0 and got[8] > 0
    if "maxpathlength" in options or "maxsteps" in options:
        assert got[9] > 0


def test_lsc_slab_is_the_bench_scene():
    import importlib.util
    from pathlib import Path

    from pvtrace_tpu_torch.engine import compile_scene

    path = Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("pvtrace_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert compile_scene(lsc_slab()).content_digest == \
        compile_scene(bench.build_scene()).content_digest


def test_lanes_do_not_change_fates():
    scene = lsc_slab()
    runs = [
        _fates(simulate(scene, 3000, seed=4, record_every=0, dtype=np.float64,
                        lanes=lanes, device="cpu", index_offset=17))
        for lanes in (None, 1000, 64)
    ]
    for fates in runs[1:]:
        np.testing.assert_array_equal(fates, runs[0])


def test_result_layout():
    result = simulate(lsc_slab(), 500, seed=1, record_every=0, device="cpu")
    assert sum(result.fate_counts().values()) == 500
    assert result.num_rays == 500 and result.sources[3] == "Light"
    assert result.data["fates"].dtype == np.int64
    assert result.data["steps"] > 0
    assert result.data["counts"].shape == (0,)
    assert result.data["position"].shape == (0, 128, 3)
    assert list(result.histories()) == []


def _mesh_scene():
    world = Node(name="world", geometry=Sphere(radius=5.0, material=Material(refractive_index=1.0)))
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    Node(name="tet", geometry=Mesh((v, f), material=Material(refractive_index=1.3)),
         parent=world)
    Node(name="lamp", light=Light(), parent=world)
    return Scene(world)


def _recorder_scene():
    scene = lsc_slab()
    scene.root.recorders = [Recorder("out", event="escaping")]
    return scene


def _host_light_scene():
    world = Node(name="world", geometry=Sphere(radius=5.0, material=Material(refractive_index=1.0)))
    Node(name="lamp", light=Light(direction=lambda: (0.0, 0.0, 1.0)), parent=world)
    return Scene(world)


@pytest.mark.parametrize("make, kwargs, item", [
    (lsc_slab, {"record_every": 1}, "item 9"),
    (lsc_slab, {"record_every": 0, "score": True}, "item 10"),
    (lsc_slab, {"record_every": 0, "pathwise": (("n", 1),)}, "item 11"),
    (_recorder_scene, {"record_every": 0}, "item 4"),
    (_mesh_scene, {"record_every": 0}, "item 8"),
    (_host_light_scene, {"record_every": 0}, "item 5"),
], ids=["event-log", "score", "pathwise", "recorders", "mesh", "host-emission"])
def test_unported_features_raise(make, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        simulate(make(), 10, device="cpu", **kwargs)


@pytest.mark.parametrize("n, offset", [(0, 0), (10, -1), (2, 2 ** 32 - 2)])
def test_budget_outside_uint32_photon_ids_is_rejected(n, offset):
    with pytest.raises(ValueError):
        simulate(lsc_slab(), n, record_every=0, device="cpu", index_offset=offset)


def test_import_leaves_jax_out():
    code = (
        "import sys, pvtrace_tpu_torch, pvtrace_tpu_torch.kernels, "
        "pvtrace_tpu_torch.kernels.check, pvtrace_tpu_torch.scenes; "
        "print('jax' in sys.modules)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        timeout=120,
    )
    assert out.stdout.strip() == "False"
