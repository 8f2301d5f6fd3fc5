"""The port's counterparts of three of the JAX package's engine test files,
run on the eager twin (``simulate(..., device="cpu")``):

* ``tests/test_eps.py``: per-node forward-hit tolerances on a thin gap (a
  lamp 0.01 cm above a slab in a 240 cm world), and the first-surface
  Fresnel reflection that a scene-wide float32 tolerance lost;
* ``tests/test_regeneration.py``: an exact photon budget, fates and
  recorder tallies that do not depend on ``lanes``, determinism, and
  complete histories with regeneration;
* ``tests/test_mesh_engine.py``: a cube mesh against the Box it bounds,
  against the oracle, and with regeneration and recorders; the mesh LSC
  against the oracle (``slow``, as in the JAX package).

Budgets are 2**14 photons or fewer (the JAX files take up to 10**5).
"""
import numpy as np
import pytest

from _torch_threads import cap_threads

torch = pytest.importorskip("torch")

from pvtrace_tpu_torch.algorithm import photon_tracer  # noqa: E402
from pvtrace_tpu_torch.engine import compile_scene, simulate, tables  # noqa: E402
from pvtrace_tpu_torch.light.event import Event  # noqa: E402
from pvtrace_tpu_torch.scenes import _MESHES, api, mesh_lsc  # noqa: E402

cap_threads()
p = api()


def run(scene, n, seed, **kwargs):
    kwargs.setdefault("record_every", 0)
    return simulate(scene, n, seed=seed, device="cpu", **kwargs)


def z_score(k1, n1, k2, n2):
    pooled = (k1 + k2) / (n1 + n2)
    return abs(k1 / n1 - k2 / n2) / np.sqrt(max(pooled * (1 - pooled) * (1 / n1 + 1 / n2), 1e-12))


# -- test_eps.py -----------------------------------------------------------

def thin_gap_scene():
    """A 4.8 x 1.8 x 0.25 cm slab in a 240 cm world, lit straight down by
    a rectangular 555 nm lamp 0.01 cm above its top face."""
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=240.0, material=p.Material(refractive_index=1.0)))
    p.Node(name="slab", parent=world, geometry=p.Box(
        (4.8, 1.8, 0.25),
        material=p.Material(refractive_index=1.5, components=[p.Absorber(0.02)])))
    light = p.Node(name="light", parent=world, light=p.Light(
        wavelength=p.ConstantWavelengthMask(555.0), position=p.RectangularMask(2.4, 0.9)))
    light.translate((0.0, 0.0, 0.125 + 0.01))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


def test_per_node_eps_resolves_thin_features():
    compiled = compile_scene(thin_gap_scene())
    eps = compiled.resolved_eps_per_node(np.float32)
    names = list(compiled.node_names)
    assert eps[names.index("slab")] < 0.01 / 10, eps
    assert eps[names.index("world")] > eps[names.index("slab")]
    # The trace reads each node's own tolerance from the node records.
    st = tables.scene_tensors(compiled, dtype=torch.float32)
    np.testing.assert_allclose(st["node_f"][:, tables.NF_EPS].numpy(), eps, rtol=1e-7)


def test_first_surface_reflection_survives_f32():
    scene = thin_gap_scene()
    slab = next(n for n in scene.root.iter_preorder() if n.name == "slab")
    slab.recorders = [p.Recorder("r", event="reflected", facet=(0, 0, 1))]
    N = 1 << 14
    result = run(scene, N, 3, dtype=np.float32)
    assert sum(result.fate_counts().values()) == N
    frac = result.recorders["r"].rays / N
    assert abs(frac - 0.04) < 5 * np.sqrt(0.04 * 0.96 / N), frac


# -- test_regeneration.py ----------------------------------------------------

def lsc_scene():
    x = np.arange(400, 801, dtype=float)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=12.0, material=p.Material(refractive_index=1.0)))
    lsc = p.Node(name="lsc", parent=world, geometry=p.Box((5.0, 5.0, 1.0), material=p.Material(
        refractive_index=1.5,
        components=[p.Luminophore(coefficient=np.column_stack(
                        (x, p.lumogen_f_red_305.absorption(x) * 8.0)),
                        emission=np.column_stack((x, p.lumogen_f_red_305.emission(x))),
                        quantum_yield=0.9),
                    p.Absorber(0.2)])))
    lsc.recorders = [p.Recorder("escape", event="escaping",
                                histograms=[p.Histogram("wavelength", 400, 800, 40)])]
    light = p.Node(name="light", parent=world,
                   light=p.Light(wavelength=p.ConstantWavelengthMask(555.0)))
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


@pytest.mark.parametrize("lanes", [1 << 10, 1 << 12])
def test_regeneration_traces_exact_budget_and_matches_plain(lanes):
    scene, N = lsc_scene(), 1 << 13
    plain = run(scene, N, 11, lanes=None, dtype=np.float64)
    regen = run(scene, N, 11, lanes=lanes, dtype=np.float64)
    assert sum(regen.fate_counts().values()) == N
    assert regen.fate_counts() == plain.fate_counts()
    r1, r2 = plain.recorders["escape"], regen.recorders["escape"]
    assert (r1.rays, r1.crossings) == (r2.rays, r2.crossings)
    assert (r1.histogram()[1] == r2.histogram()[1]).all()
    assert abs(r1.mean("wavelength") - r2.mean("wavelength")) < 1e-6


def test_regeneration_is_deterministic():
    scene = lsc_scene()
    a = run(scene, 8000, 3, lanes=2048)
    b = run(scene, 8000, 3, lanes=2048)
    assert a.fate_counts() == b.fate_counts()
    assert (a.recorders["escape"].histogram()[1] == b.recorders["escape"].histogram()[1]).all()


def test_regeneration_histories_are_complete():
    result = run(lsc_scene(), 6000, 5, record_every=250, lanes=1024)
    histories = list(result.histories())
    assert len(histories) == 24
    for history in histories:
        assert history[0][1] == Event.GENERATE
        assert history[-1][1] in (Event.EXIT, Event.NONRADIATIVE, Event.KILL)


# -- test_mesh_engine.py -----------------------------------------------------

def make_scene(geometry):
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=10.0, material=p.Material(refractive_index=1.0)))
    p.Node(name="slab", parent=world, geometry=geometry)
    light = p.Node(name="light", parent=world, light=p.Light(
        wavelength=p.ConstantWavelengthMask(555.0), position=p.RectangularMask(0.3, 0.3)))
    light.translate((0.0, 0.0, 2.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


def material():
    return p.Material(refractive_index=1.5, components=[p.Absorber(0.8)])


def cube_mesh_scene():
    return make_scene(p.Mesh(_MESHES["cube"], material=material()))


def test_mesh_cube_matches_analytic_box():
    N = 1 << 14
    fm = run(cube_mesh_scene(), N, 5).fate_counts()
    fb = run(make_scene(p.Box((1.0, 1.0, 1.0), material=material())), N, 5).fate_counts()
    assert sum(fm.values()) == N
    # The same key streams and geometry: equal but for grazing shared-edge
    # hits of the triangles.
    for event in (Event.EXIT, Event.NONRADIATIVE):
        assert abs(fm.get(event, 0) - fb.get(event, 0)) <= max(3, 0.001 * N), (event, fm, fb)


def oracle_absorbed(scene, n, np_seed):
    np.random.seed(np_seed)
    return sum(photon_tracer.follow(scene, ray)[-1][1] == Event.NONRADIATIVE
               for ray in scene.emit(n))


def test_mesh_engine_matches_oracle():
    scene, N, n2 = cube_mesh_scene(), 1 << 14, 800
    absorbed = run(scene, N, 9).fate_counts().get(Event.NONRADIATIVE, 0)
    assert z_score(absorbed, N, oracle_absorbed(scene, n2, 2), n2) < 5


def test_mesh_regeneration_and_recorders():
    scene = cube_mesh_scene()
    slab = next(n for n in scene.root.iter_preorder() if n.name == "slab")
    slab.recorders = [p.Recorder("top-escape", event="escaping", facet=(0, 0, 1)),
                      p.Recorder("lost", event="lost")]
    r1 = run(scene, 1 << 14, 4, lanes=4096)
    r2 = run(scene, 1 << 14, 4, lanes=None)
    assert r1.fate_counts() == r2.fate_counts()
    for name in ("lost", "top-escape"):
        assert r1.recorders[name].rays == r2.recorders[name].rays
    assert r1.recorders["top-escape"].rays > 0


@pytest.mark.slow
def test_mesh_lsc_coated_device_vs_oracle():
    """The hexagonal mesh LSC (mirror below, six edge cells): fates against
    the oracle, the six cells collect alike, nearly every photon enters."""
    scene, N, n2 = mesh_lsc(), 12000, 400
    result = run(scene, N, 5)
    fates = result.fate_counts()
    assert set(fates) <= {Event.EXIT, Event.NONRADIATIVE, Event.KILL}
    assert z_score(fates.get(Event.NONRADIATIVE, 0), N, oracle_absorbed(scene, n2, 21), n2) < 5
    cells = np.array([result.recorders[f"cell_{i}"].rays for i in range(6)], float)
    assert cells.sum() > 0
    assert np.all(np.abs(cells - cells.sum() / 6.0) < 6 * np.sqrt(cells.sum() / 6.0)), cells
    assert result.recorders["incident"].rays > 0.9 * N
