"""Scenes the port is checked and measured on.

Every scene function takes ``ns``, the package whose classes build it:
None for ``pvtrace_tpu_torch``, or another package with the same
sub-paths (the JAX package, whose compiler takes only its own classes),
so that the tests can build the same scene for both.
"""
import functools
import importlib
from types import SimpleNamespace

import numpy as np

# Name -> (sub-path, attribute; None for the module itself)
_NAMES = {
    "Box": ("geometry.box", "Box"),
    "Cylinder": ("geometry.cylinder", "Cylinder"),
    "Mesh": ("geometry.mesh", "Mesh"),
    "Sphere": ("geometry.sphere", "Sphere"),
    "Light": ("light.light", "Light"),
    "CircularMask": ("light.light", "CircularMask"),
    "ConstantWavelengthMask": ("light.light", "ConstantWavelengthMask"),
    "CubeMask": ("light.light", "CubeMask"),
    "RectangularMask": ("light.light", "RectangularMask"),
    "SpectrumWavelengthMask": ("light.light", "SpectrumWavelengthMask"),
    "Absorber": ("material.component", "Absorber"),
    "Luminophore": ("material.component", "Luminophore"),
    "Reactor": ("material.component", "Reactor"),
    "Scatterer": ("material.component", "Scatterer"),
    "Distribution": ("material.distribution", "Distribution"),
    "Material": ("material.material", "Material"),
    "FacetOverride": ("material.surface", "FacetOverride"),
    "FacetOverrideSurfaceDelegate": ("material.surface", "FacetOverrideSurfaceDelegate"),
    "Surface": ("material.surface", "Surface"),
    "OVERRIDE_ABSORB": ("material.surface", "OVERRIDE_ABSORB"),
    "OVERRIDE_LAMBERTIAN_MIRROR": ("material.surface", "OVERRIDE_LAMBERTIAN_MIRROR"),
    "OVERRIDE_MIRROR": ("material.surface", "OVERRIDE_MIRROR"),
    "Cone": ("material.utils", "Cone"),
    "HenyeyGreenstein": ("material.utils", "HenyeyGreenstein"),
    "cone": ("material.utils", "cone"),
    "isotropic": ("material.utils", "isotropic"),
    "lambertian": ("material.utils", "lambertian"),
    "Node": ("scene.node", "Node"),
    "Scene": ("scene.scene", "Scene"),
    "Heatmap": ("engine.recorder", "Heatmap"),
    "Histogram": ("engine.recorder", "Histogram"),
    "Recorder": ("engine.recorder", "Recorder"),
    "lumogen_f_red_305": ("data.lumogen_f_red_305", None),
}


def api(ns=None):
    """The scene-building names of package `ns` (None: this package)."""
    pkg = __name__.rpartition(".")[0] if ns is None else ns.__name__
    out = {}
    for name, (path, attr) in _NAMES.items():
        module = importlib.import_module(f"{pkg}.{path}")
        out[name] = module if attr is None else getattr(module, attr)
    return SimpleNamespace(**out)


def lsc_slab(ns=None):
    """The LSC benchmark scene of the JAX package's ``bench.py``: a 5x5x1
    cm slab (n = 1.5) with a Lumogen F Red 305 dye (peak absorption 10
    cm^-1, quantum yield 0.9) and a 0.3 cm^-1 background absorber, in a
    25 cm world sphere, lit by a 555 nm cone (20 degrees) from 3 cm above."""
    p = api(ns)
    x = np.arange(400, 801, dtype=float)
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=25.0, material=p.Material(refractive_index=1.0)),
    )
    p.Node(
        name="lsc",
        geometry=p.Box(
            (5.0, 5.0, 1.0),
            material=p.Material(
                refractive_index=1.5,
                components=[
                    p.Luminophore(
                        coefficient=np.column_stack(
                            (x, p.lumogen_f_red_305.absorption(x) * 10.0)
                        ),
                        emission=np.column_stack((x, p.lumogen_f_red_305.emission(x))),
                        quantum_yield=0.9,
                        name="dye",
                    ),
                    p.Absorber(0.3, name="background"),
                ],
            ),
        ),
        parent=world,
    )
    light = p.Node(
        name="light",
        light=p.Light(
            direction=functools.partial(p.cone, np.radians(20)),
            wavelength=p.ConstantWavelengthMask(555.0),
        ),
        parent=world,
    )
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


def _slab_node(scene):
    return next(n for n in scene.root.iter_preorder() if n.name == "lsc")


def lsc_slab_recorders(n_rec, ns=None):
    """The LSC slab with `n_rec` recorders on the slab, as the JAX
    package's ``benchmarks/benchmark_recorders.py`` builds it: events
    cycle escaping / entering / reflected / lost, facets cycle the six
    axis normals (a lost recorder has none), and every recorder keeps a
    50-bin wavelength histogram over [400, 800) nm."""
    p = api(ns)
    scene = lsc_slab(ns)
    events = ["escaping", "entering", "reflected", "lost"]
    faces = [(0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)]
    recs = []
    for i in range(n_rec):
        event = events[i % len(events)]
        recs.append(p.Recorder(
            f"r{i:03d}",
            event=event,
            facet=faces[i % len(faces)] if event != "lost" else None,
            histograms=[p.Histogram("wavelength", 400.0, 800.0, 50)],
        ))
    _slab_node(scene).recorders = recs
    return scene


def lsc_slab_heatmap(bins=200, ns=None):
    """The LSC slab with two recorders whose histograms are larger than a
    block's shared memory: where photons leave the top face (a `bins` x
    `bins` heatmap of local x, y) and where the slab loses them (x, y, z
    histograms and a depth-by-wavelength heatmap)."""
    p = api(ns)
    scene = lsc_slab(ns)
    _slab_node(scene).recorders = [
        p.Recorder(
            "top", event="escaping", facet=(0, 0, 1),
            histograms=[p.Heatmap("x", "y", (-2.5, 2.5, bins), (-2.5, 2.5, bins)),
                        p.Histogram("angle", 0.0, 1.6, 32)],
        ),
        p.Recorder(
            "lost", event="lost",
            histograms=[p.Histogram("x", -2.5, 2.5, 40), p.Histogram("y", -2.5, 2.5, 40),
                        p.Histogram("z", -0.5, 0.5, 20),
                        p.Heatmap("z", "wavelength", (-0.5, 0.5, 20), (550.0, 750.0, 40))],
        ),
    ]
    return scene


def mixed_scene(ns=None):
    """A cylinder with an HG scatterer and a reactor beside a dyed plate
    whose faces carry mirror, absorb and Lambertian-mirror overrides; two
    lights, so photons alternate between them."""
    p = api(ns)
    x = np.arange(400, 801, dtype=float)
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=12.0, material=p.Material(refractive_index=1.0)),
    )
    overrides = p.FacetOverrideSurfaceDelegate([
        p.FacetOverride((0.0, 0.0, -1.0), p.OVERRIDE_MIRROR),
        p.FacetOverride((1.0, 0.0, 0.0), p.OVERRIDE_ABSORB),
        p.FacetOverride((0.0, -1.0, 0.0), p.OVERRIDE_LAMBERTIAN_MIRROR),
    ])
    p.Node(
        name="plate",
        geometry=p.Box(
            (4.0, 4.0, 0.5),
            material=p.Material(
                refractive_index=1.5,
                surface=p.Surface(overrides),
                components=[
                    p.Luminophore(
                        coefficient=np.column_stack(
                            (x, p.lumogen_f_red_305.absorption(x) * 4.0)
                        ),
                        emission=np.column_stack((x, p.lumogen_f_red_305.emission(x))),
                        quantum_yield=0.95,
                        tau_rad=1e-9,
                        name="dye",
                    ),
                    p.Scatterer(0.2, phase_function=p.HenyeyGreenstein(0.5), name="haze"),
                ],
            ),
        ),
        parent=world,
    )
    rod = p.Node(
        name="rod",
        geometry=p.Cylinder(
            length=2.0, radius=0.6,
            material=p.Material(
                refractive_index=1.4,
                components=[
                    p.Reactor(0.6, name="reactor"),
                    p.Scatterer(0.8, phase_function=p.HenyeyGreenstein(-0.4), name="hg"),
                    p.Absorber(0.1, tau_nr=2e-9, name="grey"),
                ],
            ),
        ),
        parent=world,
    )
    rod.translate((0.0, 0.0, 3.0))
    rod.rotate(np.radians(90.0), (1.0, 0.0, 0.0))
    top = p.Node(
        name="top-lamp",
        light=p.Light(position=p.RectangularMask(1.5, 1.5), direction=p.Cone(np.radians(25.0))),
        parent=world,
    )
    top.translate((0.0, 0.0, 6.0))
    top.rotate(np.radians(180.0), (1.0, 0.0, 0.0))
    side = p.Node(name="side-lamp", light=p.Light(position=p.CircularMask(0.4)), parent=world)
    side.translate((-4.0, 0.0, 3.0))
    side.rotate(np.radians(90.0), (0.0, 1.0, 0.0))
    return p.Scene(world)


def tetrahedron(ns=None):
    """A glass tetrahedron mesh in a world sphere with a default lamp at
    the origin (the port's compiler takes it; its tracer does not trace
    meshes yet)."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=5.0, material=p.Material(refractive_index=1.0)))
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    p.Node(name="tet", geometry=p.Mesh((v, f), material=p.Material(refractive_index=1.3)),
           parent=world)
    p.Node(name="lamp", light=p.Light(), parent=world)
    return p.Scene(world)
