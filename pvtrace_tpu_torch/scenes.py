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
    "NullSurfaceDelegate": ("material.surface", "NullSurfaceDelegate"),
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


def lsc_slab(ns=None, scale_bg=1.0):
    """The LSC benchmark scene of the JAX package's ``bench.py``: a 5x5x1
    cm slab (n = 1.5) with a Lumogen F Red 305 dye (peak absorption 10
    cm^-1, quantum yield 0.9) and a 0.3 cm^-1 background absorber, in a
    25 cm world sphere, lit by a 555 nm cone (20 degrees) from 3 cm above.
    `scale_bg` multiplies the background absorber: the scene that
    ``examples/optimize_lsc.py`` builds for ``optimize_concentration``."""
    p = api(ns)
    return _slab_scene(p, p.Box((5.0, 5.0, 1.0), material=_slab_material(p, scale_bg)))


def _slab_material(p, scale_bg=1.0):
    x = np.arange(400, 801, dtype=float)
    return p.Material(
        refractive_index=1.5,
        components=[
            p.Luminophore(
                coefficient=np.column_stack((x, p.lumogen_f_red_305.absorption(x) * 10.0)),
                emission=np.column_stack((x, p.lumogen_f_red_305.emission(x))),
                quantum_yield=0.9,
                name="dye",
            ),
            p.Absorber(0.3 * scale_bg, name="background"),
        ],
    )


def _slab_scene(p, geometry):
    """`geometry` as the node "lsc" in the bench slab's world and light."""
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=25.0, material=p.Material(refractive_index=1.0)),
    )
    p.Node(name="lsc", geometry=geometry, parent=world)
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


def lsc_slab_host(ns=None, n_rec=0):
    """The bench slab (``lsc_slab``: the same box, dye, background and 20
    degree cone from the same pose) under a lamp whose wavelengths come
    from a spectrum tabulated in 10 nm bins, flat over 400-700 nm
    (``Distribution(x, y, hist=True)``), as a lamp or solar spectrum is
    often given. The compilers lower no histogram spectrum to a device
    sampler, so its photons are emitted on the host (``engine/emit.py``).
    `n_rec` recorders on the slab as ``lsc_slab_recorders`` puts them."""
    p = api(ns)
    scene = _slab_scene(p, p.Box((5.0, 5.0, 1.0), material=_slab_material(p)))
    x = np.arange(400.0, 700.0, 10.0)
    lamp = next(n for n in scene.root.iter_preorder() if n.name == "light")
    lamp.light.wavelength = p.SpectrumWavelengthMask(p.Distribution(x, np.ones_like(x), hist=True))
    _slab_node(scene).recorders = _slab_recorders(p, n_rec)
    return scene


def lsc_tiles(ns=None, tiles=8, dyes=5):
    """A row of `tiles` 1 cm LSC cubes (n = 1.5) 1 mm apart, each with
    `dyes` Lumogen F Red 305 luminophores of graded strength (10 cm^-1
    peak in all, quantum yield 0.9) and a 0.3 cm^-1 background absorber,
    in a world sphere of 25 cm (1.1 cm a tile past 22 tiles, so that the
    row stays inside it), lit by a 555 nm lamp over the row (a 20
    degree cone from a rectangle 3 cm above). Every component is fitted on
    its own, so the K5a table grows with tiles x dyes: at the defaults 40
    luminophores, over 100 KB, more than the trace kernel's shared-memory
    budget of a block (``kSharedTallyLimit``), and each node has more
    components than a step holds in registers (``kHeldSlots``)."""
    p = api(ns)
    x = np.arange(400, 801, dtype=float)
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=max(25.0, 1.1 * tiles),
                          material=p.Material(refractive_index=1.0)),
    )
    for i in range(tiles):
        comps = [
            p.Luminophore(
                coefficient=np.column_stack(
                    (x, p.lumogen_f_red_305.absorption(x) * (10.0 / dyes) * (0.8 + 0.1 * j))
                ),
                emission=np.column_stack((x, p.lumogen_f_red_305.emission(x))),
                quantum_yield=0.9,
                name=f"dye{i}-{j}",
            )
            for j in range(dyes)
        ]
        comps.append(p.Absorber(0.3, name=f"background{i}"))
        tile = p.Node(
            name=f"tile{i}",
            geometry=p.Box((1.0, 1.0, 1.0),
                           material=p.Material(refractive_index=1.5, components=comps)),
            parent=world,
        )
        tile.translate((1.1 * (i - (tiles - 1) / 2), 0.0, 0.0))
    light = p.Node(
        name="light",
        light=p.Light(
            position=p.RectangularMask(0.55 * tiles, 0.5),
            direction=functools.partial(p.cone, np.radians(20)),
            wavelength=p.ConstantWavelengthMask(555.0),
        ),
        parent=world,
    )
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


def touching_scene(ns=None, n1=1.5, n2=1.5, n3=1.5):
    """Three unit glass boxes stacked along +z with coincident faces, in a
    10 cm world sphere (the JAX package's
    ``tests/test_touching_engine.py::touching_scene``)."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=10.0, material=p.Material(refractive_index=1.0)))
    for name, n, dz in (("box1", n1, 0.0), ("box2", n2, 1.0), ("box3", n3, 2.0)):
        node = p.Node(name=name, parent=world,
                      geometry=p.Box((1.0, 1.0, 1.0), material=p.Material(refractive_index=n)))
        node.translate((0.0, 0.0, dz))
    return p.Scene(world)


def embedded_scene(ns=None, n1=1.5):
    """One unit glass box in a 10 cm world sphere (the JAX package's
    ``tests/test_touching_engine.py::embedded_scene``)."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=10.0, material=p.Material(refractive_index=1.0)))
    p.Node(name="box", parent=world,
           geometry=p.Box((1.0, 1.0, 1.0), material=p.Material(refractive_index=n1)))
    return p.Scene(world)


def _slab_node(scene):
    return next(n for n in scene.root.iter_preorder() if n.name == "lsc")


def _collimated_slab(p, material):
    """A 2x2x1 cm box of `material` in a 10 cm world sphere, lit straight
    down by a 555 nm default lamp from 3 cm above (``tests/test_diff.py``)."""
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=10.0, material=p.Material(refractive_index=1.0)),
    )
    p.Node(name="slab", parent=world, geometry=p.Box((2.0, 2.0, 1.0), material=material))
    light = p.Node(name="light", parent=world,
                   light=p.Light(wavelength=p.ConstantWavelengthMask(555.0)))
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


def absorber_slab(alpha=0.8, ns=None):
    """Collimated light through a null-surface slab with one absorber: no
    reflection, no refraction, so P(absorb) = 1 - exp(-alpha L) exactly
    and its derivative in log(alpha) is alpha L exp(-alpha L) (the JAX
    package's ``tests/test_diff.py::slab_scene``)."""
    p = api(ns)
    return _collimated_slab(p, p.Material(
        refractive_index=1.0, surface=p.Surface(delegate=p.NullSurfaceDelegate()),
        components=[p.Absorber(alpha)],
    ))


def absorbing_box(ns=None):
    """A 2x2x1 absorbing box (n = 1.5, 0.5 cm^-1) in a 10 cm world sphere
    under a 555 nm lamp, with an escaping recorder (a 40-bin wavelength
    histogram) and a lost one: the scene of the JAX package's
    ``tests/test_checkpoint.py::make_scene``, on which streams and
    checkpoints are checked."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=10.0, material=p.Material(refractive_index=1.0)))
    box = p.Node(name="box", parent=world, geometry=p.Box(
        (2.0, 2.0, 1.0), material=p.Material(refractive_index=1.5, components=[p.Absorber(0.5)])))
    box.recorders = [
        p.Recorder("escape", event="escaping",
                   histograms=[p.Histogram("wavelength", 400, 800, 40)]),
        p.Recorder("lost", event="lost"),
    ]
    light = p.Node(name="light", parent=world,
                   light=p.Light(wavelength=p.ConstantWavelengthMask(555.0)))
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


def fresnel_slab(n_slab=1.5, alpha=0.5, ns=None):
    """Collimated normal-incidence light on a Fresnel slab with an
    absorber: every surface coin is R = ((n-1)/(n+1))^2 and the path
    geometry does not depend on n, so d(fate)/dn is analytic (the JAX
    package's ``tests/test_diff.py::fresnel_slab_scene``)."""
    p = api(ns)
    return _collimated_slab(p, p.Material(refractive_index=n_slab,
                                          components=[p.Absorber(alpha)]))


def pathwise_slab(fresnel, alpha=0.8, ns=None):
    """The collimated 2x2x1 cm absorber slab, index-matched behind a null
    surface (``fresnel`` False: P(absorb) = 1 - exp(-alpha L)) or a Fresnel
    slab of n = 1.5 (a geometric series in R and exp(-alpha L)): the
    analytic d P(absorb) / d L of the JAX package's
    ``tests/test_diff.py::test_pathwise_geometry_gradient_matches_analytic``
    (its nested ``slab``)."""
    p = api(ns)
    return _collimated_slab(p, p.Material(
        refractive_index=1.5 if fresnel else 1.0,
        surface=p.Surface() if fresnel else p.Surface(delegate=p.NullSurfaceDelegate()),
        components=[p.Absorber(alpha)],
    ))


def tilted_fresnel_slab(n_slab=1.5, alpha=0.5, tilt_deg=30.0, ns=None):
    """Oblique incidence on a 4x4x1 cm Fresnel absorber slab tilted by
    `tilt_deg` about x: the Fresnel coins and the chord both depend on n
    (Snell), so the full d(fate)/dn needs the pathwise channel (the JAX
    package's ``tests/test_diff.py::tilted_fresnel_slab``)."""
    p = api(ns)
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=10.0, material=p.Material(refractive_index=1.0)),
    )
    slab = p.Node(
        name="slab", parent=world,
        geometry=p.Box((4.0, 4.0, 1.0), material=p.Material(
            refractive_index=n_slab, components=[p.Absorber(alpha)])),
    )
    slab.rotate(np.radians(tilt_deg), (1, 0, 0))
    light = p.Node(name="light", parent=world,
                   light=p.Light(wavelength=p.ConstantWavelengthMask(555.0)))
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)


def lsc_slab_recorders(n_rec, ns=None):
    """The LSC slab with `n_rec` recorders on the slab, as the JAX
    package's ``benchmarks/benchmark_recorders.py`` builds it: events
    cycle escaping / entering / reflected / lost, facets cycle the six
    axis normals (a lost recorder has none), and every recorder keeps a
    50-bin wavelength histogram over [400, 800) nm."""
    scene = lsc_slab(ns)
    _slab_node(scene).recorders = _slab_recorders(api(ns), n_rec)
    return scene


def _slab_recorders(p, n_rec):
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
    return recs


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
    the origin, on vertex 0, shining along an edge."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=5.0, material=p.Material(refractive_index=1.0)))
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    p.Node(name="tet", geometry=p.Mesh((v, f), material=p.Material(refractive_index=1.3)),
           parent=world)
    p.Node(name="lamp", light=p.Light(), parent=world)
    return p.Scene(world)


def _outward(vertices, faces):
    """`faces` wound so that every face normal points away from the
    centroid (right for star-shaped meshes)."""
    faces = np.array(faces, dtype=np.int64)
    v0 = vertices[faces[:, 0]]
    n = np.cross(vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0)
    out = vertices[faces].mean(axis=1) - vertices.mean(axis=0)
    flip = np.einsum("ij,ij->i", n, out) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return faces


def mesh_small(ns=None):
    """The parity scene of the mesh path: a glass tetrahedron (edge 2 cm,
    n = 1.5) with a constant absorber and an isotropic scatterer, a
    mirror on its -x face and two recorders (escaping through the
    slanted face, entering anywhere), lit from 1.5 cm below by a 10
    degree cone that lands inside the bottom face, away from its edges
    and vertices."""
    p = api(ns)
    world = p.Node(name="world",
                   geometry=p.Sphere(radius=5.0, material=p.Material(refractive_index=1.0)))
    v = 2.0 * np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    mirror = p.FacetOverrideSurfaceDelegate(
        [p.FacetOverride((-1.0, 0.0, 0.0), p.OVERRIDE_MIRROR, atol=1e-3)]
    )
    tet = p.Node(
        name="tet",
        geometry=p.Mesh((v, f), material=p.Material(
            refractive_index=1.5,
            surface=p.Surface(mirror),
            components=[p.Absorber(0.4, name="grey"), p.Scatterer(1.5, name="haze")],
        )),
        parent=world,
    )
    slant = tuple(float(c) for c in np.full(3, 1.0 / np.sqrt(3.0)))
    tet.recorders = [
        p.Recorder("slant", event="escaping", facet=slant, atol=1e-3),
        p.Recorder("in", event="entering"),
    ]
    lamp = p.Node(name="lamp", light=p.Light(direction=functools.partial(p.cone, np.radians(10))),
                  parent=world)
    lamp.translate((0.0, 0.0, -1.5))
    return p.Scene(world)


def mesh_slab_fine(ns=None):
    """The bench slab as a closed mesh: the 5x5x1 cm box with its faces cut
    into 1 cm squares, two triangles each (140 triangles, more than the
    JAX package unrolls), with the bench slab's material, world and light."""
    p = api(ns)
    corners = np.array([[x, y, z] for x in range(6) for y in range(6) for z in (0, 1)], float)
    index = {tuple(c): i for i, c in enumerate(corners)}
    vertices = corners - np.array([2.5, 2.5, 0.5])
    faces = []

    def square(a, b, c, d):
        ids = [index[tuple(q)] for q in (a, b, c, d)]
        faces.extend([(ids[0], ids[1], ids[2]), (ids[0], ids[2], ids[3])])

    for i in range(5):
        for j in range(5):
            for z in (0, 1):
                square((i, j, z), (i + 1, j, z), (i + 1, j + 1, z), (i, j + 1, z))
        for fixed in (0, 5):
            square((fixed, i, 0), (fixed, i + 1, 0), (fixed, i + 1, 1), (fixed, i, 1))
            square((i, fixed, 0), (i + 1, fixed, 0), (i + 1, fixed, 1), (i, fixed, 1))
    mesh = (vertices, _outward(vertices, faces))
    return _slab_scene(p, p.Mesh(mesh, material=_slab_material(p)))


def hex_plate(radius=4.0, thickness=1.0):
    """Closed hexagonal-plate triangle mesh with outward windings (24
    triangles; ``examples/mesh_lsc.py``)."""
    ang = np.arange(6) * np.pi / 3.0
    h = 0.5 * thickness
    ring = np.column_stack([radius * np.cos(ang), radius * np.sin(ang)])
    vertices = np.vstack([
        [0.0, 0.0, h], [0.0, 0.0, -h],
        np.column_stack([ring, np.full(6, h)]),
        np.column_stack([ring, np.full(6, -h)]),
    ])
    faces = []
    for k in range(6):
        k2 = (k + 1) % 6
        faces.append((0, 2 + k, 2 + k2))  # top fan (+z)
        faces.append((1, 8 + k2, 8 + k))  # bottom fan (-z)
        faces.append((2 + k, 8 + k, 8 + k2))  # side lower
        faces.append((2 + k, 8 + k2, 2 + k2))  # side upper
    return vertices, _outward(vertices, faces)


def edge_normals():
    """Outward normals of the hex plate's six edge facets (local frame)."""
    ang = np.arange(6) * np.pi / 3.0 + np.pi / 6.0
    return [(float(np.cos(a)), float(np.sin(a)), 0.0) for a in ang]


def mesh_lsc(ns=None, radius=4.0, thickness=1.0, dye_peak=5.0, bg=0.1):
    """The mesh LSC of ``examples/mesh_lsc.py`` (``build_mesh_lsc``): a
    24-triangle hexagonal plate (n = 1.5) with Lumogen F Red 305 dye and
    a background absorber, a mirror on its bottom faces, ideal solar
    cells (absorbing facet overrides) on its six edges, a recorder on each
    cell and one on the top face; a 555 nm cone light (20 degrees) above."""
    p = api(ns)
    x = np.arange(400, 801, dtype=float)
    overrides = [p.FacetOverride((0.0, 0.0, -1.0), p.OVERRIDE_MIRROR, atol=1e-3)]
    overrides += [p.FacetOverride(nrm, p.OVERRIDE_ABSORB, atol=1e-3) for nrm in edge_normals()]
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=radius * 25.0, material=p.Material(refractive_index=1.0)),
    )
    plate = p.Node(
        name="plate",
        parent=world,
        geometry=p.Mesh(
            hex_plate(radius, thickness),
            material=p.Material(
                refractive_index=1.5,
                surface=p.Surface(delegate=p.FacetOverrideSurfaceDelegate(overrides)),
                components=[
                    p.Luminophore(
                        np.column_stack((x, dye_peak * p.lumogen_f_red_305.absorption(x))),
                        emission=np.column_stack((x, p.lumogen_f_red_305.emission(x))),
                        quantum_yield=0.95,
                        name="dye",
                    ),
                    p.Absorber(bg, name="background"),
                ],
            ),
        ),
    )
    plate.recorders = [
        p.Recorder(f"cell_{i}", event="escaping", facet=nrm, atol=1e-3)
        for i, nrm in enumerate(edge_normals())
    ] + [p.Recorder("incident", event="entering", facet=(0.0, 0.0, 1.0))]
    light = p.Node(
        name="light",
        parent=world,
        light=p.Light(
            direction=functools.partial(p.cone, np.radians(20)),
            wavelength=p.ConstantWavelengthMask(555.0),
        ),
    )
    light.translate((0.0, 0.0, thickness * 2.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return p.Scene(world)



# -- random scenes: disjoint, nested and touching nodes -------------------

# What ``random_scene`` draws from (its coverage of seeds 0-19 is a test).
RANDOM_SOLIDS = ("box", "sphere", "cylinder")
RANDOM_MESHES = ("tetrahedron", "cube")
RANDOM_COMPONENTS = ("absorber", "isotropic", "hg", "luminophore", "reactor")
RANDOM_MASKS = ("point", "rectangle", "circle", "cube")
RANDOM_EMIT = ("kT", "redshift", "full")
RANDOM_RAYS = 16
# The corner tetrahedron of ``tetrahedron()`` and the unit cube mesh of
# the JAX package's tests/test_mesh_engine.py.
_MESHES = {
    "tetrahedron": (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float),
                    np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])),
    "cube": (np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                       [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], dtype=float) / 2.0,
             np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                       [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])),
}
_AXES = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
         (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))


def random_scene(seed, ns=None, matched=False, probes=False):
    """A seeded random scene of disjoint, nested and touching nodes.

    Every draw comes from ``np.random.default_rng(seed)``, so the same
    seed builds the same scene from any package's classes (`ns`, as every
    scene here). A world sphere (radius 10-50, n = 1) holds 2-6 boxes,
    spheres and cylinders and, in one seed of four, a mesh (the corner
    tetrahedron or a cube). Nodes are disjoint (bounding spheres apart),
    nested up to three levels (a child's bounding sphere inside its
    parent's inscribed sphere), or, in even seeds, 2-3 boxes that share
    faces under one geometry-less group node with a random rigid
    transform; every node has a random rotation and translation, and a
    draw that would overlap another is drawn again. Materials: n in
    [1, 2] (some neighbours share it), components from none, Absorber,
    isotropic and Henyey-Greenstein Scatterers, Luminophores (Lumogen F
    Red 305 or Gaussian spectra, quantum yield 0.5-1; each with a
    background absorber, so that no photon is trapped for good) and
    Reactors; facet overrides (mirror, absorb, Lambertian mirror) on some
    free boxes; escaping and entering recorders, with and without a
    facet. 1-2 lights, outside the nodes aimed at one or inside a dyed
    leaf node, with point, rectangular, circular and cube position
    masks, cone or Lambertian directions and constant or spectral
    wavelengths. With `matched` the geometry is the same, but every node
    has the world's n, no component and no override: every crossing is
    then a deterministic TRANSMIT. With `probes` each face two touching
    boxes share carries four facet recorders more (``probe-LO-HI-*``),
    with no draw of their own, so the scene is otherwise the same: for
    crossings upward (LO to HI) the lower box's escaping and the upper
    box's entering recorder on that face, for crossings downward the
    upper's escaping and the lower's entering one. Rounding picks which
    of the two surfaces a crossing hits, so each pair's sum counts every
    crossing of its direction whichever surface was hit.

    Returns a namespace: ``scene``; ``options``, the run's
    ``emit_method``, ``maxsteps`` and ``maxpathlength`` (None: no cap),
    as ``simulate`` takes them; ``rays``, RANDOM_RAYS crafted start rays
    (world positions and unit directions, [16, 3] each) from node centres
    at every nesting level, across touching faces and from outside toward
    nodes; ``features``, what the scene holds; ``scale``, the world
    radius; ``coincident``, the names of the nodes that share a face;
    ``probes``, with `probes` the names of each pair of probe recorders
    (escaping, entering) whose crossings sum to the same in any build, else
    empty."""
    plan = _random_plan(int(seed))
    pairs = _probe_pairs(plan) if probes else ()
    return SimpleNamespace(scene=_build_random(api(ns), plan, matched, pairs),
                           options=dict(plan["options"]), rays=plan["rays"],
                           features=plan["features"], scale=plan["radius"],
                           coincident=tuple(it["name"] for it in plan["items"]
                                            if it["name"].startswith("t")),
                           probes=tuple((a[1], b[1]) for a, b in pairs))


def _probe_pairs(plan):
    """The probe recorders of ``random_scene(probes=True)``: for each face
    two touching boxes share (its outward world normal `up` from the lower
    box), two pairs ((node, name, event, facet), (node, name, event,
    facet)), the upward crossing's and the downward one's."""
    pairs = []
    for lo, hi, up in plan["faces"]:
        down = tuple(-c for c in up)
        tag = f"probe-{lo}-{hi}"
        pairs.append(((lo, f"{tag}-up-out", "escaping", up),
                      (hi, f"{tag}-up-in", "entering", down)))
        pairs.append(((hi, f"{tag}-down-out", "escaping", down),
                      (lo, f"{tag}-down-in", "entering", up)))
    return tuple(pairs)


def _rotation(rng):
    """A uniform random rotation (a normalised Gaussian quaternion)."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _pose(rotation, offset):
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = rotation, offset
    return m


def _unit(rng):
    v = rng.normal(size=3)
    return v / np.linalg.norm(v)


def _in_ball(rng, radius):
    return _unit(rng) * radius * rng.random() ** (1.0 / 3.0)


def _mesh_radii(kind):
    """(bounding, inscribed) radius of the unit mesh `kind` about its
    vertex mean (``Mesh`` recentres there)."""
    v, f = _MESHES[kind]
    v = v - v.mean(axis=0)
    normals = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    normals /= np.linalg.norm(normals, axis=1)[:, None]
    inner = np.abs(np.einsum("ij,ij->i", normals, v[f[:, 0]])).min()
    return float(np.linalg.norm(v, axis=1).max()), float(inner)


def _shape(item):
    """Set `item`'s dimensions and inscribed radius from its bounding
    radius ``rb`` and shape draws."""
    kind, rb, a = item["kind"], item["rb"], item["aspect"]
    if kind == "sphere":
        item["dims"], item["ri"] = (rb,), rb
    elif kind == "box":
        h = rb * a / np.linalg.norm(a)
        item["dims"], item["ri"] = tuple(2.0 * h), float(h.min())
    elif kind == "cylinder":
        r, hl = rb * np.cos(a[0]), rb * np.sin(a[0])
        item["dims"], item["ri"] = (2.0 * hl, r), min(r, hl)
    elif kind == "group":
        h = np.concatenate([a[:2], [a[2:].sum()]])
        s = rb / np.linalg.norm(h)
        item["dims"], item["ri"] = tuple(s * a), 0.0
    else:
        unit_rb, unit_ri = _mesh_radii(kind)
        item["dims"], item["ri"] = (rb / unit_rb,), rb / unit_rb * unit_ri


def _place(rng, children, items, container, radius):
    """Draw the offsets (in the container's frame) and rotations of
    `children`, disjoint with gaps: in the world, within a central region
    that widens with every failed draw; in `container`, within its
    inscribed sphere, a child shrinking by 3 % every 200 failed draws."""
    placed = []
    for c in children:
        item = items[c]
        tries = 0
        while True:
            if container is None:
                reach = min(0.6 * radius - item["rb"], 1.0 + 2.0 * item["rb"] + 0.05 * tries)
                gap = 0.3
            else:
                item["rb"] = item["fraction"] * items[container]["ri"] * 0.97 ** (tries // 200)
                reach = 0.92 * items[container]["ri"] - item["rb"]
                gap = 0.05 * items[container]["ri"]
            centre = _in_ball(rng, reach)
            if all(np.linalg.norm(centre - items[o]["centre"]) >= item["rb"] + items[o]["rb"] + gap
                   for o in placed):
                break
            tries += 1
        item["centre"] = centre
        _shape(item)
        item["pose"] = _pose(_rotation(rng), centre)
        placed.append(c)


def _random_plan(seed):
    """Every draw of ``random_scene(seed)``, as plain data."""
    rng = np.random.default_rng(seed)
    radius = float(rng.uniform(10.0, 50.0))
    n_solids = int(rng.integers(2, 7))
    k_touch = min(int(rng.integers(2, 4)), n_solids) if seed % 2 == 0 else 0
    deep = seed % 5 == 0
    n_free = max(n_solids - k_touch, 3 if deep else 0)
    mesh = RANDOM_MESHES[(seed // 4) % 2] if seed % 4 == 3 else None

    # Geometry items: free solids, then the touching group, then the mesh.
    items = []

    def add(kind, parent, aspect):
        level = 1 if parent is None else items[parent]["level"] + 1
        item = {"name": None, "kind": kind, "parent": parent, "level": level,
                "aspect": aspect, "fraction": float(rng.uniform(0.35, 0.6))}
        if parent is None:
            item["rb"] = float(rng.uniform(0.8, 2.2))
        items.append(item)
        return item

    def pick_parent(p):
        hosts = [j for j, it in enumerate(items) if it["kind"] in RANDOM_SOLIDS and it["level"] < 3]
        return hosts[int(rng.integers(len(hosts)))] if hosts and rng.random() < p else None

    for i in range(n_free):
        kind = "sphere" if deep and i < 2 else RANDOM_SOLIDS[int(rng.integers(3))]
        parent = i - 1 if deep and 0 < i < 3 else pick_parent(0.4) if i else None
        aspect = (rng.uniform(0.5, 1.0, 3) if kind == "box"
                  else np.array([rng.uniform(0.35, 1.2)]) if kind == "cylinder" else None)
        add(kind, parent, aspect)
        items[-1]["name"] = f"s{i}"
    if k_touch:
        group = add("group", pick_parent(0.3),
                    np.concatenate([rng.uniform(0.5, 1.0, 2), rng.uniform(0.3, 0.8, k_touch)]))
        group["name"] = "g0"
    if mesh is not None:
        add(mesh, pick_parent(0.5), None)["name"] = "m0"
    for c in [None] + list(range(len(items))):
        _place(rng, [j for j, it in enumerate(items) if it["parent"] == c], items, c, radius)

    # World frames; the touching boxes, stacked along their group's z.
    world_of = {}
    for j, item in enumerate(items):
        up = np.eye(4) if item["parent"] is None else world_of[item["parent"]]
        world_of[j] = up @ item["pose"]
    geometry = [j for j, it in enumerate(items) if it["kind"] != "group"]
    boxes = []
    if k_touch:
        g = next(j for j, it in enumerate(items) if it["kind"] == "group")
        hx, hy, *hz = items[g]["dims"]
        z = -sum(hz)
        for k, h in enumerate(hz):
            boxes.append({"name": f"t{k}", "kind": "box", "parent": g,
                          "level": items[g]["level"], "dims": (2 * hx, 2 * hy, 2 * h),
                          "ri": min(hx, hy, h), "rb": float(np.linalg.norm((hx, hy, h))),
                          "pose": _pose(np.eye(3), (0.0, 0.0, z + h))})
            z += 2 * h
        for b in boxes:
            world_of[len(items)] = world_of[g] @ b["pose"]
            items.append(b)
            geometry.append(len(items) - 1)
    up = tuple(float(c) for c in world_of[g][:3, 2]) if k_touch else None
    shared = [(lo["name"], hi["name"], up) for lo, hi in zip(boxes, boxes[1:])]
    solids = [j for j in geometry if items[j]["kind"] in RANDOM_SOLIDS]

    # Materials.
    touching = [j for j in geometry if items[j]["name"].startswith("t")]
    for idx, j in enumerate(geometry):
        item = items[j]
        if touching and j in touching[1:]:
            near = touching[touching.index(j) - 1]
        elif item["parent"] is not None and items[item["parent"]]["kind"] != "group":
            near = item["parent"]
        else:
            near = geometry[idx - 1] if idx else None
        share = near is not None and rng.random() < 0.3
        item["n"] = items[near]["n"] if share else float(rng.uniform(1.0, 2.0))
        kinds = [] if rng.random() < 0.3 else [
            RANDOM_COMPONENTS[k]
            for k in rng.choice(5, size=int(rng.integers(1, 3)), replace=False)]
        if idx == 0 and RANDOM_COMPONENTS[seed % 5] not in kinds:
            kinds.append(RANDOM_COMPONENTS[seed % 5])
        if "luminophore" in kinds and "absorber" not in kinds:
            kinds.append("absorber")
        comps = []
        for kind in kinds:
            alpha = float(rng.uniform(0.2, 1.5)) / (2.0 * item["rb"])
            if kind == "absorber" and "luminophore" in kinds:
                alpha = float(rng.uniform(0.1, 0.5)) / (2.0 * item["rb"])
            spec = {"kind": kind, "alpha": alpha, "name": f"{item['name']}-{kind}"}
            if kind == "hg":
                spec["g"] = float(rng.uniform(-0.7, 0.9))
            if kind == "luminophore":
                spec.update(lumogen=bool(rng.random() < 0.5), centre=float(rng.uniform(450, 550)),
                            shift=float(rng.uniform(60, 120)), qy=float(rng.uniform(0.5, 1.0)))
            comps.append(spec)
        item["components"] = comps
        item["overrides"] = []
        if item["kind"] == "box" and j not in touching and rng.random() < 0.35:
            faces = rng.choice(6, size=int(rng.integers(1, 4)), replace=False)
            item["overrides"] = [(_AXES[f], int(rng.integers(3))) for f in faces]
        recs = []
        if rng.random() < 0.35:
            for k in range(int(rng.integers(1, 3))):
                event = ("escaping", "entering")[int(rng.integers(2))]
                facet = (_AXES[int(rng.integers(6))]
                         if item["kind"] in ("box", "cube") and rng.random() < 0.6 else None)
                recs.append({"name": f"{item['name']}-r{k}", "event": event, "facet": facet,
                             "histogram": bool(rng.random() < 0.5)})
        item["recorders"] = recs

    # A photon that a scatterer, a luminophore or a Lambertian facet sends
    # off in a random direction can be trapped for good by total internal
    # reflection in any node it then enters from inside: every ancestor of
    # such a node and every box touching it. Those that have no component
    # get a background absorber.
    def ancestors(j):
        while items[j]["parent"] is not None:
            j = items[j]["parent"]
            yield j

    randomizing = [j for j in geometry if 2 in {m for _, m in items[j]["overrides"]} or any(
        c["kind"] in ("isotropic", "hg", "luminophore") for c in items[j]["components"])]
    reached = {a for j in randomizing for a in ancestors(j)}
    if any(j in touching for j in randomizing):
        reached.update(touching)
    for j in geometry:
        if j in reached and not items[j]["components"]:
            items[j]["components"] = [{
                "kind": "absorber", "alpha": float(rng.uniform(0.1, 0.5)) / (2.0 * items[j]["rb"]),
                "name": f"{items[j]['name']}-absorber"}]

    # Lights: inside a dyed leaf node, or outside every node aimed at one.
    tops = [j for j, it in enumerate(items) if it["parent"] is None]
    leaves = [j for j in geometry if items[j]["kind"] in ("box", "sphere", "cylinder")
              and not any(it["parent"] == j for it in items)
              and any(c["kind"] == "luminophore" for c in items[j]["components"])]
    lights = []
    for k in range(int(rng.integers(1, 3))):
        light = {"name": f"light{k}", "mask": RANDOM_MASKS[(seed + k) % 4],
                 "lambertian": bool(rng.random() < 0.3), "theta": float(rng.uniform(5.0, 40.0)),
                 "cone_class": bool(rng.random() < 0.5), "spectrum": bool(rng.random() < 0.4),
                 "wavelength": float(rng.uniform(430.0, 600.0))}
        if leaves and rng.random() < 0.5:
            host = leaves[int(rng.integers(len(leaves)))]
            light.update(parent=host, extent=0.3 * items[host]["ri"],
                         pose=_pose(_rotation(rng), np.zeros(3)))
        else:
            target = tops[int(rng.integers(len(tops)))]
            centre, rb = world_of[target][:3, 3], items[target]["rb"]
            dist = rb + float(rng.uniform(0.8, 2.5))
            for tries in range(1000):
                u = _unit(rng)
                pos = centre + (dist + 0.01 * tries) * u
                if all(np.linalg.norm(pos - world_of[o][:3, 3]) > items[o]["rb"] + 0.5
                       for o in tops) and np.linalg.norm(pos) < 0.8 * radius:
                    break
            z = -u
            x = np.cross(z, _unit(rng))
            x /= np.linalg.norm(x)
            light.update(parent=None, extent=min(0.5 * rb, 0.2),
                         pose=_pose(np.column_stack([x, np.cross(z, x), z]), pos))
        lights.append(light)

    # Crafted rays: from node centres, across touching faces, from outside.
    starts, dirs = [], []
    for j in geometry[:8]:
        starts.append(world_of[j][:3, 3])
        dirs.append(_unit(rng))
    for k in range(len(boxes) - 1):
        lo, hi = geometry[len(geometry) - len(boxes) + k:][:2]
        up = world_of[lo][:3, 2]
        tilt = 0.5 * min(items[lo]["dims"][:2]) / max(items[lo]["dims"][2], items[hi]["dims"][2])
        side = world_of[lo][:3, :2] @ rng.uniform(-tilt, tilt, 2)
        for j, sign in ((lo, 1.0), (hi, -1.0)):
            d = sign * up + side
            starts.append(world_of[j][:3, 3])
            dirs.append(d / np.linalg.norm(d))
    while len(starts) < RANDOM_RAYS:
        j = geometry[len(starts) % len(geometry)]
        aim = world_of[j][:3, 3] + 0.2 * items[j]["ri"] * _unit(rng)
        start = 0.9 * radius * _unit(rng)
        starts.append(start)
        dirs.append((aim - start) / np.linalg.norm(aim - start))

    options = {
        "emit_method": RANDOM_EMIT[seed % 3],
        "maxsteps": int(rng.integers(6, 21)) if seed % 5 == 1 or rng.random() < 0.1 else 1000,
        "maxpathlength": (float(rng.uniform(5.0, 40.0))
                          if seed % 5 == 2 or rng.random() < 0.1 else None),
    }
    recs = [r for j in geometry for r in items[j]["recorders"]]
    features = {
        "geometries": sorted({items[j]["kind"] for j in geometry}),
        "depth": max(items[j]["level"] for j in geometry),
        "touching": len(boxes),
        "components": sorted({c["kind"] for j in geometry for c in items[j]["components"]}),
        "overrides": sorted({m for j in geometry for _, m in items[j]["overrides"]}),
        "masks": sorted({light["mask"] for light in lights}),
        "lights_inside": sum(light["parent"] is not None for light in lights),
        "caps": sorted(k for k in ("maxsteps", "maxpathlength")
                       if options[k] not in (None, 1000)),
        "recorders": sorted({"facet" if r["facet"] else "no facet" for r in recs}),
        "nodes": len(geometry) + 1,
    }
    return {"radius": radius, "items": items, "geometry": geometry, "lights": lights,
            "rays": (np.array(starts[:RANDOM_RAYS]), np.array(dirs[:RANDOM_RAYS])),
            "options": options, "features": features, "faces": shared}


def _random_component(p, spec, x):
    name, alpha = spec["name"], spec["alpha"]
    if spec["kind"] == "absorber":
        return p.Absorber(alpha, name=name)
    if spec["kind"] == "reactor":
        return p.Reactor(alpha, name=name)
    if spec["kind"] == "isotropic":
        return p.Scatterer(alpha, name=name)
    if spec["kind"] == "hg":
        return p.Scatterer(alpha, phase_function=p.HenyeyGreenstein(spec["g"]), name=name)
    if spec["lumogen"]:
        absorption = p.lumogen_f_red_305.absorption(x)
        emission = p.lumogen_f_red_305.emission(x)
    else:
        absorption = np.exp(-0.5 * ((x - spec["centre"]) / 25.0) ** 2)
        emission = np.exp(-0.5 * ((x - spec["centre"] - spec["shift"]) / 30.0) ** 2)
    return p.Luminophore(coefficient=np.column_stack((x, alpha * absorption)),
                         emission=np.column_stack((x, emission)),
                         quantum_yield=spec["qy"], name=name)


def _build_random(p, plan, matched, probes=()):
    """The scene of `plan` (``_random_plan``) from the classes of `p`, with
    the probe recorders `probes` (``_probe_pairs``)."""
    extra = {}
    for pair in probes:
        for node, name, event, facet in pair:
            extra.setdefault(node, []).append(
                p.Recorder(name, event=event, facet=facet, atol=1e-3))
    x = np.arange(400, 801, dtype=float)
    world = p.Node(name="world", geometry=p.Sphere(
        radius=plan["radius"], material=p.Material(refractive_index=1.0)))
    made = []
    for item in plan["items"]:
        parent = world if item["parent"] is None else made[item["parent"]]
        if item["kind"] == "group":
            made.append(p.Node(name=item["name"], parent=parent))
            made[-1].pose = item["pose"]
            continue
        surface = None
        if item["overrides"] and not matched:
            surface = p.Surface(p.FacetOverrideSurfaceDelegate([
                p.FacetOverride(normal, (p.OVERRIDE_MIRROR, p.OVERRIDE_ABSORB,
                                         p.OVERRIDE_LAMBERTIAN_MIRROR)[mode], atol=1e-3)
                for normal, mode in item["overrides"]]))
        material = p.Material(
            refractive_index=1.0 if matched else item["n"], surface=surface,
            components=[] if matched else [_random_component(p, c, x)
                                           for c in item["components"]])
        kind, dims = item["kind"], item["dims"]
        if kind == "box":
            geometry = p.Box(dims, material=material)
        elif kind == "sphere":
            geometry = p.Sphere(radius=dims[0], material=material)
        elif kind == "cylinder":
            geometry = p.Cylinder(length=dims[0], radius=dims[1], material=material)
        else:
            v, f = _MESHES[kind]
            geometry = p.Mesh((v * dims[0], f), material=material)
        node = p.Node(name=item["name"], geometry=geometry, parent=parent)
        node.pose = item["pose"]
        node.recorders = [
            p.Recorder(r["name"], event=r["event"], facet=r["facet"], atol=1e-3,
                       histograms=[p.Histogram("wavelength", 400.0, 800.0, 20)]
                       if r["histogram"] else [])
            for r in item["recorders"]] + extra.get(item["name"], [])
        made.append(node)
    for light in plan["lights"]:
        e = light["extent"]
        position = {"point": None, "rectangle": p.RectangularMask(e, e),
                    "circle": p.CircularMask(e), "cube": p.CubeMask(e, e, e)}[light["mask"]]
        theta = np.radians(light["theta"])
        direction = (p.lambertian if light["lambertian"]
                     else p.Cone(theta) if light["cone_class"]
                     else functools.partial(p.cone, theta))
        wavelength = (p.SpectrumWavelengthMask(p.Distribution(
            x, np.exp(-0.5 * ((x - light["wavelength"]) / 20.0) ** 2)))
            if light["spectrum"] else p.ConstantWavelengthMask(light["wavelength"]))
        parent = world if light["parent"] is None else made[light["parent"]]
        node = p.Node(name=light["name"], parent=parent, light=p.Light(
            position=position, direction=direction, wavelength=wavelength, name=light["name"]))
        node.pose = light["pose"]
    return p.Scene(world)
