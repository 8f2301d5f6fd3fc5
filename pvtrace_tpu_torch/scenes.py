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
    in a 25 cm world sphere, lit by a 555 nm lamp over the row (a 20
    degree cone from a rectangle 3 cm above). Every component is fitted on
    its own, so the K5a table grows with tiles x dyes: at the defaults 40
    luminophores, over 100 KB, more than the trace kernel's shared-memory
    budget of a block (``kSharedTallyLimit``), and each node has more
    components than a step holds in registers (``kHeldSlots``)."""
    p = api(ns)
    x = np.arange(400, 801, dtype=float)
    world = p.Node(
        name="world",
        geometry=p.Sphere(radius=25.0, material=p.Material(refractive_index=1.0)),
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
