"""High-level luminescent solar concentrator abstraction.

Parity: reference ``pvtrace/device/lsc.py`` — same constructor/builders
(`add_luminophore`, `add_absorber`, `add_scatterer`, `add_light`,
`add_solar_cell`, `add_back_surface_mirror`, `add_air_gap_mirror`) and
analysis API (`spectrum`, `counts`, `summary`, `report`).

The port's copy of ``pvtrace_tpu/device/lsc.py``. The mirror/solar-cell
surfaces are declarative facet overrides
(``FacetOverrideSurfaceDelegate``), so LSC scenes lower to the port's
scene tensors and run through its engine: on the card (the default) the
hand-written kernels, ``pvt_trace`` with the event log and
``pvt_log_pack`` for `simulate`, ``pvt_trace_score`` or
``pvt_trace_pathwise`` for `gradient`; with ``device="cpu"`` the eager
PyTorch twins. `simulate`'s dataframe is built on the host from the dense
event log (``EngineResult.histories``). The oracle tracer remains
available via ``simulate(..., engine="python")``.
"""
import functools
from dataclasses import asdict

import numpy as np
import pandas as pd

from pvtrace_tpu_torch.data import lumogen_f_red_305
from pvtrace_tpu_torch.geometry.box import Box
from pvtrace_tpu_torch.geometry.utils import EPS_ZERO
from pvtrace_tpu_torch.light.event import Event
from pvtrace_tpu_torch.light.light import Light
from pvtrace_tpu_torch.material.component import Absorber, Luminophore, Scatterer
from pvtrace_tpu_torch.material.material import Material
from pvtrace_tpu_torch.material.surface import (
    OVERRIDE_ABSORB,
    OVERRIDE_LAMBERTIAN_MIRROR,
    OVERRIDE_MIRROR,
    FacetOverride,
    FacetOverrideSurfaceDelegate,
    Surface,
)
from pvtrace_tpu_torch.material.utils import cone
from pvtrace_tpu_torch.scene.node import Node
from pvtrace_tpu_torch.scene.scene import Scene

# Facet name -> outward local normal of the LSC box
_FACET_NORMALS = {
    "left": (-1, 0, 0),
    "right": (1, 0, 0),
    "near": (0, -1, 0),
    "far": (0, 1, 0),
    "bottom": (0, 0, -1),
    "top": (0, 0, 1),
}


class OptionalMirrorAndSolarCell(FacetOverrideSurfaceDelegate):
    """Ideal specular mirror on the bottom facet plus perfectly
    index-matched, perfectly absorbing cells on selected edges
    (reference lsc.py:22-62), as declarative facet overrides."""

    def __init__(self, lsc):
        overrides = []
        if lsc._back_surface_mirror_info["want_back_surface_mirror"]:
            overrides.append(FacetOverride((0, 0, -1), OVERRIDE_MIRROR))
        for facet in lsc._solar_cell_surfaces:
            overrides.append(
                FacetOverride(_FACET_NORMALS[facet], OVERRIDE_ABSORB)
            )
        super(OptionalMirrorAndSolarCell, self).__init__(overrides)


class AirGapMirror(FacetOverrideSurfaceDelegate):
    """Perfect reflector (specular or Lambertian) below an air gap
    (reference lsc.py:65-86)."""

    def __init__(self, lsc):
        mode = (
            OVERRIDE_LAMBERTIAN_MIRROR
            if lsc._air_gap_mirror_info["lambertian"]
            else OVERRIDE_MIRROR
        )
        overrides = [
            FacetOverride(normal, mode) for normal in _FACET_NORMALS.values()
        ]
        super(AirGapMirror, self).__init__(overrides)


class LSC(object):
    """Abstraction of a luminescent solar concentrator — a high-level,
    easy-to-use API over the scene/engine machinery."""

    def __init__(self, size, wavelength_range=None, n0=1.0, n1=1.5):
        super(LSC, self).__init__()
        self.wavelength_range = (
            np.arange(400, 800) if wavelength_range is None else wavelength_range
        )
        self.size = size  # centimetres
        self.n0 = n0
        self.n1 = n1

        self._solar_cell_surfaces = set()
        self._back_surface_mirror_info = {"want_back_surface_mirror": False}
        self._air_gap_mirror_info = {"want_air_gap_mirror": False, "lambertian": False}
        self._scene = None
        self._store = None
        self._df = None
        self._counts = None
        self._user_lights = []
        self._user_components = []
        self._renderer = None
        # The last engine runs: simulate's EngineResult (None after the
        # oracle), and gradient's compiled scene (with its cell and
        # incident recorders), resolved pathwise specs and recorder totals.
        self._last_result = None
        self._last_gradient = None

    # -- defaults ------------------------------------------------------

    def _default_recipe(self):
        """Register the reference defaults when the user added nothing:
        Lumogen F Red 305 at peak absorption 10 cm^-1 + a 0.1 cm^-1
        background absorber (reference lsc.py:115-133), lit by a 555 nm
        20-degree cone spotlight above the top face."""
        if not self._user_components:
            grid = self.wavelength_range
            self.add_luminophore(
                "Lumogen F Red 305",
                np.column_stack((grid, 10.0 * lumogen_f_red_305.absorption(grid))),
                np.column_stack((grid, lumogen_f_red_305.emission(grid))),
                quantum_yield=1.0,
            )
            self.add_absorber("Background", 0.1)
        if not self._user_lights:
            self.add_light(
                "Light",
                location=(0.0, 0.0, self.size[-1] * 5),
                rotation=(np.radians(180), (1, 0, 0)),
                direction=functools.partial(cone, np.radians(20)),
            )

    def _instantiate_components(self):
        built = []
        for spec in self._user_components:
            params = {
                k: v for k, v in spec.items() if k not in ("cls", "coefficient")
            }
            if params.get("phase_function", "?") is None:
                del params["phase_function"]
            built.append(spec["cls"](spec["coefficient"], **params))
        return built

    def _attach_air_gap_mirror(self, world):
        length, width, depth = self.size
        sheet = 0.25 * depth
        mirror = Node(
            name="Air Gap Mirror",
            parent=world,
            geometry=Box(
                (length, width, sheet),
                material=Material(
                    refractive_index=self.n0,
                    components=[],
                    surface=Surface(delegate=AirGapMirror(self)),
                ),
            ),
        )
        mirror.translate((0.0, 0.0, -(0.5 * depth + sheet)))

    def _attach_lights(self, world):
        for spec in self._user_lights:
            source = Light(
                name=spec["name"],
                direction=spec["direction"],
                wavelength=spec["wavelength"],
                position=spec["position"],
            )
            holder = Node(name=spec["name"], light=source, parent=world)
            holder.location = spec["location"]
            if spec["rotation"]:
                holder.rotate(*spec["rotation"])

    def _make_scene(self):
        """World box 100x the plate (reference lsc.py:148-219), the LSC
        box with its components and the mirror/cell surface delegate,
        optional air-gap mirror sheet, then the lights."""
        length, width, depth = self.size
        self._default_recipe()
        world = Node(
            name="World",
            geometry=Box(
                (length * 100, width * 100, depth * 100),
                material=Material(refractive_index=self.n0),
            ),
        )
        Node(
            name="LSC",
            parent=world,
            geometry=Box(
                (length, width, depth),
                material=Material(
                    refractive_index=self.n1,
                    components=self._instantiate_components(),
                    surface=Surface(delegate=OptionalMirrorAndSolarCell(self)),
                ),
            ),
        )
        if self._air_gap_mirror_info["want_air_gap_mirror"]:
            self._attach_air_gap_mirror(world)
        self._attach_lights(world)
        self._scene = Scene(world)

    # -- configuration -------------------------------------------------

    def component_names(self):
        if self._scene is None:
            raise ValueError("Run a simulation before calling this method.")
        return {c["name"] for c in self._user_components}

    def light_names(self):
        if self._scene is None:
            raise ValueError("Run a simulation before calling this method.")
        return {l["name"] for l in self._user_lights}

    def _register_component(self, cls, name, coefficient, **extra):
        self._user_components.append(
            dict(cls=cls, name=name, coefficient=coefficient, **extra)
        )

    def add_luminophore(
        self, name, coefficient, emission, quantum_yield, phase_function=None
    ):
        self._register_component(
            Luminophore, name, coefficient, emission=emission,
            quantum_yield=quantum_yield, phase_function=phase_function,
        )

    def add_absorber(self, name, coefficient):
        self._register_component(Absorber, name, coefficient)

    def add_scatterer(self, name, coefficient, phase_function=None):
        self._register_component(
            Scatterer, name, coefficient, phase_function=phase_function
        )

    def add_light(
        self,
        name,
        location,
        rotation=None,
        direction=None,
        wavelength=None,
        position=None,
    ):
        self._user_lights.append(
            dict(name=name, location=location, rotation=rotation,
                 direction=direction, wavelength=wavelength,
                 position=position)
        )

    def add_solar_cell(self, facets):
        if not isinstance(facets, (list, tuple, set)):
            raise ValueError("Facets should be a set. e.g. `{'left', 'right'}`")
        facets = set(facets)
        allowed = {"left", "near", "far", "right"}
        if not facets.issubset(allowed):
            raise ValueError("Solar cell have allowed surfaces", allowed)
        self._solar_cell_surfaces = facets.union(self._solar_cell_surfaces)

    def add_back_surface_mirror(self):
        self._back_surface_mirror_info = {"want_back_surface_mirror": True}

    def add_air_gap_mirror(self, lambertian=False):
        self._air_gap_mirror_info = {
            "want_air_gap_mirror": True,
            "lambertian": lambertian,
        }

    # -- visualisation -------------------------------------------------

    def show(self, **kwargs):
        """Render the scene; returns the renderer."""
        if self._scene is None:
            self._make_scene()
        from pvtrace_tpu_torch.scene.renderer import SceneRenderer

        self._renderer = SceneRenderer()
        self._renderer.render(self._scene)
        return self._renderer

    # -- simulation ----------------------------------------------------

    def gradient(self, n=200_000, seed=None, component=None,
                 wrt="concentration", mesh=None, device="cuda", dtype=None):
        """Monte-Carlo gradient of the optical efficiency (north star).

        Returns d(optical efficiency) / d log(coefficient scale) of
        ``component`` (default: the first luminophore — i.e. the
        derivative w.r.t. log dye concentration) from ONE device-engine
        run, using the tracer's score-function accumulators: each
        solar-cell facet recorder tallies distinct escaping photons
        together with their path score at the collection event, so with
        A = collected fraction and I = incident fraction,

            d(A / I) = (dA * I - A * dI) / I**2

        with dA, dI taken from the recorder score sums. Counts include
        every photon crossing the cell facets (with top illumination
        essentially all are luminescent), unlike ``summary()`` which
        filters by source. Requires solar cells (``add_solar_cell``).

        Returns dict(optical_efficiency, gradient, component).

        ``wrt`` selects the parameter: ``"concentration"`` (default —
        d/dlog of `component`'s coefficient scale), ``"n"`` (the plate's
        refractive index, hybrid pathwise estimator with the Snell
        term), or ``"length"``/``"width"``/``"thickness"`` (plate
        dimensions in cm via the geometry tangent channels).

        ``mesh`` shards the photon axis over a process group
        (``parallel.make_photon_mesh()``, a ``parallel.PhotonMesh``) with
        the recorder score accumulators all-reduced across its ranks
        (``parallel.shard_simulate``) — the multi-device path for the
        unbiased estimator. `n` (and each streamed bundle) must be a
        multiple of the mesh size.

        The run is on `device`: on the card (the default) through
        ``pvt_trace_score``, or ``pvt_trace_pathwise`` for the pathwise
        parameters (float64: their float64 builds, ``score_f64`` and
        ``pathwise_f64``); ``"cpu"`` runs the eager twin. `dtype` None
        means float32. With a mesh, `device` must name the mesh's device.
        """
        if not self._solar_cell_surfaces:
            raise ValueError(
                "gradient() needs solar cells; call add_solar_cell first."
            )
        if self._scene is None:
            self._make_scene()
        scene = self._scene
        from pvtrace_tpu_torch.engine.api import simulate
        from pvtrace_tpu_torch.engine.recorder import Recorder

        lsc_node = next(
            node for node in scene.root.iter_preorder() if node.name == "LSC"
        )
        saved = list(getattr(lsc_node, "recorders", []))
        cells = sorted(self._solar_cell_surfaces)
        try:
            lsc_node.recorders = saved + [
                Recorder(
                    f"__cell_{facet}", event="escaping",
                    facet=_FACET_NORMALS[facet],
                )
                for facet in cells
            ] + [Recorder("__incident", event="entering")]
            # Stream in exact-union bundles with float64 host sums: a
            # single f32 on-device score accumulator quantizes O(10)
            # adds away once it reaches ~1e7 magnitude (docs/VALIDATION
            # Result 3), which matters at the 1e7-1e8 photon counts the
            # 1e-3 gradient target needs.
            if seed is None:
                seed = int(np.random.randint(0, 2 ** 31 - 1))
            pathwise = ()
            if wrt in ("n", "refractive_index", "n1"):
                pathwise = (("n", "LSC"),)
            elif wrt in ("thickness", "width", "length"):
                axis = {"length": 0, "width": 1, "thickness": 2}[wrt]
                pathwise = (("size", "LSC", axis),)
            elif wrt != "concentration":
                raise ValueError(
                    "wrt must be 'concentration', 'n' or one of "
                    f"'length'/'width'/'thickness'; got {wrt!r}"
                )
            # Compile once (after the recorder swap, which changes the
            # tables) and reuse across bundles — compile_scene is
            # uncached, so recompiling per 16M-photon bundle would cost
            # ~7 redundant host compiles at 1e8 photons.
            from pvtrace_tpu_torch.engine.compiler import compile_scene

            compiled = compile_scene(scene)
            if pathwise:
                from pvtrace_tpu_torch.diff.transport import (
                    resolve_pathwise_params,
                )

                pathwise = resolve_pathwise_params(compiled, pathwise)
            bundle = 16_000_000
            if mesh is not None:
                n_dev = mesh.size
                if n % n_dev != 0:
                    raise ValueError(
                        f"n ({n}) must be a multiple of the mesh "
                        f"size ({n_dev})."
                    )
                bundle = max(n_dev, bundle - bundle % n_dev)
            distinct = None
            scores = None
            traced = 0
            while traced < n:
                n_call = min(bundle, n - traced)
                if mesh is not None:
                    from pvtrace_tpu_torch.parallel.shard import shard_simulate

                    data = shard_simulate(
                        scene, n_call, mesh, seed=seed, index_offset=traced,
                        score=True, pathwise=pathwise, compiled=compiled,
                        dtype=dtype, device=device,
                    )
                else:
                    data = simulate(
                        scene, n_call, seed=seed, index_offset=traced,
                        record_every=0, score=True, pathwise=pathwise,
                        compiled=compiled, dtype=dtype, device=device,
                    ).data
                d_part = np.asarray(data["rec_distinct"], dtype=float)
                s_part = np.asarray(data["rec_scores"], dtype=float)
                distinct = d_part if distinct is None else distinct + d_part
                scores = s_part if scores is None else scores + s_part
                traced += n_call
        finally:
            lsc_node.recorders = saved
        self._last_gradient = {"compiled": compiled, "pathwise": pathwise,
                               "distinct": distinct, "scores": scores}

        comp_names = list(compiled.component_names)
        if pathwise:
            # Pathwise channels append after component + node blocks.
            channel = len(comp_names) + len(compiled.nodes)
            component = wrt
        else:
            if component is None:
                component = next(
                    data["name"] for data in self._user_components
                    if data["cls"] is Luminophore
                )
            channel = comp_names.index(component)

        order = [spec.name for spec in compiled.recorder_specs]
        cell_rows = [order.index(f"__cell_{facet}") for facet in cells]
        inc_row = order.index("__incident")

        collected = sum(distinct[row] for row in cell_rows) / n
        incident = distinct[inc_row] / n
        d_collected = sum(scores[row, channel] for row in cell_rows) / n
        d_incident = scores[inc_row, channel] / n
        if incident == 0:
            raise ValueError("No incident photons; cannot form the ratio.")
        efficiency = collected / incident
        grad = (d_collected * incident - collected * d_incident) / incident**2
        return {
            "optical_efficiency": float(efficiency),
            "gradient": float(grad),
            "component": component,
        }

    def simulate(self, n, progress=None, emit_method="kT", engine="auto",
                 seed=None, device="cuda", dtype=None):
        """Trace `n` photons and build the results dataframe.

        engine: "auto" uses the device engine when the scene compiles,
        "python" forces the per-ray oracle tracer. Only a scene the
        compiler refuses (``UnsupportedSceneError``) falls back to the
        oracle; a missing card or a failed kernel build raises.

        The engine runs every photon's history (``record_every=1``) on
        `device`: on the card (the default) ``pvt_trace`` with the event
        log, packed by ``pvt_log_pack`` and copied to host memory;
        ``"cpu"`` runs the eager twin. `dtype` None means float32; float64
        runs the float64 build of the kernels on the card
        (``tracer_f64``), or the twin in float64. The dataframe is built
        on the host from the dense log.
        """
        if self._scene is None:
            self._make_scene()
        scene = self._scene

        if self._store is None:
            store = {"entrance_rays": [], "exit_rays": []}
        else:
            store = self._store

        histories = self._trace_histories(
            scene, n, emit_method=emit_method, engine=engine, seed=seed,
            progress=progress, device=device, dtype=dtype,
        )
        for history in histories:
            rays, events = zip(*history)
            store["entrance_rays"].append((rays[1], events[1]))
            if events[-1] in (Event.ABSORB, Event.KILL, Event.NONRADIATIVE,
                              Event.REACT):
                store["exit_rays"].append((rays[-1], events[-1]))
            elif events[-1] == Event.EXIT:
                # Store the penultimate location (on the LSC boundary)
                store["exit_rays"].append((rays[-2], events[-2]))

        self._store = store
        self._counts = None
        df = self._make_dataframe()
        df = self.expand_coords(df, "direction")
        df = self.expand_coords(df, "position")
        df = self.label_facets(df, *self.size)
        self._df = df
        return df

    def _trace_histories(self, scene, n, emit_method, engine, seed, progress,
                         device="cuda", dtype=None):
        from pvtrace_tpu_torch import engine as device_engine
        from pvtrace_tpu_torch.algorithm import photon_tracer
        from pvtrace_tpu_torch.engine.compiler import UnsupportedSceneError

        if engine != "python":
            try:
                result = device_engine.simulate(
                    scene, n, seed=seed, emit_method=emit_method,
                    record_every=1, device=device, dtype=dtype,
                )
                self._last_result = result
                out = []
                for i, history in enumerate(result.histories()):
                    out.append([(ray, event) for ray, event, _ in history])
                    if progress:
                        progress(i + 1)
                return out
            except UnsupportedSceneError:
                if engine == "device":
                    raise
        self._last_result = None
        out = []
        for i, ray in enumerate(scene.emit(n)):
            history = photon_tracer.follow(scene, ray, emit_method=emit_method)
            out.append(history)
            if progress:
                progress(i + 1)
        return out

    # -- analysis ------------------------------------------------------

    def _make_dataframe(self):
        rows = []
        for ray, event in self._store["entrance_rays"]:
            rep = asdict(ray)
            rep["kind"] = "entrance"
            rep["event"] = event.name.lower()
            rows.append(rep)
        for ray, event in self._store["exit_rays"]:
            rep = asdict(ray)
            rep["kind"] = "exit"
            rep["event"] = event.name.lower()
            rows.append(rep)
        df = pd.DataFrame(rows)
        self._df = df
        return df

    def expand_coords(self, df, column):
        """Expand a coordinate tuple column into _x/_y/_z columns."""
        coords = np.stack(df[column].values)
        df["{}_x".format(column)] = coords[:, 0]
        df["{}_y".format(column)] = coords[:, 1]
        df["{}_z".format(column)] = coords[:, 2]
        df = df.drop(columns=column)
        return df

    def label_facets(self, df, length, width, height):
        """Label rows with facet names for a box LSC (local frame)."""
        xmin, xmax = -0.5 * length, 0.5 * length
        ymin, ymax = -0.5 * width, 0.5 * width
        zmin, zmax = -0.5 * height, 0.5 * height
        atol = max(EPS_ZERO, 1e-4)
        df.loc[np.isclose(df["position_x"], xmin, atol=atol), "facet"] = "left"
        df.loc[np.isclose(df["position_x"], xmax, atol=atol), "facet"] = "right"
        df.loc[np.isclose(df["position_y"], ymin, atol=atol), "facet"] = "far"
        df.loc[np.isclose(df["position_y"], ymax, atol=atol), "facet"] = "near"
        df.loc[np.isclose(df["position_z"], zmin, atol=atol), "facet"] = "bottom"
        df.loc[np.isclose(df["position_z"], zmax, atol=atol), "facet"] = "top"
        return df

    def _make_counts(self, df):
        if self._counts is not None:
            return self._counts
        all_components = self.component_names()
        all_lights = self.light_names()

        facets = ["left", "right", "near", "far", "top", "bottom"]
        solar_out, solar_in, lum_out, lum_in = {}, {}, {}, {}
        for facet in facets:
            solar_out[facet] = self.spectrum(
                facets={facet}, source=all_lights, kind="last"
            ).shape[0]
            solar_in[facet] = self.spectrum(
                facets={facet}, source=all_lights, kind="first"
            ).shape[0]
            lum_out[facet] = self.spectrum(
                facets={facet}, source=all_components, kind="last"
            ).shape[0]
            lum_in[facet] = self.spectrum(
                facets={facet}, source=all_components, kind="first"
            ).shape[0]

        self._counts = counts = pd.DataFrame(
            {
                "Solar In": pd.Series(solar_in),
                "Solar Out": pd.Series(solar_out),
                "Luminescent Out": pd.Series(lum_out),
                "Luminescent In": pd.Series(lum_in),
            },
            index=facets,
        )
        return counts

    def spectrum(self, facets=set(), kind="last", source="all", events=None):
        if self._df is None:
            raise ValueError("Run a simulation before calling this method.")
        df = self._df

        if kind is not None and kind not in {"first", "last"}:
            raise ValueError("Direction must be either `'first'` or `'last'.`")
        if kind is None:
            want_kind = pd.Series(True, index=df.index)
        elif kind == "first":
            want_kind = df["kind"] == "entrance"
        else:
            want_kind = df["kind"] == "exit"

        all_sources = self.component_names() | self.light_names()
        if source == "all":
            want_source = df["source"].isin(all_sources)
        else:
            if isinstance(source, str):
                source = {source}
            unknown = set(source) - all_sources
            if unknown:
                raise ValueError("Unknown source requested.", unknown)
            want_source = df["source"].isin(set(source))

        if isinstance(facets, (list, tuple, set)):
            if len(facets) > 0:
                want_facets = df["facet"].isin(set(facets))
            else:
                want_facets = pd.Series(True, index=df.index)
        else:
            raise ValueError(
                "`'facets'` should be a set `{'left', 'right'}`", {"got": facets}
            )

        if events is None:
            want_events = pd.Series(True, index=df.index)
        else:
            all_events = {e.name.lower() for e in Event}
            if isinstance(events, (list, tuple, set)):
                events = set(events)
                if not events.issubset(all_events):
                    raise ValueError(
                        "Contained some unknown events",
                        {"got": events, "expected": all_events},
                    )
                want_events = df["event"].isin(events)
            else:
                raise ValueError(
                    "Events must be set of event strings",
                    {"allowed": all_events},
                )

        return df.loc[want_kind & want_source & want_facets & want_events][
            "wavelength"
        ]

    def counts(self):
        df = self._df
        if df is None:
            df = self._make_dataframe()
            df = self.expand_coords(df, "direction")
            df = self.expand_coords(df, "position")
            df = self.label_facets(df, *self.size)
        return self._make_counts(df)

    #: Facet vocabulary of the slab (label_facets output).
    _FACETS = frozenset({"left", "right", "near", "far", "top", "bottom"})

    def summary(self):
        """Efficiency summary as a pandas Series.

        The Series keys are the reference's public output contract
        (``device/lsc.py:579-621``) and are preserved verbatim —
        including the trailing colon in the loss row. Values:

        * optical efficiency = collected luminescent photons / incident;
        * waveguide efficiency = collected / all radiated, with the
          thermodynamic prediction ``n^2 / (Cg + n^2)`` alongside
          (Cg = top area / edge area);
        * loss fraction counts every terminal absorption (here:
          nonradiative, react and kill too — the engine distinguishes
          them where the reference lumps them under "absorb").

        Ratios are NaN when their denominator is zero (no incident or
        no radiated photons) instead of raising.
        """
        counts = self._make_counts(self._df)
        cells = self._solar_cell_surfaces

        def across(row, facets):
            return sum(counts[row][facet] for facet in facets)

        collected = across("Luminescent Out", cells)
        radiated = collected + across("Luminescent Out", self._FACETS - cells)
        incident = across("Solar In", self._FACETS)
        lost = len(self.spectrum(
            source="all",
            events={"absorb", "nonradiative", "react", "kill"},
            kind="last",
        ))

        length, width, depth = self.size
        concentration = (width * length) / (2.0 * depth * (length + width))
        n = self.n1

        def ratio(numerator, denominator):
            return numerator / denominator if denominator else np.nan

        return pd.Series({
            "Optical Efficiency": ratio(collected, incident),
            "Waveguide Efficiency": ratio(collected, radiated),
            "Waveguide Efficiency (Thermodynamic Prediction)": (
                n ** 2 / (concentration + n ** 2)
            ),
            "Non-radiative Loss (fraction):": ratio(lost, incident),
            "Incident": incident,
            "Geometric Concentration": concentration,
            "Refractive Index": n,
            "Cell Surfaces": cells,
            "Components": self.component_names(),
            "Lights": self.light_names(),
        })

    def report(self):
        """Print the counts table and summary Series (same layout as
        reference ``device/lsc.py:623-632``)."""
        print("\n".join([
            "",
            "Simulation Report",
            "-----------------",
            "",
            "Surface Counts:",
            str(self.counts()),
            "",
            "Summary:",
            str(self.summary()),
        ]))
