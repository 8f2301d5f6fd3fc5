"""Compile a scene into flat tables for the device wavefront tracer.

Counterpart of the reference's ``engine/compiler.py`` (which lowers to
numpy tables for a Cython kernel) — re-designed for TPU execution:

* Spectra and emission CDFs are resampled onto **shared uniform grids**
  so device lookups are O(1) gather + lerp instead of binary search
  (reference ``_kernel.pyx:219-238``).
* Per-node **total attenuation** spectra are precomputed so the hot loop
  does one lookup per photon, not one per component.
* Emission sampling uses a precomputed **inverse-CDF table** on a
  uniform probability grid.
* Surfaces support per-facet overrides (mirror / ideal cell /
  lambertian mirror), so LSC-style scenes compile instead of falling
  back to the per-ray tracer.

* Triangle **meshes compile too** (the reference engine rejects them,
  ``engine/compiler.py:53``): per-node (v0, e1, e2, face-normal) tables
  are baked as constants and the tracer intersects them with a
  fixed-trip Möller–Trumbore loop. Grazing shared-edge hits may count
  twice (the per-ray oracle dedups them); for Monte-Carlo rays this is
  a measure-zero event and at worst kills the photon auditably.

Scenes with unrecognised surface delegates, custom phase functions or
histogram-sampled spectra raise ``UnsupportedSceneError`` so callers
can fall back to ``pvtrace_tpu_torch.algorithm.photon_tracer``.
"""
import numpy as np

from pvtrace_tpu_torch.engine.recorder import EVENTS, PROPERTIES, Heatmap, Recorder
from pvtrace_tpu_torch.geometry.box import Box
from pvtrace_tpu_torch.geometry.cylinder import Cylinder
from pvtrace_tpu_torch.geometry.mesh import Mesh
from pvtrace_tpu_torch.geometry.sphere import Sphere
from pvtrace_tpu_torch.material.component import Absorber, Luminophore, Reactor, Scatterer
from pvtrace_tpu_torch.material.surface import (
    FacetOverrideSurfaceDelegate,
    FresnelSurfaceDelegate,
    NullSurfaceDelegate,
)
from pvtrace_tpu_torch.material.utils import Cone, HenyeyGreenstein, isotropic

# Volume interaction selectors cannot be restricted by surface facet
VOLUME_EVENTS = {"lost", "reacted", "killed"}
MAX_RECORDERS = 256

# Geometry type tags
GEOM_MESH = 3
GEOM_BOX = 0
GEOM_SPHERE = 1
GEOM_CYLINDER = 2

# Surface type tags
SURF_FRESNEL = 0
SURF_NULL = 1

# Component type tags
COMP_ABSORBER = 0
COMP_SCATTERER = 1
COMP_LUMINOPHORE = 2
COMP_REACTOR = 3

# Phase function tags
PHASE_ISOTROPIC = 0
PHASE_HENYEY_GREENSTEIN = 1
PHASE_CONE = 2

# Emission method tags
EMIT_KT = 0
EMIT_REDSHIFT = 1
EMIT_FULL = 2
EMIT_METHODS = {"kT": EMIT_KT, "redshift": EMIT_REDSHIFT, "full": EMIT_FULL}

# Facet override modes (match material.surface constants)
OVR_NONE = -1


class UnsupportedSceneError(Exception):
    """The scene uses a feature the compiled engine does not support."""


class CompiledScene:
    """Flat-table representation of a scene for the device tracer.

    Tables are built in float64 numpy; the port's
    ``engine.tables.scene_tensors`` lays them out as torch tensors (this
    copy has no ``device_tables``, the JAX package's jnp lowering).
    """

    def __init__(self, scene, wavelength_bins=2048, icdf_bins=2048, eps=None):
        nodes = [n for n in scene.root.iter_preorder() if n.geometry is not None]
        if len(nodes) == 0:
            raise UnsupportedSceneError("Scene has no geometry nodes.")
        if scene.root.geometry is None:
            raise UnsupportedSceneError("Root node must have a geometry.")

        self.scene = scene
        self.nodes = nodes
        self.node_names = [node.name for node in nodes]
        self.root_id = nodes.index(scene.root)
        n = len(nodes)

        self.geom_type = np.zeros(n, dtype=np.int32)
        self.geom_params = np.zeros((n, 4), dtype=np.float64)
        self.mesh_data = {}  # node index -> (v0, e1, e2, normals) [T, 3]
        self.local_to_world = np.zeros((n, 4, 4), dtype=np.float64)
        self.world_to_local = np.zeros((n, 4, 4), dtype=np.float64)
        self.refractive_index = np.zeros(n, dtype=np.float64)
        self.surface_type = np.zeros(n, dtype=np.int32)

        # -- geometry, transforms, surfaces ----------------------------
        overrides_per_node = []
        components_per_node = []
        for i, node in enumerate(nodes):
            self._compile_geometry(i, node.geometry)
            self._compile_transform(i, node, scene.root)
            material = node.geometry.material
            if material is None:
                raise UnsupportedSceneError(
                    f"Node {node.name!r} has geometry without a material."
                )
            self.refractive_index[i] = float(material.refractive_index)
            surf_tag, ovrs = self._surface_tag(node, material)
            self.surface_type[i] = surf_tag
            overrides_per_node.append(ovrs)
            components_per_node.append(list(material.components))

        # -- facet override tables -------------------------------------
        F = max([len(o) for o in overrides_per_node] + [1])
        self.max_overrides = F
        self.ovr_mode = np.full((n, F), OVR_NONE, dtype=np.int32)
        self.ovr_normal = np.zeros((n, F, 3), dtype=np.float64)
        self.ovr_atol = np.zeros((n, F), dtype=np.float64)
        for i, ovrs in enumerate(overrides_per_node):
            for f, o in enumerate(ovrs):
                self.ovr_mode[i, f] = o.mode
                self.ovr_normal[i, f] = o.normal
                self.ovr_atol[i, f] = o.atol

        # -- components ------------------------------------------------
        comps = []  # flat list of (node_index, component)
        self.component_names = []
        Kmax = max([len(c) for c in components_per_node] + [1])
        self.max_components = Kmax
        self.node_comp_idx = np.full((n, Kmax), -1, dtype=np.int32)
        self.comp_count = np.zeros(n, dtype=np.int32)
        for i, comp_list in enumerate(components_per_node):
            for k, component in enumerate(comp_list):
                self.node_comp_idx[i, k] = len(comps)
                comps.append((i, component))
                self.component_names.append(component.name)
            self.comp_count[i] = len(comp_list)

        C = max(len(comps), 1)
        self.n_components = len(comps)
        self.comp_type = np.zeros(C, dtype=np.int32)
        self.comp_qy = np.zeros(C, dtype=np.float64)
        self.comp_tau_rad = np.zeros(C, dtype=np.float64)
        self.comp_tau_nr = np.zeros(C, dtype=np.float64)
        self.comp_phase_type = np.zeros(C, dtype=np.int32)
        self.comp_phase_param = np.zeros(C, dtype=np.float64)

        # Wavelength grid over the union of all spectral ranges
        lo, hi = np.inf, -np.inf
        for _, component in comps:
            dist = component._abs_dist
            if dist.hist:
                raise UnsupportedSceneError(
                    "Histogram-sampled spectra are not supported."
                )
            if dist._x is not None:
                lo = min(lo, dist._x_range[0])
                hi = max(hi, dist._x_range[1])
            if isinstance(component, Luminophore):
                edist = component._ems_dist
                if edist.hist:
                    raise UnsupportedSceneError(
                        "Histogram-sampled emission spectra are not supported."
                    )
                lo = min(lo, edist._x_range[0])
                hi = max(hi, edist._x_range[1])
        if not np.isfinite(lo):
            lo, hi = 0.0, 1.0
        if hi <= lo:
            hi = lo + 1.0
        L = int(wavelength_bins)
        M = int(icdf_bins)
        self.grid_x0 = float(lo)
        self.grid_x1 = float(hi)
        self.grid_n = L
        self.grid_dx = (hi - lo) / (L - 1)
        self.icdf_n = M
        grid = np.linspace(lo, hi, L)
        self.wavelength_grid = grid

        self.comp_coef = np.zeros((C, L), dtype=np.float64)
        self.ems_cdf = np.zeros((C, L), dtype=np.float64)
        self.ems_icdf = np.zeros((C, M), dtype=np.float64)
        pgrid = np.linspace(0.0, 1.0, M)

        for c, (i, component) in enumerate(comps):
            self._check_phase(nodes[i], component, c)
            self.comp_qy[c] = float(component.quantum_yield)
            self.comp_tau_rad[c] = component.tau_rad or 0.0
            self.comp_tau_nr[c] = component.tau_nr or 0.0
            self.comp_type[c] = self._component_tag(component)
            dist = component._abs_dist
            if dist._x is None:
                self.comp_coef[c] = float(dist._y)
            else:
                self.comp_coef[c] = np.interp(grid, dist._x, dist._y)
            if isinstance(component, Luminophore):
                edist = component._ems_dist
                self.ems_cdf[c] = np.interp(grid, edist._x, edist._cdf)
                self.ems_icdf[c] = np.interp(pgrid, edist._cdf, edist._x)

        # Per-node total attenuation on the shared grid
        self.node_alpha = np.zeros((n, L), dtype=np.float64)
        for i in range(n):
            for k in range(self.comp_count[i]):
                self.node_alpha[i] += self.comp_coef[self.node_comp_idx[i, k]]

        # -- packed spectral table -------------------------------------
        # TPU gathers are expensive; the hot loop does exactly ONE wide
        # gather for all per-step spectral data. Layout per node row
        # (grid index i), slot pairs (value at i, value at i+1):
        #   slots 0..K-1:              cumulative attenuation over the
        #                              node's components (slot K-1 = alpha)
        #   slots K+2j, K+2j+1:        j-th luminophore of the node:
        #                              kT-shifted emission CDF, plain CDF
        # A second [n_lum*M, 2] gather serves inverse-CDF emission
        # sampling. The kT redshift (component.py:407-412) is baked into
        # the table at compile time so the lookup shares the λ column.
        kB_eV = 1.380649e-23 / 1.60217662e-19
        node_meta = []
        lum_rows = []
        slot_width = 1
        for i, node in enumerate(nodes):
            K = int(self.comp_count[i])
            comp_ids = [int(self.node_comp_idx[i, k]) for k in range(K)]
            lum_ordinals = {}
            for k, cid in enumerate(comp_ids):
                if self.comp_type[cid] == COMP_LUMINOPHORE:
                    lum_ordinals[cid] = len(lum_ordinals)
            W = K + 2 * len(lum_ordinals)
            slot_width = max(slot_width, W)
            node_meta.append((K, tuple(comp_ids), lum_ordinals))
        self.pack_width = slot_width

        self.spec_pack = np.zeros((n * L, 2 * slot_width), dtype=np.float64)
        lum_index = {}
        for i, node in enumerate(nodes):
            K, comp_ids, lum_ordinals = node_meta[i]
            rows = slice(i * L, (i + 1) * L)
            cum = np.zeros(L)
            for k, cid in enumerate(comp_ids):
                cum = cum + self.comp_coef[cid]
                self.spec_pack[rows, 2 * k] = cum
                self.spec_pack[rows, 2 * k + 1] = np.append(cum[1:], cum[-1])
            for cid, j in lum_ordinals.items():
                component = comps[cid][1]
                edist = component._ems_dist
                e_nm = 1240.0 / (1240.0 / grid + 1.5 * kB_eV * 300.0)
                cdf_kt = np.interp(e_nm, edist._x, edist._cdf)
                cdf_rs = np.interp(grid, edist._x, edist._cdf)
                wk = K + 2 * j
                wr = K + 2 * j + 1
                self.spec_pack[rows, 2 * wk] = cdf_kt
                self.spec_pack[rows, 2 * wk + 1] = np.append(cdf_kt[1:], cdf_kt[-1])
                self.spec_pack[rows, 2 * wr] = cdf_rs
                self.spec_pack[rows, 2 * wr + 1] = np.append(cdf_rs[1:], cdf_rs[-1])
                if cid not in lum_index:
                    lum_index[cid] = len(lum_index)
                    lum_rows.append(self.ems_icdf[cid])
        self.lum_index = lum_index
        self.n_lum = len(lum_rows)
        if lum_rows:
            icdf = np.stack(lum_rows)  # [n_lum, M]
            pairs = np.stack(
                [icdf, np.concatenate([icdf[:, 1:], icdf[:, -1:]], axis=1)],
                axis=-1,
            )
            self.ems_icdf_pairs = pairs.reshape(self.n_lum * M, 2)
        else:
            self.ems_icdf_pairs = np.zeros((1, 2), dtype=np.float64)

        # -- device emission tables ------------------------------------
        # Built-in light delegates compile to static samplers so whole
        # bundles are emitted on device (no host numpy, no H2D bundle
        # transfer). Unsupported (custom) delegates fall back to host
        # emission (engine/emit.py).
        self._compile_lights(scene)

        # -- Chebyshev spectral surrogates -------------------------------
        # Profiled on v5e, the two per-step spectral gathers plus their
        # tiled-to-linear column relayouts are ~85% of a tracer step
        # (gathers run near the hardware's ~2 ns/row limit; the physics
        # itself is cheap VPU work). Smooth spectra — every built-in dye
        # and most measured ones — admit a Chebyshev fit whose Clenshaw
        # evaluation is a few hundred fused FMAs per lane and needs no
        # gather at all. Fits are accepted only when the max error on
        # the compile grid is below a tolerance tied to the table's own
        # resolution; jagged spectra keep the exact gather path.
        self._fit_chebyshev(node_meta)

        # Static structural metadata consumed by the tracer's unrolled
        # code generation (hashable nested tuples).
        self.node_static = tuple(
            (
                int(self.geom_type[i]),
                int(self.surface_type[i]),
                node_meta[i][0],
                node_meta[i][1],
                tuple(
                    sorted(
                        (cid, j) for cid, j in node_meta[i][2].items()
                    )
                ),
                tuple(
                    (
                        int(self.ovr_mode[i, f]),
                        tuple(float(v) for v in self.ovr_normal[i, f]),
                        float(self.ovr_atol[i, f]),
                    )
                    for f in range(self.max_overrides)
                    if self.ovr_mode[i, f] >= 0
                ),
            )
            for i in range(n)
        )
        self.comp_static = tuple(
            (
                int(self.comp_type[c]),
                float(self.comp_qy[c]),
                float(self.comp_tau_rad[c]),
                float(self.comp_tau_nr[c]),
                int(self.comp_phase_type[c]),
                float(self.comp_phase_param[c]),
                int(self.lum_index.get(c, -1)),
            )
            for c in range(self.n_components)
        )

        # -- numeric tolerance -----------------------------------------
        # Forward-hit filter: intersections closer than eps along the ray
        # are "on surface". Scaled to the scene extent for f32 safety.
        extents = []
        for i, node in enumerate(nodes):
            if self.geom_type[i] == GEOM_BOX:
                extents.append(np.max(self.geom_params[i, :3]))
            elif self.geom_type[i] == GEOM_SPHERE:
                extents.append(self.geom_params[i, 0])
            elif self.geom_type[i] == GEOM_MESH:
                v0 = self.mesh_data[i][0]
                extents.append(2.0 * float(np.max(np.abs(v0))) + 1e-9)
            else:
                extents.append(max(self.geom_params[i, 0], self.geom_params[i, 1]))
        self.scene_extent = float(max(extents))
        self.node_extent = tuple(float(v) for v in extents)
        self.eps = eps  # resolved per-dtype in device_tables

        self._compile_recorders(nodes)
        self._compute_digest()

    # Chebyshev surrogate acceptance: max fit error on the compile grid,
    # relative to the table's value scale. 2e-4 is far below both the
    # Monte-Carlo noise floor of any practical run and the error the
    # grid resampling itself introduces versus the raw spectra.
    CHEB_REL_TOL = 2e-4
    # Global degrees are capped at 64: a degree-192/256 Clenshaw chain
    # is a *serial* dependency of hundreds of FMAs per lane; beyond 64
    # the adaptive piecewise fit below is both cheaper (independent
    # short chains) and more accurate (kinks get their own segments).
    CHEB_DEGREES = (8, 16, 32, 64)
    # Log-space fallback acceptance: max POINTWISE-relative error of the
    # reconstruction. Attenuation spectra (steep absorption cliff onto a
    # near-zero plateau, e.g. every real dye) defeat plain polynomial
    # fits, but are smooth in log space; pointwise-relative accuracy is
    # also the physically right metric for an absorption coefficient: a
    # relative error e on every component coefficient bounds the
    # relative error of the total attenuation (free-path sampling) AND
    # of every roulette probability by e. 2.5e-3 keeps all systematic
    # fate-fraction shifts well under the 0.5% validation target;
    # clipped-Gaussian dye spectra have a kink at the clip boundary
    # that floors polynomial fits around ~2e-3 regardless of degree.
    CHEB_LOG_REL_TOL = 2.5e-3
    # Adaptive piecewise fallback: per-segment degree and the segment
    # budget. Evaluation cost is ~PW_DEG FMAs per segment, but every
    # segment's Clenshaw chain is independent (ILP-friendly VPU work),
    # unlike one long serial chain of a high global degree.
    PW_DEG = 8
    PW_MAX_SEGMENTS = 48

    @staticmethod
    def _cheb_fit(values, rel_tol=None):
        """Fit `values` (sampled on a uniform grid) with the lowest-degree
        Chebyshev series meeting the tolerance; falls back to an adaptive
        piecewise fit; None if nothing meets tolerance.

        Returns a fit descriptor ``(kind, coef, offset)``:
          ("lin", coef, 0.0)  -> y ≈ clenshaw(t, coef)
          ("log", coef, off)  -> y ≈ exp(clenshaw(t, coef)) - off
          ("pw", segs, off)   -> piecewise; segs = ((a, b, kind, coef), ...)
                                 with per-segment affine map to [-1, 1]
        """
        from numpy.polynomial import chebyshev as _cheb

        explicit_tol = rel_tol is not None
        rel_tol = rel_tol or CompiledScene.CHEB_REL_TOL
        y = np.asarray(values, dtype=np.float64)
        t = np.linspace(-1.0, 1.0, y.shape[0])
        scale = float(np.max(np.abs(y)))
        if scale == 0.0:
            return ("lin", np.zeros(1), 0.0)
        tol = rel_tol * scale
        for deg in CompiledScene.CHEB_DEGREES:
            if deg >= y.shape[0]:
                break
            coef = _cheb.chebfit(t, y, deg)
            err = float(np.max(np.abs(_cheb.chebval(t, coef) - y)))
            if err <= tol:
                return ("lin", coef, 0.0)
        if float(np.min(y)) >= 0.0:
            off = max(1e-3 * scale, 1e-30)
            ly = np.log(y + off)
            floor = np.maximum(y, off)
            for deg in CompiledScene.CHEB_DEGREES:
                if deg >= y.shape[0]:
                    break
                coef = _cheb.chebfit(t, ly, deg)
                rec = np.exp(_cheb.chebval(t, coef)) - off
                rel = float(np.max(np.abs(rec - y) / floor))
                if rel <= CompiledScene.CHEB_LOG_REL_TOL:
                    return ("log", coef, off)
        return CompiledScene._cheb_fit_piecewise(
            y, rel_tol if explicit_tol else None
        )

    @staticmethod
    def _cheb_fit_piecewise(y, rel_tol=None):
        """Adaptive piecewise-Chebyshev fit of a uniform-grid table.

        Global polynomial fits fail on spectra with *kinks* (e.g. a
        clipped-Gaussian dye absorption crossing zero): the error floors
        near the kink no matter the degree. Bisecting failing segments
        at the midpoint isolates each kink; a segment that shrinks
        inside a single grid cell reproduces the table's linear
        interpolation EXACTLY (degree >= 1), so the recursion always
        converges. The ground truth is the piecewise-linear interpolant
        the gather path computes, checked on an 8x oversampled grid
        with the same pointwise-relative criterion as the log-space
        fits (or the caller's tighter tolerance when one was given).
        """
        from numpy.polynomial import chebyshev as _cheb

        L = y.shape[0]
        scale = float(np.max(np.abs(y)))
        deg = CompiledScene.PW_DEG
        if rel_tol is None:
            rel_tol = CompiledScene.CHEB_LOG_REL_TOL
        else:
            rel_tol = min(rel_tol, CompiledScene.CHEB_LOG_REL_TOL)
        can_log = float(np.min(y)) >= 0.0
        off = max(1e-3 * scale, 1e-30) if can_log else 0.0
        # 8x oversampled truth (linear interpolation of the table)
        td = np.linspace(-1.0, 1.0, 8 * (L - 1) + 1)
        tgrid = np.linspace(-1.0, 1.0, L)
        yd = np.interp(td, tgrid, y)
        floor = np.maximum(np.abs(yd), max(1e-3 * scale, 1e-30))
        cell = 2.0 / (L - 1)

        def fit_segment(a, b):
            m = (td >= a - 1e-12) & (td <= b + 1e-12)
            if int(m.sum()) < 4:
                # Too few truth samples to check a fit honestly; let the
                # cell-scale path below handle it exactly.
                return None
            ts = (td[m] - a) * (2.0 / (b - a)) - 1.0
            ys = yd[m]
            fl = floor[m]
            # Keep the degree well below the sample count: a fit through
            # ~d+1 points is an interpolant — zero residual AT the
            # samples, unchecked oscillation between them (a cliff in
            # one grid cell passes falsely). Degree <= samples/3 keeps
            # the residual test meaningful; tight segments then keep
            # splitting until the exact-linear cell fallback.
            d = min(deg, max(1, (ts.shape[0] - 1) // 3))
            coef = _cheb.chebfit(ts, ys, d)
            rel = np.abs(_cheb.chebval(ts, coef) - ys) / fl
            if float(np.max(rel)) <= rel_tol:
                return ("lin", coef)
            if can_log and float(np.min(ys)) >= 0.0:
                lcoef = _cheb.chebfit(ts, np.log(ys + off), d)
                lrel = np.abs(np.exp(_cheb.chebval(ts, lcoef)) - off - ys) / fl
                if float(np.max(lrel)) <= rel_tol:
                    return ("log", lcoef)
            return None

        segments = []
        stack = [(-1.0, 1.0)]
        while stack:
            if len(segments) + len(stack) > CompiledScene.PW_MAX_SEGMENTS:
                return None
            a, b = stack.pop()
            fit = fit_segment(a, b)
            if fit is not None:
                segments.append((a, b, fit[0], fit[1]))
                continue
            if b - a <= 1.25 * cell:
                # Cell-scale segment still failing (a kink inside it).
                # Dyadic endpoints generally do NOT line up with the
                # grid's cells (width 2/(L-1)), so snapping to a cell
                # index would stretch the wrong endpoints onto the
                # segment. Instead split at any grid knot strictly
                # inside; a knot-free segment lies within one cell,
                # where the truth is exactly linear in t.
                knots = tgrid[(tgrid > a + 1e-9 * cell)
                              & (tgrid < b - 1e-9 * cell)]
                if knots.size:
                    k = float(knots[knots.size // 2])
                    stack.append((a, k))
                    stack.append((k, b))
                    continue
                ya = float(np.interp(a, tgrid, y))
                yb = float(np.interp(b, tgrid, y))
                coef = np.array([0.5 * (ya + yb), 0.5 * (yb - ya)])
                segments.append((a, b, "lin", coef))
                continue
            # Bisect. (Splitting at the worst-error point can stall when
            # the worst point hugs a segment edge; bisection terminates
            # in <= log2(grid cells) depth per kink and measured FEWER
            # segments on real dye spectra: the power-of-two edges box
            # kinks in quickly.)
            mid = 0.5 * (a + b)
            stack.append((a, mid))
            stack.append((mid, b))
        segments.sort(key=lambda s: s[0])
        return ("pw", tuple(segments), off)

    def _fit_chebyshev(self, node_meta):
        """Gather-free spectral surrogates (see compile-time note above).

        Sets, each independently None when any of its fits misses
        tolerance (the tracer then keeps the exact table gather):
          cheb_comp        [fit per component] for the component
                           attenuation coefficients (log-space capable,
                           so every cumulative slot is a short sum of
                           pointwise-relative-accurate terms)
          cheb_spec        {node: [W slot descriptors]} — cumulative
                           slots are ("cum", comp_ids) references into
                           cheb_comp; emission-CDF slots are direct fits
          cheb_icdf        [n_lum fits] for emission inverse CDFs
          cheb_light_icdf  [fits] for lamp-spectrum inverse CDFs
        """
        L, M = self.grid_n, self.icdf_n

        comp_fits = []
        ok = True
        for c in range(self.n_components):
            fit = self._cheb_fit(self.comp_coef[c])
            if fit is None:
                ok = False
                break
            comp_fits.append(fit)
        self.cheb_comp = comp_fits if ok else None

        spec = {}
        for i in range(len(node_meta)):
            if not ok:
                break
            K, comp_ids, lum_ordinals = node_meta[i]
            W = K + 2 * len(lum_ordinals)
            if W == 0 or K == 0:
                continue
            rows = slice(i * L, (i + 1) * L)
            fits = [("cum", tuple(comp_ids[: k + 1]), 0.0) for k in range(K)]
            for w in range(K, W):
                fit = self._cheb_fit(self.spec_pack[rows, 2 * w])
                if fit is None:
                    ok = False
                    break
                fits.append(fit)
            if not ok:
                break
            spec[i] = fits
        self.cheb_spec = spec if ok else None

        icdf = []
        n_lum = self.n_lum
        for l in range(n_lum):
            vals = self.ems_icdf_pairs[l * M:(l + 1) * M, 0]
            coef = self._cheb_fit(vals)
            if coef is None:
                icdf = None
                break
            icdf.append(coef)
        self.cheb_icdf = icdf

        light = []
        rows = self.light_icdf_pairs.shape[0] // M if M else 0
        for l in range(rows):
            vals = self.light_icdf_pairs[l * M:(l + 1) * M, 0]
            coef = self._cheb_fit(vals)
            if coef is None:
                light = None
                break
            light.append(coef)
        self.cheb_light_icdf = light

    def _compute_digest(self):
        """Content digest so identical scenes share jit/table caches
        across repeated compile_scene calls."""
        import hashlib

        h = hashlib.sha1()
        for arr in (
            self.geom_type, self.geom_params, self.local_to_world,
            self.world_to_local, self.refractive_index, self.surface_type,
            self.ovr_mode, self.ovr_normal, self.ovr_atol,
            self.node_comp_idx, self.comp_count, self.comp_type,
            self.comp_qy, self.comp_tau_rad, self.comp_tau_nr,
            self.comp_phase_type, self.comp_phase_param, self.spec_pack,
            self.ems_icdf_pairs, self.light_icdf_pairs, self.rec_node,
            self.rec_event, self.rec_has_facet, self.rec_facet,
            self.rec_atol,
        ):
            h.update(np.ascontiguousarray(arr).tobytes())
        for i in sorted(self.mesh_data):
            for arr in self.mesh_data[i]:
                h.update(np.ascontiguousarray(arr).tobytes())
        h.update(
            repr(
                (
                    self.node_static, self.comp_static, self.light_static,
                    self.root_id, self.grid_x0, self.grid_dx, self.grid_n,
                    self.icdf_n, self.hist_specs, self.lights_supported,
                    self.scene_extent, self.eps,
                )
            ).encode()
        )
        self.content_digest = h.hexdigest()

    # Light sampler tags
    WAV_CONST = 0
    WAV_SPECTRUM = 1
    POS_DEFAULT = 0
    POS_RECT = 1
    POS_CIRCLE = 2
    POS_CUBE = 3
    DIR_DEFAULT = 0
    DIR_CONE = 1
    DIR_ISOTROPIC = 2
    DIR_LAMBERTIAN = 3
    DIR_HG = 4

    def _compile_lights(self, scene):
        import functools

        from pvtrace_tpu_torch.light import light as light_module
        from pvtrace_tpu_torch.material.utils import (
            Cone as _Cone,
            HenyeyGreenstein as _HG,
            cone as _cone_fn,
            isotropic as _iso_fn,
            lambertian as _lam_fn,
        )

        lights = scene.light_nodes
        static = []
        icdf_rows = []
        M = self.icdf_n
        pgrid = np.linspace(0.0, 1.0, M)
        supported = len(lights) > 0
        self.light_names = [node.light.name for node in lights]
        for node in lights:
            light = node.light
            w, p, d = light.wavelength, light.position, light.direction
            # wavelength
            if w is light_module.default_wavelength or isinstance(
                w, light_module.DefaultWavelength
            ):
                wav = (self.WAV_CONST, 555.0)
            elif isinstance(w, light_module.ConstantWavelengthMask):
                wav = (self.WAV_CONST, float(w.nanometers))
            elif isinstance(w, light_module.SpectrumWavelengthMask) and not getattr(
                w.distribution, "hist", False
            ):
                dist = w.distribution
                icdf_rows.append(np.interp(pgrid, dist._cdf, dist._x))
                wav = (self.WAV_SPECTRUM, float(len(icdf_rows) - 1))
            else:
                supported = False
                break
            # position
            if p is light_module.default_position or isinstance(
                p, light_module.DefaultPosition
            ):
                pos = (self.POS_DEFAULT, 0.0, 0.0, 0.0)
            elif isinstance(p, light_module.RectangularMask):
                pos = (self.POS_RECT, float(p.x), float(p.y), 0.0)
            elif isinstance(p, light_module.CircularMask):
                pos = (self.POS_CIRCLE, float(p.radius), 0.0, 0.0)
            elif isinstance(p, light_module.CubeMask):
                pos = (self.POS_CUBE, float(p.x), float(p.y), float(p.z))
            else:
                supported = False
                break
            # direction
            theta = None
            if d is light_module.default_direction or isinstance(
                d, light_module.DefaultDirection
            ):
                direction = (self.DIR_DEFAULT, 0.0)
            elif isinstance(d, _Cone):
                direction = (self.DIR_CONE, float(d.theta_max))
            elif isinstance(d, functools.partial) and d.func is _cone_fn:
                theta = (
                    float(d.args[0]) if d.args
                    else float(d.keywords.get("theta_max"))
                )
                direction = (self.DIR_CONE, theta)
            elif d is _iso_fn:
                direction = (self.DIR_ISOTROPIC, 0.0)
            elif d is _lam_fn:
                direction = (self.DIR_LAMBERTIAN, 0.0)
            elif isinstance(d, _HG):
                direction = (self.DIR_HG, float(d.g))
            else:
                supported = False
                break
            matrix = np.asarray(node.transformation_to(scene.root))
            static.append(
                (
                    wav,
                    pos,
                    direction,
                    tuple(tuple(float(v) for v in row) for row in matrix),
                )
            )
        self.lights_supported = supported and len(static) == len(lights)
        self.light_static = tuple(static) if self.lights_supported else ()
        if icdf_rows and self.lights_supported:
            icdf = np.stack(icdf_rows)
            pairs = np.stack(
                [icdf, np.concatenate([icdf[:, 1:], icdf[:, -1:]], axis=1)],
                axis=-1,
            )
            self.light_icdf_pairs = pairs.reshape(-1, 2)
        else:
            self.light_icdf_pairs = np.zeros((1, 2), dtype=np.float64)

    # -- pieces --------------------------------------------------------

    def _compile_geometry(self, i, geometry):
        if isinstance(geometry, Mesh):
            self.geom_type[i] = GEOM_MESH
            # (v0, e1, e2, outward face normal) per triangle, local frame
            self.mesh_data[i] = (
                np.asarray(geometry._v0, dtype=np.float64),
                np.asarray(geometry._e1, dtype=np.float64),
                np.asarray(geometry._e2, dtype=np.float64),
                np.asarray(geometry._face_normals, dtype=np.float64),
            )
        elif isinstance(geometry, Box):
            self.geom_type[i] = GEOM_BOX
            self.geom_params[i, :3] = np.asarray(geometry._size, dtype=np.float64)
        elif isinstance(geometry, Sphere):
            self.geom_type[i] = GEOM_SPHERE
            self.geom_params[i, 0] = float(geometry.radius)
        elif isinstance(geometry, Cylinder):
            self.geom_type[i] = GEOM_CYLINDER
            self.geom_params[i, 0] = float(geometry.length)
            self.geom_params[i, 1] = float(geometry.radius)
        else:
            raise UnsupportedSceneError(
                f"Geometry type {type(geometry).__name__} is not supported."
            )

    def _compile_transform(self, i, node, root):
        l2w = np.asarray(node.transformation_to(root), dtype=np.float64)
        rotation = l2w[:3, :3]
        if not np.allclose(rotation @ rotation.T, np.eye(3), atol=1e-9):
            raise UnsupportedSceneError(
                f"Node {node.name!r} transform is not rigid (has scale or shear)."
            )
        self.local_to_world[i] = l2w
        self.world_to_local[i] = np.linalg.inv(l2w)

    def _surface_tag(self, node, material):
        delegate = material.surface.delegate
        if isinstance(delegate, FacetOverrideSurfaceDelegate):
            return SURF_FRESNEL, delegate.overrides
        if type(delegate) is FresnelSurfaceDelegate:
            return SURF_FRESNEL, []
        if type(delegate) is NullSurfaceDelegate:
            return SURF_NULL, []
        raise UnsupportedSceneError(
            f"Node {node.name!r} uses surface delegate "
            f"{type(delegate).__name__}; supported: FresnelSurfaceDelegate, "
            "NullSurfaceDelegate, FacetOverrideSurfaceDelegate."
        )

    @staticmethod
    def _component_tag(component):
        # Order matters: Reactor < Absorber < Scatterer; Luminophore < Scatterer
        if isinstance(component, Reactor):
            return COMP_REACTOR
        if isinstance(component, Absorber):
            return COMP_ABSORBER
        if isinstance(component, Luminophore):
            return COMP_LUMINOPHORE
        if isinstance(component, Scatterer):
            return COMP_SCATTERER
        raise UnsupportedSceneError(
            f"Component type {type(component).__name__} is not supported."
        )

    def _check_phase(self, node, component, c):
        phase = component.phase_function
        if phase is isotropic:
            self.comp_phase_type[c] = PHASE_ISOTROPIC
        elif isinstance(phase, HenyeyGreenstein):
            self.comp_phase_type[c] = PHASE_HENYEY_GREENSTEIN
            self.comp_phase_param[c] = float(phase.g)
        elif isinstance(phase, Cone):
            self.comp_phase_type[c] = PHASE_CONE
            self.comp_phase_param[c] = float(phase.theta_max)
        else:
            raise UnsupportedSceneError(
                f"Node {node.name!r}: custom phase functions are not supported."
            )

    def _compile_recorders(self, nodes):
        recorders = []
        for i, node in enumerate(nodes):
            for recorder in getattr(node, "recorders", []):
                if not isinstance(recorder, Recorder):
                    raise UnsupportedSceneError(
                        f"Node {node.name!r} recorders must be Recorder objects."
                    )
                if recorder.event in VOLUME_EVENTS and recorder.facet is not None:
                    raise UnsupportedSceneError(
                        f"Recorder {recorder.name!r}: facet filters only apply "
                        "to surface events."
                    )
                recorders.append((i, recorder))
        if len(recorders) > MAX_RECORDERS:
            raise UnsupportedSceneError(
                f"At most {MAX_RECORDERS} recorders are supported."
            )
        names = [rec.name for _, rec in recorders]
        if len(set(names)) != len(names):
            raise UnsupportedSceneError("Recorder names must be unique.")

        R = len(recorders)
        self.n_recorders = R
        self.recorder_names = names
        self.recorder_specs = [rec for _, rec in recorders]
        self.rec_node = np.zeros(max(R, 1), dtype=np.int32)
        self.rec_event = np.zeros(max(R, 1), dtype=np.int32)
        self.rec_has_facet = np.zeros(max(R, 1), dtype=np.int32)
        self.rec_facet = np.zeros((max(R, 1), 3), dtype=np.float64)
        self.rec_atol = np.zeros(max(R, 1), dtype=np.float64)
        self.rec_hist_start = np.zeros(max(R, 1), dtype=np.int32)
        self.rec_hist_n = np.zeros(max(R, 1), dtype=np.int32)

        h_rows = []
        offset = 0
        for r, (node_index, recorder) in enumerate(recorders):
            self.rec_node[r] = node_index
            self.rec_event[r] = EVENTS[recorder.event]
            if recorder.facet is not None:
                self.rec_has_facet[r] = 1
                self.rec_facet[r] = recorder.facet
            self.rec_atol[r] = recorder.atol
            self.rec_hist_start[r] = len(h_rows)
            for hist in recorder.histograms:
                if isinstance(hist, Heatmap):
                    a, b = hist.a, hist.b
                    h_rows.append(
                        (r, PROPERTIES[a.prop], PROPERTIES[b.prop], a.bins,
                         b.bins, a.start, a.stop, b.start, b.stop, offset)
                    )
                    offset += a.bins * b.bins
                else:
                    h_rows.append(
                        (r, PROPERTIES[hist.prop], -1, hist.bins, 1,
                         hist.start, hist.stop, 0.0, 1.0, offset)
                    )
                    offset += hist.bins
            self.rec_hist_n[r] = len(recorder.histograms)

        # Histogram specs stay host-side (static python metadata for the
        # unrolled tally loop).
        self.hist_specs = h_rows
        self.total_bins = offset

    # -- device lowering ----------------------------------------------

    def resolved_eps(self, dtype):
        """Forward-hit tolerance for the given compute dtype (scene-wide;
        prefer `resolved_eps_per_node` — see that docstring)."""
        if self.eps is not None:
            return float(self.eps)
        scale = max(1.0, self.scene_extent)
        if np.dtype(dtype) == np.float32:
            return 3e-5 * scale
        return 2.2e-12 * scale

    def resolved_eps_per_node(self, dtype):
        """Per-node forward-hit tolerance.

        Intersections are solved in each node's LOCAL frame, so the f32
        rounding error scales with that node's own extent — not the
        scene's. A single scene-wide eps breaks thin features: a world
        container 100x the device makes eps larger than, e.g., the gap
        between a lamp and the LSC surface, silently filtering real
        hits (caught by the 10^8-photon flux validation).
        """
        if self.eps is not None:
            return tuple(float(self.eps) for _ in self.node_extent)
        factor = 3e-5 if np.dtype(dtype) == np.float32 else 2.2e-12
        return tuple(factor * max(1.0, e) for e in self.node_extent)


def compile_scene(scene, **kwargs) -> CompiledScene:
    """Compile `scene` to flat tables, or raise `UnsupportedSceneError`."""
    return CompiledScene(scene, **kwargs)
