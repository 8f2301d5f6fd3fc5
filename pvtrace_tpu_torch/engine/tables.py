"""Scene tensors: the compiled scene as flat records the tracer reads.

Port of ``CompiledScene.device_tables`` (pvtrace_tpu/engine/compiler.py)
plus the constants the JAX tracer bakes into its program
(pvtrace_tpu/engine/tracer.py ``_run``). The JAX tracer generates code per
scene; the port is table-driven instead: one loop over the node records,
so the same CUDA kernel serves every scene. The eager twin and the CUDA
kernels read the same tensors, with the column layout below. The layout
is mirrored by ``kernels/csrc/tracer.cuh``; the tests compare the two.

Records (rows padded to at least one so no tensor is empty, the lights
aside):

* ``node_f`` [N, NODE_F] and ``node_i`` [N, NODE_I], in node order;
* ``comp_f`` [C, COMP_F] and ``comp_i`` [C, COMP_I], in component order
  (a node's components are the contiguous range
  ``[comp_first, comp_first + n_comps)``);
* ``ovr_f`` [O, OVR_F] and ``ovr_i`` [O]: facet overrides, node by node;
* K10, the triangles of every mesh node, node by node: ``tri_f`` [ΣT,
  TRI_F], rows (v0, e1, e2, outward face normal) in the node's local
  frame (the compiler's ``mesh_data``); a mesh node's triangles are the
  rows ``[tri_first, tri_first + n_tris)`` (``NI_TRI0``, ``NI_NTRI``);
* ``light_f`` [nL, LIGHT_F] and ``light_i`` [nL, LIGHT_I], the lights
  the compiler lowered to device samplers; none (``n_lights`` 0) when it
  could not lower them all, and then every photon comes from a host
  bundle (``engine/emit.py``) and device emission refuses the scene;
* the three spectral tables the tracer reads: ``spec_pack`` [N*L, 2W],
  ``ems_icdf_pairs`` [n_lum*M, 2] and ``light_icdf_pairs`` [rows*M, 2].
  The other tables of ``device_tables`` are not read by the tracer;
* K5a, the compiler's Chebyshev fits (``cheb_comp``, ``cheb_spec``,
  ``cheb_icdf``, ``cheb_light_icdf``) flattened: ``cheb_fit_i`` [F,
  CHEB_FIT_I] and ``cheb_fit_f`` [F] per fit (kind, segment count, first
  segment; ``off``), ``cheb_seg_f`` [S, CHEB_SEG_F] and ``cheb_seg_i``
  [S, CHEB_SEG_I] per segment, one coefficient array ``cheb_coef``, and
  the spectral slots ``cheb_slot`` [N*W, 2], each the sum of the fits
  ``cheb_ref[first:first + count]`` (a ``cum`` slot lists its
  components' fits). Fits are numbered components first, then the
  non-``cum`` slot fits, the emission ICDFs (from ``meta["cheb_icdf0"]``)
  and the lamp ICDFs (from ``meta["cheb_light0"]``). The eager twin reads
  these; the kernels read the same fits packed into ``cheb_pack``, words
  of the run's real type (float32: int32 words holding float32 bits;
  float64: int64 words holding float64 bits, for the float64 build of the
  kernels) in records of four words, which a block of the trace kernels
  copies into its shared memory: a record per fit (``FR_*``: segment
  count, word offsets of its first segment record and of its
  breakpoints, ``off``), a record per segment (``SR_*``: a, 2 / (b - a),
  the word offset of its coefficients, and its degree with ``SEG_LOG`` and
  ``SEG_MAP``), every piecewise fit's interior breakpoints b_0 .. b_{n-2}
  (in the run's dtype, as the segment records hold them), and each
  segment's coefficients from the highest degree down, from a four-word
  boundary and padded with zeros to one (``meta["cheb_words"]`` words in
  all; the same count in either dtype, the records 16 or 32 bytes).
  Every piecewise fit must partition [-1, 1] (contiguous, sorted, from
  -1 to 1), as the compiler builds them: the kernel's search
  over the breakpoints then finds the one segment the reference's masks
  select;
* K9, the recorders: ``rec_f`` [R, REC_F] and ``rec_i`` [R, REC_I],
  ``hist_f`` [H, HIST_F] and ``hist_i`` [H, HIST_I] (the compiler's
  ``hist_specs``), and an index from (node, selector) to the recorders
  that can match it, in CSR form: the recorders of key ``node * N_SEL +
  sel`` are ``rec_ids[rec_csr[key]:rec_csr[key + 1]]``. Within a key
  they come in groups that share one facet test (no facet, or the same
  normal and tolerance), in order of first appearance: the key's groups
  are ``rec_grp[key]:rec_grp[key + 1]``, and group g's recorders
  ``rec_ids[grp_pos[g]:grp_pos[g + 1]]`` (``meta["n_grp"]`` groups),
  its facet test ``grp_f`` [G, GRP_F] (the normal, its tolerance, and 1
  where there is a facet, 0 where every event passes). Every event that
  matches one recorder of a group matches them all.

``meta`` says which lookups take K5a: a lookup takes its Chebyshev fits
when the compiler made them and ``PVTRACE_TPU_NO_CHEB`` is unset, the JAX
package's rule (tracer.py ``spec_slots_fn`` / ``icdf_fn``, and
``_device_emit_flat`` for lamps); otherwise the table lerp (K5b).
"""
import os
from types import MappingProxyType

import numpy as np
import torch

from pvtrace_tpu_torch.engine import compiler as comp
from pvtrace_tpu_torch.engine.recorder import EVENTS

# node_f columns
NF_W2L = 0  # 3x4 world-to-local rows, 12 values
NF_L2W = 12  # 3x3 local-to-world rotation, 9 values
NF_GP = 21  # geometry parameters, 3 values
NF_EPS = 24  # forward-hit tolerance
NF_NIDX = 25  # refractive index
NODE_F = 26

# node_i columns
NI_GEOM = 0
NI_SURF = 1
NI_NCOMP = 2
NI_COMP0 = 3
NI_OVR0 = 4
NI_NOVR = 5
NI_TRI0 = 6  # first tri_f row of a mesh node
NI_NTRI = 7  # its triangle count (0 for other geometries)
NODE_I = 8

# tri_f columns: a triangle's first vertex, two edges and face normal
TF_V0 = 0
TF_E1 = 3
TF_E2 = 6
TF_N = 9
TRI_F = 12

# comp_f columns
CF_QY = 0
CF_TAU_RAD = 1
CF_TAU_NR = 2
CF_PHASE = 3  # phase parameter: HG g, or cone half-angle
CF_SIN_PHASE = 4  # sin(cone half-angle), taken in float64
COMP_F = 5

# comp_i columns
CI_TYPE = 0
CI_PHASE = 1  # phase type; HG with |g| < 1e-12 is stored as isotropic
CI_LUM = 2  # emission ICDF row (max(lum_index, 0))
CI_P1 = 3  # kT CDF slot in the node's spec_pack row, -1 if not a luminophore
COMP_I = 4

# ovr_f columns
OF_NX, OF_NY, OF_NZ, OF_ATOL = 0, 1, 2, 3
OVR_F = 4

# light_f columns
LF_WAV = 0  # constant wavelength
LF_POS = 1  # position-mask parameters, 3 values
LF_DIR = 4  # direction parameter (cone half-angle or HG g)
LF_SIN_DIR = 5  # sin(cone half-angle), taken in float64
LF_MAT = 6  # 3x4 local-to-world rows, 12 values
LIGHT_F = 18

# light_i columns
LI_WAV = 0
LI_POS = 1
LI_DIR = 2  # direction kind; HG with |g| < 1e-12 is stored as isotropic
LI_ROW = 3  # light_icdf_pairs row block of a spectrum light
LIGHT_I = 4

# cheb_fit_i columns and fit kinds (the compiler's "lin", "log", "pw")
FI_KIND = 0
FI_NSEG = 1
FI_SEG0 = 2
CHEB_FIT_I = 3
FIT_LIN = 0
FIT_LOG = 1
FIT_PW = 2

# cheb_seg_f columns: segment [a, b) of t and 2 / (b - a), taken in float64
SF_A = 0
SF_B = 1
SF_SCALE = 2
CHEB_SEG_F = 3

# cheb_seg_i columns: FIT_LIN or FIT_LOG, first coefficient, degree
SI_KIND = 0
SI_COEF0 = 1
SI_DEG = 2
CHEB_SEG_I = 3

# cheb_pack: words of a fit or segment record; the fit record's segment
# count, word offsets of its first segment record and of its breakpoints,
# and off (a real's bits); the segment record's a and 2 / (b - a) (a
# real's bits), word offset of its coefficients, and its degree with the flags
# SEG_LOG (a log segment: exp(v) - off) and SEG_MAP (a piecewise fit's
# segment: t is mapped onto it).
CHEB_REC = 4
FR_NSEG = 0
FR_SEG = 1
FR_BRK = 2
FR_OFF = 3
SR_A = 0
SR_SCALE = 1
SR_COEF = 2
SR_DEG = 3
SEG_DEG_MASK = 255
SEG_LOG = 256
SEG_MAP = 512

# rec_f columns: facet normal and its tolerance
RF_NX = 0
RF_ATOL = 3
REC_F = 4

# rec_i columns
RI_NODE = 0
RI_EVENT = 1
RI_FACET = 2  # 1 when the recorder has a facet filter
RI_HIST0 = 3  # first hist row
RI_NHIST = 4
REC_I = 5

# grp_f columns: a facet group's normal, tolerance, and 1.0 where its
# recorders have a facet (0.0: every event passes)
GF_NX = 0
GF_ATOL = 3
GF_FACET = 4
GRP_F = 5

# hist_f columns: lower edge and width (hi - lo, taken in float64) per axis
HF_LO_A = 0
HF_W_A = 1
HF_LO_B = 2
HF_W_B = 3
HIST_F = 4

# hist_i columns: recorder, properties (recorder.PROPERTIES; -1: a 1-D
# histogram), bin counts and the offset into the flat bins
HI_REC = 0
HI_PROP_A = 1
HI_PROP_B = 2
HI_NA = 3
HI_NB = 4
HI_OFF = 5
HIST_I = 6

# Event-log records (engine/eventlog.py): ints and floats per record
LOG_I = 6
LOG_F = 12

# K13, the pathwise channels' table (``pathwise_table``): per channel the
# kind (PATH_N: a node's refractive index; PATH_GEOM: a geometry
# parameter), the node and the parameter's index in the node's NF_GP
# values; and the width of a channel's tangent map (engine/pathwise.py
# OUTPUTS).
PATH_KIND = 0
PATH_NODE = 1
PATH_PARAM = 2
PATH_I = 3
PATH_N = 0
PATH_GEOM = 1
PATH_J = 10

N_SEL = len(EVENTS)  # recorder selectors, recorder.EVENTS tags
MAX_RECORDERS = comp.MAX_RECORDERS
SEEN_WORDS = MAX_RECORDERS // 32  # the kernel's per-photon seen bitset
# A block of the kernel moves a recorder's float32 moment sums into the
# float64 totals at every SUMS_FLUSH-th distinct ray of that recorder.
SUMS_FLUSH = 1024

LAYOUT = MappingProxyType({
    name: value for name, value in globals().items()
    if name.isupper() and isinstance(value, int)
})


ROW_RECORDS = ("node_f", "node_i", "ovr_f", "ovr_i", "light_f", "light_i")


def _isotropic_if_flat(kind, hg_kind, iso_kind, g):
    return iso_kind if kind == hg_kind and abs(g) < 1e-12 else kind


def _check_partition(segs, name):
    """Raise ValueError unless the segments `segs` of piecewise fit `name`
    partition [-1, 1]: from -1 to 1, each starting where the last ended."""
    a = np.asarray([seg[0] for seg in segs], np.float64)
    b = np.asarray([seg[1] for seg in segs], np.float64)
    if not (a[0] == -1.0 and b[-1] == 1.0 and np.all(a < b) and np.array_equal(a[1:], b[:-1])):
        raise ValueError(f"K5a fit {name}: its segments {list(zip(a, b))} do not partition "
                         "[-1, 1] (contiguous, sorted, from -1 to 1)")


class _Fits:
    """Flattens compiler fit descriptors into the cheb_* records."""

    def __init__(self):
        self.fit_i, self.fit_f, self.seg_f, self.seg_i, self.coef = [], [], [], [], []
        self.seg_coef = []  # each segment's coefficients, for cheb_pack

    def add(self, fit, name):
        """Append fit ``(kind, coef, off)`` (`name` says which, in errors);
        returns its index."""
        kind, coef, off = fit
        segs = coef if kind == "pw" else ((-1.0, 1.0, kind, coef),)
        if kind == "pw":
            _check_partition(segs, f"{len(self.fit_i)} ({name})")
        self.fit_i.append(({"lin": FIT_LIN, "log": FIT_LOG, "pw": FIT_PW}[kind],
                           len(segs), len(self.seg_i)))
        self.fit_f.append(float(off))
        for a, b, skind, c in segs:
            c = np.asarray(c, np.float64).ravel()
            self.seg_f.append((a, b, 2.0 / (b - a)))
            self.seg_i.append((FIT_LOG if skind == "log" else FIT_LIN, len(self.coef), len(c) - 1))
            self.coef.extend(c.tolist())
            self.seg_coef.append(c)
        return len(self.fit_i) - 1

    def pack(self, real=np.float32):
        """The fits as ``cheb_pack``'s words for reals of type `real`
        (module doc): int32 words for float32, int64 for float64."""
        F, S = len(self.fit_i), len(self.seg_i)
        word = np.int64 if real == np.float64 else np.int32

        def bits(x):
            return int(np.asarray(x, real).view(word))

        brk = [bits(self.seg_f[s][SF_B]) for _, nseg, seg0 in self.fit_i if nseg > 1
               for s in range(seg0, seg0 + nseg - 1)]
        words = [0] * (CHEB_REC * (F + S)) + brk + [0] * (-len(brk) % 4)
        at = CHEB_REC * (F + S)  # the next fit's breakpoints
        for f, (kind, nseg, seg0) in enumerate(self.fit_i):
            words[CHEB_REC * f:CHEB_REC * (f + 1)] = (
                nseg, CHEB_REC * (F + seg0), at, bits(self.fit_f[f]))
            at += nseg - 1 if nseg > 1 else 0
            for s in range(seg0, seg0 + nseg):
                skind, deg = self.seg_i[s][SI_KIND], self.seg_i[s][SI_DEG]
                flags = deg | (SEG_LOG if skind == FIT_LOG else 0) \
                    | (SEG_MAP if kind == FIT_PW else 0)
                words[CHEB_REC * (F + s):CHEB_REC * (F + s + 1)] = (
                    bits(self.seg_f[s][SF_A]), bits(self.seg_f[s][SF_SCALE]), len(words), flags)
                c = [bits(x) for x in self.seg_coef[s][::-1]]
                words += c + [0] * (-len(c) % 4)
        return np.asarray(words or [0] * CHEB_REC, word)


def _cheb_records(compiled, real=np.float32):
    """cheb_* arrays and meta of `compiled`'s fits (empty when it has none),
    ``cheb_pack`` for reals of type `real`."""
    N, W = len(compiled.nodes), compiled.pack_width
    fits = _Fits()
    comp_fit = [fits.add(f, f"component {c}") for c, f in enumerate(compiled.cheb_comp or ())]
    slots = np.zeros((N * W, 2), np.int32)
    refs = []
    spec = compiled.cheb_spec
    if spec is not None and compiled.cheb_comp is not None:
        for n, node_fits in sorted(spec.items()):
            cums = [fit[1] for fit in node_fits if fit[0] == "cum"]
            if any(tuple(ids) != tuple(cums[-1][:len(ids)]) for ids in cums):
                # The kernel forms every cumulative slot of a node from the
                # partial sums of its last one (tracer.cuh alpha_slot).
                raise ValueError(f"node {n}: its cumulative slots are not prefixes of the last")
            for w, fit in enumerate(node_fits):
                ids = ([comp_fit[c] for c in fit[1]] if fit[0] == "cum"
                       else [fits.add(fit, f"node {n} slot {w}")])
                slots[n * W + w] = (len(refs), len(ids))
                refs.extend(ids)
        if len(spec) == 1:
            # The JAX rule (tracer.py spec_slots_cheb): with one component
            # node, its slot values serve every container.
            (n,) = spec
            slots[:] = np.tile(slots[n * W:(n + 1) * W], (N, 1))
    icdf0 = len(fits.fit_i)
    for lum, f in enumerate(compiled.cheb_icdf or ()):
        fits.add(f, f"emission ICDF {lum}")
    light0 = len(fits.fit_i)
    for row, f in enumerate(compiled.cheb_light_icdf or ()):
        fits.add(f, f"lamp ICDF {row}")

    no_cheb = bool(os.environ.get("PVTRACE_TPU_NO_CHEB", ""))
    records = {
        "cheb_fit_i": np.asarray(fits.fit_i or [(FIT_LIN, 0, 0)], np.int32),
        "cheb_fit_f": np.asarray(fits.fit_f or [0.0]),
        "cheb_seg_f": np.asarray(fits.seg_f or [(-1.0, 1.0, 1.0)]),
        "cheb_seg_i": np.asarray(fits.seg_i or [(FIT_LIN, 0, 0)], np.int32),
        "cheb_coef": np.asarray(fits.coef or [0.0]),
        "cheb_slot": slots,
        "cheb_ref": np.asarray(refs or [0], np.int32),
        "cheb_pack": fits.pack(real),
    }
    meta = {
        "cheb_spec": spec is not None and compiled.cheb_comp is not None and not no_cheb,
        "cheb_icdf": bool(compiled.cheb_icdf) and not no_cheb,
        "cheb_light": compiled.cheb_light_icdf is not None and not no_cheb,
        "cheb_icdf0": icdf0,
        "cheb_light0": light0,
        "cheb_n_fits": len(fits.fit_i),
        "cheb_max_seg": max([nseg for _, nseg, _ in fits.fit_i] + [1]),
        "cheb_max_refs": int(slots[:, 1].max()) if slots.size else 0,
        "cheb_words": int(records["cheb_pack"].size),
    }
    return records, meta


def _recorder_records(compiled):
    """rec_*, hist_* and the (node, selector) CSR index of `compiled`, with
    each key's recorders grouped by their facet test."""
    R, N = compiled.n_recorders, len(compiled.nodes)
    if R > MAX_RECORDERS:
        raise ValueError(f"at most {MAX_RECORDERS} recorders, got {R}")
    rec_f = np.zeros((max(R, 1), REC_F))
    rec_i = np.zeros((max(R, 1), REC_I), np.int32)
    # Per key, its recorders by facet test (first appearance order): a
    # recorder without a facet, or the facet's normal and tolerance.
    keys = [{} for _ in range(N * N_SEL)]
    for r in range(R):
        rec_f[r, RF_NX:RF_NX + 3] = compiled.rec_facet[r]
        rec_f[r, RF_ATOL] = compiled.rec_atol[r]
        rec_i[r] = (compiled.rec_node[r], compiled.rec_event[r], compiled.rec_has_facet[r],
                    compiled.rec_hist_start[r], compiled.rec_hist_n[r])
        test = (tuple(float(x) for x in compiled.rec_facet[r]), float(compiled.rec_atol[r])) \
            if compiled.rec_has_facet[r] else None
        keys[compiled.rec_node[r] * N_SEL + compiled.rec_event[r]].setdefault(test, []).append(r)
    specs = compiled.hist_specs
    hist_f = np.zeros((max(len(specs), 1), HIST_F))
    hist_i = np.zeros((max(len(specs), 1), HIST_I), np.int32)
    for h, (r, pa, pb, na, nb, lo_a, hi_a, lo_b, hi_b, offset) in enumerate(specs):
        hist_f[h] = (lo_a, hi_a - lo_a, lo_b, hi_b - lo_b)
        hist_i[h] = (r, pa, pb, na, nb, offset)
    groups = [g for k in keys for g in k.values()]
    tests = [t for k in keys for t in k]
    grp_f = np.zeros((max(len(groups), 1), GRP_F))
    for g, test in enumerate(tests):
        if test is not None:
            grp_f[g] = (*test[0], test[1], 1.0)
    csr = np.cumsum([0] + [sum(len(g) for g in k.values()) for k in keys]).astype(np.int32)
    ids = np.asarray([r for g in groups for r in g] or [0], np.int32)
    return {
        "rec_f": rec_f, "rec_i": rec_i, "hist_f": hist_f, "hist_i": hist_i,
        "rec_csr": csr, "rec_ids": ids,
        "rec_grp": np.cumsum([0] + [len(k) for k in keys]).astype(np.int32),
        "grp_pos": np.cumsum([0] + [len(g) for g in groups]).astype(np.int32),
        "grp_f": grp_f,
    }


def scene_tensors(compiled, dtype=torch.float32, device="cpu"):
    """Flat tensors of `compiled` in `dtype` on `device` (see module doc).

    Returns a dict of tensors plus ``"meta"``, a dict of the scene-wide
    python scalars (node count, root, grid and ICDF sizes, pack width,
    triangle count, which lookups take K5a, recorder and bin counts), and
    ``"rows"``, the small records as python lists.
    """
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    N = len(compiled.nodes)
    eps = compiled.resolved_eps_per_node(np_dtype)

    node_f = np.zeros((N, NODE_F))
    node_i = np.zeros((N, NODE_I), np.int32)
    ovr_f, ovr_i, tri_f = [], [], []
    comp_first = [int(compiled.node_comp_idx[n, 0]) for n in range(N)]
    p1_slot = {}
    for n, (geom, surf, K, comp_ids, lums, ovrs) in enumerate(
        compiled.node_static
    ):
        if K and tuple(comp_ids) != tuple(range(comp_first[n], comp_first[n] + K)):
            raise ValueError("node components must be a contiguous range")
        node_f[n, NF_W2L:NF_W2L + 12] = compiled.world_to_local[n, :3, :4].ravel()
        node_f[n, NF_L2W:NF_L2W + 9] = compiled.local_to_world[n, :3, :3].ravel()
        node_f[n, NF_GP:NF_GP + 3] = compiled.geom_params[n, :3]
        node_f[n, NF_EPS] = eps[n]
        node_f[n, NF_NIDX] = compiled.refractive_index[n]
        mesh = compiled.mesh_data.get(n)
        n_tris = 0 if mesh is None else len(mesh[0])
        node_i[n] = (geom, surf, K, comp_first[n] if K else 0, len(ovr_i), len(ovrs),
                     len(tri_f), n_tris)
        if mesh is not None:
            tri_f.extend(np.concatenate(mesh, axis=1))
        for mode, normal, atol in ovrs:
            ovr_f.append((*normal, atol))
            ovr_i.append(mode)
        for cid, j in lums:
            p1_slot[cid] = K + 2 * j

    comp_f = np.zeros((max(compiled.n_components, 1), COMP_F))
    comp_i = np.zeros((max(compiled.n_components, 1), COMP_I), np.int32)
    for c, (ctype, qy, tau_rad, tau_nr, ptype, pparam, lum) in enumerate(
        compiled.comp_static
    ):
        comp_f[c] = (qy, tau_rad, tau_nr, pparam, np.sin(pparam))
        ptype = _isotropic_if_flat(
            ptype, comp.PHASE_HENYEY_GREENSTEIN, comp.PHASE_ISOTROPIC, pparam
        )
        comp_i[c] = (ctype, ptype, max(lum, 0), p1_slot.get(c, -1))

    C = comp.CompiledScene
    lights = compiled.light_static
    light_f = np.zeros((len(lights), LIGHT_F))
    light_i = np.zeros((len(lights), LIGHT_I), np.int32)
    for li, (wspec, pspec, dspec, matrix) in enumerate(lights):
        dkind = _isotropic_if_flat(dspec[0], C.DIR_HG, C.DIR_ISOTROPIC, dspec[1])
        light_f[li, LF_WAV] = wspec[1] if wspec[0] == C.WAV_CONST else 0.0
        light_f[li, LF_POS:LF_POS + 3] = pspec[1:4]
        light_f[li, LF_DIR] = dspec[1]
        light_f[li, LF_SIN_DIR] = np.sin(dspec[1])
        light_f[li, LF_MAT:LF_MAT + 12] = np.asarray(matrix)[:3, :4].ravel()
        row = int(wspec[1]) if wspec[0] == C.WAV_SPECTRUM else 0
        light_i[li] = (wspec[0], pspec[0], dkind, row)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    cheb, cheb_meta = _cheb_records(compiled, np_dtype)
    recs = _recorder_records(compiled)
    out = {
        "node_f": f(node_f),
        "node_i": i(node_i),
        "comp_f": f(comp_f),
        "comp_i": i(comp_i),
        "ovr_f": f(ovr_f if ovr_f else np.zeros((1, OVR_F))),
        "ovr_i": i(ovr_i if ovr_i else [comp.OVR_NONE]),
        "tri_f": f(tri_f if tri_f else np.zeros((1, TRI_F))),
        "light_f": f(light_f),
        "light_i": i(light_i),
        "spec_pack": f(compiled.spec_pack),
        "ems_icdf_pairs": f(compiled.ems_icdf_pairs),
        "light_icdf_pairs": f(compiled.light_icdf_pairs),
        **{k: (torch.as_tensor(v, device=device) if k == "cheb_pack" else i(v)
               if v.dtype == np.int32 else f(v)) for k, v in cheb.items()},
        **{k: (i(v) if v.dtype == np.int32 else f(v)) for k, v in recs.items()},
        "meta": {
            "n_nodes": N,
            "root_id": int(compiled.root_id),
            "n_comps": int(compiled.n_components),
            "n_lights": len(lights),
            "n_lum": int(compiled.n_lum),
            "grid_n": int(compiled.grid_n),
            "icdf_n": int(compiled.icdf_n),
            "pack_width": int(compiled.pack_width),
            "n_tris": len(tri_f),
            "grid_x0": float(compiled.grid_x0),
            "grid_dx": float(compiled.grid_dx),
            "n_rec": int(compiled.n_recorders),
            "n_grp": int(recs["grp_pos"].size - 1),
            "grp_max": int(np.diff(recs["grp_pos"]).max(initial=0)),
            "total_bins": int(compiled.total_bins),
            **cheb_meta,
        },
    }
    # The same records as python rows, read once, for the eager twin's
    # loops over nodes, overrides and lights.
    out["rows"] = {name: out[name].tolist() for name in ROW_RECORDS}
    return out


def pathwise_table(specs, device="cpu"):
    """The pathwise channels `specs` (``("n", node)`` or ``("geom", node,
    j)``) as int32 rows [max(C, 1), PATH_I] for the kernel."""
    rows = [(PATH_N, int(p[1]), 0) if p[0] == "n" else (PATH_GEOM, int(p[1]), int(p[2]))
            for p in specs]
    return torch.as_tensor(np.asarray(rows or [(0, 0, 0)], np.int32), device=device)
