"""On-card checks of each kernel against its plain-PyTorch twin.

``chip_smoke.py`` and the GPU tests run these on CUDA scene tensors. Each
check raises AssertionError on a mismatch and returns what it measured:
the largest deviation, the kernel's and the twin's times (CUDA events,
milliseconds per call), and the operations and bytes the call needs,
counted from the code and this call's inputs, for its bound (``bound``).
"""
import numpy as np
import torch

from pvtrace_tpu_torch import kernels
from pvtrace_tpu_torch.engine import absorb, chebyshev, eventlog, geometry, history_tally, physics
from pvtrace_tpu_torch.engine import rng, tally
from pvtrace_tpu_torch.engine import pathwise as path
from pvtrace_tpu_torch.engine import tracer
from pvtrace_tpu_torch.engine import score as score_ch
from pvtrace_tpu_torch.engine import compiler as comp
from pvtrace_tpu_torch.engine import tables as T
from pvtrace_tpu_torch.light.event import Event

# Discrete outcomes of a step that must agree lane by lane.
DISCRETE = ("alive", "hit", "container", "source", "count") + physics.FLAGS \
    + physics.SELECTORS + physics.EVENT_FLAGS
# pvt_cheb against the twin: |kernel - twin| over the fit's largest |value|
# on the grid. Both are float32; nvcc's FMA contraction in the affine map
# and in the Clenshaw chain (up to degree 64) moves the kernel by ulps.
CHEB_RTOL = 1e-5
# The kernels' moment sums: a block adds each recorder's eight moments
# (all non-negative) into float32 partials, which move into the float64
# totals every SUMS_FLUSH distinct rays of that recorder and at the end.
# A warp adds its fresh lanes' moments as one sum (in lane order, at most
# 31 roundings of itself), so a partial takes at most SUMS_FLUSH adds
# between two moves plus one in flight from each of the block's other 7
# warps: it is off by at most (SUMS_FLUSH + 38) roundings of its value,
# within (SUMS_FLUSH + 255) * 2**-24 = 7.6e-5 (the bound of one add a
# thread, kept), however many photons the block traces; so is their
# total.
SUMS_BOUND = (T.SUMS_FLUSH + 255) * 2.0 ** -24
# pvt_tally's sums against the twin's, which adds one float32 reduction
# over the lanes (about log2(lanes) roundings) per step: SUMS_BOUND and
# that, rounded up.
SUMS_RTOL = 1e-4
# Two kernel runs of the same photons, one result cast to float32.
SUMS_RUNS_RTOL = 2 * SUMS_BOUND + 2.0 ** -24
# The float64 build adds each addend to its recorder's double sum (in a
# block's shared memory, then into the totals), as the twin adds them in
# float64 in another order. The moments are non-negative, so a sum of m of
# them in any order is within (m - 1) 2**-53 of its value (the bound of
# recursive summation); the kernel's and the twin's each, and each addend
# may differ by two ulps (an angle's acos of a cosine an ulp apart), so
# they agree within ``sums_bound_f64(m)`` relative, m a recorder's
# distinct rays.
F64_ULP = 2.0 ** -53


def sums_bound_f64(m):
    """Relative bound of two float64 sums of the same m non-negative
    addends in two orders, each addend within two ulps (tensor or
    number)."""
    return (2 * m + 4) * F64_ULP


# That holds for one step's events given to two tallies (``check_tally``).
# Two traces (``check_trace``: the kernel's steps and the twin's) carry
# their own rounding into each addend, and every column takes it: a
# wavelength from K5a's emission fit, and the path length and duration
# (each segment's length, times n / c for the duration) after a few steps,
# are within F64_RTOL of each other (below), not two ulps, and so is the
# direction the incidence cosine c is taken from. Near normal incidence
# the angle also takes c's own rounding, where acos's slope 1/sin(angle)
# has no bound: the two builds' c are each within two ulps of the exact
# cosine, so up to four ulps (2**-51) apart below 1, which move acos(c) by
# up to sqrt(2 * 2**-51) = 2**-25, and its square by up to pi * 2**-51
# (2 angle d(angle), angle / sin(angle) <= pi / 2). So each sum takes
# F64_RTOL of itself beside the summation bound, and the angle moments
# ANGLE_F64 and ANGLE2_F64 a distinct ray (``sums_allow_f64``).
ANGLE_F64, ANGLE2_F64 = 2.0 ** -25, np.pi * 2.0 ** -51


def sums_allow_f64(sums, m):
    """Allowed |kernel - twin| of two traces' float64 moment sums [R, 8]
    (`sums`, the twin's: wavelength, angle, duration, path length and
    their squares) of m [R] distinct rays: ``sums_bound_f64(m)`` and
    F64_RTOL of each, and for the angle and its square the part their
    cosines' rounding adds near normal incidence (ANGLE_F64, ANGLE2_F64 a
    ray)."""
    allow = sums.abs() * (sums_bound_f64(m)[:, None] + F64_RTOL)
    allow[:, 2] += m * ANGLE_F64
    allow[:, 3] += m * ANGLE2_F64
    return allow


# The float64 build against the float64 twin, both on the card: FMA
# contraction moves the kernel by ulps (2**-53 relative), which a few
# steps carry on through divisions by small distances (5e-11 found after
# 8 steps at 2**20 lanes); F64_RTOL is twenty times that, and five orders
# below float32's 1e-4. K5a's Clenshaw chains of up to degree 64 grow an
# ulp by a few hundred, as CHEB_RTOL is float32's 2**-24 grown. K10's t is
# a quotient by the determinant, small at grazing incidence, which grows
# the contracted cross and dot products' ulps (1.5e-11 found at 2**20
# rays): F64_RTOL too. A hit count may differ only on a ray within
# EDGE_TOL_F64 (barycentric) of an edge, FMA's reach in float64.
F64_RTOL, F64_ATOL = 1e-9, 1e-12
CHEB_RTOL_F64 = 1e-12
MESH_RTOL_F64 = F64_RTOL
EDGE_TOL_F64 = 1e-12
# A float64 trace against the twin: a discrete outcome flips only where a
# value lies within an ulp or so of a threshold, about 1e-9 of float32's
# chance, so fates and integer tallies agree within F64_PARTED at 2**20
# photons, and records photon by photon with at most F64_PARTED parted.
F64_PARTED = 4

# The card's peaks for the bound (H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores; and 32-bit
# integer instructions, 64 a clock an SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) on 132 SMs at
# the 1.98 GHz boost clock, on each of two pipes: shifts and logic (SHF,
# LOP3, LEA) issue on the ALU pipe alone, adds on it (IADD3) or on the FMA
# pipe (IMAD.IADD).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_INT_OPS_PER_S = 64 * 132 * 1.98e9
# Float64 operations/s outside the tensor cores (the same data sheet):
# the float64 build's float work is taken at this rate.
PEAK_F64_OPS_PER_S = 34e12

# Operations per unit of work, counted from tracer.cuh (add, multiply,
# compare, select and shift each count one; an FMA two; exp, log1p, sqrt,
# acos, sin and cos ten each), the draws apart. The draws are integer
# instructions, counted as the SASS of threefry issues them (``python -m
# pvtrace_tpu_torch.kernels.variants --sass``: 20 SHF.L.W a call) and only
# those a run's words need (``step_draws``, ``emit_draws``):
OPS_THREEFRY_ALU = 40  # 20 funnel shifts (a rotate each), 20 xors
OPS_THREEFRY_ADD = 26  # 20 rounds, 5 key injections into x1, the last into x0 (others fuse)
OPS_UNIFORM_ALU = 1  # a word to [1, 2): one LEA.HI (the float subtract not counted)
OPS_STEP = 420  # one LSC-slab step, its draws apart
OPS_EMIT = 80  # samplers, transform, the draws apart
OPS_CHEB_SEARCH = 4  # one halving step of the segment search: load, compare, select, shift
OPS_CHEB_DEGREE = 4  # one Clenshaw step
OPS_CHEB_EVAL = 24  # affine map, final step, exp on a log segment
OPS_TALLY_LANE = 30  # key, candidate walk, acos, local frame
OPS_TALLY_MATCH = 12  # facet test, crossing
OPS_TALLY_NEW = 20  # seen bit, distinct, eight moments
OPS_TALLY_BIN = 10  # one histogram bin
OPS_TRIANGLE = 60  # one Möller–Trumbore test: 3 cross products, 4 dots, a division
OPS_LERP = 10  # one K5b lerp: grid index, clamp, cast, row offset, two loads' lerp
OPS_FRESNEL_DR = 70  # fresnel_dR: two partials, 8 divisions, a root
OPS_SCORE_STEP = 20 + OPS_FRESNEL_DR  # component channels of the slab, branch, 4 row adds
OPS_SCORE_FOLD = 4  # per channel folded: load, compare, two float64 adds
OPS_CHORD = 60  # one node's transform (24) and chord (box slab test, 36)
OPS_ABSORBED = 20  # grid lerp, exp, weight
OPS_ABSORBED_GRAD = 16  # two multiplies, exp, a float64 add
OPS_PATH_STEP = 40  # the hybrid terms a step's channels share (expm1 twice, exp, branch)
OPS_PATH_CHANNEL = 260  # one channel's tangent map: frames 36, slab test 60, normal, Fresnel
# 90, reflection or refraction 40, hybrid terms and shift 30

# pvt_mesh against the twin: t1 and t2 within MESH_RTOL relative where the
# hit counts agree; the counts may differ only on rays that pass within
# EDGE_TOL (barycentric) of a triangle's edge, where FMA contraction can
# move a hit across it.
MESH_RTOL = 1e-5
EDGE_TOL = 1e-5
# The event log against the twin's: a recorded photon whose ints differ
# anywhere has diverged (an ulp flipped one of its discrete outcomes); on
# the others, every float within LOG_RTOL of the twin's, relative to its
# column's largest magnitude (the scene's size for positions, 1 for
# directions). Not to each value's own magnitude: K5a carries the
# kernel's rounding relative to a fit's scale (CHEB_RTOL), so in a
# spectrum's tail an absorption length, and the positions it leads to,
# can differ by more than 1e-4 of their own size.
LOG_RTOL = 1e-4
LOG_DIVERGED = 1e-2
# A float32 photon whose events all equal the twin's can still drift past
# LOG_RTOL: a reflection or refraction on a curved surface (a sphere's, a
# cylinder's) turns a position's rounding into a direction's, and each
# further one grows it (3e-2 of the scene's scale after about 20
# reflections in a random scene's cylinder, float32 with and without
# contraction on the host). Such a photon is held apart from the parted
# ones: its records agree within LOG_RTOL up to its first surface event on
# a curved node, and at most LOG_DRIFTED of the recorded photons drift
# (random scenes 1 and 10 on the card: 1 and 8 of 16384, 4.9e-4). Float64
# has no such allowance: every photon whose events are equal is within
# F64_RTOL.
LOG_DRIFTED = 2e-3
CURVED = (comp.GEOM_SPHERE, comp.GEOM_CYLINDER)
#
# Coincident faces: where two nodes share a face (touching boxes), a
# crossing hits one of the two surfaces at one distance, and rounding picks
# which (the JAX package alike; even the host build and the twin differ on
# a few photons in 10^4). The container and adjacent node, and so the
# physics, are the same either way; the hit node, the sign of the logged
# normal and the recorder that counts the crossing (escaping the one,
# entering the other) are not. The checks take the nodes with such faces
# (`coincident`): a record whose hit differs only that way is equal
# (``coincident_hits``). The recorders on those nodes are held through
# probes (``scenes.random_scene(probes=True)``): pairs of facet recorders,
# the escaping one of the lower box and the entering one of the upper on a
# shared face (and the reverse), whose crossings sum to the same whichever
# surface a crossing hit. Each pair's sum is held as any tally, and every
# integer tally of a recorder on those nodes within the tally's tolerance
# plus U, the twin's crossings of the shared faces (the probes' sum): a
# crossing whose hit the two builds pick differently moves a count by one.


def coincident_recorders(st, nodes):
    """Boolean [R] of the recorders on `nodes` (nodes with a coincident
    face) and boolean [total_bins] of their histogram bins."""
    R, B = st["meta"]["n_rec"], st["meta"]["total_bins"]
    rec_i, hist_i = st["rec_i"][:R].cpu(), st["hist_i"].cpu()
    on = torch.tensor([int(rec_i[r, T.RI_NODE]) in set(nodes) for r in range(R)],
                      dtype=torch.bool)
    bins = torch.zeros(B, dtype=torch.bool)
    for r in torch.nonzero(on)[:, 0].tolist():
        for h in range(int(rec_i[r, T.RI_HIST0]), int(rec_i[r, T.RI_HIST0] + rec_i[r, T.RI_NHIST])):
            off = int(hist_i[h, T.HI_OFF])
            bins[off:off + int(hist_i[h, T.HI_NA] * max(int(hist_i[h, T.HI_NB]), 1))] = True
    return on, bins


def hold_tallies(got_t, ref_t, st, tol, label, coincident=(), probes=()):
    """Hold the kernel's integer tallies to the twin's: each within `tol`
    on the recorders off `coincident` nodes; on them, each probe pair's
    (`probes`, recorder indices) crossings summed within `tol`, and each
    tally within `tol` + U, U the twin's crossings of the probes (above).
    Returns {name: largest diff off those nodes}, U and the largest diff on
    them."""
    R, B = st["meta"]["n_rec"], st["meta"]["total_bins"]
    on, on_bins = coincident_recorders(st, coincident)
    if bool(on.any()) and not probes:
        raise ValueError("recorders on coincident nodes need probes (random_scene(probes=True))")
    cross_k, cross_t = got_t["cross"].cpu()[:R].long(), ref_t["cross"].cpu()[:R].long()
    for a, b in probes:
        d = abs(int(cross_k[a] + cross_k[b]) - int(cross_t[a] + cross_t[b]))
        require(d <= tol, f"{label}: probes {a}, {b} cross a shared face {d} times more or "
                f"less than the twin's (limit {tol})")
    shared = int(sum(int(cross_t[a] + cross_t[b]) for a, b in probes))
    out, aside = {}, 0
    for name in ("distinct", "cross", "bins"):
        d = (got_t[name].cpu()[:B if name == "bins" else R].long()
             - ref_t[name].cpu()[:B if name == "bins" else R].long()).abs()
        mask = on_bins if name == "bins" else on
        out[name] = int(d[~mask].max()) if bool((~mask).any()) else 0
        require(out[name] <= tol, f"{label}: recorder {name} off by {out[name]} > {tol}")
        if bool(mask.any()):
            aside = max(aside, int(d[mask].max()))
    require(aside <= tol + shared, f"{label}: a recorder on a coincident face off by {aside} > "
            f"{tol} + {shared} shared-face crossings")
    return out, shared, aside


# Recorder moment sums recomputed from the kernel's float32 log in
# float64, against the kernel's own: SUMS_BOUND and the angle's float32
# rounding (acos of a float32 cosine), rounded up.
LOG_SUMS_RTOL = 2e-4
# K12 against its twin, both float32 on the card: a lane's path score
# within SCORE_RTOL of its channel's scale (the largest |score| of the
# twin's lanes) plus the score's slack, which the twin carries with it
# (``engine/score.py``: K5a's rounding on the component channels, the
# Fresnel partials' conditioning near the critical angle on the node
# channels); FMA contraction moves each contribution by ulps.
SCORE_RTOL = 1e-4
# Score sums (fate_scores, rec_scores): each addend is a float32 path
# score and its sign varies, so a bound relative to the sum itself means
# nothing. The trace kernel against its twin is held photon by photon
# (``compare_score_records``): a photon's path parted from the twin's
# where its fate or step count differs, or a channel of its folded score
# is off by more than SCORE_RTOL of the channel's scale plus its slack;
# at most SCORE_PARTED of the photons may part. The kernel's sums must
# equal its own records added up by fate, in float64 (m addends in two
# orders: 2 m 2**-53 S, S the sum of their magnitudes, fate_abs /
# rec_abs), and the twin's sums within SCORE_RTOL of S, the folded
# scores' slack, and twice the channel's largest |score| for each photon
# that parted. Two kernel runs of the same photons: each photon's
# float32 score is the same in both (its own steps in order); the kernel
# adds them in float64, m of them with an error of at most m * 2**-53 * S
# per run; ``simulate`` returns the sums cast to float32 (2**-24 * S).
# ``score_runs_bound`` gives that bound.
SCORE_F64_ULP = 2.0 ** -53
SCORE_PARTED = 1e-4
# A float32 photon whose fate and steps equal the twin's can still part in
# its score record: as in the event log (LOG_DRIFTED), its path drifts on
# curved surfaces and the score terms follow it. The host build and the
# twin agree step by step from one state, so only the paths part (random
# scene 20: photons 47340 and 51731 of 2**16 on the host build; 8 parted
# of 2**16 on the card, 1.2e-4, against the slab's 0-2 of 2**20). A
# caller that runs such scenes gives such photons room of their own
# (``compare_score_records``' `max_drifted`): at most SCORE_DRIFTED.
SCORE_DRIFTED = 5e-4
# Fresnel partials in float32 on the card against the twin in float32:
# SCORE_RTOL of max(|value|, 1) (the partials are sums of O(1) terms that
# cancel near grazing incidence and at n1 = n2), away from the critical
# angle, where 1 - ratio^2 s2 is within FRESNEL_SINGULAR of 0 and the
# square root's slope decides the value.
FRESNEL_SINGULAR = 1e-3
# K15 against the plain version, both float32 on the card: weights and
# depths within ABSORBED_RTOL relative (FMA contraction in the transform
# and the chord), the gradient within GRAD_RTOL of the sum of its terms'
# magnitudes (a float32 sum in another order).
ABSORBED_RTOL = 1e-5
GRAD_RTOL = 1e-4
# K13 against its twin, both float32 on the card, lane by lane: each
# output of a channel's tangent map (``kernels.pathwise_step``) within
# PATH_RTOL of its scale (the largest |value| of the twin's lanes; see
# PATH_GROUPS), the contribution within that plus its slack
# (``engine/pathwise.py``), and each value also within
# ``pathwise.grazing`` of itself: near a grazing hit, t0's tangent carries
# the rounding of the incidence cosine c_hit over c_hit^2 (1.1e-3 of the
# value at c_hit = 0.034 on a cylinder's barrel, measured on the H100).
# The reflectivity's tangent and the coin term also carry PATH_RTOL of the
# tangents' scale (the error of the incidence cosine's tangent) times
# dR/dc, which grows without bound at the critical angle. Left out,
# counted and capped at PATH_LEFT_OUT of the lanes: lanes whose step
# differs (the discrete outcomes), lanes where either side saturates
# (``saturates``: a square root's infinite slope taken through
# nan_to_num, FLT_MAX, or a NaN sum of two), and lanes whose nearest hit
# is below the grazing cosine ``score.GRAZING_C``. In the photon-by-photon
# trace check a photon whose record saturates on either side is left out
# and counted likewise (at most SCORE_PARTED of them), and its scores join
# the sums' allowance.
PATH_RTOL = 1e-4
PATH_LEFT_OUT = 1e-3
# A scale is taken over a group of outputs: the position's and the
# direction's tangents, before and after the shift, and t0's (a direction
# tangent's rounding is a position tangent's over a radius of curvature
# of order 1 cm: a ray whose origin moves along itself hits a curved
# surface at the same point, and the tangent of the normal there is 0 in
# exact arithmetic and a residue of two cancelling O(|position tangent|)
# terms in float32), and the wavelength's; each other output has its own.
# A scale is at least PATH_FLOOR of the channel's largest.
PATH_GROUPS = ((0, 1, 2, 3, 4, 5, 7, 11, 12, 13, 14, 15, 16), (6, 17))
PATH_FLOOR = 1e-6
# ``saturates``' threshold: nan_to_num takes an infinite slope to FLT_MAX
# in float32 and to DBL_MAX in float64, both above it, and no path score
# or tangent of a float64 run comes near it otherwise, so it serves both.
SATURATED = 1e30
# K12, K13 and K15 of the float64 builds against the float64 twin, both on
# the card. Each float32 bound above is float32's rounding grown by the
# step's conditioning; float64's rounding is 2**-29 of it, and nvcc's FMA
# contraction moves the float64 kernels by ulps that a few steps grow to
# 5e-11 of a value (the float64 trace, F64_RTOL). So each float64 bound is
# its float32 form with the rounding part taken at F64_RTOL in place of
# 1e-4, the factor F64_SLACK = F64_RTOL / SCORE_RTOL (1e-5), still 10**4
# times float64's own rounding in each:
# * ``rtol``, ``path_rtol``: a path score, a tangent map's output, a fold
#   against its magnitudes, a Fresnel partial (FRESNEL_SINGULAR still
#   leaves the critical angle out) within F64_RTOL of its scale;
# * the twin's slack (``score.SLACK_SPECTRAL``: K5a's 1e-5 of a fit's
#   scale, which is 1e-12 in float64, CHEB_RTOL_F64; ``FRESNEL_ROUNDING``,
#   ``GRAZING_ROUNDING`` and ``pathwise.grazing``: float32 ulps over the
#   incidence's conditioning) times F64_SLACK;
# * ``absorbed``: K15's weights and depths (F64_RTOL, as the float64
#   transform and chord); ``grad``: its gradient against the sum of its
#   terms' magnitudes, both float64 sums of float64 terms in other orders,
#   m terms within m 2**-53 each: F64_RTOL covers m to 10**7.
# Discrete outcomes part only where a value lies within an ulp or so of a
# threshold: F64_PARTED photons of a score trace may part (``parted``),
# and as many saturate (a photon's path, not its rounding, decides that).
# The lanes PATH_LEFT_OUT counts are the grazing hits below
# ``score.GRAZING_C`` and the saturated lanes, which the geometry sets, not
# the rounding: the same share bounds them in float64 (``left_out``).
F64_SLACK = F64_RTOL / SCORE_RTOL


def gradient_bounds(dtype):
    """The bounds of the K12, K13 and K15 checks for tensors of `dtype`:
    a dict of ``rtol`` (SCORE_RTOL, PATH_RTOL; float64: F64_RTOL), the
    factor on the twin's ``slack``, ``parted(n)`` the photons of n that may
    part, ``left_out`` (PATH_LEFT_OUT), ``absorbed`` and ``grad`` (K15's),
    and ``cast``, the rounding of ``simulate``'s sums in `dtype`."""
    if dtype == torch.float64:
        return {"rtol": F64_RTOL, "path_rtol": F64_RTOL, "slack": F64_SLACK,
                "parted": lambda n: F64_PARTED, "left_out": PATH_LEFT_OUT,
                "absorbed": F64_RTOL, "grad": F64_RTOL, "cast": 0.0,
                "fates": lambda n: F64_PARTED}
    return {"rtol": SCORE_RTOL, "path_rtol": PATH_RTOL, "slack": 1.0,
            "parted": lambda n: SCORE_PARTED * n, "left_out": PATH_LEFT_OUT,
            "absorbed": ABSORBED_RTOL, "grad": GRAD_RTOL, "cast": 2.0 ** -24,
            "fates": lambda n: max(20, n // 500)}


def require(ok, message):
    """Raise AssertionError(message) unless `ok` (kept under python -O)."""
    if not ok:
        raise AssertionError(message)


def bound(ops, nbytes, draws=(0, 0), dtype=torch.float32):
    """(bound_ms, bound_by): the largest of `ops` float operations at the
    peak of `dtype` (float32's, or float64's for the float64 build), the
    integer instructions of `draws` ((ALU, add), as ``threefry_draws``
    counts them: the ALU's alone at one pipe's rate, or all of them over
    both pipes, whichever is longer) and `nbytes` at the memory rate, and
    which of operations and bytes it is."""
    alu, add = draws
    t_int = max(alu, (alu + add) / 2) / PEAK_INT_OPS_PER_S
    peak = PEAK_F64_OPS_PER_S if dtype == torch.float64 else PEAK_OPS_PER_S
    t_ops = max(ops / peak, t_int)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def threefry_draws(calls, words):
    """(ALU, add) instructions of `calls` threefry calls, `words` of whose
    words become uniforms."""
    return (calls * OPS_THREEFRY_ALU + words * OPS_UNIFORM_ALU, calls * OPS_THREEFRY_ADD)


def add_draws(a, b):
    return (a[0] + b[0], a[1] + b[1])


# Fate slots (light.event.Event values; 10: left without a hit).
FATE_EXIT, FATE_KILL, FATE_NO_HIT = 7, 9, 10


def step_draws(steps, events):
    """The draws that `steps` steps, `events` of them at a volume or surface
    event, read at least: pair 0 each step, the event's first pair (1 or 3)
    at each event (re-emissions, lifetimes and Lambertian reflections read
    more, not counted; the kernel draws all four, pvt_draw)."""
    pairs = steps + events
    return threefry_draws(pairs, 2 * pairs)


def trace_events(total_steps, fates):
    """The steps of a trace at a volume or surface event: all but a
    photon's last step where it left (EXIT), was killed or hit nothing."""
    f = [int(x) for x in fates]
    return max(total_steps - f[FATE_EXIT] - f[FATE_KILL] - f[FATE_NO_HIT], 0)


def light_pairs(st):
    """The emission pairs each lamp of `st` reads (bit j: pair j), as
    tracer.cuh's light_pairs finds them: pair 0 for a spectrum's wavelength
    or a position, pair 1 for a position, pair 2 for a direction."""
    C = comp.CompiledScene
    masks = []
    for row in st["light_i"].view(-1, T.LIGHT_I).cpu().tolist():
        pos = row[T.LI_POS] != C.POS_DEFAULT
        masks.append(int(row[T.LI_WAV] != C.WAV_CONST or pos) | int(pos) << 1
                     | int(row[T.LI_DIR] != C.DIR_DEFAULT) << 2)
    return masks


def emit_draws(st, n, index_offset=0, bundle=False):
    """The draws that start photons [index_offset, index_offset + n) read
    at least: each photon's key and, emitted on the card, the emission
    pairs its own lamp reads (light pid mod the lamps; the kernel draws
    those of every lamp of the scene for each photon, emit_pairs)."""
    if bundle:
        return threefry_draws(n, 0)
    masks = light_pairs(st)
    pairs = 0
    for li, mask in enumerate(masks):
        first = (li - index_offset) % len(masks)
        photons = (n - first + len(masks) - 1) // len(masks) if n > first else 0
        pairs += photons * bin(mask).count("1")
    return threefry_draws(n + pairs, 2 * pairs)


def cuda_ms(fn, reps=10, warmup=1):
    """Mean milliseconds per call of `fn` on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps=10):
    """Mean device milliseconds per call of `fn`: `reps` calls captured in
    a CUDA graph and replayed, so no host time (a wrapper's checks and
    ctypes call, which outlast a kernel of a few microseconds) lies
    between the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _real(st):
    """The scene's dtype and the bytes of one of its reals."""
    dtype = st["node_f"].dtype
    return dtype, torch.empty(0, dtype=dtype).element_size()


def check_emit(st, seed_words, B, index_offset=0, atol=None, reps=10):
    """pvt_emit against the twin for B photons: keys and integer state
    bit-equal, floats within `atol` (None: 1e-5 in float32, F64_ATOL in
    float64). Returns (state, report)."""
    dtype, real = _real(st)
    atol = (F64_ATOL if dtype == torch.float64 else 1e-5) if atol is None else atol
    dev = st["node_f"].device
    pids = index_offset + torch.arange(B, device=dev, dtype=torch.int64)
    twin = tracer.initial_state(st, seed_words, pids)
    out = kernels.emit(st, seed_words, index_offset, B)
    torch.cuda.synchronize()
    err = 0.0
    for name, ref in twin.items():
        got = out[name]
        if ref.dtype.is_floating_point:
            err = max(err, float((got - ref).abs().max()))
        else:
            bad = int((got.long() != ref.long()).sum())
            require(bad == 0, f"pvt_emit: {name} differs in {bad} of {B} lanes")
    require(err <= atol, f"pvt_emit: max abs error {err} > {atol}")
    report = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: kernels.emit(st, seed_words, index_offset, B), reps),
        "plain_ms": cuda_ms(lambda: tracer.initial_state(st, seed_words, pids), reps),
    }
    # 14 lane outputs: 9 reals, 2 ints of 4 bytes, alive 1, the two int64
    # keys 16 (61 bytes in float32).
    report["bound_ms"], report["bound_by"] = bound(B * OPS_EMIT, B * (9 * real + 25),
                                                   emit_draws(st, B, index_offset), dtype)
    return twin, report


def check_step(st, state, steps=8, max_discrete=1e-4, rtol=None, atol=None,
               maxsteps=1000, emit_method=0, reps=10):
    """pvt_step against the twin for `steps` steps, both fed the twin's
    previous output. Discrete outcomes may differ on at most a fraction
    `max_discrete` of lanes (FMA contraction moves floats by ulps); the
    other lanes' floats must agree within rtol/atol (None: 1e-4 and 1e-5
    in float32, F64_RTOL and F64_ATOL in float64)."""
    dtype, real = _real(st)
    f64 = dtype == torch.float64
    rtol = (F64_RTOL if f64 else 1e-4) if rtol is None else rtol
    atol = (F64_ATOL if f64 else 1e-5) if atol is None else atol
    B = state["px"].shape[0]
    worst_frac, err = 0.0, 0.0
    s = state
    for k in range(steps):
        twin = tracer.step_state(st, s, maxsteps, emit_method)
        if k == 0:
            # The timed step's draws: pair 0 a live lane, the first pair
            # of each event.
            none = twin["exit_mask"] | twin["kills"] | twin["no_hit_term"]
            draws = step_draws(int(s["alive"].sum()), int((s["alive"] & ~none).sum()))
        got = kernels.step(st, s, maxsteps, emit_method)
        torch.cuda.synchronize()
        bad = torch.zeros(B, dtype=torch.bool, device=s["px"].device)
        for name in DISCRETE:
            bad |= got[name].long() != twin[name].long()
        frac = float(bad.sum()) / B
        worst_frac = max(worst_frac, frac)
        require(
            frac <= max_discrete,
            f"pvt_step step {k}: discrete outcomes differ in {frac:.2e} of lanes",
        )
        for name in physics.STATE_FLOATS + physics.SURFACE:
            ref, val = twin[name][~bad], got[name][~bad]
            fine = torch.isclose(val, ref, rtol=rtol, atol=atol, equal_nan=True)
            require(
                bool(fine.all()),
                f"pvt_step step {k}: {name} off by {float((val - ref).abs().max())}",
            )
            diff = (val - ref).abs()
            err = max(err, float(diff[torch.isfinite(diff)].max()) if diff.numel() else 0.0)
        s = twin
    report = {
        "max_abs_err": err,
        "discrete_frac": worst_frac,
        "ms": cuda_ms(lambda: kernels.step(st, state, maxsteps, emit_method), reps),
        "plain_ms": cuda_ms(
            lambda: tracer.step_state(st, state, maxsteps, emit_method), reps
        ),
    }
    # Reads the 14 lane inputs (61 bytes in float32, 9 of them reals),
    # writes them and 17 flags (45 bytes in float32, 4 of them reals).
    lane, flags = 61 + 9 * (real - 4), 45 + 4 * (real - 4)
    report["bound_ms"], report["bound_by"] = bound(B * OPS_STEP, B * (2 * lane + flags), draws,
                                                   dtype)
    return report


def draw_inputs(B, seed, device, need=7, starts=None):
    """Random inputs of ``kernels.draws`` for B lanes (numpy's generator
    seeded with `seed`): per warp `starts` dead lanes, or a number from 0
    to 32, at random places, and a density of the step words its lanes
    read (0.05, 0.3 or 0.9); per lane a random key and step count. Returns
    the argument tuple after the seed words, with `need`."""
    rs = np.random.default_rng(seed)
    W = B // rng.WARP
    starts = rs.integers(0, rng.WARP + 1, W) if starts is None else np.full(W, starts)
    dead = rs.random((W, rng.WARP)).argsort(1).argsort(1) < starts[:, None]
    density = rs.choice([0.05, 0.3, 0.9], W).repeat(rng.WARP)
    mask = (rs.random((B, 8)) < density[:, None]) @ (1 << np.arange(8))

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return (t(rs.integers(0, 2 ** 31, W), torch.int64), t(dead.reshape(-1), torch.bool), need,
            t(rs.integers(0, 2 ** 32, B), torch.int64), t(rs.integers(0, 2 ** 32, B), torch.int64),
            t(rs.integers(1, 1001, B), torch.int32), t(mask, torch.uint8))


def draws_bound(args, calls, real=4):
    """(bound_ms, bound_by) of pvt_draws on `args` (``draw_inputs``'s): the
    threefry calls whose words are read (each pair of a step word in a
    lane's mask, each dead lane's key and emission pairs) at the integer
    rate, and its inputs read and outputs written once (`real` bytes a
    uniform)."""
    base, dead, need, _, _, _, mask = args
    B = dead.numel()
    m = mask.long()
    pairs = sum(int(((m >> (2 * j)) & 3 != 0).sum()) for j in range(4))
    words = sum(int(((m >> k) & 1).sum()) for k in range(8))
    drawn = bin(need).count("1")
    draws = add_draws(threefry_draws(pairs, words),
                      threefry_draws(int(dead.sum()) * (1 + drawn), int(dead.sum()) * 2 * drawn))
    nbytes = B * (8 + 8 + 4 + 1 + 1) + 8 * base.numel() + B * (16 + 14 * real) \
        + calls.numel() * 4
    return bound(0, nbytes, draws)


def check_draws(device, B=1 << 20, seed=27, reps=10, dtype=torch.float32):
    """pvt_draws against its twin (``rng.warp_draws``: pvt_draw's words) on
    ``draw_inputs`` for each emission mask of a run (every pair; none; the
    bench slab's lamp, pair 2 alone, which it then times): keys, emission
    and step words bit for bit (the words drawn and read; -1 elsewhere in
    both), and the threefry calls each warp's refill made, as the kernel
    counts them where it makes them, against the twin's count. With
    `dtype` float64 the float64 build's draws, against the twin's float32
    words widened."""
    seed_words = rng.key_words(seed)
    report = {"refill_calls_per_warp": {}}
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    for need in (7, 0, 4):
        args = draw_inputs(B, seed + need, device, need)
        got = kernels.draws(seed_words, *args, dtype=dtype)
        ref = rng.warp_draws(seed_words, *args)
        torch.cuda.synchronize()
        for name, g, r in zip(("keys", "emit", "words", "calls"), got, ref):
            g = g.view(bits) if g.dtype.is_floating_point else g.long()
            r = r.to(dtype).view(bits) if r.dtype.is_floating_point else r.long()
            bad = int((g != r).sum())
            require(bad == 0, f"pvt_draws, emission pairs {need}: {name} differs in {bad} places")
        report["refill_calls_per_warp"][need] = float(got[3].float().mean())
    report.update(
        max_abs_err=0.0, lanes=B,
        ms=cuda_ms(lambda: kernels.draws(seed_words, *args, dtype=dtype), reps),
        plain_ms=cuda_ms(lambda: rng.warp_draws(seed_words, *args), reps),
    )
    report["bound_ms"], report["bound_by"] = draws_bound(
        args, got[3], torch.empty(0, dtype=dtype).element_size())
    return report


def cheb_points(st):
    """The t values, in the scene's dtype, where K5a's masks switch: every
    breakpoint of every piecewise fit, its neighbours in that dtype on
    both sides, -1, 1 and NaN."""
    seg_f = st["cheb_seg_f"].cpu()
    f = dict(dtype=seg_f.dtype)
    edges = torch.cat([seg_f[:, T.SF_A], seg_f[:, T.SF_B], torch.tensor([-1.0, 1.0], **f)])
    t = torch.cat([edges, torch.nextafter(edges, torch.tensor(-np.inf, **f)),
                   torch.nextafter(edges, torch.tensor(np.inf, **f))]).unique()
    return torch.cat([t, torch.tensor([float("nan")], **f)]).to(st["node_f"].device)


def check_cheb(st, n_t=4096, reps=10, shared=True):
    """pvt_cheb against the twin: every fit of the scene at `n_t` values of
    t evenly spaced on [-1, 1] and at ``cheb_points`` (every breakpoint,
    its neighbours, the ends and NaN): each value's segment equal to the
    twin's, its value within CHEB_RTOL (CHEB_RTOL_F64 for a float64 scene)
    of the fit's scale on the grid (NaN
    where the twin's is). With `shared` the blocks stage the table in
    shared memory where it fits (``shared_cheb`` says whether it did), else
    they read it in device memory. Times the grid on the card alone
    (``graph_ms``) and through the wrapper, host work between launches
    included (``wrapper_ms``)."""
    dev = st["node_f"].device
    dtype, real = _real(st)
    rtol = CHEB_RTOL_F64 if dtype == torch.float64 else CHEB_RTOL
    F = st["meta"]["cheb_n_fits"]
    require(F > 0, "pvt_cheb: the scene has no Chebyshev fits")
    grid = torch.linspace(-1.0, 1.0, n_t, device=dev, dtype=dtype)
    t = torch.cat([grid, cheb_points(st)])
    got, seg = kernels.cheb(st, t, shared=shared, segments=True)
    placed = kernels.last_cheb["shared_cheb"]
    fits = torch.arange(F, device=dev, dtype=torch.int64).repeat_interleave(t.shape[0])
    grid_fits = torch.arange(F, device=dev, dtype=torch.int64).repeat_interleave(n_t)
    twin = chebyshev.eval_fits(st, fits, t.repeat(F)).reshape(F, -1)
    twin_seg = chebyshev._segment(st, fits, t.repeat(F)).reshape(F, -1)
    torch.cuda.synchronize()
    bad = int((seg != twin_seg).sum())
    require(bad == 0, f"pvt_cheb: {bad} values took another segment than the twin's")
    nan = twin.isnan()
    require(bool((got.isnan() == nan).all()), "pvt_cheb: NaN where the twin has none, or none "
            "where it has")
    scale = twin[:, :n_t].abs().amax(1).clamp(min=1e-30)
    diff = (got - twin).abs().masked_fill(nan, 0.0)
    rel = float((diff / scale[:, None]).max())
    require(rel <= rtol, f"pvt_cheb: max relative error {rel:.3g} > {rtol}")
    report = {
        "max_abs_err": float(diff.max()),
        "max_rel_err": rel,
        "n_fits": F,
        "n_t": n_t,
        "segment_points": t.shape[0] - n_t,
        "shared_cheb": placed,
        "ms": graph_ms(lambda: kernels.cheb(st, grid, shared=shared), reps),
        "wrapper_ms": cuda_ms(lambda: kernels.cheb(st, grid, shared=shared), reps),
        "plain_ms": cuda_ms(lambda: chebyshev.eval_fits(st, grid_fits, grid.repeat(F)), reps),
    }
    # Per evaluation on the grid: the search's ceil(log2 nseg) halving
    # steps, and the Clenshaw chain of the segment t falls in (t is
    # uniform, so each segment's degree counts by its width). Bytes: t and
    # the values, and the table read once.
    fit_i = st["cheb_fit_i"].cpu()
    seg_f, seg_i = st["cheb_seg_f"].cpu().double(), st["cheb_seg_i"].cpu()
    ops = 0.0
    for kind, nseg, seg0 in fit_i.tolist():
        a, b = seg_f[seg0:seg0 + nseg, T.SF_A], seg_f[seg0:seg0 + nseg, T.SF_B]
        deg = seg_i[seg0:seg0 + nseg, T.SI_DEG].double()
        mean_deg = float(((b - a) / 2.0 * deg).sum())
        steps = int(np.ceil(np.log2(nseg)))
        ops += n_t * (OPS_CHEB_SEARCH * steps + OPS_CHEB_DEGREE * mean_deg + OPS_CHEB_EVAL)
    nbytes = real * (n_t + F * n_t + st["cheb_pack"].numel())
    report["bound_ms"], report["bound_by"] = bound(ops, nbytes, dtype=dtype)
    return report


def _copy(t):
    return {k: v.clone() for k, v in t.items()}


def check_tally(st, state, steps=8, maxsteps=1000, emit_method=0, reps=10):
    """pvt_tally against the twin for `steps` steps of the lanes `state`,
    both fed the twin's physics step: distinct, crossings, bins and the
    seen bits equal after every step, moment sums within SUMS_RTOL (a
    float64 scene: each recorder's within ``sums_bound_f64`` of its
    distinct rays)."""
    require(st["meta"]["n_rec"] > 0, "pvt_tally: the scene has no recorders")
    dtype, real = _real(st)
    B = state["px"].shape[0]
    twin_t, kern_t = tally.empty(st, B), tally.empty(st, B)
    s, shared, work = state, None, [0, 0, 0, 0]
    for k in range(steps):
        out = tracer.step_state(st, s, maxsteps, emit_method)
        before = _copy(twin_t)
        tally.tally(twin_t, st, out)
        shared = kernels.tally_step(kern_t, st, out)
        torch.cuda.synchronize()
        for name in ("distinct", "cross", "bins", "seen"):
            bad = int((kern_t[name] != twin_t[name]).sum())
            require(bad == 0, f"pvt_tally step {k}: {name} differs in {bad} entries")
        work[0] += int((out["sel"] >= 0).sum())
        work[1] += int((twin_t["cross"] - before["cross"]).sum())
        work[2] += int((twin_t["distinct"] - before["distinct"]).sum())
        work[3] += int((twin_t["bins"] - before["bins"]).sum())
        s = out
    ref, got = twin_t["sums"].double(), kern_t["sums"].double()
    words, res = kernels.pack_seen(kern_t["seen"]), kernels.zero_tally_out(st)
    rel_each = (got - ref).abs() / ref.abs().clamp(min=1e-30)
    rel = float(rel_each.max())
    if dtype == torch.float64:
        used = float((rel_each / sums_bound_f64(twin_t["distinct"].double())[:, None]).max())
        require(used <= 1.0, f"pvt_tally: float64 sums at {used:.3g} of their bound")
    else:
        require(rel <= SUMS_RTOL, f"pvt_tally: sums off by {rel:.3g} relative > {SUMS_RTOL}")
    report = {
        "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": rel,
        "shared_bins": shared,
        "ms": cuda_ms(lambda: kernels.launch_tally(st, out, words, res), reps),
        "plain_ms": cuda_ms(lambda: tally.tally(_copy(twin_t), st, out), reps),
    }
    # Per step and lane: reads 6 reals, 2 ints, 2 flags, 4 normal reals
    # and the 32-byte seen words (50 bytes in float32 besides the seen
    # words), writes the seen words back.
    lanes, matches, new, bins = (w / steps for w in work)
    ops = (B * OPS_TALLY_LANE + matches * OPS_TALLY_MATCH + new * OPS_TALLY_NEW
           + bins * OPS_TALLY_BIN)
    report["bound_ms"], report["bound_by"] = bound(ops, B * (50 + 10 * (real - 4) + 2 * 32),
                                                   dtype=dtype)
    report["events_per_step"] = lanes
    return report


def trace_bound(st, n, total_steps, tallies=None, bundle=False, fates=None):
    """(bound_ms, bound_by) of pvt_trace for `n` photons that took
    `total_steps` steps in all, with this run's recorder tallies: emission
    per photon (with a host `bundle`, the key alone and the bundle's 28
    bytes a photon read), the step per step (not counting K5a's segment
    search and Clenshaw chains, which only lowers the bound) with a test of
    every mesh triangle, and each crossing, distinct ray and bin add; the
    draws (integer operations) the photons' keys, emission and steps read
    at least, the events counted from this run's `fates` (none without).
    Bytes: the scene tensors read once and the fates, counts and tallies
    written once."""
    ops = n * (0 if bundle else OPS_EMIT) \
        + total_steps * (OPS_STEP + st["meta"]["n_tris"] * OPS_TRIANGLE)
    events = trace_events(total_steps, fates) if fates is not None else 0
    draws = add_draws(emit_draws(st, n, bundle=bundle), step_draws(total_steps, events))
    dtype, real = _real(st)
    nbytes = sum(
        v.numel() * v.element_size() for v in st.values() if isinstance(v, torch.Tensor)
    ) + 8 * physics.N_FATES + (7 * real * n if bundle else 0)
    if tallies is not None and st["meta"]["n_rec"]:
        ops += (int(tallies["cross"].sum()) * OPS_TALLY_MATCH
                + int(tallies["distinct"].sum()) * OPS_TALLY_NEW
                + int(tallies["bins"].sum()) * OPS_TALLY_BIN)
        nbytes += sum(v.numel() * v.element_size() for v in tallies.values())
    return bound(ops, nbytes, draws, dtype)


def lerp_bound(st, total_steps):
    """(bound_ms, bound_by) of K5b's own work in a run of `total_steps`
    steps: one table lerp a step (the container's attenuation, which every
    step takes; the roulette's, p1's and the emission ICDF's lerps only
    raise it), and the lerp tables read once."""
    nbytes = sum(st[name].numel() * st[name].element_size()
                 for name in ("spec_pack", "ems_icdf_pairs", "light_icdf_pairs"))
    return bound(total_steps * OPS_LERP, nbytes, dtype=st["node_f"].dtype)


def check_trace(st, seed_words, n, lanes=1 << 18, maxsteps=1000, emit_method=0,
                maxpathlength=float("inf"), bundle=None, coincident=(), probes=()):
    """pvt_trace against the twin, both on the card, for n photons: both
    account for every photon, and each fate count agrees within
    max(20, 0.2% of n) (the same photons take the same streams; FMA
    contraction flips a few discrete outcomes). With recorders, so do
    each recorder's distinct rays, crossings and bins, and its mean
    wavelength agrees within its standard error, or within SUMS_RTOL of
    itself where that is larger (a recorder that sees one wavelength,
    like the mesh LSC's top face under a 555 nm lamp, has none; its
    float32 sums still round). A float64 scene (``tracer_f64``): every
    fate count and integer tally within F64_PARTED, and where the integer
    tallies are equal (the same photons' events) each recorder's moment
    sums within ``sums_allow_f64`` of its distinct rays. With a host
    `bundle` ([7, n] in the scene's dtype on the card) both start from it
    (K8's trace_bundle entry). Both take the run options `maxsteps`,
    `emit_method` (``compiler.EMIT_METHODS``' tag) and `maxpathlength`.
    The recorders on `coincident` nodes are held through their `probes`
    (``hold_tallies``; their means within the swapped photons' reach, their
    float64 sums not held). ``ms`` is the
    kernel's own time (``last_trace["ms"]``) in a second launch, whose
    fates must equal the first's; ``wrapper_ms`` the first call of
    ``kernels.trace`` whole (its allocations, scene descriptor and result
    reads included)."""
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    options = {"maxsteps": maxsteps, "emit_method": emit_method, "maxpathlength": maxpathlength}
    got, longest, got_t, _ = kernels.trace(st, seed_words, n, bundle=bundle, **options)
    mid.record()
    ref, steps, ref_t, _ = tracer.trace_eager(st, seed_words, n, lanes=lanes, bundle=bundle,
                                              **options)
    stop.record()
    torch.cuda.synchronize()
    wrapper_ms = start.elapsed_time(mid)
    again, _, _, _ = kernels.trace(st, seed_words, n, bundle=bundle, **options)
    got, ref = got.cpu(), ref.cpu()
    require(torch.equal(again.cpu(), got), "pvt_trace: fates differ between two runs")
    require(int(got.sum()) == n, f"pvt_trace: fates sum to {int(got.sum())}, not {n}")
    require(int(ref.sum()) == n, f"twin: fates sum to {int(ref.sum())}, not {n}")
    f64 = st["node_f"].dtype == torch.float64
    tol = F64_PARTED if f64 else max(20, n // 500)
    err = int((got - ref).abs().max())
    require(err <= tol, f"pvt_trace: fates {got.tolist()} vs twin {ref.tolist()}")
    report = {
        "max_abs_err": err,
        "fates": got.tolist(),
        "twin_fates": ref.tolist(),
        "longest": longest,
        "twin_steps": steps,
        "total_steps": kernels.last_trace["total_steps"],
        "lane_efficiency": kernels.last_trace["lane_efficiency"],
        "shared_bins": bool(kernels.last_trace["shared_bins"]),
        "ms": kernels.last_trace["ms"],
        "wrapper_ms": wrapper_ms,
        "plain_ms": mid.elapsed_time(stop),
        "tally_max_diff": 0,
    }
    report["bound_ms"], report["bound_by"] = trace_bound(
        st, n, report["total_steps"], got_t, bundle is not None, got
    )
    R = st["meta"]["n_rec"]
    if R:
        diffs, shared, report["coincident_max_diff"] = hold_tallies(
            got_t, ref_t, st, tol, "pvt_trace", coincident, probes)
        report["tally_max_diff"] = max(diffs.values())
        report["shared_crossings"] = shared
        on = coincident_recorders(st, coincident)[0]
        worst = 0.0
        for r in range(R):
            nk, nt = int(got_t["distinct"][r]), int(ref_t["distinct"][r])
            if min(nk, nt) < 2:
                continue
            mk = float(got_t["sums"][r, 0]) / nk
            mt = float(ref_t["sums"][r, 0]) / nt
            var = max(float(ref_t["sums"][r, 1]) / nt - mt * mt, 0.0)
            se = (var / nt) ** 0.5
            # On a coincident face up to tol + shared photons may be
            # counted by one build and not the other; each moves the mean
            # by at most its wavelength's distance from it over the count,
            # under the mean itself for a spectrum within an octave
            # (400-800 nm here).
            swaps = 2.0 * (tol + shared) * abs(mt) / min(nk, nt) if on[r] else 0.0
            require(abs(mk - mt) <= max(se, SUMS_RTOL * abs(mt)) + swaps,
                    f"pvt_trace: recorder {r} mean wavelength {mk} vs twin {mt}, "
                    f"standard error {se}")
            if not on[r]:
                worst = max(worst, abs(mk - mt) / se if se else 0.0)
        report["mean_wavelength_worst_se"] = worst
        if f64 and report["tally_max_diff"] == 0 and not bool(on.all()):
            keep = ~on.to(got_t["sums"].device)
            allow = sums_allow_f64(ref_t["sums"][:R], ref_t["distinct"][:R].double())
            share = ((got_t["sums"][:R] - ref_t["sums"][:R]).abs() / allow.clamp(min=1e-300))[keep]
            used = float(share.max())
            require(used <= 1.0, f"pvt_trace: float64 sums at {used:.3g} of their bound")
            report["sums_used"] = used
            report["sums_used_columns"] = share.amax(0).tolist()
        report["distinct"] = got_t["distinct"][:R].tolist()
        report["tallies"] = got_t
        report["crossings"] = int(got_t["cross"][:R].sum())
        report["bin_adds"] = int(got_t["bins"].sum())
    return report


def per_photon_loop_efficiency(photon_steps, warp=32):
    """The lane efficiency a loop per photon would have on these photons
    (each photon's steps, in photon-id order): a warp's lanes take `warp`
    consecutive ids together and all wait for the longest, so the steps
    traced over the lane-steps paid are the mean steps over the mean of
    each group's longest. pvt_trace's loop before it stepped every lane
    each turn; its ``last_trace["lane_efficiency"]`` stands beside this."""
    steps = photon_steps.double()
    steps = steps[:steps.numel() // warp * warp].view(-1, warp)
    return float(steps.mean() / steps.max(1).values.mean())


def check_chunks(st, seed_words, data, n, chunk=1 << 20):
    """The recorder tallies of one run of photons [0, n) (`data`, as
    ``simulate`` returns them) against the same photons traced by
    pvt_trace in runs of `chunk`, added in int64 and float64: integer
    tallies equal (a photon's events depend on (seed, pid) alone), moment
    sums within SUMS_RUNS_RTOL, which does not grow with n. Returns the
    sums' largest relative difference."""
    total = None
    for first in range(0, n, chunk):
        _, _, t, _ = kernels.trace(st, seed_words, min(chunk, n - first), index_offset=first)
        total = t if total is None else {name: total[name] + t[name] for name in t}
    R = st["meta"]["n_rec"]
    for name, key in (("distinct", "rec_distinct"), ("cross", "rec_crossings"),
                      ("bins", "rec_bins")):
        got = torch.as_tensor(data[key])
        bad = int((got != total[name][:got.shape[0]].cpu()).sum())
        require(bad == 0, f"{n} photons against runs of {chunk}: {name} differs in {bad} entries")
    ref = total["sums"][:R].cpu()
    got = torch.as_tensor(data["rec_sums"]).double()
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    require(rel <= SUMS_RUNS_RTOL,
            f"{n} photons against runs of {chunk}: sums off by {rel:.3g} > {SUMS_RUNS_RTOL:.3g}")
    return rel


def mesh_rays(st, node, B, seed):
    """B rays in the local frame of mesh node `node`: origins uniform in
    its bounding box grown by a fifth on every side, directions isotropic
    (a torch.Generator seeded with `seed`, on the scene's device), drawn in
    float32 and given in the scene's dtype."""
    tri, _ = kernels.mesh_rows(st, node)
    g = torch.Generator(device=tri.device).manual_seed(seed)
    dtype, tri = tri.dtype, tri.float()
    v0 = tri[:, T.TF_V0:T.TF_V0 + 3]
    corners = torch.cat([v0, v0 + tri[:, T.TF_E1:T.TF_E1 + 3], v0 + tri[:, T.TF_E2:T.TF_E2 + 3]])
    lo, hi = corners.min(0).values, corners.max(0).values
    lo, hi = lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo)
    f = dict(generator=g, device=tri.device, dtype=torch.float32)
    o = lo + (hi - lo) * torch.rand((B, 3), **f)
    d = torch.randn((B, 3), **f)
    return o.to(dtype).contiguous(), (d / d.norm(dim=1, keepdim=True)).to(dtype).contiguous()


def near_edge(tri, o, d, tol=EDGE_TOL, chunk=1 << 16):
    """Rays whose line crosses the plane of a triangle ahead of the origin
    within `tol` (barycentric, float64) of one of its edges."""
    tri = tri.double()
    out = []
    for first in range(0, o.shape[0], chunk):
        oo, dd = o[first:first + chunk].double(), d[first:first + chunk].double()
        v0, e1, e2 = tri[None, :, 0:3], tri[None, :, 3:6], tri[None, :, 6:9]
        pv = torch.cross(dd[:, None, :].expand(-1, tri.shape[0], -1), e2.expand(oo.shape[0], -1, -1),
                         dim=2)
        det = (e1 * pv).sum(2)
        inv = 1.0 / torch.where(det.abs() > 1e-14, det, 1.0)
        tv = oo[:, None, :] - v0
        u = (tv * pv).sum(2) * inv
        qv = torch.cross(tv, e1.expand(oo.shape[0], -1, -1), dim=2)
        v = (dd[:, None, :] * qv).sum(2) * inv
        t = (e2 * qv).sum(2) * inv
        w = 1.0 - u - v
        close = torch.minimum(torch.minimum(u.abs(), v.abs()), w.abs()) < tol
        inside = (u > -tol) & (v > -tol) & (w > -tol)
        out.append((close & inside & (det.abs() > 1e-14) & (t > 0.0)).any(1))
    return torch.cat(out)


def check_mesh(st, node, B=1 << 20, seed=0, reps=10, chunk=1 << 17):
    """pvt_mesh against the twin for B random rays (``mesh_rays``) against
    mesh node `node`: hit counts equal except on rays near an edge,
    t1 and t2 within MESH_RTOL where the counts agree, and there the
    nearest hit's normal equal (ties only happen on edges); a float64
    scene's within MESH_RTOL_F64, near an edge within EDGE_TOL_F64."""
    tri, eps = kernels.mesh_rows(st, node)
    dtype, real = _real(st)
    f64 = dtype == torch.float64
    rtol, edge_tol = (MESH_RTOL_F64, EDGE_TOL_F64) if f64 else (MESH_RTOL, EDGE_TOL)
    o, d = mesh_rays(st, node, B, seed)
    got = kernels.mesh(st, node, o, d)

    def twin():
        parts = [geometry.mesh_nearest_two(tri, o[i:i + chunk].unbind(1), d[i:i + chunk].unbind(1),
                                           eps) for i in range(0, B, chunk)]
        return [torch.cat([p[k] for p in parts]) for k in range(3)] + [
            torch.stack([torch.cat([p[3][k] for p in parts]) for k in range(3)], dim=1)]

    ref = twin()
    torch.cuda.synchronize()
    edge = near_edge(tri, o, d, edge_tol)
    differ = got[2] != ref[2]
    stray = int((differ & ~edge).sum())
    require(stray == 0, f"pvt_mesh: hit counts differ on {stray} rays away from any edge")
    same = ~differ
    err, rel = 0.0, 0.0
    for k in (0, 1):
        a, b = got[k][same], ref[k][same]
        fin = torch.isfinite(b)
        require(bool((torch.isfinite(a) == fin).all()), "pvt_mesh: a finite t against inf")
        diff = (a[fin] - b[fin]).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / b[fin].abs().clamp(min=1e-30)).max()))
    require(rel <= rtol, f"pvt_mesh: t off by {rel:.3g} relative > {rtol}")
    keep = same & ~edge
    bad_n = int((got[3][keep] != ref[3][keep]).any(1).sum())
    require(bad_n == 0, f"pvt_mesh: the nearest hit's normal differs on {bad_n} rays")
    report = {
        "max_abs_err": err,
        "max_rel_err": rel,
        "rays": B,
        "triangles": int(tri.shape[0]),
        "hits": int(ref[2].sum()),
        "count_diffs": int(differ.sum()),
        "near_edge": int(edge.sum()),
        "ms": cuda_ms(lambda: kernels.mesh(st, node, o, d), reps),
        "plain_ms": cuda_ms(twin, max(1, reps // 5)),
    }
    # Reads o, d (6 reals a ray) and the triangles, writes t1, t2, the
    # count and the normal (5 reals and 4 bytes a ray; 48 bytes a ray in
    # float32).
    report["bound_ms"], report["bound_by"] = bound(
        B * tri.shape[0] * OPS_TRIANGLE, B * (11 * real + 4) + tri.numel() * real, dtype=dtype
    )
    return report


def _log_rel_records(got, ref):
    """Each record's largest |got - ref| over its float column's largest
    |ref| (the log's last axis, LOG_F columns)."""
    scale = ref.abs().amax(dim=tuple(range(ref.dim() - 1)), keepdim=True)
    return ((got - ref).abs() / scale.clamp(min=1e-30)).amax(-1)


def _log_rel_rows(got, ref):
    """Each photon's (a row's) largest ``_log_rel_records``."""
    return _log_rel_records(got, ref).flatten(1).amax(1)


def drift_after_curved(ints, bad, st):
    """Boolean [S]: the photons of a log (dense `ints` [S, E, LOG_I]) whose
    first record in `bad` [S, E] lies at or after their first REFLECT or
    TRANSMIT on a curved node (CURVED: a sphere or cylinder)."""
    geom = st["node_i"][:, T.NI_GEOM].cpu()
    kind, hit = ints[..., 0].cpu(), ints[..., 1].cpu().long()
    surface = (kind == Event.REFLECT.value) | (kind == Event.TRANSMIT.value)
    curved = surface & (hit >= 0) & torch.isin(geom[hit.clamp(min=0)],
                                                torch.tensor(CURVED, dtype=geom.dtype))
    index = torch.arange(ints.shape[1])
    first_curved = torch.where(curved, index, ints.shape[1]).amin(1)
    first_bad = torch.where(bad.cpu(), index, ints.shape[1]).amin(1)
    return (first_curved <= first_bad).to(bad.device)


def coincident_hits(ints, floats, ref, coincident):
    """The kernel's log (dense ints and floats) with each record whose hit
    is the other of two coincident faces (both hits of `coincident` nodes
    and the record's container and adjacent node, the other fields equal)
    given the twin's hit and normal; and the number of such records."""
    if not coincident:
        return ints, floats, 0
    HIT, CONT, ADJ, NORMAL = 1, 2, 3, slice(6, 9)
    nodes = torch.tensor(sorted(coincident), device=ints.device)
    a, b = ints[..., HIT], ref["ints"][..., HIT]
    pair = torch.stack([ints[..., CONT], ints[..., ADJ]], -1)
    others = torch.cat([ints[..., :HIT], ints[..., HIT + 1:]], -1) \
        == torch.cat([ref["ints"][..., :HIT], ref["ints"][..., HIT + 1:]], -1)
    swap = (a != b) & torch.isin(a, nodes) & torch.isin(b, nodes) & others.all(-1) \
        & (pair == a[..., None]).any(-1) & (pair == b[..., None]).any(-1)
    ints, floats = ints.clone(), floats.clone()
    ints[..., HIT] = torch.where(swap, b, a)
    floats[..., NORMAL] = torch.where(swap[..., None], -floats[..., NORMAL], floats[..., NORMAL])
    return ints, floats, int(swap.sum())


def dense_log(log):
    """A kernel's event `log` as the twin keeps it: (ints, floats) with -1
    and 0 past each row's count, where the kernel leaves them unset."""
    used = (torch.arange(log["ints"].shape[1], device=log["ints"].device)
            < log["counts"][:, None])[..., None]
    return torch.where(used, log["ints"], -1), torch.where(used, log["floats"], 0.0)


def check_log_pack(log, reps=10):
    """pvt_log_pack against its plain version ``eventlog.pack`` on a
    kernel's event `log` (on the card): both outputs bit-equal. Returns
    the report: ``ms`` the kernel alone (CUDA events around each launch,
    the mean of `reps`), ``plain_ms`` the plain version, ``library_ms``
    the two boolean-mask gathers alone (the mask built beforehand), the
    bound (the packed records read once and written once), the records
    and the packed and dense bytes."""
    counts = log["counts"]
    ints, floats = kernels.log_pack(log)
    ref_ints, ref_floats = eventlog.pack(log, counts)
    bits = torch.int64 if floats.dtype == torch.float64 else torch.int32
    require(torch.equal(ints, ref_ints)
            and torch.equal(floats.view(bits), ref_floats.view(bits)),
            "pvt_log_pack: the packed records differ from eventlog.pack's")
    ms = 0.0
    for _ in range(reps):
        kernels.log_pack(log)
        ms += kernels.pack_ms() / reps
    used = torch.arange(log["ints"].shape[1], device=counts.device) < counts[:, None]
    real = floats.element_size()
    packed = ints.numel() * 4 + floats.numel() * real
    report = {
        "max_abs_err": 0.0, "ms": ms,
        "plain_ms": cuda_ms(lambda: eventlog.pack(log, counts), reps),
        "library_ms": cuda_ms(lambda: (log["ints"][used], log["floats"][used]), reps),
        "records": len(ints), "slots": len(counts), "packed_bytes": packed,
        "dense_bytes": log["ints"].numel() * 4 + log["floats"].numel() * real,
    }
    report["bound_ms"], report["bound_by"] = bound(0, 2 * packed)
    return report


def check_log(st, seed_words, n, record_every=1, max_events=128, lanes=1 << 18, bundle=None,
              maxsteps=1000, emit_method=0, maxpathlength=float("inf"), coincident=()):
    """pvt_trace with the event log against the twin (on the card), n
    photons: fates within max(20, 0.2% of n); the recorded photons'
    records compared photon by photon, at most a fraction LOG_DIVERGED of
    them diverged (ints differing anywhere), the others' records and
    record counts (the kernel's ``counts`` against the twin's rows) equal
    in the ints and within LOG_RTOL in the floats; the kernel's log packed
    by pvt_log_pack as by the plain version (``check_log_pack``, report
    ``pack``). Float32 only: a photon whose events are equal but whose
    floats drift past LOG_RTOL after its first event on a curved surface is
    counted apart, at most LOG_DRIFTED of them (above); one that drifts
    earlier fails the check. A float64 scene: fates within F64_PARTED, at
    most F64_PARTED photons diverged, every other photon's floats within
    F64_RTOL. Returns the report, with the kernel's tallies and log. With
    a host `bundle` both start from it. Both take the run options
    `maxsteps`, `emit_method` and `maxpathlength`. A record whose hit is
    the other of two coincident faces of `coincident` nodes is equal
    (above; ``coincident_hits``)."""
    dtype, real = _real(st)
    f64 = dtype == torch.float64
    start, mid, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    start.record()
    options = {"maxsteps": maxsteps, "emit_method": emit_method, "maxpathlength": maxpathlength,
               "record_every": record_every, "max_events": max_events, "bundle": bundle}
    got, _, got_t, got_log = kernels.trace(st, seed_words, n, **options)
    mid.record()
    ref, _, _, ref_log = tracer.trace_eager(st, seed_words, n, lanes=lanes, **options)
    stop.record()
    torch.cuda.synchronize()
    got, ref = got.cpu(), ref.cpu()
    tol = F64_PARTED if f64 else max(20, n // 500)
    fate_err = int((got - ref).abs().max())
    require(int(got.sum()) == n, f"pvt_trace (log): fates sum to {int(got.sum())}, not {n}")
    require(fate_err <= tol, f"pvt_trace (log): fates {got.tolist()} vs twin {ref.tolist()}")
    S = got_log["ints"].shape[0]
    require(ref_log["ints"].shape == got_log["ints"].shape, "pvt_trace (log): log shapes differ")
    got_ints, got_floats = dense_log(got_log)
    got_ints, got_floats, swapped = coincident_hits(got_ints, got_floats, ref_log, coincident)
    rtol = F64_RTOL if f64 else LOG_RTOL
    diverged = (got_ints != ref_log["ints"]).flatten(1).any(1)
    require(int(diverged.sum()) <= F64_PARTED if f64 else float(diverged.sum()) / S <= LOG_DIVERGED,
            f"pvt_trace (log): {int(diverged.sum())} of {S} recorded photons diverged")
    bad = _log_rel_records(got_floats, ref_log["floats"]) > rtol
    drifted = bad.any(1) & ~diverged
    if not f64 and bool(drifted.any()):
        early = drifted & ~drift_after_curved(ref_log["ints"], bad, st)
        require(not bool(early.any()), f"pvt_trace (log): {int(early.sum())} photons' floats "
                f"off by more than {rtol} before any event on a curved surface")
        require(float(drifted.sum()) / S <= LOG_DRIFTED,
                f"pvt_trace (log): {int(drifted.sum())} of {S} recorded photons drifted past "
                f"{rtol} after a curved surface (limit {LOG_DRIFTED} of them)")
    keep = ~diverged if f64 else ~diverged & ~drifted
    counts = got_log["counts"]
    ref_counts = (ref_log["ints"][..., 0] >= 0).sum(1).to(torch.int32)
    require(torch.equal(ref_log["counts"], ref_counts), "the twin's counts differ from its rows")
    require(torch.equal(counts[~diverged], ref_counts[~diverged]),
            "pvt_trace (log): counts differ from the twin's rows")
    rel = float(_log_rel_rows(got_floats[keep], ref_log["floats"][keep]).max()) \
        if bool(keep.any()) else 0.0
    require(rel <= rtol, f"pvt_trace (log): floats off by {rel:.3g} relative > {rtol}")
    records = int(counts.sum())
    report = {
        "max_abs_err": float((got_floats[keep] - ref_log["floats"][keep]).abs().max()),
        "max_rel_err": rel,
        "slots": S,
        "diverged": int(diverged.sum()),
        "drifted": int(drifted.sum()),
        "coincident_hits": swapped,
        "records": records,
        "full_rows": int((counts == max_events).sum()),
        "budget_kills": int(((got_ints[..., 0] == 9) & (got_ints[..., 1] < 0)
                             & (got_ints[..., 2] < 0)).sum()),
        "fates": got.tolist(),
        "twin_fates": ref.tolist(),
        "ms": start.elapsed_time(mid),
        "plain_ms": mid.elapsed_time(stop),
        "tallies": got_t,
        "log": got_log,
        "pack": check_log_pack(got_log),
    }
    ops_ms, by = trace_bound(st, n, kernels.last_trace["total_steps"], got_t, bundle is not None,
                             got)
    # The log adds its records' bytes (written once) to the trace's.
    log_ms = records * (4 * T.LOG_I + real * T.LOG_F) / PEAK_BYTES_PER_S * 1e3
    report["bound_ms"], report["bound_by"] = (ops_ms, by) if ops_ms >= log_ms else (log_ms, "bytes")
    return report


def check_fetch(scene, n, seed=4, max_events=128, lanes=1 << 10, dtype=np.float32):
    """``simulate(record_every=1)`` of `scene` on the card in `dtype`
    (``pvt_trace`` with the log, ``pvt_log_pack``, the copies and the numpy
    unpack) against the CPU twin's dense arrays, n photons: at most a
    fraction LOG_DIVERGED of the photons differ in any int (float64: at
    most F64_PARTED photons), the others' counts equal and floats within
    LOG_RTOL (float64: F64_RTOL) of their column's scale; the counts equal
    the rows' records. Returns the report."""
    from pvtrace_tpu_torch.engine import api

    f64 = np.dtype(dtype) == np.float64
    kernels.reset()
    got = api.simulate(scene, n, seed=seed, record_every=1, max_events=max_events,
                       dtype=dtype).data
    require(kernels.launches["pvt_log_pack"] == 1 and kernels.launches["pvt_trace_log"] == 1
            and kernels.launches_f64["pvt_log_pack"] == int(f64),
            f"simulate with the log: launches {kernels.launches}")
    ref = api.simulate(scene, n, seed=seed, record_every=1, max_events=max_events, lanes=lanes,
                       dtype=dtype, device="cpu").data
    ints, floats = (
        [np.stack([d[k] for k in eventlog.LOG_INTS], -1) for d in (got, ref)],
        [np.concatenate([d[k] for k in eventlog.LOG_VECS]
                        + [d[k][..., None] for k in eventlog.LOG_SCALARS], -1)
         for d in (got, ref)],
    )
    same = (ints[0] == ints[1]).reshape(len(ints[0]), -1).all(1)
    require(int((~same).sum()) <= (F64_PARTED if f64 else LOG_DIVERGED * len(same)),
            f"simulate's log: {int((~same).sum())} of {len(same)} photons differ from the twin's")
    require(np.array_equal(got["counts"], (got["kind"] >= 0).sum(1)),
            "simulate's log: counts differ from its rows")
    require(np.array_equal(got["counts"][same], ref["counts"][same]),
            "simulate's log: counts differ from the twin's")
    rel = float(_log_rel_rows(torch.from_numpy(floats[0][same]),
                              torch.from_numpy(floats[1][same])).max())
    rtol = F64_RTOL if f64 else LOG_RTOL
    require(floats[0].dtype == np.dtype(dtype), f"simulate's log: floats in {floats[0].dtype}")
    require(rel <= rtol, f"simulate's log: floats off by {rel:.3g} relative > {rtol}")
    return {"slots": len(same), "diverged": int((~same).sum()),
            "records": int(got["counts"].sum()), "max_rel_err": rel}


def check_log_tallies(scene, result, rtol=LOG_SUMS_RTOL):
    """The recorder tallies of `result` (a ``simulate`` with record_every
    = 1) against ``history_tally.tally_histories`` of its own log: rays,
    crossings and bins equal, moments within `rtol`. Returns the largest
    relative difference of the moments."""
    oracle = history_tally.tally_histories(scene, result.histories())
    worst = 0.0
    for name, rec in result.recorders.items():
        want = oracle[name]
        require((rec.rays, rec.crossings) == (want.rays, want.crossings),
                f"recorder {name}: rays, crossings {rec.rays}, {rec.crossings} against "
                f"{want.rays}, {want.crossings} from the log")
        for h in range(len(rec.spec.histograms)):
            require(np.array_equal(rec.histogram(h)[-1], want.histogram(h)[-1]),
                    f"recorder {name}: histogram {h} differs from the log's")
        scale = np.maximum(np.abs(want._moments), 1e-30)
        worst = max(worst, float((np.abs(rec._moments - want._moments) / scale).max()))
    require(worst <= rtol, f"recorder moments off by {worst:.3g} relative from the log's")
    return worst


# A CLI database's columns (``data/schema.sql``), a ray row joined with
# its event: the discrete ones, then the floats.
DB_DISCRETE = ("source", "kind", "component", "hit", "container", "adjacent", "facet")
DB_FLOATS = ("x", "y", "z", "i", "j", "k", "wavelength", "travelled", "duration", "ni", "nj",
             "nk")


def database_photons(path):
    """The histories of a database the CLI's ``simulate`` wrote, by
    throw_id: (discrete rows, float rows [events, len(DB_FLOATS)]). A
    discrete row holds DB_DISCRETE and which floats are NULL (the normal
    of a volume event); a NULL float reads 0."""
    import contextlib
    import sqlite3

    columns = ", ".join(("throw_id",) + DB_DISCRETE + DB_FLOATS)
    with contextlib.closing(sqlite3.connect(path)) as connection:
        rows = connection.execute(
            f"SELECT {columns} FROM ray JOIN event ON ray.rowid = event.ray_id "
            "ORDER BY ray.rowid").fetchall()
    by_photon = {}
    for row in rows:
        by_photon.setdefault(row[0], []).append(row[1:])
    cut = len(DB_DISCRETE)
    return {
        throw_id: ([r[:cut] + tuple(v is None for v in r[cut:]) for r in history],
                   np.array([[0.0 if v is None else v for v in r[cut:]] for r in history]))
        for throw_id, history in by_photon.items()
    }


def compare_databases(got, ref):
    """Two CLI databases (paths) of the same photons, photon by photon:
    a photon whose discrete rows differ (an event, a node, a component,
    a source, the number of events) has parted; of the others, the
    largest |got - ref| of a float over its column's largest |ref| (the
    scale of ``check_log``'s LOG_RTOL). Returns {"photons", "parted",
    "parted_ids" (the first 20), "max_rel_err"}; the caller holds them to
    its allowance."""
    g, r = database_photons(got), database_photons(ref)
    require(sorted(g) == sorted(r), "the databases hold different throw_ids")
    scale = np.max(np.abs(np.concatenate([f for _, f in r.values()])), axis=0)
    scale = np.maximum(scale, 1e-30)
    parted, worst = [], 0.0
    for throw_id, (ref_rows, ref_floats) in r.items():
        got_rows, got_floats = g[throw_id]
        if got_rows != ref_rows:
            parted.append(throw_id)
            continue
        worst = max(worst, float((np.abs(got_floats - ref_floats) / scale).max()))
    return {"photons": len(r), "parted": len(parted), "parted_ids": parted[:20],
            "max_rel_err": worst}


def score_runs_bound(m, S, dtype=torch.float32):
    """``simulate``'s score sums in `dtype` against float64 totals of the
    same photons added in another order: m addends, S the sum of their
    magnitudes (``SCORE_F64_ULP``); float32 sums are cast from float64
    (2**-24), float64 sums not cast."""
    return (gradient_bounds(dtype)["cast"] + 2 * m * SCORE_F64_ULP) * S


def sharded_gradient_bound(fates, fate_abs, n, dtype=torch.float32):
    """How far two ``fate_gradients(wrt="all")`` runs of the same n photons
    may differ when their float64 score sums were added in other orders
    (shards of a mesh against one process): ``score_runs_bound`` of each
    [fate, channel] sum (`fates` [11] float64, `fate_abs` [11, CH], the
    sums of the addends' magnitudes), carried through the centring, over
    n; `dtype` the runs' (``score_runs_bound``)."""
    B = score_runs_bound(fates[:, None], fate_abs, dtype)
    return (B + fates[:, None] / n * B.sum(0, keepdim=True)) / n


def compare_score_records(got_t, ref_t, got_fates, n, max_parted, swaps=None, max_drifted=0):
    """A score run of photons [0, n) with per-photon records (`got_t`,
    `got_fates`: ``kernels.trace(..., per_photon=True)`` on the card or
    the host build of its device code) against the twin's (`ref_t`:
    ``tracer.trace_eager(..., per_photon=True)``), by the rules above
    SCORE_F64_ULP (float64 records: F64_RTOL and the slack times
    F64_SLACK); at most `max_parted` photons may part, and as many may
    saturate (the pathwise channels, PATH_RTOL above); of those whose fate
    and steps equal the twin's but whose record parts (``drifted``),
    `max_drifted` more (SCORE_DRIFTED above). Returns a dict:
    ``parted`` (``drifted`` among them) and ``saturated`` photons, ``record_used`` and
    ``sums_used``, the largest share of its bound a record and a sum took,
    ``parted_allow`` [CH], the part of each sum's bound those photons
    take (twice the channel's largest |score| for each parted photon,
    and the saturated photons' own scores), and ``max_abs_err`` of the
    fate_scores against the twin's. `swaps` [R], where given, is each
    recorder's count of first matches that may differ between the two
    (on coincident faces, ``check_trace_scores``): its rec_scores row
    takes twice the channel's largest |score| for each, as a parted photon."""
    dev = ref_t["fate_scores"].device
    tol = gradient_bounds(ref_t["photon_scores"].dtype)
    kf, tf = got_t["photon_fate"].to(dev), ref_t["photon_fate"]
    require(bool((kf >= 0).all()), "pvt_trace (score): a photon never folded its score")
    ks, ts = got_t["photon_scores"].to(dev).double(), ref_t["photon_scores"].double()
    saturated = (saturates(ks) | saturates(ts)).any(0)
    n_sat = int(saturated.sum())
    require(n_sat <= max_parted,
            f"pvt_trace (score): {n_sat} of {n} photons saturated (limit {max_parted:g})")
    scale = torch.where(saturated[None, :], 0.0, ts.abs()).amax(1, keepdim=True)
    allow = tol["rtol"] * scale + tol["slack"] * ref_t["photon_slack"]
    off = torch.where(saturated[None, :], 0.0, (ks - ts).abs())
    discrete = (kf != tf) | (got_t["photon_steps"].to(dev) != ref_t["photon_steps"])
    parted = discrete | (off > allow).any(0)
    n_parted, n_drifted = int(parted.sum()), int((parted & ~discrete).sum())
    require(n_parted - n_drifted <= max_parted and n_parted <= max_parted + max_drifted,
            f"pvt_trace (score): {n_parted} of {n} photons parted from the twin's, "
            f"{n_drifted} of them with their fate and steps equal (limit {max_parted:g}, and "
            f"{max_drifted:g} more of those)")
    record_used = float(torch.where(parted[None, :], 0.0, off / allow.clamp(min=1e-30)).max()) \
        if n_parted < n else 0.0
    # The kernel's sums against its own records; a photon counted KILL for
    # want of an adjacent node folds again later (one fate count more each),
    # and only its last fold is in its record.
    got = {k: got_t[k].to(dev).double() for k in ("fate_scores", "fate_abs")}
    own = torch.zeros_like(got["fate_scores"]).index_add_(0, kf, ks.T)
    own_abs = torch.zeros_like(own).index_add_(0, kf, ks.abs().T)
    smax = torch.where(saturated[None, :], 0.0, torch.maximum(ks.abs(), ts.abs())).amax(1)
    sat = (ks.abs() + ts.abs())[:, saturated].sum(1)
    refolds = int(got_fates.sum()) - n
    own_allow = 2 * n * SCORE_F64_ULP * torch.maximum(own_abs, got["fate_abs"])
    own_allow[physics.EV_KILL] += refolds * smax
    own_off = (got["fate_scores"] - own).abs()
    require(bool((own_off <= own_allow).all()),
            f"pvt_trace (score): fate_scores off their records by "
            f"{float((own_off - own_allow).max()):.3g} past the bound")
    # What the parted and saturated photons may move each sum by, per channel
    parted_allow = n_parted * 2.0 * smax + sat
    sums_used = 0.0
    pairs = [("fate_scores", "fate_abs", "fate_slack")]
    if ref_t["rec_scores"].shape[0]:
        pairs.append(("rec_scores", "rec_abs", "rec_slack"))
    for name, abs_name, slack_name in pairs:
        a, b = got_t[name].to(dev).double(), ref_t[name].double()
        a = a[:b.shape[0]]
        bound_ = tol["rtol"] * ref_t[abs_name].double() + tol["slack"] * ref_t[slack_name] \
            + parted_allow
        if name == "rec_scores" and swaps is not None:
            bound_ = bound_.clone()
            bound_[:len(swaps)] += swaps.to(dev)[:, None] * 2.0 * smax[None, :]
        d = (a - b).abs()
        require(bool((d <= bound_).all()),
                f"pvt_trace (score): {name} off the twin's by "
                f"{float((d - bound_).max()):.3g} past the bound")
        sums_used = max(sums_used, float((d / bound_.clamp(min=1e-30)).max()))
    return {"parted": n_parted, "drifted": n_drifted, "saturated": n_sat,
            "record_used": record_used,
            "sums_used": sums_used, "parted_allow": parted_allow.tolist(),
            "max_abs_err": float((got["fate_scores"] - ref_t["fate_scores"].double())
                                 .abs().max())}


def check_score(st, state, steps=8, max_discrete=1e-4, maxsteps=1000, emit_method=0, reps=10):
    """pvt_score against its twin for `steps` steps from lanes `state`,
    both fed the twin's previous state and scores: discrete outcomes (the
    absorbing component among them) differ on at most a fraction
    `max_discrete` of lanes; on the others, bar the Fresnel lanes at
    incidence cosines below ``score.GRAZING_C`` (counted), each path score
    within SCORE_RTOL of its channel's scale plus the step's slack; each
    step's folds within SCORE_RTOL of their magnitudes, the folded lanes'
    slack, and the differing and grazing lanes at twice the channel's
    scale. A float64 scene: F64_RTOL and the slack times F64_SLACK
    (``gradient_bounds``)."""
    B = state["px"].shape[0]
    CH = score_ch.n_channels(st)
    s = state
    dev = state["px"].device
    dtype, real = _real(st)
    tol = gradient_bounds(dtype)
    scores = torch.zeros((CH, B), device=dev, dtype=dtype)
    # rel: the largest difference over its allowance on the agreeing lanes
    worst_frac, err, rel, fold_rel, worst_lane = 0.0, 0.0, 0.0, 0.0, ""
    grazing = 0
    for k in range(steps):
        twin, twin_new, twin_t = kernels.score_step_twin(st, s, scores, maxsteps, emit_method)
        got, got_new, got_t = kernels.score_step(st, s, scores, maxsteps, emit_method)
        torch.cuda.synchronize()
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        for name in DISCRETE + ("comp_id",):
            bad |= got[name].long() != twin[name].long()
        frac = float(bad.sum()) / B
        worst_frac = max(worst_frac, frac)
        require(frac <= max_discrete,
                f"pvt_score step {k}: discrete outcomes differ in {frac:.2e} of lanes")
        graze = twin["fres_coin"] & (twin["reflecting"] | twin["transmitting"]) \
            & (twin["c_in"] < score_ch.GRAZING_C) & ~bad
        grazing += int(graze.sum())
        bad |= graze
        scale = twin_new.abs().amax(1, keepdim=True).clamp(min=1e-30).double()
        allow = tol["rtol"] * scale + tol["slack"] * twin["slack"]
        diff = (got_new - twin_new).abs().double()
        excess = torch.where(bad[None, :], 0.0, diff - allow)
        over = float(excess.max())
        if over > 0.0:
            c, i = divmod(int(excess.argmax()), B)
            raise AssertionError(
                f"pvt_score step {k}: lane {i} channel {c} off by {float(diff[c, i]):.4g} "
                f"(kernel {float(got_new[c, i]):.6g}, twin {float(twin_new[c, i]):.6g}, "
                f"before {float(scores[c, i]):.6g}, allowed {float(allow[c, i]):.4g}; "
                f"n1 {float(twin['n1r'][i])}, n2 {float(twin['n2r'][i])}, "
                f"c_in {float(twin['c_in'][i])}, R {float(twin['refl_r'][i])}, "
                f"advance {float(twin['advance'][i])})")
        good = diff[:, ~bad]
        if good.numel():
            err = max(err, float(good.max()))
            used = torch.where(bad[None, :], 0.0, diff / allow)
            if float(used.max()) > rel:
                rel = float(used.max())
                c, i = divmod(int(used.argmax()), B)
                worst_lane = (f"step {k} lane {i} channel {c}: kernel "
                              f"{float(got_new[c, i]):.6g}, twin {float(twin_new[c, i]):.6g}, "
                              f"allowed {float(allow[c, i]):.3g} (slack "
                              f"{float(twin['slack'][c, i]):.3g}), nodes "
                              f"{int(twin['container'][i])} -> {int(twin['adjacent'][i])}, n "
                              f"{float(twin['n1r'][i]):.4g} -> {float(twin['n2r'][i]):.4g}, c_in "
                              f"{float(twin['c_in'][i]):.6g}, R {float(twin['refl_r'][i]):.4g}, "
                              f"advance {float(twin['advance'][i]):.4g}")
        twin_abs = twin_t["fate_abs"]
        fold_allow = tol["rtol"] * twin_abs + tol["slack"] * twin_t["fate_slack"] \
            + int(bad.sum()) * 2.0 * scale.T
        off = (got_t["fate_scores"] - twin_t["fate_scores"]).abs()
        require(bool((off <= fold_allow).all()),
                f"pvt_score step {k}: folds off by {float((off - fold_allow).max()):.3g} "
                f"past the bound")
        fold_rel = max(fold_rel, float((off / twin_abs.clamp(min=1e-30)).max()))
        s, scores = {name: twin[name] for name in s}, twin_new
    report = {
        "max_abs_err": err,
        "bound_used": rel,
        "worst_lane": worst_lane,
        "fold_rel_err": fold_rel,
        "discrete_frac": worst_frac,
        "grazing": grazing,
        "channels": CH,
        "ms": cuda_ms(lambda: kernels.score_step(st, s, scores, maxsteps, emit_method), reps),
        "plain_ms": cuda_ms(lambda: kernels.score_step_twin(st, s, scores, maxsteps, emit_method),
                            reps),
    }
    # pvt_step's bytes, and each lane's CH scores read and written.
    lane, flags = 61 + 9 * (real - 4), 45 + 4 * (real - 4)
    report["bound_ms"], report["bound_by"] = bound(
        B * (OPS_STEP + OPS_SCORE_STEP), B * (2 * lane + flags + 2 * real * CH),
        step_draws(B, 0), dtype,
    )
    return report


def fresnel_grid(device, dtype=torch.float32):
    """(n1, n2, c) on the unit tests' grid: four indices each way, 201
    cosines from 0 to 1 plus 1 - 1e-7 and 1e-9, and cosines at and next to
    each critical angle."""
    ns = [1.0, 1.33, 1.5, 2.4]
    cs = np.concatenate([np.linspace(0.0, 1.0, 201), [1.0 - 1e-7, 1e-9]])
    n1, n2, c = (a.ravel() for a in np.meshgrid(ns, ns, cs, indexing="ij"))
    crit = [(a, b, np.sqrt(1.0 - (b / a) ** 2) + e) for a in ns for b in ns if b < a
            for e in (0.0, 1e-7, -1e-7, 1e-4, -1e-4)]
    n1 = np.concatenate([n1, [x[0] for x in crit]])
    n2 = np.concatenate([n2, [x[1] for x in crit]])
    c = np.concatenate([c, [x[2] for x in crit]])
    return tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in (n1, n2, c))


def check_fresnel(device, reps=10, dtype=torch.float32, n=0):
    """pvt_fresnel against the twin, both in `dtype` on the card, on
    ``fresnel_grid`` and, up to `n` points in all, points drawn uniformly
    (n1, n2 in [1, 2.5], c in [0, 1], seed 0): within SCORE_RTOL (float64:
    F64_RTOL) of max(|twin|, 1) away from the critical angle
    (FRESNEL_SINGULAR), non-finite where the twin is."""
    rtol = gradient_bounds(dtype)["rtol"]
    n1, n2, c = fresnel_grid(device, dtype)
    extra = n - n1.numel()
    if extra > 0:
        g = torch.Generator(device=device).manual_seed(0)
        u = torch.rand((3, extra), generator=g, device=device, dtype=dtype)
        n1, n2, c = (torch.cat([v, w]) for v, w in zip((n1, n2, c),
                                                       (1.0 + 1.5 * u[0], 1.0 + 1.5 * u[1], u[2])))
    got = kernels.fresnel(n1, n2, c)
    twin = score_ch.fresnel_dR(n1, n2, c)
    torch.cuda.synchronize()
    r64 = n1.double() / n2.double()
    x = 1.0 - r64 * r64 * torch.clamp(1.0 - c.double() ** 2, 0.0, 1.0)
    regular = x.abs() > FRESNEL_SINGULAR
    err = 0.0
    for g, t in zip(got, twin):
        fin = torch.isfinite(t) & regular
        require(bool((torch.isfinite(g) == torch.isfinite(t))[regular].all()),
                "pvt_fresnel: finite where the twin is not, or the reverse")
        d = (g - t).abs()[fin] / t.abs()[fin].clamp(min=1.0)
        err = max(err, float(d.max()))
    require(err <= rtol, f"pvt_fresnel: off by {err:.3g} > {rtol}")
    report = {
        "max_abs_err": err,
        "points": int(n1.numel()),
        "singular": int((~regular).sum()),
        "ms": cuda_ms(lambda: kernels.fresnel(n1, n2, c), reps),
        "plain_ms": cuda_ms(lambda: score_ch.fresnel_dR(n1, n2, c), reps),
    }
    # Three reals read and two written a point.
    report["bound_ms"], report["bound_by"] = bound(
        n1.numel() * OPS_FRESNEL_DR, n1.numel() * 5 * n1.element_size(), dtype=dtype
    )
    return report


def check_layout(st, score, n_path, shared_rows=True):
    """The placement the last trace launch reported (``last_trace``)
    against ``kernels.trace_layout``'s for the same run, which it must
    equal."""
    want = kernels.trace_layout(st, score, n_path, shared_rows)
    got = {k: int(kernels.last_trace[k]) for k in want}
    require(got == want, f"pvt_trace placed its block as {got}, trace_layout says {want}")
    return got


def check_trace_scores(st, seed_words, n, lanes=1 << 18, maxsteps=1000, emit_method=0,
                       pathwise=(), bundle=None, maxpathlength=float("inf"), coincident=(),
                       probes=(), max_drifted=0):
    """pvt_trace with score channels against the twin, both on the card,
    n photons: fates (and recorder tallies) as ``check_trace``; the
    per-photon records and the fate_scores and rec_scores by
    ``compare_score_records``, at most SCORE_PARTED of the photons
    parted (a float64 scene: each within F64_PARTED, F64_PARTED
    parted). The kernel is timed again without its records, the twin with
    them. With `pathwise` specs the kernel is pvt_trace_pathwise. With a
    host `bundle` both start from it. Both take the run options
    `maxsteps`, `emit_method` and `maxpathlength`; the recorders on
    `coincident` nodes are held through their `probes` (``hold_tallies``),
    their score rows within twice the channel's largest score for each
    crossing that may have swapped (the tolerance and the shared-face
    crossings); `max_drifted` as ``compare_score_records``'. The block's placement
    (``shared_rows`` among it) must be ``kernels.trace_layout``'s."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    options = {"maxsteps": maxsteps, "emit_method": emit_method, "maxpathlength": maxpathlength,
               "score": True, "pathwise": pathwise, "bundle": bundle}
    got, _, got_t, _ = kernels.trace(st, seed_words, n, per_photon=True, **options)
    check_layout(st, True, len(pathwise))
    start.record()
    ref, _, ref_t, _ = tracer.trace_eager(st, seed_words, n, lanes=lanes, per_photon=True,
                                          **options)
    stop.record()
    torch.cuda.synchronize()
    got, ref = got.cpu(), ref.cpu()
    dtype = st["node_f"].dtype
    bounds = gradient_bounds(dtype)
    tol = bounds["fates"](n)
    require(int(got.sum()) == n, f"pvt_trace (score): fates sum to {int(got.sum())}, not {n}")
    err = int((got - ref).abs().max())
    require(err <= tol, f"pvt_trace (score): fates {got.tolist()} vs twin {ref.tolist()}")
    R = st["meta"]["n_rec"]
    swaps, held = None, {}
    if R:
        _, shared, aside = hold_tallies(got_t, ref_t, st, tol, "pvt_trace (score)", coincident,
                                        probes)
        swaps = coincident_recorders(st, coincident)[0].double() * (tol + shared)
        held = {"shared_crossings": shared, "coincident_max_diff": aside}
    report = compare_score_records(got_t, ref_t, got, n, bounds["parted"](n), swaps=swaps,
                                   max_drifted=max_drifted)
    report.update(held)
    report.update(fates=got.tolist(), twin_fates=ref.tolist(), fate_scores=got_t["fate_scores"],
                  twin_fate_scores=ref_t["fate_scores"], plain_ms=start.elapsed_time(stop),
                  tallies=got_t)
    again, _, _, _ = kernels.trace(st, seed_words, n, **options)
    require(torch.equal(again.cpu(), got), "pvt_trace (score): fates differ between two runs")
    report.update(ms=kernels.last_trace["ms"], shared_scores=kernels.last_trace["shared_scores"],
                  shared_rows=kernels.last_trace["shared_rows"],
                  shared_cheb=kernels.last_trace["shared_cheb"])
    ops_ms, by = trace_bound(st, n, kernels.last_trace["total_steps"], got_t if R else None,
                             bundle is not None, got)
    C = len(pathwise)
    CH = score_ch.n_channels(st, C)
    per_step = OPS_SCORE_STEP + (OPS_PATH_STEP + C * OPS_PATH_CHANNEL if C else 0)
    peak = PEAK_F64_OPS_PER_S if dtype == torch.float64 else PEAK_OPS_PER_S
    score_ms = (kernels.last_trace["total_steps"] * per_step + n * CH * OPS_SCORE_FOLD) \
        / peak * 1e3
    report["bound_ms"], report["bound_by"] = (ops_ms + score_ms, "operations") \
        if by == "operations" else (ops_ms, by)
    return report


def check_rows_placement(st, seed_words, n, records, pathwise=(), reps=2):
    """The score trace of photons [0, n) with the threads' rows forced into
    device memory against `records` (``check_trace_scores``' tallies, the
    rows where ``trace_layout`` put them): only the rows' addresses
    differ, so fates, every photon's record (its scores bit for bit), fate
    and steps are equal. Returns the placement of each and the kernel's
    time in each (``last_trace["ms"]`` of runs without records, in turns
    placed, device, .. `reps` times): ``ms_placed``, ``ms_device``."""
    got, _, t, _ = kernels.trace(st, seed_words, n, score=True, per_photon=True,
                                 pathwise=pathwise, shared_rows=False)
    device = check_layout(st, True, len(pathwise), shared_rows=False)
    require(not device["shared_rows"], "shared_rows=False left the rows in shared memory")
    for name in ("photon_fate", "photon_steps"):
        require(torch.equal(t[name], records[name].to(t[name].device)),
                f"rows in device memory: {name} differs from the placed rows' run")
    bits = torch.int64 if t["photon_scores"].dtype == torch.float64 else torch.int32
    a = t["photon_scores"].view(bits)
    b = records["photon_scores"].to(a.device).view(bits)
    require(torch.equal(a, b), f"rows in device memory: {int((a != b).sum())} record entries "
                               f"differ in their bits from the placed rows' run")
    ms = {True: [], False: []}
    for _ in range(reps):
        for placed in (True, False):
            kernels.trace(st, seed_words, n, score=True, pathwise=pathwise, shared_rows=placed)
            ms[placed].append(kernels.last_trace["ms"])
    return {"placed": kernels.trace_layout(st, True, len(pathwise)), "device": device,
            "fates": got.cpu().tolist(), "ms_placed": ms[True], "ms_device": ms[False]}


def saturates(x):
    """Where `x` is not finite or at least SATURATED in magnitude."""
    return ~torch.isfinite(x) | (x.abs() >= SATURATED)


def fresnel_dR_dc(out):
    """|dR/dc| of the Fresnel reflectivity at each lane's (n1, n2, c_in),
    float64 (inf at the critical angle)."""
    c = out["c_in"].double().requires_grad_()
    with torch.enable_grad():
        r = score_ch.fresnel_R(out["n1r"].double(), out["n2r"].double(), c)
        (g,) = torch.autograd.grad(r.sum(), c)
    return g.abs()


def check_pathwise(st, state, specs, steps=8, max_discrete=1e-4, maxsteps=1000, emit_method=0,
                   reps=10):
    """pvt_pathwise against its twin for `steps` steps from lanes `state`
    with the pathwise channels `specs`, both fed the twin's previous state
    and tangents (zero at the start): discrete outcomes (the absorbing
    component among them) differ on at most a fraction `max_discrete` of
    the lanes; on the others, bar the lanes left out (PATH_RTOL above,
    counted, at most PATH_LEFT_OUT of them), each channel's map (the new
    coordinates' tangents, then those of t0, alpha and the reflectivity),
    contribution and new tangents within PATH_RTOL of their scale, the
    contribution also within its slack. A float64 scene: F64_RTOL,
    PATH_LEFT_OUT and the slacks times F64_SLACK
    (``gradient_bounds``)."""
    B, C = state["px"].shape[0], len(specs)
    dev = state["px"].device
    s = state
    dtype, real = _real(st)
    tol = gradient_bounds(dtype)
    rtol, left_max = tol["path_rtol"], tol["left_out"]
    tang = torch.zeros((C, 7, B), device=dev, dtype=dtype)
    worst_frac, used, err, left_out, saturated, worst = 0.0, 0.0, 0.0, 0, 0, ""
    names = path.OUTPUTS + ("contribution",) + tuple(f"new {c}" for c in path.COORDS)
    for k in range(steps):
        twin, t_jv, t_ds, t_tang = kernels.pathwise_step_twin(st, s, tang, specs, maxsteps,
                                                              emit_method)
        got, g_jv, g_ds, g_tang = kernels.pathwise_step(st, s, tang, specs, maxsteps, emit_method)
        torch.cuda.synchronize()
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        for name in DISCRETE + ("comp_id",):
            bad |= got[name].long() != twin[name].long()
        frac = float(bad.sum()) / B
        worst_frac = max(worst_frac, frac)
        require(frac <= max_discrete,
                f"pvt_pathwise step {k}: discrete outcomes differ in {frac:.2e} of lanes")
        ref = torch.cat([t_jv, t_ds[:, None], t_tang], 1).double()  # [C, 18, B]
        val = torch.cat([g_jv, g_ds[:, None], g_tang], 1).double()
        sat = (saturates(ref) | saturates(val)).any(1).any(0)
        graze = torch.isfinite(twin["t0"]) & (twin["c_hit"] < score_ch.GRAZING_C)
        out = bad | sat | graze
        saturated += int((sat & ~bad).sum())
        left_out += int((out & ~bad).sum())
        require(left_out <= left_max * B * (k + 1),
                f"pvt_pathwise step {k}: {left_out} lanes left out (limit "
                f"{left_max * B * (k + 1):g})")
        scale = torch.where(out[None, None, :], 0.0, ref.abs()).amax(2, keepdim=True)
        for group in PATH_GROUPS:
            scale[:, group] = scale[:, group].amax(1, keepdim=True)
        scale = torch.maximum(scale, PATH_FLOOR * scale.amax(1, keepdim=True))
        allow = rtol * scale.clamp(min=1e-30) + ref.abs() * path.grazing(twin) * tol["slack"]
        allow[:, T.PATH_J] += tol["slack"] * twin["path_slack"]
        # The reflectivity's tangent and the coin term carry the error of
        # c's tangent (rtol of the tangents' scale) times dR/dc.
        dr_dc = fresnel_dR_dc(twin).nan_to_num(posinf=0.0, neginf=0.0)
        coin = twin["fres_coin"] & (twin["reflecting"] | twin["transmitting"])
        r = torch.where(coin, twin["refl_r"].double(), 0.5)
        branch = torch.where(twin["reflecting"], 1.0 / r.clamp(min=1e-12),
                             1.0 / (1.0 - r).clamp(min=1e-12))
        carried = rtol * scale[:, 0] * torch.where(coin, dr_dc, 0.0)[None, :]
        allow[:, 9] += carried
        allow[:, T.PATH_J] += carried * branch
        diff = torch.where(out[None, None, :], 0.0, (val - ref).abs())
        share = torch.where(out[None, None, :], 0.0, diff / allow)
        over = float(share.max())
        if over > used or over > 1.0:
            used = over
            c, q, i = np.unravel_index(int(share.argmax()), share.shape)
            worst = (f"step {k} lane {i} channel {specs[c]} {names[q]}: kernel "
                     f"{float(val[c, q, i]):.6g}, twin {float(ref[c, q, i]):.6g}, allowed "
                     f"{float(allow[c, q, i]):.3g}; hit {int(twin['hit'][i])}, c_in "
                     f"{float(twin['c_in'][i]):.6g}, absorbed {bool(twin['absorbed'][i])}")
        require(over <= 1.0, f"pvt_pathwise: {worst}")
        err = max(err, float((diff / scale.clamp(min=1e-30)).max()))
        require(over <= 1.0 and err == err, f"pvt_pathwise step {k}: not finite")
        s, tang = {name: twin[name] for name in s}, t_tang.contiguous()
    report = {
        "max_abs_err": err, "bound_used": used, "worst_lane": worst,
        "discrete_frac": worst_frac, "left_out": left_out, "saturated": saturated,
        "channels": C,
        "ms": cuda_ms(lambda: kernels.pathwise_step(st, s, tang, specs, maxsteps, emit_method),
                      reps),
        "plain_ms": cuda_ms(lambda: kernels.pathwise_step_twin(st, s, tang, specs, maxsteps,
                                                               emit_method), reps),
    }
    # pvt_step's work and bytes, and per channel the map: 7 tangents read,
    # 7 written, PATH_J map values and one contribution written.
    lane, flags = 61 + 9 * (real - 4), 45 + 4 * (real - 4)
    report["bound_ms"], report["bound_by"] = bound(
        B * (OPS_STEP + OPS_PATH_STEP + C * OPS_PATH_CHANNEL),
        B * (2 * lane + flags + real * C * (7 + 7 + T.PATH_J + 1)), step_draws(B, 0), dtype,
    )
    return report


def check_chunk_scores(st, seed_words, data, n, chunk=1 << 20):
    """The score sums of one ``simulate(score=True)`` run of photons
    [0, n) (`data`) against the same photons traced by pvt_trace in runs
    of `chunk`: fates and recorder counts equal, and fate_scores and
    rec_scores within ``score_runs_bound`` (of the scene's dtype) of the
    runs' float64 totals. Returns the largest difference over its
    bound."""
    total = None
    for first in range(0, n, chunk):
        fates, _, t, _ = kernels.trace(st, seed_words, min(chunk, n - first),
                                       index_offset=first, score=True)
        t = dict(t, fates=fates)
        total = t if total is None else {k: total[k] + t[k] for k in t}
    fates = total["fates"].cpu()
    require(bool((torch.as_tensor(data["fates"]) == fates).all()),
            f"{n} photons against runs of {chunk}: fates differ")
    worst = 0.0
    R = st["meta"]["n_rec"]
    rows = [("fate_scores", "fate_abs", fates.double())]
    if R:
        distinct = total["distinct"][:R].cpu()
        require(bool((torch.as_tensor(data["rec_distinct"]) == distinct).all()),
                f"{n} photons against runs of {chunk}: rec_distinct differs")
        rows.append(("rec_scores", "rec_abs", distinct.double()))
    for name, abs_name, m in rows:
        got = torch.as_tensor(data[name]).double()
        ref = total[name][:got.shape[0]].cpu()
        allow = score_runs_bound(m[:, None], total[abs_name][:got.shape[0]].cpu(),
                                 st["node_f"].dtype)
        off = (got - ref).abs()
        require(bool((off <= allow).all()),
                f"{n} photons against runs of {chunk}: {name} off by "
                f"{float((off - allow).max()):.3g} past the bound")
        worst = max(worst, float((off / allow.clamp(min=1e-300)).max()))
    return worst


def absorbed_photons(st, seed_words, P):
    """P photons of the scene's lights, as pvt_emit makes them: positions
    and directions [P, 3] and wavelengths [P] in the scene's dtype."""
    s = kernels.emit(st, seed_words, 0, P)
    pos = torch.stack([s["px"], s["py"], s["pz"]], 1).contiguous()
    direction = torch.stack([s["dx"], s["dy"], s["dz"]], 1).contiguous()
    return pos, direction, s["wav"].contiguous()


def check_absorbed(tab, pos, direction, wav, log_c=0.0, reps=10):
    """pvt_absorbed and pvt_absorbed_grad against the plain version
    (``engine/absorb.py``) on the card: weights and depths within
    ABSORBED_RTOL relative, the gradient (cotangents 1/P, as a mean's)
    within GRAD_RTOL of the sum of its terms' magnitudes (float64 photons
    and table: F64_RTOL for both)."""
    P, dtype = wav.shape[0], wav.dtype
    tol = gradient_bounds(dtype)
    c = torch.exp(torch.full((1,), log_c, device=wav.device, dtype=dtype))
    grad_w = torch.full_like(wav, 1.0 / P)
    w, dep = kernels.absorbed(tab, pos, direction, wav, c)
    g = kernels.absorbed_grad(dep, grad_w, c)
    ref_dep = absorb.depth(tab, pos, direction, wav)
    ref_w = absorb.weight(c, ref_dep)
    terms = grad_w * (c * ref_dep * torch.exp(-c * ref_dep))
    torch.cuda.synchronize()
    rel_w = float(((w - ref_w).abs() / ref_w.abs().clamp(min=1e-30)).max())
    rel_d = float(((dep - ref_dep).abs() / ref_dep.abs().clamp(min=1e-30)).max())
    rel_g = float((g.double() - terms.double().sum()).abs() / terms.abs().double().sum())
    require(rel_w <= tol["absorbed"] and rel_d <= tol["absorbed"],
            f"pvt_absorbed: weights off by {rel_w:.3g}, depths by {rel_d:.3g} > "
            f"{tol['absorbed']}")
    require(rel_g <= tol["grad"], f"pvt_absorbed_grad: off by {rel_g:.3g} > {tol['grad']}")
    A = tab["node_i"].shape[0]
    report = {
        "max_abs_err": float((w - ref_w).abs().max()),
        "max_rel_err": rel_w,
        "grad_rel_err": rel_g,
        "grad_abs_err": float((g.double() - terms.double().sum()).abs()),
        "absorbed": float(w.mean()),
        "ms": cuda_ms(lambda: kernels.absorbed(tab, pos, direction, wav, c), reps),
        "plain_ms": cuda_ms(lambda: absorb.weight(c, absorb.depth(tab, pos, direction, wav)),
                            reps),
        "grad_ms": cuda_ms(lambda: kernels.absorbed_grad(dep, grad_w, c), reps),
        "grad_plain_ms": cuda_ms(lambda: absorb.grad_log_concentration(c, ref_dep, grad_w),
                                 reps),
    }
    # Reads pos, dir, wav (7 reals), writes w and depth (2); the grad reads
    # depth and the cotangent (2 reals) and writes one float64.
    real = wav.element_size()
    report["bound_ms"], report["bound_by"] = bound(P * (A * OPS_CHORD + OPS_ABSORBED),
                                                   P * 9 * real, dtype=dtype)
    report["grad_bound_ms"], report["grad_bound_by"] = bound(P * OPS_ABSORBED_GRAD,
                                                             P * 2 * real + 8, dtype=dtype)
    return report


def surrogate_sgd(weight_fn, pos, direction, wav, steps=5, target=0.8, lr=0.1):
    """`steps` SGD steps of ``make_training_step``'s single-shard
    arithmetic: loss = (mean(w) - target)^2 over the photons, gradient in
    log_concentration by torch.autograd, log_c -= lr * grad. `weight_fn`
    (log_c, pos, dir, wav) -> weights. Returns [(log_c, loss, grad)]; log_c
    in the photons' dtype."""
    log_c = torch.zeros((), device=wav.device, dtype=wav.dtype, requires_grad=True)
    history = []
    for _ in range(steps):
        loss = (weight_fn(log_c, pos, direction, wav).mean() - target) ** 2
        (grad,) = torch.autograd.grad(loss, log_c)
        history.append((float(log_c.detach()), float(loss.detach()), float(grad)))
        with torch.no_grad():
            log_c -= lr * grad
    return history
