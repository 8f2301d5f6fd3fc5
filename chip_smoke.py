"""Smoke test of pvtrace_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain-PyTorch twin on the card, then drives the port's main
paths: ``engine.simulate`` of the LSC benchmark scene without and with
recorders, of the hex-plate mesh LSC, and with event-log histories, and
the gradient paths of ``diff.transport`` (score channels, pathwise
channels, the Beer–Lambert surrogate), and the entry points above
``simulate`` (``simulate_stream``, ``simulate_checkpointed``, the LSC
device API) and the user's entry points above those (the CLI with
``--watch``, the studio's live run, the profiling utilities), at full
width. Phases, one line each:

0. the card (nvidia-smi name and power limit, torch's device name);
1. build the kernels with nvcc (sm_90a), one nvcc per library (tracer,
   score, pathwise, diff, and their float64 builds tracer_f64, score_f64,
   pathwise_f64, diff_f64) started together: build time, and one line a
   function, every instantiation and every function kept out of line,
   with its registers, stack frame and spills (``trace_kernel<..>`` by
   its template flags), and one line of the instantiations with recorders
   (K9) or meshes (K10) and of pvt_tally's and pvt_mesh's kernels;
2. pvt_emit against the twin on 2**20 photons;
3. pvt_step against the twin for 8 steps from the emitted state;
4. pvt_trace against the eager twin, 2**20 photons, at the scene's
   defaults (Chebyshev spectra, K5a): the kernel's own time (CUDA events
   around a second launch, whose fates must equal the first's) and the
   wrapper's (the first ``kernels.trace`` call whole);
4b. phases 2-4 again on the table lerp (K5b, PVTRACE_TPU_NO_CHEB=1),
   against the K5b twin;
5. the main path: simulate at 2**27 photons through pvt_trace (launch
   counts set to 0 just before and read just after), with its photons/s,
   its kernel time and phase 4's at 2**20; the slab's K5a table must have
   been staged in shared memory. Its lane efficiency (the photons' steps
   over the lane-steps of the warps' turns, ``last_trace``) must exceed
   the estimate for a loop per photon (each warp of 32 consecutive ids
   as long as its longest photon) from phase 17's per-photon steps of
   the slab, printed beside it; so in phases 10, 11, 15 (phase 17's
   mesh LSC records) and 25 (phase 24's);
6. pvt_cheb against the twin on every Chebyshev fit of the scene, on a
   grid of 2**16 t and at every breakpoint, its float32 neighbours, the
   ends and NaN (each value's segment equal to the twin's), with the
   table staged in shared memory and read in device memory; then
   ``scenes.lsc_tiles``, whose K5a table is larger than a block's shared
   budget: pvt_cheb and pvt_trace (2**16 photons) against the twin with
   the table in device memory;
7. pvt_tally against the twin on phase 3's lanes for 8 steps, by the rule
   pvt_trace takes for each scene: with 32 recorders (groups of 8, each
   lane its own event: tally_event), with 256 (groups of up to 64, the
   warp's together: tally_warp) and with the heatmap's bins past shared
   memory (global 64-bit bins, tally_event): integer tallies and seen bits
   equal after every step;
8. pvt_trace with 32 and with 256 recorders (the full width: 10 facet
   groups, the warp rule, over 48 KB of shared memory a block), 2**20 photons,
   against the twin: distinct rays, crossings and bins per entry, mean
   wavelengths; simulate's RecorderResults against the kernel's tallies;
9. a recorder scene whose bins exceed a block's shared memory, so the
   kernel's global-atomic bins path runs, against the twin;
10. the main path with K5a and with the table lerp (K5b,
    PVTRACE_TPU_NO_CHEB=1), in turns a, b, b, a: photons/s and lane
    efficiency of each (K5b's estimate from its own per-photon steps);
11. the recorder path at 2**27 photons for 4, 32 and 256 recorders,
    each read around its own run: photons/s, and launches of pvt_trace
    with no eager run; at 32, its tallies against the same photons in
    128 runs of 2**20 (integers equal, sums within the stated bound);
12. pvt_mesh (K10, the triangles staged in shared memory as pvt_trace's
    blocks stage them) against the twin, 2**20 random rays against the hex
    plate (24 triangles) and the tessellated slab (140): hit counts equal
    except on rays near an edge, t1 and t2 within 1e-5 relative, the
    nearest hit's normals equal;
13. pvt_trace on the mesh LSC (``scenes.mesh_lsc``) against the eager
    twin, 2**20 photons: fates, each recorder's distinct rays, crossings
    and bins within max(20, 0.2% of n), mean wavelengths within one
    standard error;
14. the event log (K11) against the twin's, photon by photon, on the
    mesh LSC and the slab, record_every=1, 2**14 photons, max_events 128
    and on the mesh LSC 8 (the event-budget kill), the kernel's counts
    against the twin's rows; pvt_log_pack against ``eventlog.pack`` on
    each of those logs, bit-equal, timed beside the plain version and the
    two boolean-mask gathers; simulate's dense log (pack, copy, unpack)
    against the CPU twin's on the mesh LSC at max_events 128 and 8; then
    simulate's recorder tallies against the tallies recomputed from its
    own log (``history_tally``), on the mesh LSC and on the slab with 8
    recorders;
15. full width: the mesh LSC at 2**27 photons (record_every=0), at 2**27
    with record_every=1000 and at 2**17 with record_every=1, each read
    around its own run (photons/s, the log's bytes, launches of pvt_trace,
    pvt_trace_log and pvt_log_pack with no eager run; with the log the
    fetch's parts: the pack, the copy of the records and counts with its
    GB/s, the unpack, the bytes copied against the dense bytes);
    pvt_log_pack against ``eventlog.pack`` on a log of 1 in 1000 at
    2**27, bit-equal and timed; the slab at 2**27 again, beside phase 5;
16. pvt_score (K12, one step with score channels) against the twin on
    phase 3's lanes for 8 steps, on the slab and on the mixed scene:
    discrete outcomes on all but 1e-4 of the lanes, path scores within
    1e-4 of each channel's scale plus their slack, the folds likewise;
    pvt_fresnel (dR/dn) in float32 against the twin on the unit tests'
    grid;
17. pvt_trace with score channels against the eager twin, 2**20 photons,
    on the slab, the slab with 32 recorders and the mesh LSC: fates within
    max(20, 0.2% of n), fate_scores and rec_scores within the stated
    bound, the block's placement (the threads' rows in shared memory)
    equal to ``kernels.trace_layout``'s, the slab's and the mesh LSC's
    per-photon loop estimates equal to those phases 5-15 printed; each
    again with the rows forced
    into device memory, its per-photon records bit-equal (only the
    addresses differ) and both placements timed in turns; then
    simulate(score=True) at 2**27 with 32 recorders against the same
    photons in 128 runs of 2**20 (integers equal, score sums within the
    float64 accumulation bound);
18. the gradient path at full width: diff.transport.fate_gradients of the
    slab at 2**27 photons (wrt="all", bundles of 16e6) and simulate of the
    mesh LSC at 2**27 with score=True, each read around its own run
    (photons/s beside phase 5, launches of pvt_trace_score, no eager run,
    the launches' summed kernel time beside the host seconds, where the
    rows lay);
    the absorber slab and the Fresnel slab at 2**24 against their
    analytic gradients (bounds 0.02 and 0.005); optimize_concentration on
    the scaled LSC as examples/optimize_lsc.py calls it (6 iterations of
    400,000 photons), its history finite;
19. K15: pvt_absorbed and pvt_absorbed_grad against the plain version on
    2**24 photons emitted by pvt_emit from the slab's light: weights
    within 1e-5 relative, the gradient within 1e-4; then 5 SGD steps of
    make_training_step's single-shard arithmetic through
    absorbed_fraction_fn (launches read around them) against the plain
    version, step by step;
20. pvt_pathwise (K13, one step with pathwise channels) against the twin
    on 2**20 lanes of the mixed scene for 8 steps, channels ("n",
    "plate"), ("size", "plate", 2), ("radius", "rod"), ("length", "rod"):
    discrete outcomes on all but 1e-4 of the lanes, each channel's tangent
    map, contribution and new tangents within the stated tolerance of its
    scale (saturated and grazing lanes left out, counted, capped);
21. pvt_trace_pathwise against the eager twin photon by photon, 2**20
    photons, on the slab and the slab with 32 recorders with ("n", "lsc")
    and ("size", "lsc", 2), and on the mesh LSC with ("n", plate): as
    phase 17, the rows forced into device memory too; then two channels
    on the slab with 256 recorders, where the rows do not fit a block's
    budget (they took device memory), and with 224, where they fit only
    without the K5a table: each against the twin photon by photon at
    2**16 photons (as above), then at 2**20 rows in shared memory and the
    table in device memory against the reverse, records bit-equal, timed
    in turns;
22. the analytic pathwise gradients at 2**24 photons: d P(NONRADIATIVE)
    / dn of the tilted Fresnel slab (30 degrees) within 0.006 of its
    analytic value and EXIT's within 0.008 of its negative; d
    P(NONRADIATIVE) / dL of the index-matched and the Fresnel absorber
    slab within 0.005 (the JAX package's bounds);
23. the pathwise gradient path at full width: fate_gradients(slab,
    2**27, wrt="all", pathwise=[("n", "lsc"), ("size", "lsc", 2)]) in
    bundles of 16e6 (launches read around it; photons/s beside phases 5
    and 18; kernel time and rows as phase 18);
24. pvt_trace in bundle mode (K8's trace_bundle entry) against the twin
    fed the same host bundle: ``scenes.lsc_slab_host`` with 4 recorders,
    one ``emit_bundle`` output of 2**20 photons, fates and recorder
    counts within max(20, 0.2% of n); at 2**14 with the event log photon
    by photon (as phase 14); with score channels photon by photon (as
    phase 17); then pvt_emit's output (phase 2's photons) fed back as a
    bundle gives phase 4's fates bit for bit, and on the slab with 32
    recorders phase 8's tallies;
25. the host-emission path at full width: simulate(lsc_slab_host(),
    2**24, record_every=0) (launches read around it: one pvt_trace, in
    bundle mode, no eager run), photons/s over `elapsed` beside phase 5's,
    the numpy sampling's seconds apart;
26. K14, the sharded runs of ``parallel``: a world of one on NCCL
    (``init_distributed(backend="nccl")``) runs shard_simulate of the slab
    with 4 recorders at 2**27, equal to simulate of the same seed (fates
    and integer tallies; rec_sums within two runs' bound), then the score
    run at 2**27, fate_gradients(mesh=) at 2**24 and a make_training_step
    step on 2**24 photons; then two ranks on gloo sharing the card
    (``python3 chip_smoke.py --rank r`` subprocesses: NCCL refuses two
    ranks on one card) run the same three, against the world of one:
    integers equal, score sums and gradients within the float64
    accumulation bound, the step within float32 rounding. The all-reduce's
    time and bytes per call on each backend (no multi-GPU speed can be
    measured on one card). On the world of one also ``LSC.gradient(mesh=)``
    (2**23 photons, one bundle) against its run without a mesh (distinct
    counts and efficiency equal, score sums within two runs' float64
    bound) and ``simulate_checkpointed(mesh=)`` (the slab with 4 recorders,
    2**24 in two bundles) against its run without one (integers equal),
    their all-reduces counted, and in float64 ``fate_gradients(mesh=)``
    (2**23 photons, ``score_f64``) against its run without a mesh
    (fractions equal, gradients within two float64 runs' bound) and a
    ``make_training_step`` step on 2**24 float64 photons (``diff_f64``);
27. K1's and K2's draws as pvt_trace makes them (a step's four pairs; a
    refill's keys and the emission pairs the scene's lamps read, not all
    three): pvt_draws on 2**20 lanes with random keys, step counts, read
    masks and dead lanes, for lamps that read three emission pairs, none
    and the slab lamp's one, against the twin's threefry words
    (``rng.warp_draws``) bit for bit, and the threefry calls each warp's
    refill made (counted in the kernel where it makes them) against the
    twin's count;
28. ``simulate_stream`` of the slab at 2**27 in bundles of 2**24 and at
    2**22 in the JAX package's default bundles of 50,000, each against one
    ``simulate`` of the same seed: fates bit for bit (a photon's draws are
    a function of (seed, global id)); pvt_trace launches read around the
    stream (one a bundle, no eager run), its summed ``elapsed``, its host
    seconds from the first next() to the last, photons/s of each and the
    host time a bundle (the scene tensors are rebuilt every call);
29. ``simulate_checkpointed`` at 2**27 in bundles of 2**24: three bundles,
    then a resume without ``bundle=`` (the stored one), against an
    uninterrupted run, on the slab with 32 recorders (integers equal, sums
    within two runs' bound) and on the slab with ``score=True``
    (fate_scores of both within the float64 accumulation bound of the same
    photons traced by pvt_trace_score in bundles); launches read around
    the two calls, the save's seconds a bundle;
30. ``LSC((5, 5, 1)).simulate`` at its defaults (histories: pvt_trace with
    the event log and pvt_log_pack, launches read around it) at 2**14
    against ``device="cpu"`` (float32, the same seed and np.random state):
    the counts table and the exit events within max(20, 0.2% of n), one
    entrance row a recorded photon; at 2**16 timed: the trace and fetch
    (``elapsed``) apart from the host loops of ``histories()`` and of the
    dataframe, the loop's ends marked by ``LSC.simulate``'s progress
    calls;
31. ``LSC.gradient`` with solar cells on the four edges at 2**27,
    ``wrt="concentration"`` (pvt_trace_score) and ``wrt="n"``
    (pvt_trace_pathwise), 9 launches each in bundles of 16,000,000, and at
    2**20 against ``device="cpu"`` (the CPU side in a process of its own,
    ``--lsc-twins`` below, started after phase 35 and compared after phase
    38's random scenes): distinct counts within max(20, 0.2% of
    n), the cells' and the incident row's score sums within phase 17's
    bound (SCORE_RTOL of the twin's sum of |score| plus its slack, and
    twice the channel's largest |score| for each photon whose record
    parted from the CPU twin's, compared photon by photon on the same
    inputs), the gradient within that bound carried through the ratio;
    and the gradient run's scene and channel (its recorders, the resolved
    pathwise spec) through pvt_trace_score or pvt_trace_pathwise against
    the twin on the card photon by photon, phase 17's and 21's check;
32. the CLI: ``simulate tests/data/lsc.yml -n 100000 --seed 3`` (the
    README's command; pvt_trace with the log and pvt_log_pack, launches
    read around it): wall seconds, the trace kernels' ms, and of the
    command's host time the waits on the stream, ``histories()`` and
    SQLite (``cli_clocks``, timed from outside the command);
    the rays written and the events by kind; ``count``, ``spectrum`` and
    ``time`` of the plate's escaping rays; then the same command at 2**12
    on the card and with ``--device cpu``, photon by photon
    (``check.compare_databases``: at most LOG_DIVERGED of the photons
    parted, the others' floats within LOG_RTOL);
33. ``simulate --watch`` at 2**16 with a viewer on ``/api/watch``: the
    messages in order, the last bundle's recorder integers equal to one
    ``simulate``'s of the seed;
34. the studio: ``create_server(port=0)``, the document PUT, ``/api/run``
    at its defaults (100,000 rays, bundles of 25,000, record_every 1000,
    200 paths) and at 2**24 in bundles of 2**22: the recorder integers
    equal to a summed ``simulate_stream``'s, paths sent, rays/s as the
    server sends it and on the client's clock, launches; a second
    ``/api/run`` during the 2**24 run refused with 409;
35. ``utils.trace_profile`` around ``simulate(lsc_slab(), 2**20)``: the
    torch.profiler trace must name the ``trace_kernel`` instantiation
    that ran (CUPTI sees the ctypes launches), its time beside the CUDA
    events'; ``device_memory_stats()`` before (the peak reset) and after;
36. float64 (``tracer_f64``): each float64 entry against the float64
    twin on the card at 2**20 (pvt_emit, pvt_step for 8 steps, pvt_cheb
    in both placements, pvt_draws bit for bit, pvt_tally with 32 and 256
    recorders, pvt_mesh; pvt_trace on the slab, with 32 and 256
    recorders, the mesh LSC and the host-lit slab's bundle: fates and
    integer tallies within ``check.F64_PARTED``, sums within the float64
    summation bound; the event log at record_every=1 on 2**14 photon by
    photon, at most F64_PARTED parted, and its pvt_log_pack, and
    simulate's dense float64 log against the CPU twin's); then
    ``simulate(dtype=np.float64)`` at full width (the slab at 2**27, with
    32 recorders, the mesh LSC, its history at record_every=1000, the
    host-lit slab at 2**24; launches read around each, tracer_f64's and no
    eager run), photons/s beside the float32 phases'; a float64
    ``simulate_stream`` union against one ``simulate`` at 2**20, integer by
    integer;
37. float64 gradients (``score_f64``, ``pathwise_f64``, ``diff_f64``):
    pvt_score for 8 steps and pvt_pathwise (the mixed scene's four
    channels) for 8 steps at 2**20 lanes, and pvt_fresnel at 2**20
    points, against the float64 twin lane by lane; pvt_trace_score at
    2**16 and pvt_trace_pathwise at 2**14 photon by photon on the slab,
    with 32 recorders and on the mesh LSC, the rows where
    ``trace_layout`` puts them and forced into device memory (records
    bit-equal); pvt_absorbed and pvt_absorbed_grad at 2**24, 5 SGD steps
    of ``absorbed_fraction_fn`` against the plain version's and 2 of
    ``make_training_step`` (all with ``check.gradient_bounds``' float64
    bounds); then at 2**27 ``fate_gradients(lsc_slab(), wrt="all")``,
    with the slab's two pathwise channels, ``simulate(mesh_lsc(),
    score=True)``, ``LSC.gradient`` (concentration and n) and
    ``simulate_checkpointed(score=True)`` (its sums against runs of 2**24
    within the float64 accumulation bound), each in float64, launches read
    around it (the float64 builds' alone, no eager run), photons/s beside
    phases 18's, 23's, 29's and 31's float32 figures; and
    ``optimize_concentration`` for two iterations.

38. random scenes (``scenes.random_scene``, seeds 0-31, each under its own
    emit method and caps, with probe recorders on the faces touching boxes
    share): ``check_trace`` in float32 at 2**18 and in float64 at 2**16
    photons with the recorders' tallies, ``check_log`` on
    four seeds, ``check_trace_scores`` on four with absorbing components
    in nested nodes, and the index-matched copy's crafted rays through
    ``pvt_trace``'s bundle mode in float64, their logs equal to the twin's
    in kinds and nodes and to the oracle's record by record
    (``kernels.crafted``); then ``lsc_tiles(N, dyes=1)`` for N = 8, 16, 32,
    64: ``check_trace`` at 2**18 and ``simulate`` at 2**24 (photons/s,
    kernel ms, lane efficiency, registers, where the K5a table lies).

Then the script's seconds, the card's nvidia-smi line, one JSON line of
per-kernel numbers (each row with ``reached_from``: the entry points above
``simulate`` whose run in phases 26, 28-34 and 38 launched it or, for device
code inside the trace kernels, launched a kernel whose loop runs it on a
scene that needs it; the float64 entries' rows, named ``*_f64``, from
phases 36 and 37, their bounds at the FP64 rate, each with its
``library``; a float64 gradient row whose entry runs only inside a trace
kernel counts its own launches, 0 on the path, and names that kernel in
``runs_inside``, as the float32 rows do),
and as the last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before the last line; without a CUDA device nothing runs.

    python3 chip_smoke.py --rank R --world W --port P --out FILE

is one rank of phase 26's gloo world: it joins ``tcp://localhost:P``,
runs the sharded runs on the card and writes them to FILE as JSON.

    python3 chip_smoke.py --lsc-twins FILE

is phase 31's CPU side: ``LSC.gradient(device="cpu")`` and the eager
twin's per-photon records at 2**20, saved to FILE (``torch.save``).
"""
import atexit
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

N_CHECK = 1 << 20
N_MAIN = 1 << 27
N_CHUNK = 1 << 20
N_LOG = 1 << 14
N_LOG_FULL = 1 << 17
N_SLAB = 1 << 24
N_OPT = 400_000
N_HOST = 1 << 24
N_BUDGET = 1 << 16
N_BUNDLE = 1 << 24
N_SMALL_STREAM, SMALL_BUNDLE = 1 << 22, 50000
N_LSC_LOG = 1 << 16
N_LSC_MESH = 1 << 23  # one bundle of LSC.gradient's 16,000,000
N_F64_SCORE, N_F64_PATH = 1 << 16, 1 << 14
RANKS = 2
# Phase 31's parameters of LSC.gradient and the kernel each runs.
LSC_PARAMS = (("concentration", "pvt_trace_score"), ("n", "pvt_trace_pathwise"))
# Phase 38: random scenes (0-19 as the CPU tests, 20-31 on the card only),
# the seeds of its event-log and score checks, and lsc_tiles' node counts.
RANDOM_SEEDS = tuple(range(32))
RANDOM_LOG_SEEDS = (1, 3, 10, 22)
RANDOM_SCORE_SEEDS = (0, 7, 15, 20)
N_RANDOM, N_RANDOM_F64 = 1 << 18, 1 << 16
TILES = (8, 16, 32, 64)
N_TILES = 1 << 24
SOURCE = {name: "pvtrace_tpu_torch/kernels/csrc/tracer.cu" for name in (
    "pvt_emit", "pvt_step", "pvt_trace", "pvt_cheb", "pvt_tally", "pvt_mesh", "pvt_trace_log")}
SOURCE.update({name: "pvtrace_tpu_torch/kernels/csrc/score.cu"
               for name in ("pvt_score", "pvt_fresnel", "pvt_trace_score")})
SOURCE.update({name: "pvtrace_tpu_torch/kernels/csrc/pathwise.cu"
               for name in ("pvt_pathwise", "pvt_trace_pathwise")})
SOURCE.update({name: "pvtrace_tpu_torch/kernels/csrc/diff.cu"
               for name in ("pvt_absorbed", "pvt_absorbed_grad")})
SOURCE["pvt_trace_bundle"] = "pvtrace_tpu_torch/kernels/csrc/tracer.cu"
SOURCE["pvt_draws"] = "pvtrace_tpu_torch/kernels/csrc/tracer.cu"
SOURCE["pvt_log_pack"] = "pvtrace_tpu_torch/kernels/csrc/tracer.cu"
SOURCE["all_reduce_tallies"] = "pvtrace_tpu_torch/parallel/shard.py"
REPLACES = {
    "pvt_emit": "pvtrace_tpu/engine/tracer.py:762",
    "pvt_step": "pvtrace_tpu/engine/tracer.py:1073",
    "pvt_trace": "pvtrace_tpu/engine/tracer.py:953",
    "pvt_cheb": "pvtrace_tpu/engine/tracer.py:128",
    "pvt_tally": "pvtrace_tpu/engine/tracer.py:588",
    "pvt_mesh": "pvtrace_tpu/engine/tracer.py:366",
    "pvt_trace_log": "pvtrace_tpu/engine/tracer.py:512",
    "pvt_score": "pvtrace_tpu/engine/tracer.py:1871",
    "pvt_fresnel": "pvtrace_tpu/engine/tracer.py:172",
    "pvt_trace_score": "pvtrace_tpu/engine/tracer.py:1991",
    "pvt_pathwise": "pvtrace_tpu/engine/tracer.py:1746",
    "pvt_trace_pathwise": "pvtrace_tpu/engine/tracer.py:1918",
    "pvt_absorbed": "pvtrace_tpu/diff/transport.py:214",
    "pvt_absorbed_grad": "pvtrace_tpu/diff/transport.py:284",
    "pvt_trace_bundle": "pvtrace_tpu/engine/tracer.py:936",
    "pvt_draws": "pvtrace_tpu/engine/tracer.py:100",
    "pvt_log_pack": "pvtrace_tpu/engine/api.py:560",
    "all_reduce_tallies": "pvtrace_tpu/parallel/shard.py:48",
}
# The rows whose device code runs inside the trace kernels' loop
# (``tracer.cuh``: photon_start, photon_step), their own wrappers being
# launched only by their checks: the kernels whose loop runs it, and the
# scene-tensor meta entry that must be non-zero for it to run.
INSIDE = {
    "pvt_emit": (("pvt_trace",), None),
    "pvt_draws": (("pvt_trace",), None),
    "pvt_step": (("pvt_trace",), None),
    "pvt_cheb": (("pvt_trace",), "cheb_n_fits"),
    "pvt_tally": (("pvt_trace",), "n_rec"),
    "pvt_mesh": (("pvt_trace",), "n_tris"),
    "pvt_score": (("pvt_trace_score", "pvt_trace_pathwise"), None),
    "pvt_fresnel": (("pvt_trace_score", "pvt_trace_pathwise"), None),
    "pvt_pathwise": (("pvt_trace_pathwise",), None),
}
# What each entry point above simulate launched in phases 26 and 28-34
# (the counts read around its call) and its scene's meta, by label; the
# kernels line's reached_from is read from these.
ENTRY_RUNS = {}


def entry_run(label, launched, compiled):
    """Record what the entry point `label` launched on `compiled`."""
    from pvtrace_tpu_torch.engine import scene_tensors

    ENTRY_RUNS[label] = ({k: int(v) for k, v in launched.items()},
                         scene_tensors(compiled, device="cpu")["meta"])


def reached_from(name):
    """The entry points whose run launched `name`, or a trace kernel whose
    loop runs its device code on a scene that needs it (``INSIDE``)."""
    kernels_of, need = INSIDE.get(name, ((), None))
    out = []
    for label, (launched, meta) in ENTRY_RUNS.items():
        via = [k for k in kernels_of if launched.get(k, 0) > 0]
        if launched.get(name, 0) > 0:
            out.append(label)
        elif via and (need is None or meta.get(need, 0) > 0):
            out.append(f"{label} (inside {', '.join(via)})")
    return out


# Fate slots of the LSC slab's photons: NONRADIATIVE, EXIT, KILL.
LSC_FATES = (4, 7, 9)
PATHWISE = [("n", "lsc"), ("size", "lsc", 2)]
# LSC.gradient's solar cells, and its recorders' order: the four cells
# (sorted), then the incident row.
LSC_CELLS = ("far", "left", "near", "right")


def oblique_analytic(n, theta0, alpha, L):
    """P(absorb) and dP/dn of the tilted Fresnel slab: multiple internal
    reflections at one angle (the JAX package's tests/test_diff.py)."""
    import numpy as np

    s, c1 = np.sin(theta0), np.cos(theta0)

    def P(n):
        st = s / n
        ct = np.sqrt(1 - st * st)
        rs = ((c1 - n * ct) / (c1 + n * ct)) ** 2
        rp = ((ct - n * c1) / (ct + n * c1)) ** 2
        R = 0.5 * (rs + rp)
        T = np.exp(-alpha * L / ct)
        return (1 - R) * (1 - T) / (1 - R * T)

    h = 1e-6
    return P(n), (P(n + h) - P(n - h)) / (2 * h)


def fail(message):
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def lsc_with_cells():
    """The LSC device API's default 5x5x1 plate with solar cells on its
    four edges."""
    from pvtrace_tpu_torch.device.lsc import LSC

    lsc = LSC((5.0, 5.0, 1.0))
    lsc.add_solar_cell(LSC_CELLS)
    return lsc


def lsc_gradient(wrt, n, seed, **kwargs):
    """``LSC.gradient`` of ``lsc_with_cells()``: (its result, the recorder
    totals of its engine runs as ``rec_distinct`` and ``rec_scores``, host
    seconds, and the compiled scene with its recorders and the resolved
    pathwise specs those runs were given)."""
    lsc = lsc_with_cells()
    tic = time.perf_counter()
    out = lsc.gradient(n=n, seed=seed, wrt=wrt, **kwargs)
    seconds = time.perf_counter() - tic
    run = lsc._last_gradient
    return (out, {"rec_distinct": run["distinct"], "rec_scores": run["scores"]}, seconds,
            run["compiled"], run["pathwise"])


def lsc_twins_main(out):
    """Phase 31's CPU side, a process of its own (``python3 chip_smoke.py
    --lsc-twins OUT``) that runs beside phases 36-38: for each parameter
    of LSC_PARAMS, ``LSC.gradient(device="cpu")`` at N_CHECK and the eager
    twin's trace of the same photons keeping each photon's score record
    (``per_photon``; lanes as the CPU ``simulate`` takes them), saved to
    `out`. It uses six of the host's cores, at a lower priority than the
    script's own process."""
    import torch

    from pvtrace_tpu_torch.engine import rng, scene_tensors, tracer

    os.nice(10)
    torch.set_num_threads(6)
    runs = {}
    for wrt, _ in LSC_PARAMS:
        twin_g = lsc_gradient(wrt, N_CHECK, 32, device="cpu")
        tic = time.perf_counter()
        _, _, cpu_t, _ = tracer.trace_eager(
            scene_tensors(twin_g[3], dtype=torch.float32, device="cpu"), rng.key_words(32),
            N_CHECK, lanes=1 << 18, score=True, per_photon=True, pathwise=twin_g[4])
        cpu_t.pop("seen")
        runs[wrt] = {"result": twin_g[:3], "tallies": cpu_t,
                     "records_s": time.perf_counter() - tic}
    torch.save(runs, out)


def start_lsc_twins():
    """Start ``lsc_twins_main`` in a child process: (the process, its
    output file, its log file)."""
    tmp = tempfile.mkdtemp()
    out, log = os.path.join(tmp, "lsc_twins.pt"), open(os.path.join(tmp, "lsc_twins.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--lsc-twins", out],
                            stdout=log, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)  # a failure before finish_lsc_twins ends it too
    return proc, out, log


def finish_lsc_twins(twins):
    """Wait for ``start_lsc_twins``' process and load what it saved; the
    process is killed if it has not ended (a failure here included)."""
    import torch

    proc, out, log = twins
    try:
        code = proc.wait(timeout=900)
    finally:
        proc.kill()
        log.close()
    if code != 0:
        with open(log.name) as fh:
            fail(f"phase 31's CPU twins exited {code}: {fh.read()[-3000:]}")
    runs = torch.load(out, weights_only=False)
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    return runs


def lsc_channel(result):
    """The score channel of an ``LSC.gradient`` result: the luminophore's
    (the first component) or, for wrt="n", the one pathwise channel, the
    last."""
    return -1 if result["component"] == "n" else 0


def share_of_bound(off, allow):
    """The largest share of its bound an entry took (an entry whose bound
    is 0 must be 0 itself and counts as 0)."""
    import numpy as np

    off, allow = np.asarray(off, dtype=np.float64), np.asarray(allow, dtype=np.float64)
    return float(np.max(np.where(allow > 0, off / np.where(allow > 0, allow, 1.0),
                                 np.where(off > 0, np.inf, 0.0)), initial=0.0))


def lsc_gradient_bound(n, got, ref, allow):
    """How far ``LSC.gradient``'s (d(A/I), A/I) may lie from another run's
    of the same n photons: `got` and `ref` are (result, data) of the two,
    `allow` [5] the bound of each recorder's score sum in the gradient's
    channel (the four cells, then the incident row). The gradient (dC * I
    - C * dI) / I**2 is carried to first order through the score sums'
    bounds and the distinct counts' observed differences."""
    import numpy as np

    d_got = np.asarray(got[1]["rec_distinct"], dtype=np.float64)
    d_ref = np.asarray(ref[1]["rec_distinct"], dtype=np.float64)
    dd = np.abs(d_got - d_ref) / n
    C, I = d_ref[:4].sum() / n, d_ref[4] / n
    scores = np.asarray(ref[1]["rec_scores"], dtype=np.float64)[:, lsc_channel(ref[0])]
    dC, dI = scores[:4].sum() / n, scores[4] / n
    return (allow[:4].sum() / n / I + C * allow[4] / n / I ** 2 + abs(dI) * dd[:4].sum() / I ** 2
            + (abs(dC) / I ** 2 + 2 * C * abs(dI) / I ** 3) * dd[4])


def shard_runs(mesh):
    """Phase 26's sharded runs on `mesh` (this process's rank of it), on
    the card: shard_simulate of the slab with 4 recorders at N_MAIN with
    score channels, fate_gradients(mesh=) of the slab at N_SLAB, and one
    make_training_step step on N_SLAB photons of the slab's lamp (this
    rank's slice). Returns them JSON-ready, with the all-reduces' cost."""
    import numpy as np
    import torch

    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.diff import transport
    from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors
    from pvtrace_tpu_torch.kernels import check
    from pvtrace_tpu_torch.parallel import shard, shard_simulate
    from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_recorders

    shard.reduce_stats.update(calls=0, bytes=0)
    kernels.reset()
    rec4 = lsc_slab_recorders(4)
    data = shard_simulate(rec4, N_MAIN, mesh, seed=26, compiled=compile_scene(rec4), score=True)
    reduce = dict(shard.reduce_stats)
    score_launches = kernels.launches["pvt_trace_score"]
    fractions, gradients = transport.fate_gradients(lsc_slab(), N_SLAB, seed=27, wrt="all",
                                                    mesh=mesh, dtype=np.float32)
    slab = compile_scene(lsc_slab())
    st = scene_tensors(slab, dtype=torch.float32, device=mesh.device)
    pos, direction, wav = check.absorbed_photons(st, rng.key_words(19), N_SLAB)
    rows = slice(mesh.rank * N_SLAB // mesh.size, (mesh.rank + 1) * N_SLAB // mesh.size)
    step = transport.make_training_step(slab, mesh)
    params = {"log_concentration": torch.zeros((), device=mesh.device)}
    new, loss = step(params, pos[rows].contiguous(), direction[rows].contiguous(),
                     wav[rows].contiguous())
    # The all-reduce alone, on the score run's tallies (on the card): one call
    # first (NCCL makes its communicator at the first), a barrier, then 50
    # calls on the host clock, each ending in a read of the steps.
    names = {"fates": "fates", "distinct": "rec_distinct", "cross": "rec_crossings",
             "bins": "rec_bins", "sums": "rec_sums", "fate_scores": "fate_scores",
             "rec_scores": "rec_scores"}
    tallies = {k: torch.as_tensor(data[v], device=mesh.device) for k, v in names.items()}
    shard._all_reduce_tallies(mesh, tallies, 0)
    torch.distributed.barrier(group=mesh.group)
    shard.reduce_stats.update(calls=0, bytes=0)
    tic = time.perf_counter()
    for _ in range(50):
        shard._all_reduce_tallies(mesh, tallies, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    steady = dict(shard.reduce_stats)
    return {
        "rank": mesh.rank, "size": mesh.size,
        "score_run": {k: (np.asarray(v).tolist() if k != "steps" else v) for k, v in data.items()},
        "score_launches": score_launches, "reduce": reduce,
        "reduce_ms": seconds / steady["calls"] * 1e3,
        "reduce_bytes": steady["bytes"] / steady["calls"],
        "fractions": {e.name: float(v) for e, v in fractions.items()},
        "gradients": {e.name: np.asarray(g).tolist() for e, g in gradients.items()},
        "train": [float(loss), float(new["log_concentration"])],
    }


def rank_main(rank, world, port, out_path):
    """One rank of phase 26's gloo world on the card."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    from pvtrace_tpu_torch.parallel import init_distributed, make_photon_mesh, shutdown_distributed

    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                     rank=rank, device="cuda")
    try:
        out = shard_runs(make_photon_mesh(device="cuda"))
    finally:
        shutdown_distributed()
    with open(out_path, "w") as fh:
        json.dump(out, fh)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


N_CLI = 100_000  # the README's budget for the CLI
N_CLI_CHECK = 1 << 12
N_WATCH = 1 << 16
N_STUDIO, STUDIO_BUNDLE = 1 << 24, 1 << 22
N_PROFILE = 1 << 20
HERE = os.path.dirname(os.path.abspath(__file__))
LSC_YML = os.path.join(HERE, "tests", "data", "lsc.yml")
STUDIO_YML = os.path.join(HERE, "tests", "data", "lsc_scene_studio.yml")


@contextlib.contextmanager
def cli_clocks(cli):
    """Host clocks of the CLI's ``simulate`` runs inside the block, taken
    from outside the command: the seconds its loop waits on
    ``simulate_stream``'s bundles, spends in ``EngineResult.histories()``,
    and spends in SQLite (``write_history`` and the connection's commits).
    Yields the dict, filled as the runs go."""
    from unittest import mock

    from pvtrace_tpu_torch import engine
    from pvtrace_tpu_torch.engine.result import EngineResult

    clocks = {"stream_s": 0.0, "histories_s": 0.0, "sqlite_s": 0.0}

    def timed_items(items, clock):
        items = iter(items)
        while True:
            tic = time.perf_counter()
            try:
                item = next(items)
            except StopIteration:
                return
            finally:
                clocks[clock] += time.perf_counter() - tic
            yield item

    def timed(fn, clock):
        def call(*args, **kwargs):
            tic = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                clocks[clock] += time.perf_counter() - tic
        return call

    class Connection:
        def __init__(self, connection):
            self._connection = connection
            self.commit = timed(connection.commit, "sqlite_s")

        def __getattr__(self, name):
            return getattr(self._connection, name)

    stream, histories = engine.simulate_stream, EngineResult.histories
    prepare = cli.prepare_database
    with mock.patch.object(engine, "simulate_stream",
                           lambda *a, **k: timed_items(stream(*a, **k), "stream_s")), \
            mock.patch.object(EngineResult, "histories",
                              lambda self: timed_items(histories(self), "histories_s")), \
            mock.patch.object(cli, "write_history", timed(cli.write_history, "sqlite_s")), \
            mock.patch.object(cli, "prepare_database", lambda path: Connection(prepare(path))):
        yield clocks


def entry_point_phases(smi):
    """Phases 32-35 on the card: the CLI, ``simulate --watch``, the studio
    and the profiling utilities, through the entry points a user calls.
    Returns their reports."""
    import glob
    import sqlite3
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.cli import main as cli
    from pvtrace_tpu_torch.cli.parse import parse
    from pvtrace_tpu_torch.engine import compile_scene, simulate, simulate_stream, tracer
    from pvtrace_tpu_torch.kernels import check
    from pvtrace_tpu_torch.scenes import lsc_slab
    from pvtrace_tpu_torch.studio.client import (
        captured,
        recorder_ints,
        sse_messages,
        tally_ints,
        watch_run,
    )
    from pvtrace_tpu_torch.studio.server import create_server
    from pvtrace_tpu_torch.utils import device_memory_stats, trace_profile

    work = tempfile.mkdtemp()
    reports = {}

    def launched_through(launched, what, names=("pvt_trace_log", "pvt_log_pack")):
        if any(launched[k] == 0 for k in names) or tracer.eager_runs:
            fail(f"{what} did not run through {', '.join(names)}: launches {launched}, eager "
                 f"runs {tracer.eager_runs}")

    def cli_simulate(n, db, *extra):
        """The CLI's simulate of lsc.yml at seed 3 into `db`: (seconds,
        launches, the trace kernels' summed ms, the host clocks)."""
        kernels.reset()
        tracer.eager_runs = 0
        with cli_clocks(cli) as clocks:
            tic = time.perf_counter()
            rc, said = captured(cli.app, ["simulate", LSC_YML, "-n", str(n), "--seed", "3",
                                          "--database", db, *extra])
            wall = time.perf_counter() - tic
        if rc != 0 or f"Wrote {n} ray histories" not in said:
            fail(f"simulate -n {n}: rc {rc}, {said!r}")
        return wall, dict(kernels.launches), kernels.launch_ms["pvt_trace"], clocks

    # 32. the CLI at the README's budget, its queries, and at N_CLI_CHECK
    # against --device cpu photon by photon
    scene = parse(LSC_YML)
    compiled = compile_scene(scene)
    db = os.path.join(work, "lsc.sqlite3")
    wall, launched, kernel_ms, host = cli_simulate(N_CLI, db)
    launched_through(launched, "the CLI's simulate")
    entry_run("CLI simulate", launched, compiled)
    with contextlib.closing(sqlite3.connect(db)) as connection:
        rays = connection.execute("SELECT COUNT(DISTINCT throw_id) FROM ray").fetchone()[0]
        kinds = dict(connection.execute("SELECT kind, COUNT(*) FROM event GROUP BY kind"))
    if rays != N_CLI:
        fail(f"simulate -n {N_CLI}: {rays} rays in the database")
    queries = {}
    for command in ("count", "spectrum", "time"):
        tic = time.perf_counter()
        rc, said = captured(cli.app, [command, db, "lsc", "escaping"]
                            + ([] if command == "count" else ["--output", "json"]))
        seconds = time.perf_counter() - tic
        values = [int(said)] if command == "count" else json.loads(said)
        if rc != 0 or not values:
            fail(f"{command} {db} lsc escaping: rc {rc}, {said[:200]!r}")
        queries[command] = {"s": seconds, "rows": len(values),
                            "mean": float(np.mean(values))}
    if not queries["spectrum"]["rows"] >= queries["count"]["mean"] > 0 \
            or queries["time"]["rows"] < queries["count"]["mean"]:
        fail(f"the queries disagree: {queries}")
    small = {}
    for label, extra in (("card", ()), ("cpu", ("--device", "cpu"))):
        small[label] = os.path.join(work, f"{label}.sqlite3")
        cli_simulate(N_CLI_CHECK, small[label], *extra)
    parted = check.compare_databases(small["card"], small["cpu"])
    if parted["parted"] > check.LOG_DIVERGED * N_CLI_CHECK \
            or parted["max_rel_err"] > check.LOG_RTOL:
        fail(f"the CLI on the card against --device cpu at {N_CLI_CHECK}: {parted}")
    rest_s = wall - host["stream_s"] - host["histories_s"] - host["sqlite_s"]
    reports["cli"] = {"n": N_CLI, "wall_s": wall, "kernel_ms": kernel_ms,
                      "pack_launches": launched["pvt_log_pack"],
                      "trace_launches": launched["pvt_trace_log"], **host, "rest_s": rest_s,
                      "rays": rays, "events": kinds, "queries": queries,
                      "check": {"n": N_CLI_CHECK, **parted}}
    shown = {k: (v["rows"], float(f"{v['mean']:.6g}"), round(v["s"], 4))
             for k, v in queries.items()}
    print(
        f"phase 32 CLI simulate lsc.yml -n {N_CLI} --seed 3: {wall:.4f} s wall, "
        f"pvt_trace_log {launched['pvt_trace_log']} launches ({kernel_ms:.2f} ms), "
        f"pvt_log_pack {launched['pvt_log_pack']}; waits on the stream {host['stream_s']:.4f} s, "
        f"histories() {host['histories_s']:.4f} s, SQLite {host['sqlite_s']:.4f} s, the rest "
        f"{rest_s:.4f} s; {rays} rays written, events {kinds}; count/spectrum/time of lsc "
        f"escaping {shown} (rows, mean, s); at {N_CLI_CHECK} against --device cpu: "
        f"{parted['parted']} photons parted (limit {check.LOG_DIVERGED * N_CLI_CHECK:g}), "
        f"the others' floats within "
        f"{parted['max_rel_err']:.3g} of their column's scale (limit {check.LOG_RTOL}) | {smi}",
        flush=True,
    )

    # 33. simulate --watch: a viewer on the watch server, its last bundle
    # against one simulate of the seed
    kernels.reset()
    tracer.eager_runs = 0
    tic = time.perf_counter()
    rc, said, messages = watch_run(cli.app, [
        "simulate", LSC_YML, "-n", str(N_WATCH), "--seed", "3", "--database",
        os.path.join(work, "watch.sqlite3"), "--watch", "--no-browser", "--port", "0"])
    wall = time.perf_counter() - tic
    launched = dict(kernels.launches)
    launched_through(launched, "simulate --watch")
    entry_run("CLI simulate --watch", launched, compiled)
    kinds = [m["type"] for m in messages]
    bundles = -(-N_WATCH // 50000)
    if rc != 0 or kinds != ["started"] + ["bundle"] * bundles + ["done"]:
        fail(f"simulate --watch: rc {rc}, messages {kinds}")
    one = simulate(scene, N_WATCH, seed=3, record_every=1, compiled=compiled)
    want = tally_ints(compiled, one.data["rec_distinct"], one.data["rec_crossings"],
                      one.data["rec_bins"])
    if recorder_ints(messages[-2]["recorders"]) != want:
        fail("simulate --watch: the last bundle's recorders differ from one simulate's")
    reports["watch"] = {"n": N_WATCH, "wall_s": wall, "messages": len(messages),
                        "rays_per_second": messages[-2]["rays_per_second"],
                        "paths": sum(len(m["paths"]) for m in messages[1:-1])}
    print(
        f"phase 33 simulate --watch -n {N_WATCH}: {wall:.4f} s, a viewer read {kinds}; the last "
        f"bundle's recorders ({sum(v[0] for v in want.values())} rays over "
        f"{len(want)} recorders) equal one simulate's integer for integer; "
        f"{reports['watch']['paths']} paths, rays/s as sent "
        f"{messages[-2]['rays_per_second']:.6g}; launches pvt_trace_log "
        f"{launched['pvt_trace_log']}, pvt_log_pack {launched['pvt_log_pack']} | {smi}",
        flush=True,
    )

    # 34. the studio: a document, /api/run at its defaults and at N_STUDIO,
    # a second run refused while one goes. The launches and the kernel ms
    # are read as the run's stream ends, before the reference runs.
    httpd = create_server(port=0)
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        with open(STUDIO_YML) as fh:
            body = json.dumps({"text": fh.read()}).encode()
        put = urllib.request.Request(base + "/api/document", data=body, method="PUT",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(put) as response:
            if response.status != 200 or not json.loads(response.read())["scene"]["nodes"]:
                fail("PUT /api/document did not apply the document")
        studio_scene = httpd.studio.scene
        studio_compiled = compile_scene(studio_scene)
        studio_runs = {}
        for label, query, n, bundle, seed in (
                ("defaults", "seed=34", 100_000, 25_000, 34),
                (f"{N_STUDIO}", f"rays={N_STUDIO}&bundle={STUDIO_BUNDLE}&seed=35", N_STUDIO,
                 STUDIO_BUNDLE, 35)):
            kernels.reset()
            tracer.eager_runs = 0
            started, refused = threading.Event(), []
            got = []
            tic = time.perf_counter()
            reader = threading.Thread(target=lambda: got.extend(
                sse_messages(f"{base}/api/run?{query}", started)))
            reader.start()
            if label != "defaults":
                if not started.wait(600):
                    fail("/api/run sent nothing")
                try:
                    urllib.request.urlopen(f"{base}/api/run?rays=10", timeout=60)
                    refused.append(200)
                except urllib.error.HTTPError as error:
                    refused.append(error.code)
            reader.join(timeout=600)
            client_s = time.perf_counter() - tic
            launched = dict(kernels.launches)
            kernel_ms = kernels.launch_ms["pvt_trace"]
            kinds = [m["type"] for m in got]
            if kinds != ["started"] + ["bundle"] * -(-n // bundle) + ["done"]:
                fail(f"/api/run?{query}: messages {kinds}")
            if refused and refused != [409]:
                fail(f"a second /api/run while one streamed got {refused}, not 409")
            launched_through(launched, f"/api/run?{query}")
            if label == "defaults":
                entry_run("studio /api/run", launched, studio_compiled)
            totals = [np.zeros(k, np.int64) for k in (studio_compiled.n_recorders,) * 2
                      + (int(studio_compiled.total_bins),)]
            for result, _ in simulate_stream(studio_scene, n, bundle=bundle, seed=seed,
                                             record_every=1000, compiled=studio_compiled):
                for total, key in zip(totals, ("rec_distinct", "rec_crossings", "rec_bins")):
                    total += result.data[key]
            paths = sum(len(m["paths"]) for m in got[1:-1])
            if recorder_ints(got[-2]["recorders"]) != tally_ints(studio_compiled, *totals) \
                    or not paths:
                fail(f"/api/run?{query}: the recorders differ from a summed simulate_stream's, "
                     f"or no paths ({paths})")
            studio_runs[label] = {
                "n": n, "bundle": bundle, "client_s": client_s, "rays_per_second_client":
                n / client_s, "rays_per_second_server": got[-2]["rays_per_second"],
                "server_elapsed_s": got[-1]["elapsed"], "kernel_ms": kernel_ms,
                "launches": {k: launched[k] for k in ("pvt_trace_log", "pvt_log_pack")},
                "paths": paths, "second_run": refused[0] if refused else None}
    finally:
        httpd.shutdown()
        httpd.server_close()
        serving.join(timeout=30)
    reports["studio"] = studio_runs
    for label, run in studio_runs.items():
        print(
            f"phase 34 studio /api/run ({label}: {run['n']} rays, bundle {run['bundle']}, "
            f"record_every 1000): recorders equal a summed simulate_stream's integer for "
            f"integer, {run['paths']} paths; rays/s as the server sends "
            f"{run['rays_per_second_server']:.6g}, on the client's clock "
            f"{run['rays_per_second_client']:.6g} ({run['client_s']:.4f} s); "
            f"launches {run['launches']} ({run['kernel_ms']:.2f} ms)"
            + (f"; a second /api/run meanwhile: {run['second_run']}" if run["second_run"] else "")
            + f" | {smi}",
            flush=True,
        )

    # 35. trace_profile around one simulate of the slab; device memory
    slab = lsc_slab()
    slab_compiled = compile_scene(slab)
    simulate(slab, N_PROFILE, seed=35, record_every=0, compiled=slab_compiled)
    torch.cuda.reset_peak_memory_stats()
    before = device_memory_stats()
    profile_dir = os.path.join(work, "profile")
    kernels.reset()
    with trace_profile(profile_dir):
        simulate(slab, N_PROFILE, seed=35, record_every=0, compiled=slab_compiled)
    after = device_memory_stats()
    files = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"trace_profile wrote {files}")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    on_card = [e for e in events if e.get("cat") == "kernel"]
    traced = sorted({e["name"] for e in on_card if "trace_kernel" in e["name"]})
    if not traced:
        fail(f"trace_profile's trace names no trace_kernel instantiation (CUPTI saw "
             f"{sorted({e['name'] for e in on_card})[:10]})")
    trace_us = sum(e.get("dur", 0) for e in on_card if "trace_kernel" in e["name"])
    reports["profile"] = {"n": N_PROFILE, "trace_bytes": os.path.getsize(files[0]),
                          "kernel_events": len(on_card), "trace_kernel": traced,
                          "trace_kernel_us": trace_us, "events_ms": kernels.launch_ms["pvt_trace"],
                          "memory_before": before, "memory_after": after}
    print(
        f"phase 35 trace_profile(simulate(slab, {N_PROFILE})): {os.path.getsize(files[0])} bytes "
        f"of trace, {len(on_card)} kernel events, {traced} for {trace_us / 1e3:.3f} ms (CUDA "
        f"events: {kernels.launch_ms['pvt_trace']:.3f} ms); device_memory_stats before "
        f"{before}, after {after} | {smi}",
        flush=True,
    )
    shutil.rmtree(work, ignore_errors=True)
    return reports


def float64_phases(smi, f32_rates):
    """Phase 36 on the card: the float64 build (``tracer_f64``) against the
    float64 twin, entry by entry, then ``simulate(dtype=np.float64)`` at
    full width through the main, recorder, mesh, history and host-emission
    paths, and a float64 stream against one ``simulate``. `f32_rates` are
    phase 5's, 11's, 15's
    and 25's float32 photons/s by path. Returns (the kernels line's rows of
    the float64 entries, a summary)."""
    import numpy as np
    import torch

    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.engine import api, compile_scene, rng, scene_tensors, simulate
    from pvtrace_tpu_torch.engine import simulate_stream, tracer
    from pvtrace_tpu_torch.engine.emit import emit_bundle
    from pvtrace_tpu_torch.kernels import check
    from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_host, lsc_slab_recorders, mesh_lsc

    tic = time.perf_counter()
    F64 = torch.float64
    seed = rng.key_words(36)
    tol = check.F64_PARTED

    def tensors(scene):
        return scene_tensors(compile_scene(scene), dtype=F64, device="cuda")

    # The float64 entries against the float64 twin on the card.
    st = tensors(lsc_slab())
    state, emit_rep = check.check_emit(st, seed, N_CHECK)
    step_rep = check.check_step(st, state, steps=8)
    cheb_rep = check.check_cheb(st)
    cheb_dev = check.check_cheb(st, shared=False)
    draws_rep = check.check_draws("cuda", N_CHECK, seed=36, dtype=F64)
    st32, st256 = tensors(lsc_slab_recorders(32)), tensors(lsc_slab_recorders(256))
    tally_rep = check.check_tally(st32, tracer.initial_state(st32, seed, torch.arange(
        N_CHECK, device="cuda")))
    tally256 = check.check_tally(st256, tracer.initial_state(st256, seed, torch.arange(
        N_CHECK, device="cuda")))
    mesh_scene = mesh_lsc()
    st_mesh = tensors(mesh_scene)
    mesh_rep = check.check_mesh(st_mesh, 1, N_CHECK, seed=36)
    traces = {label: check.check_trace(st_t, seed, N_CHECK) for label, st_t in (
        ("slab", st), ("slab R=32", st32), ("slab R=256", st256), ("mesh LSC", st_mesh))}
    for label, rep in traces.items():
        if rep["max_abs_err"] > tol or rep["tally_max_diff"] > tol:
            fail(f"phase 36 {label}: fates or tallies off by more than {tol}")
    host_scene = lsc_slab_host(n_rec=4)
    st_host = scene_tensors(compile_scene(host_scene), dtype=F64, device="cuda")
    np.random.seed(36)
    bundle = torch.from_numpy(tracer.bundle_rows(*emit_bundle(host_scene, N_CHECK)[:3],
                                                 np.float64)).cuda()
    bundle_rep = check.check_trace(st_host, seed, N_CHECK, bundle=bundle)
    log_rep = check.check_log(st_mesh, seed, N_LOG)
    fetch_rep = check.check_fetch(mesh_scene, N_LOG, seed=36, dtype=np.float64)
    if kernels.last_trace["library"] != "tracer_f64":
        fail(f"phase 36: the float64 runs did not launch tracer_f64: {kernels.last_trace}")
    print(
        f"phase 36 float64 entries vs the float64 twin: pvt_emit max abs err "
        f"{emit_rep['max_abs_err']:.3g}, kernel {emit_rep['ms']:.4f} ms (bound "
        f"{emit_rep['bound_ms']:.4f}); pvt_step discrete mismatch {step_rep['discrete_frac']:.2e}, "
        f"max abs err {step_rep['max_abs_err']:.3g}, {step_rep['ms']:.4f} ms (bound "
        f"{step_rep['bound_ms']:.4f}); pvt_cheb max rel err {cheb_rep['max_rel_err']:.3g} "
        f"(limit {check.CHEB_RTOL_F64}), {cheb_rep['ms']:.5f} ms shared, {cheb_dev['ms']:.5f} "
        f"device; pvt_draws bit for bit, {draws_rep['ms']:.4f} ms; pvt_tally R=32 sums within "
        f"{tally_rep['max_rel_err']:.3g}, {tally_rep['ms']:.4f} ms, R=256 {tally256['ms']:.4f} "
        f"ms; pvt_mesh t within {mesh_rep['max_rel_err']:.3g} (limit {check.MESH_RTOL_F64}), "
        f"counts differ on {mesh_rep['count_diffs']} rays, {mesh_rep['ms']:.4f} ms | {smi}",
        flush=True)
    for label, rep in list(traces.items()) + [("host-lit slab bundle", bundle_rep)]:
        print(
            f"phase 36 float64 pvt_trace vs twin, {label}: {N_CHECK} photons, fates "
            f"{rep['fates']} vs {rep['twin_fates']}, max diff {rep['max_abs_err']}, tallies max "
            f"diff {rep['tally_max_diff']} (limit {tol}), sums at "
            f"{rep.get('sums_used', 0.0):.3g} of their bound; kernel {rep['ms']:.4f} ms, "
            f"twin {rep['plain_ms']:.2f} ms, bound {rep['bound_ms']:.4f} ms "
            f"({rep['bound_by']}), lane efficiency {rep['lane_efficiency']:.4f} | {smi}",
            flush=True)
    print(
        f"phase 36 float64 event log vs twin, mesh LSC, {N_LOG} photons: {log_rep['diverged']} "
        f"parted (limit {tol}), floats within {log_rep['max_rel_err']:.3g} of their scale, "
        f"{log_rep['records']} records; pvt_log_pack bit-equal, {log_rep['pack']['ms']:.4f} ms, "
        f"mask gathers {log_rep['pack']['library_ms']:.4f} ms; simulate's dense float64 log "
        f"against the CPU twin's: {fetch_rep['diverged']} parted | {smi}", flush=True)

    # Full width, each run's launches read around it alone.
    def drive(label, scene, n, record_every=0, want=("pvt_trace",)):
        compiled = compile_scene(scene)
        kernels.reset()
        tracer.eager_runs = 0
        res = simulate(scene, n, seed=36, record_every=record_every, dtype=np.float64,
                       compiled=compiled)
        launched, launched64 = dict(kernels.launches), dict(kernels.launches_f64)
        fates = np.asarray(res.data["fates"])
        if int(fates.sum()) != n or tracer.eager_runs \
                or any(launched64[k] != 1 or launched[k] != 1 for k in want):
            fail(f"phase 36 {label}: fates {fates.tolist()}, launches {launched}, float64 "
                 f"launches {launched64}, eager runs {tracer.eager_runs}")
        if res.data["rec_sums"].dtype != np.float64 or (
                record_every and res.data["position"].dtype != np.float64):
            fail(f"phase 36 {label}: results not float64")
        run = {"n": n, "photons_per_s": n / res.elapsed, "elapsed_s": res.elapsed,
               "kernel_ms": kernels.last_trace["ms"], "threads": kernels.last_trace["threads"],
               "lane_efficiency": kernels.last_trace["lane_efficiency"],
               "shared_bytes": kernels.last_trace["shared_bytes"],
               "shared_cheb": kernels.last_trace["shared_cheb"], "launches_f64": launched64,
               "fates": fates.tolist()}
        if record_every:
            run["fetch"] = dict(api.last_fetch)
        print(
            f"phase 36 float64 {label}: simulate({n}, dtype=float64) {res.elapsed:.4f} s, "
            f"{run['photons_per_s']:.6g} photons/s (float32: {f32_rates[label]:.6g}, ratio "
            f"{f32_rates[label] / run['photons_per_s']:.3f}), pvt_trace {run['kernel_ms']:.2f} "
            f"ms, {run['threads']} threads, {run['shared_bytes']} shared bytes a block, lane "
            f"efficiency {run['lane_efficiency']:.4f}, fates {run['fates']}, float64 launches "
            f"{ {k: v for k, v in launched64.items() if v} } | {smi}", flush=True)
        return run

    full = {
        "main path": drive("main path", lsc_slab(), N_MAIN),
        "recorders R=32": drive("recorders R=32", lsc_slab_recorders(32), N_MAIN),
        "mesh": drive("mesh", mesh_scene, N_MAIN),
        "history": drive("history", mesh_scene, N_MAIN, 1000,
                         ("pvt_trace", "pvt_trace_log", "pvt_log_pack")),
        "host emission": drive("host emission", lsc_slab_host(), N_HOST,
                               want=("pvt_trace", "pvt_trace_bundle")),
    }

    # One float64 stream against one simulate, integer by integer.
    rec32 = lsc_slab_recorders(32)
    compiled32 = compile_scene(rec32)
    kernels.reset()
    tracer.eager_runs = 0
    union = None
    for res, _ in simulate_stream(rec32, N_CHECK, bundle=N_CHECK // 4, seed=36,
                                  record_every=0, dtype=np.float64, compiled=compiled32):
        part = {k: np.asarray(res.data[k]) for k in ("fates", "rec_distinct", "rec_crossings",
                                                     "rec_bins")}
        union = part if union is None else {k: union[k] + part[k] for k in union}
    stream_launches = kernels.launches_f64["pvt_trace"]
    one = simulate(rec32, N_CHECK, seed=36, record_every=0, dtype=np.float64,
                   compiled=compiled32).data
    if stream_launches != 4 or tracer.eager_runs or any(
            not np.array_equal(union[k], one[k]) for k in union):
        fail(f"phase 36: the float64 stream's union differs from one simulate (float64 "
             f"launches {stream_launches})")
    print(f"phase 36 float64 simulate_stream(slab R=32, {N_CHECK}, bundle={N_CHECK // 4}): "
          f"fates, distinct rays, crossings and bins equal one simulate's, integer by integer, "
          f"{stream_launches} float64 launches | {smi}", flush=True)

    print(f"phase 36 took {time.perf_counter() - tic:.1f} s | {smi}", flush=True)

    def inside(label):
        return [f"simulate(dtype=float64) (inside pvt_trace, {label})"]

    main_f64 = full["main path"]["launches_f64"]
    history = full["history"]["launches_f64"]
    host = full["host emission"]["launches_f64"]
    rows = [
        ("pvt_emit", emit_rep, main_f64["pvt_emit"], inside("main path"), {"n": N_CHECK}),
        ("pvt_step", step_rep, main_f64["pvt_step"], inside("main path"), {"n": N_CHECK}),
        ("pvt_cheb", cheb_rep, main_f64["pvt_cheb"], inside("main path"),
         {"device_memory_ms": cheb_dev["ms"], "n_fits": cheb_rep["n_fits"]}),
        ("pvt_draws", draws_rep, main_f64["pvt_draws"], inside("main path"), {"n": N_CHECK}),
        ("pvt_tally", tally_rep, full["recorders R=32"]["launches_f64"]["pvt_tally"],
         inside("recorders R=32"), {"n": N_CHECK, "recorders": 32, "R256_ms": tally256["ms"]}),
        ("pvt_mesh", mesh_rep, full["mesh"]["launches_f64"]["pvt_mesh"], inside("mesh"),
         {"n": N_CHECK, "triangles": mesh_rep["triangles"]}),
        ("pvt_trace", traces["slab"], main_f64["pvt_trace"],
         ["simulate(dtype=float64)", "simulate_stream(dtype=float64)"],
         {"n": N_CHECK, "full_width": full,
          **{k.replace(" ", "_"): {q: v[q] for q in ("ms", "plain_ms", "bound_ms", "fates")}
             for k, v in traces.items() if k != "slab"}}),
        ("pvt_trace_bundle", bundle_rep, host["pvt_trace_bundle"], ["simulate(dtype=float64)"],
         {"n": N_CHECK, "scene": "lsc_slab_host(n_rec=4)"}),
        ("pvt_trace_log", log_rep, history["pvt_trace_log"], ["simulate(dtype=float64)"],
         {"n": N_LOG, "record_every": 1, "diverged": log_rep["diverged"]}),
        ("pvt_log_pack", dict(log_rep["pack"], max_abs_err=0.0), history["pvt_log_pack"],
         ["simulate(dtype=float64)"],
         {"n": N_LOG, "library_ms": log_rep["pack"]["library_ms"],
          "library_is": "two boolean-mask gathers, ints[mask] and floats[mask]"}),
    ]
    return rows, {"seconds": time.perf_counter() - tic}


def float64_gradient_phases(smi, f32):
    """Phase 37 on the card: the float64 builds of K12, K13 and K15
    (``score_f64``, ``pathwise_f64``, ``diff_f64``) against the float64
    twin, entry by entry, then the float64 gradient paths at full width.
    `f32` holds the float32 photons/s of phases 18, 23, 29 and 31 by path.
    Returns (the kernels line's rows of the float64 gradient entries, a
    summary)."""
    import numpy as np
    import torch

    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.diff import transport
    from pvtrace_tpu_torch.engine import absorb, compile_scene, rng, scene_tensors, simulate
    from pvtrace_tpu_torch.engine import simulate_checkpointed, tracer
    from pvtrace_tpu_torch.kernels import check
    from pvtrace_tpu_torch.light.event import Event
    from pvtrace_tpu_torch.parallel import make_photon_mesh
    from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_recorders, mesh_lsc, mixed_scene

    tic = time.perf_counter()
    F64 = torch.float64
    seed = rng.key_words(37)
    scenes = {label: compile_scene(make()) for label, make in (
        ("slab", lsc_slab), ("slab R=32", lambda: lsc_slab_recorders(32)), ("mesh LSC", mesh_lsc),
        ("mixed", mixed_scene))}
    st = {label: scene_tensors(c, dtype=F64, device="cuda") for label, c in scenes.items()}

    # K12 and K13 lane by lane, K15 photon by photon.
    lanes, _ = check.check_emit(st["slab"], seed, N_CHECK, reps=1)
    score_rep = check.check_score(st["slab"], lanes, steps=8, reps=3)
    fresnel_rep = check.check_fresnel("cuda", reps=3, dtype=F64, n=N_CHECK)
    mixed_specs = transport.resolve_pathwise_params(scenes["mixed"], [
        ("n", "plate"), ("size", "plate", 2), ("radius", "rod"), ("length", "rod")])
    lanes_mixed, _ = check.check_emit(st["mixed"], seed, N_CHECK, reps=1)
    path_rep = check.check_pathwise(st["mixed"], lanes_mixed, mixed_specs, steps=8, reps=2)
    print(
        f"phase 37 float64 pvt_score vs twin, slab: {N_CHECK} lanes x 8 steps, discrete mismatch "
        f"{score_rep['discrete_frac']:.2e}, path scores at {score_rep['bound_used']:.3g} of their "
        f"bound ({check.F64_RTOL} of the channel's scale plus {check.F64_SLACK:g} of the "
        f"slack; {score_rep['grazing']} grazing lanes left out), folds within "
        f"{score_rep['fold_rel_err']:.3g} of their magnitudes, kernel {score_rep['ms']:.4f} ms, "
        f"twin {score_rep['plain_ms']:.4f}, bound {score_rep['bound_ms']:.5f}; pvt_fresnel "
        f"{fresnel_rep['points']} points, max err {fresnel_rep['max_abs_err']:.3g} (limit "
        f"{check.F64_RTOL}), kernel {fresnel_rep['ms']:.4f} ms, twin "
        f"{fresnel_rep['plain_ms']:.4f}; pvt_pathwise, mixed, channels {list(mixed_specs)}: "
        f"discrete mismatch {path_rep['discrete_frac']:.2e}, at {path_rep['bound_used']:.3g} of "
        f"the bound ({path_rep['left_out']} lane-steps left out, {path_rep['saturated']} "
        f"saturated; worst: {path_rep['worst_lane']}), kernel {path_rep['ms']:.4f} ms, twin "
        f"{path_rep['plain_ms']:.4f}, bound {path_rep['bound_ms']:.5f} | {smi}", flush=True)

    # The trace kernels photon by photon, the rows where trace_layout puts
    # them and forced into device memory.
    traces = {}
    for label, specs, n in (("slab", (), N_F64_SCORE), ("slab R=32", (), N_F64_SCORE),
                            ("mesh LSC", (), N_F64_SCORE), ("slab", PATHWISE, N_F64_PATH),
                            ("slab R=32", PATHWISE, N_F64_PATH),
                            ("mesh LSC", [("n", scenes["mesh LSC"].node_names[1])], N_F64_PATH)):
        resolved = transport.resolve_pathwise_params(scenes[label], specs)
        rep = check.check_trace_scores(st[label], seed, n, pathwise=resolved)
        want = "pathwise_f64" if resolved else "score_f64"
        if kernels.last_trace["library"] != want:
            fail(f"phase 37 {label}: launched {kernels.last_trace['library']}, not {want}")
        rep["rows"] = check.check_rows_placement(st[label], seed, n, rep["tallies"], resolved)
        key = f"{label}, pathwise" if resolved else label
        traces[key] = rep
        print(
            f"phase 37 float64 {'pvt_trace_pathwise' if resolved else 'pvt_trace_score'} vs "
            f"twin, {label}: {n} photons, channels {list(resolved)}, fates {rep['fates']} vs "
            f"{rep['twin_fates']}, {rep['parted']} parted, {rep['saturated']} saturated (limit "
            f"each {check.F64_PARTED}), the others' scores at {rep['record_used']:.3g} of "
            f"their bound, score sums at {rep['sums_used']:.3g} of theirs; kernel "
            f"{rep['ms']:.4f} ms, twin {rep['plain_ms']:.2f} ms, bound {rep['bound_ms']:.4f} ms; "
            f"rows {rep['rows']['placed']}, forced into device memory records bit-equal, kernel "
            f"ms in turns placed {rep['rows']['ms_placed']} / device "
            f"{rep['rows']['ms_device']} | {smi}", flush=True)

    tab = absorb.table(scenes["slab"], "cuda", F64)
    pos, direction, wav = check.absorbed_photons(st["slab"], seed, N_SLAB)
    absorbed_rep = check.check_absorbed(tab, pos, direction, wav)
    weight = transport.absorbed_fraction_fn(scenes["slab"])
    kernels.reset()
    sgd = check.surrogate_sgd(lambda lc, p, d, w: weight({"log_concentration": lc}, p, d, w),
                              pos, direction, wav)
    sgd_launches = dict(kernels.launches_f64)
    plain_sgd = check.surrogate_sgd(
        lambda lc, p, d, w: absorb.weight(torch.exp(lc), absorb.depth(tab, p, d, w)),
        pos, direction, wav)
    for k, (a, b) in enumerate(zip(sgd, plain_sgd)):
        if not np.allclose(a, b, rtol=check.F64_RTOL, atol=1e-15):
            fail(f"phase 37 float64 surrogate SGD step {k}: kernel {a} against plain {b}")
    if sgd_launches["pvt_absorbed"] != 5 or sgd_launches["pvt_absorbed_grad"] != 5:
        fail(f"phase 37 float64 surrogate SGD did not run through diff_f64: {sgd_launches}")
    step = transport.make_training_step(scenes["slab"], make_photon_mesh(device="cuda"))
    params = {"log_concentration": torch.zeros((), device="cuda", dtype=F64)}
    kernels.reset()
    for _ in range(2):
        params, loss = step(params, pos, direction, wav)
    train_launches = dict(kernels.launches_f64)
    if train_launches["pvt_absorbed"] != 2 or params["log_concentration"].dtype != F64 \
            or not torch.isfinite(loss):
        fail(f"phase 37 float64 make_training_step: launches {train_launches}, {params}")
    print(
        f"phase 37 float64 pvt_absorbed vs plain: {N_SLAB} photons, weights within "
        f"{absorbed_rep['max_rel_err']:.3g} (limit {check.F64_RTOL}), gradient within "
        f"{absorbed_rep['grad_rel_err']:.3g} (limit {check.F64_RTOL}); forward "
        f"{absorbed_rep['ms']:.4f} ms (plain {absorbed_rep['plain_ms']:.4f}, bound "
        f"{absorbed_rep['bound_ms']:.4f}), backward {absorbed_rep['grad_ms']:.4f} ms (plain "
        f"{absorbed_rep['grad_plain_ms']:.4f}, bound {absorbed_rep['grad_bound_ms']:.4f}); 5 SGD "
        f"steps equal the plain version's, float64 launches {sgd_launches['pvt_absorbed']} + "
        f"{sgd_launches['pvt_absorbed_grad']}; make_training_step 2 steps, log c "
        f"{float(params['log_concentration']):.9g}, loss {float(loss):.9g} | {smi}", flush=True)

    # Full width, each run's launches read around it alone, each entry
    # called as its float32 phase calls it.
    def drive(label, name, want, rate_of, call):
        kernels.reset()
        tracer.eager_runs = 0
        start = time.perf_counter()
        out = call()
        seconds = time.perf_counter() - start
        launched, launched64 = dict(kernels.launches), dict(kernels.launches_f64)
        if launched64[name] != want or launched[name] != want or tracer.eager_runs \
                or launched64["pvt_trace"] != launched["pvt_trace"]:
            fail(f"phase 37 {label}: launches {launched}, float64 launches {launched64}, eager "
                 f"runs {tracer.eager_runs}")
        run = {"n": N_MAIN, "seconds": seconds, "photons_per_s": N_MAIN / seconds,
               "launches_f64": launched64[name], "launched64": launched64,
               "kernel_ms": kernels.launch_ms[name],
               "shared_rows": kernels.last_trace["shared_rows"],
               "library": kernels.last_trace["library"], "float32_photons_per_s": f32[rate_of]}
        print(
            f"phase 37 float64 {label}: {N_MAIN} photons in {seconds:.4f} s, "
            f"{run['photons_per_s']:.6g} photons/s (float32, {rate_of}: {f32[rate_of]:.6g}, "
            f"ratio {f32[rate_of] / run['photons_per_s']:.3f}), {want} {name} launches of "
            f"{run['library']} ({run['kernel_ms']:.2f} ms, rows in shared memory: "
            f"{run['shared_rows']}), eager runs 0 | {smi}", flush=True)
        return run, out

    full = {}
    full["gradient path"], (fractions, gradients) = drive(
        "gradient path: fate_gradients(slab, wrt='all')", "pvt_trace_score", 9, "phase 18",
        lambda: transport.fate_gradients(lsc_slab(), N_MAIN, seed=37, wrt="all",
                                         dtype=np.float64))
    full["pathwise"], (_, path_gradients) = drive(
        f"pathwise gradient path: fate_gradients(slab, wrt='all', pathwise={PATHWISE})",
        "pvt_trace_pathwise", 9, "phase 23",
        lambda: transport.fate_gradients(lsc_slab(), N_MAIN, seed=37, wrt="all",
                                         pathwise=PATHWISE, dtype=np.float64))
    full["mesh"], mesh_res = drive(
        "simulate(mesh LSC, score=True)", "pvt_trace_score", 1, "phase 18 mesh",
        lambda: simulate(mesh_lsc(), N_MAIN, seed=37, record_every=0, score=True,
                         dtype=np.float64, compiled=scenes["mesh LSC"]))
    for g in list(gradients.values()) + list(path_gradients.values()):
        if not np.isfinite(g).all():
            fail(f"phase 37 float64 gradients not finite: {gradients}, {path_gradients}")
    if mesh_res.data["fate_scores"].dtype != np.float64 \
            or not np.isfinite(mesh_res.data["rec_scores"]).all():
        fail("phase 37 float64 mesh LSC score run: scores not float64 or not finite")
    lsc_results = {}
    for wrt, name in (("concentration", "pvt_trace_score"), ("n", "pvt_trace_pathwise")):
        full[f"LSC.gradient {wrt}"], lsc_results[wrt] = drive(
            f"LSC.gradient(wrt={wrt!r})", name, 9, f"phase 31 {wrt}",
            lambda wrt=wrt: lsc_gradient(wrt, N_MAIN, 37, dtype=np.float64))
        if not np.isfinite(lsc_results[wrt][0]["gradient"]):
            fail(f"phase 37 float64 LSC.gradient(wrt={wrt!r}): {lsc_results[wrt][0]}")
    ckpt_dir = tempfile.mkdtemp()
    full["checkpoint"], ckpt = drive(
        "simulate_checkpointed(slab, score=True)", "pvt_trace_score", N_MAIN // N_BUNDLE,
        "phase 29", lambda: simulate_checkpointed(
            lsc_slab(), N_MAIN, os.path.join(ckpt_dir, "f64.npz"), seed=37, record_every=0,
            bundle=N_BUNDLE, score=True, dtype=np.float64, compiled=scenes["slab"]))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    full["checkpoint"]["sums_used"] = check.check_chunk_scores(
        st["slab"], seed, {"fates": ckpt._fates, "fate_scores": ckpt._fate_scores}, N_MAIN,
        N_BUNDLE)
    kernels.reset()
    log_scale, history = transport.optimize_concentration(
        lambda scale: lsc_slab(scale_bg=scale), 0.55, num_rays=N_OPT, iters=2, lr=8.0, seed=11,
        component=1, event=Event.NONRADIATIVE, dtype=np.float64)
    if kernels.launches_f64["pvt_trace_score"] != 2 or not np.isfinite(log_scale):
        fail(f"phase 37 float64 optimize_concentration: {kernels.launches_f64}, {history}")
    print(
        f"phase 37 float64 gradients: fractions "
        f"{ {e.name: round(float(v), 6) for e, v in fractions.items()} }, d/dlog(dye, "
        f"background) and d/dn(world, slab) of NONRADIATIVE "
        f"{gradients[Event.NONRADIATIVE].tolist()}, pathwise d/dn(lsc), d/dsize_z(lsc) "
        f"{path_gradients[Event.NONRADIATIVE][-2:].tolist()}; LSC.gradient "
        f"{ {w: r[0] for w, r in lsc_results.items()} }; simulate_checkpointed's fate_scores at "
        f"{full['checkpoint']['sums_used']:.3g} of their float64 accumulation bound against "
        f"{N_MAIN // N_BUNDLE} runs of {N_BUNDLE}; optimize_concentration 2 x {N_OPT}: history "
        f"{[tuple(round(float(v), 6) for v in row) for row in history]}; phase 37 took "
        f"{time.perf_counter() - tic:.1f} s | {smi}", flush=True)

    gradient_entries = ["fate_gradients(dtype=float64)", "simulate(score=True, dtype=float64)",
                        "LSC.gradient(dtype=float64)",
                        "simulate_checkpointed(score=True, dtype=float64)",
                        "optimize_concentration(dtype=float64)"]
    pathwise_entries = ["fate_gradients(pathwise=..., dtype=float64)",
                        "LSC.gradient(wrt='n', dtype=float64)"]
    surrogate = ["absorbed_fraction_fn (float64)", "make_training_step (float64)"]
    summary = {k: {q: v[q] for q in ("photons_per_s", "float32_photons_per_s", "kernel_ms",
                                     "launches_f64", "seconds", "shared_rows")}
               for k, v in full.items()}
    rows = [
        ("pvt_score", score_rep, full["gradient path"]["launched64"]["pvt_score"],
         [f"{e} (inside pvt_trace_score)" for e in gradient_entries],
         {"library": "score_f64", "n": N_CHECK, "channels": score_rep["channels"],
          "runs_inside": "pvt_trace_score_f64 (score_step)"}),
        ("pvt_fresnel", fresnel_rep, full["gradient path"]["launched64"]["pvt_fresnel"],
         [f"{e} (inside pvt_trace_score)" for e in gradient_entries],
         {"library": "score_f64", "points": fresnel_rep["points"],
          "runs_inside": "pvt_trace_score_f64 (fresnel_dR)"}),
        ("pvt_trace_score", traces["slab"], full["gradient path"]["launches_f64"],
         gradient_entries,
         {"library": "score_f64", "n": N_F64_SCORE, "full_width": summary,
          **{k.replace(" ", "_").replace(",", ""): {q: v[q] for q in (
              "ms", "plain_ms", "bound_ms", "parted", "shared_rows")}
             for k, v in traces.items() if k != "slab"}}),
        ("pvt_pathwise", path_rep, full["pathwise"]["launched64"]["pvt_pathwise"],
         [f"{e} (inside pvt_trace_pathwise)" for e in pathwise_entries],
         {"library": "pathwise_f64", "n": N_CHECK, "channels": path_rep["channels"],
          "left_out": path_rep["left_out"],
          "runs_inside": "pvt_trace_pathwise_f64 (step_tangent, pathwise_step)"}),
        ("pvt_trace_pathwise", traces["slab, pathwise"], full["pathwise"]["launches_f64"],
         pathwise_entries, {"library": "pathwise_f64", "n": N_F64_PATH}),
        ("pvt_absorbed", absorbed_rep, sgd_launches["pvt_absorbed"], surrogate,
         {"library": "diff_f64", "n": N_SLAB}),
        ("pvt_absorbed_grad", dict(absorbed_rep, ms=absorbed_rep["grad_ms"],
                                   plain_ms=absorbed_rep["grad_plain_ms"],
                                   bound_ms=absorbed_rep["grad_bound_ms"],
                                   bound_by=absorbed_rep["grad_bound_by"],
                                   max_abs_err=absorbed_rep["grad_abs_err"]),
         sgd_launches["pvt_absorbed_grad"], surrogate, {"library": "diff_f64", "n": N_SLAB}),
    ]
    return rows, {"seconds": time.perf_counter() - tic, "full_width": summary}


def lsc_cpu_checks(smi, lsc_cards, lsc_grads, runs):
    """Phase 31's comparisons with the CPU twin (`runs`, from
    ``finish_lsc_twins``), for each parameter's card run at N_CHECK
    (`lsc_cards`: ``lsc_gradient``'s result and ``check_trace_scores``'
    report): the recorders' distinct counts, score sums and the gradient
    of ``LSC.gradient`` on the card and on the CPU, and the kernel's
    records photon by photon against the CPU twin's; each parameter's
    `lsc_grads` entry gains the figures."""
    import numpy as np
    import torch

    from pvtrace_tpu_torch.kernels import check

    for wrt, name in LSC_PARAMS:
        card_g, photons = lsc_cards[wrt]
        twin_g, cpu_t = runs[wrt]["result"], runs[wrt]["tallies"]
        cpu_photons = check.compare_score_records(photons["tallies"], cpu_t,
                                                  torch.as_tensor(photons["fates"]), N_CHECK,
                                                  check.SCORE_PARTED * N_CHECK)
        tol = max(20, N_CHECK // 500)
        d_off = int(np.abs(card_g[1]["rec_distinct"] - twin_g[1]["rec_distinct"]).max())
        ch = lsc_channel(twin_g[0])
        allow = (check.SCORE_RTOL * cpu_t["rec_abs"][:5, ch].double() + cpu_t["rec_slack"][:5, ch]
                 + cpu_photons["parted_allow"][ch]).numpy()
        off = np.abs(card_g[1]["rec_scores"][:, ch].astype(np.float64)
                     - twin_g[1]["rec_scores"][:, ch])
        bound = lsc_gradient_bound(N_CHECK, card_g[:2], twin_g[:2], allow)
        g_off = abs(card_g[0]["gradient"] - twin_g[0]["gradient"])
        if d_off > tol or not (off <= allow).all() or not g_off <= bound:
            fail(f"LSC.gradient(wrt={wrt!r}) on the card against the CPU twin: distinct off by "
                 f"{d_off} (limit {tol}), score sums {off.tolist()} (bound {allow.tolist()}), "
                 f"gradient {card_g[0]} against {twin_g[0]} (bound {bound})")
        lsc_grads[wrt]["check"] = {
            "card": card_g[0], "cpu": twin_g[0], "distinct_off": d_off,
            "sums_used": share_of_bound(off, allow), "gradient_off": g_off, "bound": bound,
            "cpu_s": twin_g[2], "records_s": runs[wrt]["records_s"],
            "parted_from_cpu": cpu_photons["parted"],
            "saturated_from_cpu": cpu_photons["saturated"]}
        print(
            f"phase 31 LSC.gradient(wrt={wrt!r}) at {N_CHECK} on the card against device='cpu' "
            f"({twin_g[2]:.1f} s, and {runs[wrt]['records_s']:.1f} s for the twin's per-photon "
            f"records, in a process of their own): distinct within {d_off} (limit {tol}), "
            f"score sums at {share_of_bound(off, allow):.3g} of their bound, gradient "
            f"{card_g[0]['gradient']:.6f} against {twin_g[0]['gradient']:.6f} (|diff| "
            f"{g_off:.3g}, bound {bound:.3g}); {name} photon by photon against the CPU twin: "
            f"{cpu_photons['parted']} parted, {cpu_photons['saturated']} saturated | {smi}",
            flush=True,
        )


def random_scene_phases(smi):
    """Phase 38's random scenes on the card: ``scenes.random_scene`` seeds
    RANDOM_SEEDS (0-19 as the CPU tests, 20-31 here only) under each
    scene's own emit method and caps, with probe recorders on the faces
    touching boxes share (``random_scene(probes=True)``, no draw of their
    own): ``check.check_trace`` in float32 at N_RANDOM and in float64 at
    N_RANDOM_F64 photons, with its recorders' tallies (on touching boxes
    held through the probes); ``check.check_log`` (record_every=1) on
    RANDOM_LOG_SEEDS, ``check.check_trace_scores`` on RANDOM_SCORE_SEEDS;
    the index-matched copy's crafted rays through ``kernels.trace(
    bundle=..., record_every=1)`` in float64, whose log must equal the CPU
    twin's in kinds and nodes and the oracle's record by record
    (``kernels.crafted.compare``). Returns a summary; records the launches
    for the kernels line's ``reached_from`` (``ENTRY_RUNS["random
    scenes"]``)."""
    import torch

    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, tracer
    from pvtrace_tpu_torch.kernels import check, crafted
    from pvtrace_tpu_torch.scenes import random_scene

    tic = time.perf_counter()
    kernels.reset()
    tracer.eager_runs = 0
    meta_max = {}
    worst = {"fates32": 0, "fates64": 0, "tallies32": 0, "tallies64": 0, "sums64_used": 0.0,
             "sums64_columns": [0.0] * 8, "coincident32": 0, "coincident64": 0, "shared32": 0,
             "shared64": 0}
    crafted_records = crafted_shared = oracle_repeats = crafted_swapped = 0
    logs, scores = {}, {}
    for seed in RANDOM_SEEDS:
        built = random_scene(seed, probes=True)
        compiled = compile_scene(built.scene)
        faces = crafted.coincident(built, compiled)
        opts = crafted.options(built)
        words = rng.key_words(seed)
        reps = {}
        try:
            for dtype, n in ((torch.float32, N_RANDOM), (torch.float64, N_RANDOM_F64)):
                st = scene_tensors(compiled, dtype=dtype, device="cuda")
                for key, value in st["meta"].items():
                    if isinstance(value, (int, float)):
                        meta_max[key] = max(meta_max.get(key, 0), value)
                reps[dtype] = check.check_trace(st, words, n, **opts, **faces)
                if dtype == torch.float32 and seed in RANDOM_LOG_SEEDS:
                    logs[seed] = check.check_log(st, words, N_LOG, **opts,
                                                 coincident=faces["coincident"])
                if dtype == torch.float32 and seed in RANDOM_SCORE_SEEDS:
                    scores[seed] = check.check_trace_scores(
                        st, words, N_BUDGET, **opts, **faces,
                        max_drifted=check.SCORE_DRIFTED * N_BUDGET)
            matched = random_scene(seed, matched=True)
            compiled_m = compile_scene(matched.scene)
            card = crafted.trace_crafted(
                matched, scene_tensors(compiled_m, dtype=torch.float64, device="cuda"), seed)
            twin = crafted.trace_crafted(
                matched, scene_tensors(compiled_m, dtype=torch.float64, device="cpu"), seed)
            card_ints, _, swapped = check.coincident_hits(
                card[0], card[1], {"ints": twin[0], "floats": twin[1]}, faces["coincident"])
            used = torch.arange(card[0].shape[1]) < twin[2][:, None]
            check.require(torch.equal(card[2], twin[2])
                          and torch.equal(card_ints[used][:, :4], twin[0][used][:, :4]),
                          "the crafted rays' float64 log differs from the twin's in kinds or nodes")
            counted = crafted.compare(matched, card, torch.float64)
        except AssertionError as err:
            fail(f"phase 38 random scene {seed}: {err}")
        crafted_records += counted["records"]
        crafted_swapped += swapped
        crafted_shared += counted["shared"]
        oracle_repeats += counted["oracle"]
        r32, r64 = reps[torch.float32], reps[torch.float64]
        for tag, rep in (("32", r32), ("64", r64)):
            worst["fates" + tag] = max(worst["fates" + tag], rep["max_abs_err"])
            worst["tallies" + tag] = max(worst["tallies" + tag], rep["tally_max_diff"])
            worst["coincident" + tag] = max(worst["coincident" + tag],
                                            rep.get("coincident_max_diff", 0))
            worst["shared" + tag] = max(worst["shared" + tag], rep.get("shared_crossings", 0))
        worst["sums64_used"] = max(worst["sums64_used"], r64.get("sums_used", 0.0))
        worst["sums64_columns"] = [max(a, b) for a, b in zip(
            worst["sums64_columns"], r64.get("sums_used_columns", [0.0] * 8))]
        f = built.features
        print(
            f"phase 38 random scene {seed} ({f['nodes']} nodes, depth {f['depth']}, touching "
            f"{f['touching']}, {'/'.join(f['geometries'])}, {built.options['emit_method']}, "
            f"maxsteps {built.options['maxsteps']}, maxpathlength "
            f"{built.options['maxpathlength']}): float32 {N_RANDOM} fates {r32['fates']} vs twin "
            f"{r32['twin_fates']}, max diff {r32['max_abs_err']}, tallies {r32['tally_max_diff']}"
            f" (on touching boxes {r32.get('coincident_max_diff', 0)} of "
            f"{r32.get('shared_crossings', 0)} shared-face crossings), kernel {r32['ms']:.4f} ms, "
            f"twin {r32['plain_ms']:.1f} ms; float64 {N_RANDOM_F64} max diff "
            f"{r64['max_abs_err']}, tallies {r64['tally_max_diff']} (on touching boxes "
            f"{r64.get('coincident_max_diff', 0)} of {r64.get('shared_crossings', 0)}), sums at "
            f"{r64.get('sums_used', 0.0):.3g} of their bound, kernel {r64['ms']:.4f} ms, twin "
            f"{r64['plain_ms']:.1f} ms; crafted float64 {counted['records']} records as the "
            f"twin's and the oracle's | {smi}", flush=True)
    launched, launched64 = dict(kernels.launches), dict(kernels.launches_f64)
    if tracer.eager_runs == 0 or launched["pvt_trace"] == 0 or launched64["pvt_trace"] == 0:
        fail(f"phase 38: the random scenes did not run the kernels and the twin: {launched}")
    ENTRY_RUNS["random scenes"] = (launched, meta_max)
    for seed, rep in logs.items():
        print(f"phase 38 random scene {seed} event log ({N_LOG}, record_every=1): "
              f"{rep['diverged']} of {rep['slots']} photons parted (limit "
              f"{check.LOG_DIVERGED} of them), {rep['drifted']} drifted after a curved surface "
              f"with their events equal (limit {check.LOG_DRIFTED} of them), the others' floats "
              f"within {rep['max_rel_err']:.3g} of their scale (limit {check.LOG_RTOL}), "
              f"{rep['records']} records, {rep['coincident_hits']} hits on the other of two "
              f"coincident faces, budget kills {rep['budget_kills']}; kernel {rep['ms']:.4f} ms "
              f"| {smi}", flush=True)
    for seed, rep in scores.items():
        print(f"phase 38 random scene {seed} score trace ({N_BUDGET}): fates {rep['fates']} vs "
              f"{rep['twin_fates']}, {rep['parted']} photons parted ({rep['drifted']} with their "
              f"fate and steps equal; limits {check.SCORE_PARTED * N_BUDGET:g} and "
              f"{check.SCORE_DRIFTED * N_BUDGET:g} more of those), records at "
              f"{rep['record_used']:.3g} and sums at {rep['sums_used']:.3g} of their bounds, "
              f"recorders on touching boxes within {rep.get('coincident_max_diff', 0)} of "
              f"{rep.get('shared_crossings', 0)} shared-face crossings, kernel {rep['ms']:.4f} ms,"
              f" rows in shared memory {rep['shared_rows']} | {smi}", flush=True)
    seconds = time.perf_counter() - tic
    columns = ", ".join(f"{c:.3g}" for c in worst["sums64_columns"])
    print(f"phase 38 random scenes {RANDOM_SEEDS[0]}-{RANDOM_SEEDS[-1]}: worst fate diff "
          f"{worst['fates32']} (float32, limit {max(20, N_RANDOM // 500)}), {worst['fates64']} "
          f"(float64, limit {check.F64_PARTED}); tallies {worst['tallies32']}, "
          f"{worst['tallies64']}; on touching boxes {worst['coincident32']}, "
          f"{worst['coincident64']} (most shared-face crossings {worst['shared32']}, "
          f"{worst['shared64']}); float64 sums at {worst['sums64_used']:.3g} of their bound "
          f"(by column: {columns}); crafted rays {crafted_records} records, {crafted_shared} "
          f"across touching faces ({crafted_swapped} hitting the other face than the twin), "
          f"{oracle_repeats} oracle repeats left out; {seconds:.1f} s | {smi}", flush=True)
    return {"seconds": seconds, "seeds": len(RANDOM_SEEDS), "worst": worst,
            "crafted_records": crafted_records, "launched_f64": launched64, "meta": meta_max}


def many_node_phases(smi, tracer_report):
    """Phase 38's many-node scenes: ``scenes.lsc_tiles(N, dyes=1)`` for N
    in TILES, ``check_trace`` against the twin at N_RANDOM and
    ``simulate`` at N_TILES in float32, launches read around it alone.
    `tracer_report` is phase 1's nvcc report of the tracer library.
    Returns {N: figures} and the seconds."""
    import numpy as np
    import torch

    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, simulate, tracer
    from pvtrace_tpu_torch.kernels import build, check
    from pvtrace_tpu_torch.scenes import lsc_tiles

    tic = time.perf_counter()
    regs = {fn: (r, stack, stores) for fn, r, stack, stores, _ in build.ptxas_rows(tracer_report)}
    registers = regs.get("trace_kernel<0,0,0,0,0,0,0>")
    tiles = {}
    for N in TILES:
        scene = lsc_tiles(tiles=N, dyes=1)
        compiled = compile_scene(scene)
        st = scene_tensors(compiled, dtype=torch.float32, device="cuda")
        try:
            rep = check.check_trace(st, rng.key_words(38), N_RANDOM)
        except AssertionError as err:
            fail(f"phase 38 lsc_tiles({N}): {err}")
        kernels.reset()
        tracer.eager_runs = 0
        res = simulate(scene, N_TILES, seed=38, record_every=0, dtype=np.float32,
                       compiled=compiled)
        fates = np.asarray(res.data["fates"])
        if int(fates.sum()) != N_TILES or kernels.launches["pvt_trace"] != 1 \
                or tracer.eager_runs:
            fail(f"phase 38 lsc_tiles({N}): fates {fates.tolist()}, launches "
                 f"{kernels.launches}, eager runs {tracer.eager_runs}")
        run = kernels.last_trace
        tiles[N] = {"photons_per_s": N_TILES / res.elapsed, "kernel_ms": run["ms"],
                    "lane_efficiency": run["lane_efficiency"], "threads": run["threads"],
                    "shared_cheb": run["shared_cheb"], "cheb_bytes": 4 * st["meta"]["cheb_words"],
                    "fates": fates.tolist(), "check_max_diff": rep["max_abs_err"],
                    "check_ms": rep["ms"], "twin_ms": rep["plain_ms"]}
        print(
            f"phase 38 lsc_tiles({N}, dyes=1): check_trace {N_RANDOM} fates {rep['fates']} vs twin "
            f"{rep['twin_fates']}, max diff {rep['max_abs_err']}; simulate({N_TILES}) "
            f"{tiles[N]['photons_per_s']:.6g} photons/s, pvt_trace {run['ms']:.3f} ms, lane "
            f"efficiency {run['lane_efficiency']:.4f}, {run['threads']} threads, registers/stack/"
            f"spill stores {registers}, K5a table {tiles[N]['cheb_bytes']} bytes in "
            f"{'shared' if run['shared_cheb'] else 'device'} memory, fates {fates.tolist()} | "
            f"{smi}", flush=True)
    return tiles, time.perf_counter() - tic


def main():
    start_s = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")

    import numpy as np

    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.diff import transport
    from pvtrace_tpu_torch.device.lsc import LSC
    from pvtrace_tpu_torch.engine import absorb, api, compile_scene, rng, scene_tensors, simulate
    from pvtrace_tpu_torch.engine import simulate_checkpointed, simulate_stream
    from pvtrace_tpu_torch.engine import tracer
    from pvtrace_tpu_torch.kernels import build, check
    from pvtrace_tpu_torch.light.event import Event
    from pvtrace_tpu_torch.engine.emit import emit_bundle
    from pvtrace_tpu_torch.parallel import init_distributed, make_photon_mesh, shard, shard_simulate
    from pvtrace_tpu_torch.parallel import shutdown_distributed
    from pvtrace_tpu_torch.scenes import (
        absorber_slab,
        fresnel_slab,
        lsc_slab,
        lsc_slab_host,
        lsc_slab_heatmap,
        lsc_slab_recorders,
        lsc_tiles,
        mesh_lsc,
        mesh_slab_fine,
        mixed_scene,
        pathwise_slab,
        tilted_fresnel_slab,
    )

    # 0. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(
        f"phase 0 card: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}",
        flush=True,
    )

    # 1. build: one nvcc per library, started together
    tic = time.perf_counter()
    built = build.build_all()
    for name in built:
        kernels.library(name)
    print(f"phase 1 build: {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - tic:.1f} s", flush=True)
    for name, (_, report) in built.items():
        for fn, regs, stack, stores, loads in build.ptxas_rows(report or ""):
            print(f"  ptxas {name} {fn}: {regs if regs is not None else '-'} registers, {stack} "
                  f"bytes stack, {stores} bytes spill stores, {loads} bytes spill loads")
    # The instantiations with recorders (K9, first flag) or meshes (K10,
    # third flag), and the two entries that run K9's and K10's code alone.
    k9_k10 = [f"{fn} {regs}/{stack}/{stores}" for name, (_, report) in built.items()
              for fn, regs, stack, stores, _ in build.ptxas_rows(report or "")
              if not name.endswith("_f64")
              and (fn.startswith(("trace_kernel<1", "tally_kernel", "mesh_kernel"))
                   or fn.startswith("trace_kernel<") and fn[17:18] == "1")]
    print(f"phase 1 K9 and K10 (registers/stack bytes/spill bytes): {'; '.join(k9_k10)}",
          flush=True)
    for lib in ("tracer_f64", "score_f64", "pathwise_f64", "diff_f64"):
        f64_fns = [f"{fn} {regs}/{stack}/{stores}/{loads}" for fn, regs, stack, stores, loads
                   in build.ptxas_rows(built[lib][1] or "")]
        print(f"phase 1 {lib}, a float64 build (registers/stack bytes/spill stores/spill "
              f"loads): {'; '.join(f64_fns)}", flush=True)

    scene = lsc_slab()
    compiled = compile_scene(scene)
    st = scene_tensors(compiled, dtype=torch.float32, device="cuda")
    meta = st["meta"]
    if not (meta["cheb_spec"] and meta["cheb_icdf"]):
        fail(f"the bench scene does not take K5a at its defaults: {meta}")
    seed = rng.key_words(1)

    # 2. emission
    state, emit_rep = check.check_emit(st, seed, N_CHECK)
    print(
        f"phase 2 pvt_emit: {N_CHECK} photons, keys bit-equal, max abs err "
        f"{emit_rep['max_abs_err']:.3g}; kernel {emit_rep['ms']:.4f} ms, "
        f"twin {emit_rep['plain_ms']:.4f} ms, bound {emit_rep['bound_ms']:.4f} ms | {smi}",
        flush=True,
    )

    # 3. physics step
    step_rep = check.check_step(st, state, steps=8)
    print(
        f"phase 3 pvt_step: {N_CHECK} lanes x 8 steps, discrete mismatch "
        f"{step_rep['discrete_frac']:.2e}, max abs err {step_rep['max_abs_err']:.3g}; "
        f"kernel {step_rep['ms']:.4f} ms, twin {step_rep['plain_ms']:.4f} ms, "
        f"bound {step_rep['bound_ms']:.4f} ms | {smi}",
        flush=True,
    )

    # 4. the trace against the eager twin
    trace_rep = check.check_trace(st, seed, N_CHECK)
    print(
        f"phase 4 pvt_trace vs twin: {N_CHECK} photons, fates {trace_rep['fates']} "
        f"vs {trace_rep['twin_fates']}, max diff {trace_rep['max_abs_err']}; "
        f"kernel {trace_rep['ms']:.4f} ms (through the wrapper {trace_rep['wrapper_ms']:.4f} "
        f"ms), twin {trace_rep['plain_ms']:.2f} ms, "
        f"bound {trace_rep['bound_ms']:.4f} ms, lane efficiency "
        f"{trace_rep['lane_efficiency']:.4f} | {smi}",
        flush=True,
    )

    def drive(run_scene, run_compiled, seed_value, n=N_MAIN, record_every=0):
        """One main-path run, its launch counts read around it alone."""
        kernels.reset()
        tracer.eager_runs = 0
        result = simulate(
            run_scene, n, seed=seed_value, record_every=record_every, dtype=np.float32,
            compiled=run_compiled,
        )
        launches, eager = dict(kernels.launches), tracer.eager_runs
        fates = np.asarray(result.data["fates"])
        if int(fates.sum()) != n:
            fail(f"main path: fates {fates.tolist()} do not sum to {n}")
        if any(fates[i] for i in range(len(fates)) if i not in LSC_FATES):
            fail(f"main path: fates other than EXIT/NONRADIATIVE/KILL: {fates.tolist()}")
        logged = launches["pvt_trace_log"] == (1 if record_every else 0)
        if launches["pvt_trace"] != 1 or not logged or eager:
            fail(f"main path did not run through pvt_trace: {launches}, eager runs {eager}")
        return result, launches

    def loop_estimate(st_e, bundle=None):
        """The lane efficiency a loop per photon would have on the score
        trace's per-photon steps of N_CHECK photons at `seed` (phase 17's
        run of `st_e`; with a bundle, phase 24's)."""
        _, _, t, _ = kernels.trace(st_e, seed, N_CHECK, score=True, per_photon=True,
                                   bundle=bundle)
        return check.per_photon_loop_efficiency(t["photon_steps"])

    def efficiency(label, run, estimate):
        """A launch's lane efficiency (`run`: its last_trace), which must
        exceed the loop per photon's `estimate`; printed as a phrase."""
        eff = run["lane_efficiency"]
        if not eff > estimate:
            fail(f"{label}: lane efficiency {eff:.4f}, not above the per-photon loop's "
                 f"{estimate:.4f}")
        return f"lane efficiency {eff:.4f} (a loop per photon: {estimate:.4f})"

    def exit_z(fates):
        """z of the exit fraction against phase 4's twin (other photons)."""
        ref = trace_rep["twin_fates"]
        p1, p2 = fates[7] / N_MAIN, ref[7] / N_CHECK
        pooled = (fates[7] + ref[7]) / (N_MAIN + N_CHECK)
        return abs(p1 - p2) / np.sqrt(pooled * (1 - pooled) * (1 / N_MAIN + 1 / N_CHECK))

    # 4b. the table lerp (K5b) through phases 2-4, against the K5b twin
    os.environ["PVTRACE_TPU_NO_CHEB"] = "1"
    try:
        st_b = scene_tensors(compiled, dtype=torch.float32, device="cuda")
    finally:
        os.environ.pop("PVTRACE_TPU_NO_CHEB", None)
    if st_b["meta"]["cheb_spec"] or st_b["meta"]["cheb_icdf"]:
        fail(f"PVTRACE_TPU_NO_CHEB=1 left K5a on: {st_b['meta']}")
    state_b, emit_b = check.check_emit(st_b, seed, N_CHECK)
    step_b = check.check_step(st_b, state_b, steps=8)
    trace_b = check.check_trace(st_b, seed, N_CHECK)
    lerp_ms, lerp_by = check.lerp_bound(st_b, trace_b["total_steps"])
    print(
        f"phase 4b K5b: pvt_emit max abs err {emit_b['max_abs_err']:.3g}; pvt_step "
        f"discrete mismatch {step_b['discrete_frac']:.2e}, max abs err "
        f"{step_b['max_abs_err']:.3g}; pvt_trace fates {trace_b['fates']} vs "
        f"{trace_b['twin_fates']}, max diff {trace_b['max_abs_err']}; kernel "
        f"{trace_b['ms']:.4f} ms (wrapper {trace_b['wrapper_ms']:.4f}), twin "
        f"{trace_b['plain_ms']:.2f} ms, bound "
        f"{trace_b['bound_ms']:.4f} ms; the table lerp's own bound {lerp_ms:.5f} ms "
        f"({lerp_by}, {trace_b['total_steps']} steps) | {smi}",
        flush=True,
    )

    # 5. the main path at full size, at the scene's defaults (K5a)
    result, main_launches = drive(scene, compiled, 2)
    main_run = dict(kernels.last_trace)
    slab_estimate = loop_estimate(st)
    fates = np.asarray(result.data["fates"])
    z = exit_z(fates)
    if not z < 5:
        fail(f"main path exit fraction: z = {z:.2f} against the twin")
    rate = N_MAIN / result.elapsed
    if not main_run["shared_cheb"]:
        fail(f"main path: the slab's K5a table was not staged in shared memory: {main_run}")
    print(
        f"phase 5 main path: simulate({N_MAIN} photons) fates {fates.tolist()}, "
        f"exit z = {z:.2f}, longest photon {result.data['steps']} steps, "
        f"{main_run['threads']} threads, {result.elapsed:.4f} s, "
        f"{rate:.6g} photons/s, kernel {main_run['ms']:.2f} ms (at {N_CHECK}, phase 4: "
        f"{trace_rep['ms']:.4f} ms), {main_run['total_steps']} steps, "
        f"{efficiency('main path', main_run, slab_estimate)}, K5a table in shared "
        f"memory ({main_run['shared_bytes']} bytes a block), launches {main_launches} "
        f"| {smi}",
        flush=True,
    )

    # 6. K5a: every fit of the scene on a grid of t and at its breakpoints,
    # with the table in shared and in device memory
    cheb_rep = check.check_cheb(st, n_t=1 << 16)
    cheb_dev = check.check_cheb(st, n_t=1 << 16, shared=False)
    if not cheb_rep["shared_cheb"] or cheb_dev["shared_cheb"]:
        fail(f"pvt_cheb: placements {cheb_rep['shared_cheb']}, {cheb_dev['shared_cheb']} "
             "where shared and device memory were asked for")
    for label, rep in (("shared memory", cheb_rep), ("device memory", cheb_dev)):
        print(
            f"phase 6 pvt_cheb vs twin, table in {label}: {rep['n_fits']} fits x {rep['n_t']} t "
            f"and {rep['segment_points']} breakpoints, neighbours, ends and NaN, segments equal, "
            f"max rel err {rep['max_rel_err']:.3g} (limit {check.CHEB_RTOL}); kernel "
            f"{rep['ms']:.4f} ms (through the wrapper, host work between launches included, "
            f"{rep['wrapper_ms']:.4f} ms), twin {rep['plain_ms']:.4f} ms, bound "
            f"{rep['bound_ms']:.5f} ms | {smi}",
            flush=True,
        )
    st_tiles = scene_tensors(compile_scene(lsc_tiles()), dtype=torch.float32, device="cuda")
    tiles_cheb = check.check_cheb(st_tiles, n_t=1 << 12, reps=2)
    tiles_rep = check.check_trace(st_tiles, seed, 1 << 16, lanes=1 << 14)
    if tiles_cheb["shared_cheb"] or kernels.last_trace["shared_cheb"]:
        fail("lsc_tiles: its K5a table was staged in shared memory, beyond the budget")
    print(
        f"phase 6 lsc_tiles, K5a table of {4 * st_tiles['meta']['cheb_words']} bytes in device "
        f"memory: pvt_cheb {tiles_cheb['n_fits']} fits, segments equal, max rel err "
        f"{tiles_cheb['max_rel_err']:.3g}; pvt_trace vs twin {1 << 16} photons, fates "
        f"{tiles_rep['fates']} vs {tiles_rep['twin_fates']}, max diff "
        f"{tiles_rep['max_abs_err']}; kernel {tiles_rep['ms']:.2f} ms | {smi}",
        flush=True,
    )

    # 7. K9 lane by lane: phase 3's lanes with 32 and 256 recorders and
    # with the heatmap's bins past shared memory
    rec32 = compile_scene(lsc_slab_recorders(32))
    st32 = scene_tensors(rec32, dtype=torch.float32, device="cuda")
    st256 = scene_tensors(compile_scene(lsc_slab_recorders(256)), dtype=torch.float32,
                          device="cuda")
    st_heat = scene_tensors(compile_scene(lsc_slab_heatmap()), dtype=torch.float32,
                            device="cuda")
    tally_reps = {}
    for label, st_r, shared in (("32 recorders", st32, True), ("256 recorders", st256, True),
                                ("heatmap", st_heat, False)):
        rep = tally_reps[label] = check.check_tally(st_r, state, steps=8)
        rep["rule"] = kernels.tally_rule(st_r["meta"])
        if rep["shared_bins"] != shared:
            fail(f"pvt_tally, {label}: bins in shared memory {rep['shared_bins']}, not {shared}")
        print(
            f"phase 7 pvt_tally vs twin, {label}: {N_CHECK} lanes x 8 steps, "
            f"{st_r['meta']['n_grp']} facet groups, {rep['rule']}, "
            f"{rep['events_per_step']:.0f} events a step, "
            f"integer tallies and seen bits equal after every step, sums max rel err "
            f"{rep['max_rel_err']:.3g} (limit {check.SUMS_RTOL}), shared bins "
            f"{rep['shared_bins']}; kernel {rep['ms']:.4f} ms, twin {rep['plain_ms']:.4f} ms, "
            f"bound {rep['bound_ms']:.5f} ms | {smi}",
            flush=True,
        )
    tally_rep = tally_reps["32 recorders"]

    # 8. the recorder path against the eager twin, at 32 and 256 recorders
    for R, st_r in ((32, st32), (256, st256)):
        rep = check.check_trace(st_r, seed, N_CHECK)
        shared_bytes = kernels.last_trace["shared_bytes"]
        if not rep["shared_bins"]:
            fail(f"{R} recorders: the bins did not take the shared-memory path")
        if R == 256 and shared_bytes <= 48 * 1024:
            fail(f"256 recorders: {shared_bytes} bytes a block, not above 48 KB")
        if R == 32:
            rec_rep = rep
        print(
            f"phase 8 recorders vs twin: {N_CHECK} photons, {R} recorders, distinct "
            f"{rep['distinct'][:8]}..., max diff {rep['tally_max_diff']} of "
            f"distinct/crossings/bins (limit {max(20, N_CHECK // 500)}), mean wavelengths "
            f"within {rep['mean_wavelength_worst_se']:.3f} standard errors; "
            f"{shared_bytes} bytes a block; kernel {rep['ms']:.2f} ms, "
            f"twin {rep['plain_ms']:.2f} ms | {smi}",
            flush=True,
        )
    # simulate's RecorderResults are the kernel's tallies of the same
    # photons (seed 1 is `seed`): rays and crossings equal, means within
    # two runs' rounding of the sums.
    res32 = simulate(lsc_slab_recorders(32), N_CHECK, seed=1, record_every=0,
                     dtype=np.float32, compiled=rec32)
    tallies = rec_rep["tallies"]
    for r, name in enumerate(rec32.recorder_names):
        got, rays = res32.recorders[name], int(tallies["distinct"][r])
        if (got.rays, got.crossings) != (rays, int(tallies["cross"][r])):
            fail(f"recorder {name}: RecorderResult rays {got.rays}, crossings "
                 f"{got.crossings} against the kernel's {rays}, {int(tallies['cross'][r])}")
        mean = float(tallies["sums"][r, 0]) / max(rays, 1)
        if rays and not abs(got.mean("wavelength") - mean) <= check.SUMS_RUNS_RTOL * mean:
            fail(f"recorder {name}: mean wavelength {got.mean('wavelength')} against {mean}")
    print(f"phase 8 RecorderResults of simulate: rays, crossings and mean wavelengths of "
          f"{len(rec32.recorder_names)} recorders match the kernel's tallies", flush=True)

    # 9. bins beyond shared memory: the global-atomic path
    heat_rep = check.check_trace(st_heat, seed, N_CHECK)
    if heat_rep["shared_bins"]:
        fail("heatmap scene: the bins took the shared-memory path")
    print(
        f"phase 9 global bins vs twin: {N_CHECK} photons, {st_heat['meta']['total_bins']} "
        f"bins, {heat_rep['bin_adds']} bin adds, max diff {heat_rep['tally_max_diff']}; "
        f"kernel {heat_rep['ms']:.2f} ms, twin {heat_rep['plain_ms']:.2f} ms | {smi}",
        flush=True,
    )

    # 10. K5a against K5b on the main path, in turns a, b, b, a
    # The two compute different functions of the same photons, so their
    # fates differ (which shows the switch took effect) by far less than z 5.
    rates, spectra_fates = {"K5a": [], "K5b": []}, {}
    spectra_eff = {"K5a": [], "K5b": []}
    estimates = {"K5a": slab_estimate, "K5b": loop_estimate(st_b)}
    for spectra in ("K5a", "K5b", "K5b", "K5a"):
        if spectra == "K5b":
            os.environ["PVTRACE_TPU_NO_CHEB"] = "1"
        try:
            res, _ = drive(scene, compiled, 3)
        finally:
            os.environ.pop("PVTRACE_TPU_NO_CHEB", None)
        rates[spectra].append(N_MAIN / res.elapsed)
        spectra_eff[spectra].append(efficiency(spectra, kernels.last_trace, estimates[spectra]))
        spectra_fates[spectra] = np.asarray(res.data["fates"])
        z_ab = exit_z(spectra_fates[spectra])
        if not z_ab < 5:
            fail(f"main path with {spectra}: exit z = {z_ab:.2f} against the twin")
    if np.array_equal(spectra_fates["K5a"], spectra_fates["K5b"]):
        fail("the main path gave the same fates with K5a and K5b: the switch did nothing")
    print(
        f"phase 10 spectra: photons/s K5a {[f'{r:.6g}' for r in rates['K5a']]}, "
        f"K5b {[f'{r:.6g}' for r in rates['K5b']]} ({N_MAIN} photons); K5a: "
        f"{'; '.join(spectra_eff['K5a'])}; K5b: {'; '.join(spectra_eff['K5b'])}; fates K5a "
        f"{spectra_fates['K5a'].tolist()}, K5b {spectra_fates['K5b'].tolist()} | {smi}",
        flush=True,
    )

    # 11. the recorder path at full size
    rec_rates = {0: rate}
    rec_launches = {}
    for R in (4, 32, 256):
        rec_scene = lsc_slab_recorders(R)
        res, rec_launches[R] = drive(rec_scene, compile_scene(rec_scene), 4)
        run = dict(kernels.last_trace)
        rec_rates[R] = N_MAIN / res.elapsed
        distinct = np.asarray(res.data["rec_distinct"])
        if distinct.shape != (R,) or int(distinct.sum()) == 0:
            fail(f"{R} recorders: rec_distinct {distinct.tolist()[:8]}")
        if np.asarray(res.data["rec_bins"]).shape != (R * 50,):
            fail(f"{R} recorders: rec_bins of shape {res.data['rec_bins'].shape}")
        chunks = ""
        if R == 32:
            rel = check.check_chunks(st32, rng.key_words(4), res.data, N_MAIN, N_CHUNK)
            chunks = (f"; tallies equal to {-(-N_MAIN // N_CHUNK)} runs of {N_CHUNK}, sums within "
                      f"{rel:.3g} (limit {check.SUMS_RUNS_RTOL:.3g})")
        print(
            f"phase 11 recorders R={R}: {N_MAIN} photons, {res.elapsed:.4f} s, "
            f"{rec_rates[R]:.6g} photons/s, distinct {distinct.tolist()[:4]}..., "
            f"shared bins {bool(run['shared_bins'])} ({run['shared_bytes']} bytes a block), "
            f"{run['threads']} threads, {efficiency(f'R={R}', run, slab_estimate)}, "
            f"launches {rec_launches[R]}{chunks} | {smi}",
            flush=True,
        )

    # 12. K10 ray by ray: the hex plate and the tessellated slab
    mesh_scene = mesh_lsc()
    mesh_compiled = compile_scene(mesh_scene)
    st_mesh = scene_tensors(mesh_compiled, dtype=torch.float32, device="cuda")
    st_fine = scene_tensors(compile_scene(mesh_slab_fine()), dtype=torch.float32, device="cuda")
    mesh_reps = {}
    for label, st_m in (("hex plate", st_mesh), ("fine slab", st_fine)):
        rep = check.check_mesh(st_m, 1, N_CHECK, seed=12)
        mesh_reps[label] = rep
        print(
            f"phase 12 pvt_mesh vs twin, {label}: {rep['rays']} rays x {rep['triangles']} "
            f"triangles, {rep['hits']} hits, counts differ on {rep['count_diffs']} rays "
            f"({rep['near_edge']} near an edge), t max rel err {rep['max_rel_err']:.3g} "
            f"(limit {check.MESH_RTOL}); kernel {rep['ms']:.4f} ms, twin {rep['plain_ms']:.4f} ms, "
            f"bound {rep['bound_ms']:.5f} ms | {smi}",
            flush=True,
        )

    # 13. the mesh LSC through pvt_trace against the eager twin
    mesh_rep = check.check_trace(st_mesh, seed, N_CHECK)
    print(
        f"phase 13 mesh LSC vs twin: {N_CHECK} photons, fates {mesh_rep['fates']} vs "
        f"{mesh_rep['twin_fates']}, max diff {mesh_rep['max_abs_err']}, recorders max diff "
        f"{mesh_rep['tally_max_diff']}, mean wavelengths within "
        f"{mesh_rep['mean_wavelength_worst_se']:.3f} standard errors; kernel "
        f"{mesh_rep['ms']:.2f} ms, twin {mesh_rep['plain_ms']:.2f} ms, bound "
        f"{mesh_rep['bound_ms']:.4f} ms | {smi}",
        flush=True,
    )

    # 14. K11: the event log against the twin's, then tallies against the log
    log_reps = {}
    for label, st_l, events in (("mesh LSC", st_mesh, 128), ("slab", st, 128),
                                ("mesh LSC", st_mesh, 8)):
        rep = check.check_log(st_l, seed, N_LOG, record_every=1, max_events=events)
        log_reps[(label, events)] = rep
        if events == 8 and not rep["budget_kills"]:
            fail("max_events=8: no photon met the event budget")
        print(
            f"phase 14 event log vs twin, {label}, max_events {events}: {rep['slots']} photons, "
            f"{rep['records']} records, {rep['diverged']} diverged (limit "
            f"{check.LOG_DIVERGED:g} of them), floats within {rep['max_rel_err']:.3g} of their "
            f"column's scale (limit {check.LOG_RTOL}), {rep['full_rows']} full rows, "
            f"{rep['budget_kills']} "
            f"budget kills; fates {rep['fates']} vs {rep['twin_fates']}; kernel "
            f"{rep['ms']:.2f} ms, twin {rep['plain_ms']:.2f} ms | {smi}",
            flush=True,
        )
        pack = rep["pack"]
        print(
            f"phase 14 pvt_log_pack vs eventlog.pack, {label}, max_events {events}: "
            f"{pack['records']} records of {pack['slots']} slots bit-equal, counts equal to the "
            f"twin's rows on the {rep['slots'] - rep['diverged']} photons that did not diverge; "
            f"kernel {pack['ms']:.4f} ms, plain {pack['plain_ms']:.4f} ms, two mask gathers "
            f"{pack['library_ms']:.4f} ms, bound {pack['bound_ms']:.5f} ms | {smi}",
            flush=True,
        )
    for label, make, events in (("mesh LSC", mesh_lsc, 128), ("mesh LSC", mesh_lsc, 8)):
        rep = check.check_fetch(make(), N_LOG, max_events=events)
        print(
            f"phase 14 simulate's dense log vs the CPU twin's, {label}, max_events {events}: "
            f"{rep['slots']} photons, {rep['records']} records, {rep['diverged']} diverged, "
            f"counts equal, floats within {rep['max_rel_err']:.3g} of their column's scale "
            f"(limit {check.LOG_RTOL}) | {smi}",
            flush=True,
        )
    for label, make in (("mesh LSC", mesh_lsc), ("slab R=8", lambda: lsc_slab_recorders(8))):
        log_scene = make()
        res = simulate(log_scene, N_LOG, seed=14, record_every=1, dtype=np.float32)
        worst = check.check_log_tallies(log_scene, res)
        print(
            f"phase 14 tallies from the log, {label}: {N_LOG} photons, "
            f"{len(res.recorders)} recorders, rays {[r.rays for r in res.recorders.values()]}, "
            f"rays, crossings and bins equal to the log's, moments within {worst:.3g} "
            f"(limit {check.LOG_SUMS_RTOL}) | {smi}",
            flush=True,
        )

    # 15. full width: meshes, histories, and the slab beside phase 5
    full = {}
    mesh_estimate = loop_estimate(st_mesh)
    for label, n, every in (("mesh", N_MAIN, 0), ("mesh, record_every=1000", N_MAIN, 1000),
                            ("mesh, record_every=1", N_LOG_FULL, 1)):
        res, full_launches = drive(mesh_scene, mesh_compiled, 15, n, every)
        log_bytes = sum(
            res.data[k].size * res.data[k].itemsize
            for k in ("kind", "hit", "container", "adjacent", "component", "source",
                      "position", "direction", "normal", "wavelength", "travelled", "duration")
        )
        full[label] = {
            "n": n, "photons_per_s": n / res.elapsed, "elapsed_s": res.elapsed,
            "kernel_ms": kernels.last_trace["ms"], "log_bytes": log_bytes,
            "slots": int(res.num_recorded), "records": int(np.asarray(res.data["counts"]).sum()),
            "launches": full_launches,
        }
        if every and res.num_recorded != -(-n // every):
            fail(f"{label}: {res.num_recorded} recorded photons, not {-(-n // every)}")
        fetch = ""
        if every:
            if full_launches["pvt_log_pack"] != 1:
                fail(f"{label}: the log was not packed by pvt_log_pack: {full_launches}")
            if not np.array_equal(res.data["counts"], (res.data["kind"] >= 0).sum(1)):
                fail(f"{label}: counts differ from the dense log's rows")
            part = dict(api.last_fetch)
            full[label]["fetch"] = part
            fetch = (
                f"; fetch: pack {part['pack_s'] * 1e3:.2f} ms (kernel {part['pack_ms']:.4f} "
                f"ms), copy {part['copy_s'] * 1e3:.2f} ms of {part['bytes']} bytes "
                f"({part['bytes'] / part['copy_s'] / 1e9:.3f} GB/s), unpack "
                f"{part['unpack_s'] * 1e3:.2f} ms into {part['dense_bytes']} dense bytes "
                f"({part['bytes'] / part['dense_bytes']:.4f} of them copied)"
            )
        print(
            f"phase 15 {label}: {n} photons, {res.elapsed:.4f} s, {n / res.elapsed:.6g} "
            f"photons/s, pvt_trace {kernels.last_trace['ms']:.2f} ms, fates "
            f"{np.asarray(res.data['fates']).tolist()}, {full[label]['slots']} slots, "
            f"{full[label]['records']} records, log {log_bytes} bytes{fetch}, "
            f"{efficiency(label, kernels.last_trace, mesh_estimate)}, launches {full_launches} "
            f"| {smi}",
            flush=True,
        )
    # pvt_log_pack at the history path's width: a log of 1 in 1000 at 2**27
    _, _, _, full_log = kernels.trace(st_mesh, rng.key_words(15), N_MAIN, record_every=1000)
    pack_rep = check.check_log_pack(full_log)
    del full_log
    print(
        f"phase 15 pvt_log_pack vs eventlog.pack, log 1000 at {N_MAIN}: {pack_rep['records']} "
        f"records of {pack_rep['slots']} slots bit-equal, {pack_rep['packed_bytes']} of "
        f"{pack_rep['dense_bytes']} bytes; kernel {pack_rep['ms']:.4f} ms, plain "
        f"{pack_rep['plain_ms']:.4f} ms, two mask gathers {pack_rep['library_ms']:.4f} ms, "
        f"bound {pack_rep['bound_ms']:.5f} ms | {smi}",
        flush=True,
    )
    res, _ = drive(scene, compiled, 2)
    full["slab again"] = {"n": N_MAIN, "photons_per_s": N_MAIN / res.elapsed,
                          "kernel_ms": kernels.last_trace["ms"]}
    print(
        f"phase 15 slab again: {N_MAIN / res.elapsed:.6g} photons/s (phase 5: {rate:.6g}), "
        f"pvt_trace {kernels.last_trace['ms']:.2f} ms, "
        f"{efficiency('slab again', kernels.last_trace, slab_estimate)} | {smi}",
        flush=True,
    )

    # 16. K12 lane by lane: pvt_score on phase 3's lanes, and pvt_fresnel
    score_reps = {}
    for label, st_s, lanes in (("slab", st, state),
                               ("mixed", scene_tensors(compile_scene(mixed_scene()),
                                                       dtype=torch.float32, device="cuda"), None)):
        if lanes is None:
            lanes, _ = check.check_emit(st_s, seed, N_CHECK, reps=1)
        rep = check.check_score(st_s, lanes, steps=8)
        score_reps[label] = rep
        print(
            f"phase 16 pvt_score vs twin, {label}: {N_CHECK} lanes x 8 steps, {rep['channels']} "
            f"channels, discrete mismatch {rep['discrete_frac']:.2e} (limit 1e-4), path scores "
            f"at {rep['bound_used']:.3g} of their bound ({check.SCORE_RTOL} of the channel's "
            f"scale plus slack, {rep['grazing']} grazing lanes left out; worst: "
            f"{rep['worst_lane']}), folds within "
            f"{rep['fold_rel_err']:.3g} of their magnitudes; "
            f"kernel {rep['ms']:.4f} ms, twin {rep['plain_ms']:.4f} ms, bound "
            f"{rep['bound_ms']:.5f} ms | {smi}",
            flush=True,
        )
    fresnel_rep = check.check_fresnel("cuda")
    print(
        f"phase 16 pvt_fresnel vs twin: {fresnel_rep['points']} (n1, n2, c) points, "
        f"{fresnel_rep['singular']} at the critical angle, max err {fresnel_rep['max_abs_err']:.3g} "
        f"of max(|dR/dn|, 1) (limit {check.SCORE_RTOL}); kernel {fresnel_rep['ms']:.4f} ms, "
        f"twin {fresnel_rep['plain_ms']:.4f} ms | {smi}",
        flush=True,
    )

    # 17. the score trace against the eager twin, then against itself in runs
    trace_score_reps = {}
    for label, st_s in (("slab", st), ("slab R=32", st32), ("mesh LSC", st_mesh)):
        rep = check.check_trace_scores(st_s, seed, N_CHECK)
        trace_score_reps[label] = rep
        if not (rep["shared_scores"] and rep["shared_rows"]):
            fail(f"{label}: the score sums or the rows did not take the shared-memory path")
        rep["rows"] = check.check_rows_placement(st_s, seed, N_CHECK, rep["tallies"])
        rep["loop_estimate"] = check.per_photon_loop_efficiency(rep["tallies"]["photon_steps"])
        printed = {"slab": slab_estimate, "mesh LSC": mesh_estimate}.get(label)
        if printed is not None and rep["loop_estimate"] != printed:
            fail(f"{label}: per-photon loop estimate {rep['loop_estimate']} from these records, "
                 f"not the one printed before")
        print(
            f"phase 17 pvt_trace_score vs twin, {label}: {N_CHECK} photons, fates {rep['fates']} "
            f"vs {rep['twin_fates']}, {rep['parted']} photons parted (limit "
            f"{check.SCORE_PARTED * N_CHECK:g}), the others' scores at "
            f"{rep['record_used']:.3g} of their bound, score sums at {rep['sums_used']:.3g} of "
            f"theirs (fate_scores within {rep['max_abs_err']:.4g} of the twin's); kernel "
            f"{rep['ms']:.4f} ms, twin {rep['plain_ms']:.2f} ms, bound {rep['bound_ms']:.4f} ms; "
            f"per-photon steps' loop estimate {rep['loop_estimate']:.4f}; "
            f"rows in shared memory ({kernels.trace_layout(st_s, True)['shared_bytes']} bytes a block); "
            f"forced into device memory, records bit-equal, kernel ms in turns shared "
            f"{rep['rows']['ms_placed']} / device {rep['rows']['ms_device']} | {smi}",
            flush=True,
        )
    res = simulate(lsc_slab_recorders(32), N_MAIN, seed=17, record_every=0, dtype=np.float32,
                   compiled=rec32, score=True)
    worst = check.check_chunk_scores(st32, rng.key_words(17), res.data, N_MAIN, N_CHUNK)
    print(
        f"phase 17 score sums of {N_MAIN} photons against {-(-N_MAIN // N_CHUNK)} runs of "
        f"{N_CHUNK}: fates and rays equal, fate_scores and rec_scores at {worst:.3g} of their "
        f"float64 accumulation bound; simulate {res.elapsed:.4f} s | {smi}",
        flush=True,
    )

    # 18. the gradient path at full width
    kernels.reset()
    tracer.eager_runs = 0
    tic = time.perf_counter()
    fractions, gradients = transport.fate_gradients(scene, N_MAIN, seed=18, wrt="all",
                                                    dtype=np.float32)
    grad_s = time.perf_counter() - tic
    grad_launches, grad_eager = dict(kernels.launches), tracer.eager_runs
    if grad_launches["pvt_trace_score"] != -(-N_MAIN // 16_000_000) or grad_eager:
        fail(f"fate_gradients did not run through pvt_trace_score: {grad_launches}, eager "
             f"runs {grad_eager}")
    if not all(np.isfinite(g[:2]).all() for g in gradients.values()):
        fail(f"fate_gradients: component gradients not finite: {gradients}")
    grad_rate = N_MAIN / grad_s
    grad_kernel_ms = kernels.launch_ms["pvt_trace_score"]
    print(
        f"phase 18 gradient path: fate_gradients(slab, {N_MAIN}, wrt='all') in {grad_s:.4f} s, "
        f"of it {grad_kernel_ms:.2f} ms in {grad_launches['pvt_trace_score']} pvt_trace_score "
        f"launches (rows in shared memory: {kernels.last_trace['shared_rows']}), "
        f"{grad_rate:.6g} photons/s (phase 5: {rate:.6g}, {grad_rate / rate:.3f}x), fractions "
        f"{ {e.name: round(float(v), 6) for e, v in fractions.items()} }, d/dlog(dye, "
        f"background) and d/dn(world, slab) of NONRADIATIVE "
        f"{gradients[Event.NONRADIATIVE].tolist()}, launches {grad_launches} | {smi}",
        flush=True,
    )
    kernels.reset()
    tracer.eager_runs = 0
    res = simulate(mesh_scene, N_MAIN, seed=18, record_every=0, dtype=np.float32,
                   compiled=mesh_compiled, score=True)
    mesh_score_launches = dict(kernels.launches)
    if mesh_score_launches["pvt_trace_score"] != 1 or tracer.eager_runs:
        fail(f"mesh LSC score run did not go through pvt_trace_score: {mesh_score_launches}")
    mesh_score_rate = N_MAIN / res.elapsed
    rec_scores = np.asarray(res.data["rec_scores"])
    print(
        f"phase 18 mesh LSC with score: {N_MAIN} photons, {res.elapsed:.4f} s, "
        f"{mesh_score_rate:.6g} photons/s (without score, phase 15: "
        f"{full['mesh']['photons_per_s']:.6g}), pvt_trace_score {kernels.last_trace['ms']:.2f} "
        f"ms (rows in shared memory: {kernels.last_trace['shared_rows']}), rec_scores "
        f"{rec_scores.shape}, finite {bool(np.isfinite(rec_scores).all())}, "
        f"launches {mesh_score_launches} | {smi}",
        flush=True,
    )
    analytic = {}
    for label, make, event, channel, kwargs, expect, limit in (
        ("absorber slab", lambda: absorber_slab(0.8), Event.NONRADIATIVE, 0, {},
         0.8 * np.exp(-0.8), 0.02),
        ("Fresnel slab", lambda: fresnel_slab(1.5, 0.5), Event.NONRADIATIVE, 1,
         {"wrt": "refractive_index"},
         -((1 - np.exp(-0.5)) ** 2) / (1 - 0.04 * np.exp(-0.5)) ** 2 * 4 * 0.5 / 2.5 ** 3, 0.005),
    ):
        fr, gr = transport.fate_gradients(make(), N_SLAB, seed=7, dtype=np.float32, **kwargs)
        got = float(gr[event][channel])
        analytic[label] = {"got": got, "expect": expect, "limit": limit}
        if not abs(got - expect) < limit:
            fail(f"{label}: gradient {got} against the analytic {expect} (limit {limit})")
        print(f"phase 18 {label}: {N_SLAB} photons, gradient {got:.6f}, analytic {expect:.6f}, "
              f"|diff| {abs(got - expect):.2e} (limit {limit}), P(absorb) "
              f"{float(fr[event]):.6f} | {smi}", flush=True)
    tic = time.perf_counter()
    log_scale, history = transport.optimize_concentration(
        lambda scale: lsc_slab(scale_bg=scale), 0.55, num_rays=N_OPT, iters=6, lr=8.0, seed=11,
        component=1, event=Event.NONRADIATIVE, dtype=np.float32,
    )
    if not (np.isfinite(log_scale) and np.isfinite(np.asarray(history)).all()):
        fail(f"optimize_concentration: history not finite: {history}")
    print(f"phase 18 optimize_concentration: 6 x {N_OPT} photons in "
          f"{time.perf_counter() - tic:.2f} s, log scale {log_scale:+.4f}, history (log scale, P, "
          f"loss) {[tuple(round(float(v), 6) for v in row) for row in history]} | {smi}",
          flush=True)

    # 19. K15: the surrogate's kernels against the plain version
    tab = absorb.table(compiled, "cuda")
    pos, direction, wav = check.absorbed_photons(st, seed, N_SLAB)
    absorbed_rep = check.check_absorbed(tab, pos, direction, wav)
    weight = transport.absorbed_fraction_fn(compiled)
    kernels.reset()
    sgd = check.surrogate_sgd(lambda lc, p, d, w: weight({"log_concentration": lc}, p, d, w),
                              pos, direction, wav)
    sgd_launches = dict(kernels.launches)
    plain_sgd = check.surrogate_sgd(
        lambda lc, p, d, w: absorb.weight(torch.exp(lc), absorb.depth(tab, p, d, w)),
        pos, direction, wav)
    for k, (a, b) in enumerate(zip(sgd, plain_sgd)):
        if not np.allclose(a, b, rtol=check.GRAD_RTOL, atol=1e-9):
            fail(f"surrogate SGD step {k}: kernel {a} against plain {b}")
    if sgd_launches["pvt_absorbed"] != 5 or sgd_launches["pvt_absorbed_grad"] != 5:
        fail(f"surrogate SGD did not run through pvt_absorbed: {sgd_launches}")
    print(
        f"phase 19 pvt_absorbed vs plain: {N_SLAB} photons, weights within "
        f"{absorbed_rep['max_rel_err']:.3g} (limit {check.ABSORBED_RTOL}), gradient within "
        f"{absorbed_rep['grad_rel_err']:.3g} (limit {check.GRAD_RTOL}), mean weight "
        f"{absorbed_rep['absorbed']:.6f}; forward {absorbed_rep['ms']:.4f} ms (plain "
        f"{absorbed_rep['plain_ms']:.4f}, bound {absorbed_rep['bound_ms']:.4f}), backward "
        f"{absorbed_rep['grad_ms']:.4f} ms (plain {absorbed_rep['grad_plain_ms']:.4f}, bound "
        f"{absorbed_rep['grad_bound_ms']:.4f}); 5 SGD steps (log c, loss, grad) {sgd} equal "
        f"the plain version's, launches {sgd_launches} | {smi}",
        flush=True,
    )

    # 20. K13 lane by lane: pvt_pathwise on the mixed scene's lanes
    mixed_compiled = compile_scene(mixed_scene())
    st_mixed = scene_tensors(mixed_compiled, dtype=torch.float32, device="cuda")
    mixed_specs = transport.resolve_pathwise_params(mixed_compiled, [
        ("n", "plate"), ("size", "plate", 2), ("radius", "rod"), ("length", "rod")])
    lanes_mixed, _ = check.check_emit(st_mixed, seed, N_CHECK, reps=1)
    path_rep = check.check_pathwise(st_mixed, lanes_mixed, mixed_specs, steps=8)
    print(
        f"phase 20 pvt_pathwise vs twin, mixed: {N_CHECK} lanes x 8 steps, channels "
        f"{list(mixed_specs)}, discrete mismatch {path_rep['discrete_frac']:.2e} (limit 1e-4), "
        f"maps, contributions and tangents at {path_rep['bound_used']:.3g} of their bound "
        f"({check.PATH_RTOL} of the scale plus slack and conditioning; {path_rep['left_out']} "
        f"lane-steps left out, {path_rep['saturated']} saturated, limit "
        f"{check.PATH_LEFT_OUT * N_CHECK * 8:g}; worst: {path_rep['worst_lane']}); kernel "
        f"{path_rep['ms']:.4f} ms, twin {path_rep['plain_ms']:.4f} ms, bound "
        f"{path_rep['bound_ms']:.5f} ms | {smi}",
        flush=True,
    )

    # 21. the pathwise trace against the eager twin, photon by photon
    path_trace_reps = {}
    for label, st_p, comp_p, specs in (
        ("slab", st, compiled, PATHWISE), ("slab R=32", st32, rec32, PATHWISE),
        ("mesh LSC", st_mesh, mesh_compiled, [("n", mesh_compiled.node_names[1])]),
    ):
        resolved = transport.resolve_pathwise_params(comp_p, specs)
        rep = check.check_trace_scores(st_p, seed, N_CHECK, pathwise=resolved)
        path_trace_reps[label] = rep
        if not rep["shared_rows"]:
            fail(f"{label}: the pathwise rows did not take the shared-memory path")
        rep["rows"] = check.check_rows_placement(st_p, seed, N_CHECK, rep["tallies"], resolved)
        print(
            f"phase 21 pvt_trace_pathwise vs twin, {label}: {N_CHECK} photons, channels "
            f"{list(resolved)}, fates {rep['fates']} vs {rep['twin_fates']}, {rep['parted']} "
            f"photons parted, {rep['saturated']} saturated (limit each "
            f"{check.SCORE_PARTED * N_CHECK:g}), the others' scores at "
            f"{rep['record_used']:.3g} of their bound, score sums at {rep['sums_used']:.3g} of "
            f"theirs (fate_scores within {rep['max_abs_err']:.4g} of the twin's); kernel "
            f"{rep['ms']:.4f} ms, twin {rep['plain_ms']:.2f} ms, bound {rep['bound_ms']:.4f} ms; "
            f"rows in shared memory "
            f"({kernels.trace_layout(st_p, True, len(resolved))['shared_bytes']} bytes a block); "
            f"forced into device memory, records bit-equal, kernel ms in turns shared "
            f"{rep['rows']['ms_placed']} / device {rep['rows']['ms_device']} | {smi}",
            flush=True,
        )
    # Past the budget: two channels on 256 recorders, whose rows do not
    # fit, and on 224, whose rows fit only if the K5a table goes to device
    # memory.
    # Each placement against the twin at N_BUDGET photons, then timed at
    # N_CHECK as placed and with the rows forced into device memory (which
    # gives the one-channel run the K5a table in shared memory instead).
    budget = {}
    for R, want in ((256, (0, 1)), (224, (1, 0))):
        label = f"{R} recorders"
        rec_r = compile_scene(lsc_slab_recorders(R))
        st_r = st256 if R == 256 else scene_tensors(rec_r, dtype=torch.float32, device="cuda")
        resolved = transport.resolve_pathwise_params(rec_r, PATHWISE)
        rep = check.check_trace_scores(st_r, seed, N_BUDGET, pathwise=resolved)
        placed = kernels.trace_layout(st_r, True, len(resolved))
        if (placed["shared_rows"], placed["shared_cheb"]) != want:
            fail(f"{label}, two channels: rows and K5a table placed {placed}")
        fates_r, _, t_r, _ = kernels.trace(st_r, seed, N_CHECK, score=True, per_photon=True,
                                           pathwise=resolved)
        if int(fates_r.sum()) != N_CHECK:
            fail(f"{label}, two channels: fates {fates_r.tolist()} do not sum to {N_CHECK}")
        budget[label] = check.check_rows_placement(st_r, seed, N_CHECK, t_r, resolved, reps=3)
        print(
            f"phase 21 {label}, two channels ({list(resolved)}): block {placed}; vs twin at "
            f"{N_BUDGET} photons, fates {rep['fates']} vs {rep['twin_fates']}, {rep['parted']} "
            f"parted, {rep['saturated']} saturated (limit each "
            f"{check.SCORE_PARTED * N_BUDGET:g}), the others' scores at "
            f"{rep['record_used']:.3g} of their bound, score sums at {rep['sums_used']:.3g} of "
            f"theirs; at {N_CHECK}, rows forced into device memory {budget[label]['device']}, "
            f"records bit-equal; kernel ms in turns as placed {budget[label]['ms_placed']} / "
            f"rows in device memory {budget[label]['ms_device']} | {smi}",
            flush=True,
        )

    # 22. analytic pathwise gradients on the card
    p_true, dp_true = oblique_analytic(1.5, np.radians(30.0), 0.5, 1.0)
    R, T = 0.04, np.exp(-0.8)
    path_analytic = {}
    for label, make, spec, checks in (
        ("tilted Fresnel slab, d/dn", tilted_fresnel_slab, ("n", "slab"),
         ((Event.NONRADIATIVE, dp_true, 0.006), (Event.EXIT, -dp_true, 0.008))),
        ("index-matched slab, d/dL", lambda: pathwise_slab(False), ("size", "slab", 2),
         ((Event.NONRADIATIVE, 0.8 * T, 0.005),)),
        ("Fresnel slab, d/dL", lambda: pathwise_slab(True), ("size", "slab", 2),
         ((Event.NONRADIATIVE, -((1 - R) ** 2) / (1 - R * T) ** 2 * (-0.8 * T), 0.005),)),
    ):
        fr, gr = transport.fate_gradients(make(), N_SLAB, seed=3, wrt="pathwise",
                                          pathwise=[spec], dtype=np.float32)
        got = {e.name: float(gr[e][0]) for e, _, _ in checks}
        path_analytic[label] = {"got": got, "expect": {e.name: x for e, x, _ in checks}}
        for event, expect, limit in checks:
            if not abs(got[event.name] - expect) < limit:
                fail(f"{label}: {event.name} gradient {got[event.name]} against the analytic "
                     f"{expect} (limit {limit})")
        print(f"phase 22 {label}: {N_SLAB} photons, "
              + ", ".join(f"{e.name} {got[e.name]:.6f} (analytic {x:.6f}, |diff| "
                          f"{abs(got[e.name] - x):.2e}, limit {lim})" for e, x, lim in checks)
              + f", P(absorb) {float(fr[Event.NONRADIATIVE]):.6f} | {smi}", flush=True)

    # 23. the pathwise gradient path at full width
    kernels.reset()
    tracer.eager_runs = 0
    tic = time.perf_counter()
    fractions, gradients = transport.fate_gradients(scene, N_MAIN, seed=23, wrt="all",
                                                    pathwise=PATHWISE, dtype=np.float32)
    path_s = time.perf_counter() - tic
    path_launches, path_eager = dict(kernels.launches), tracer.eager_runs
    if path_launches["pvt_trace_pathwise"] != -(-N_MAIN // 16_000_000) or path_eager \
            or path_launches["pvt_trace_score"]:
        fail(f"fate_gradients(pathwise=...) did not run through pvt_trace_pathwise: "
             f"{path_launches}, eager runs {path_eager}")
    if not all(np.isfinite(g).all() for g in gradients.values()):
        fail(f"fate_gradients(pathwise=...): gradients not finite: {gradients}")
    path_rate = N_MAIN / path_s
    path_kernel_ms = kernels.launch_ms["pvt_trace_pathwise"]
    print(
        f"phase 23 pathwise gradient path: fate_gradients(slab, {N_MAIN}, wrt='all', pathwise="
        f"{PATHWISE}) in {path_s:.4f} s, of it {path_kernel_ms:.2f} ms in "
        f"{path_launches['pvt_trace_pathwise']} pvt_trace_pathwise launches (rows in shared "
        f"memory: {kernels.last_trace['shared_rows']}), "
        f"{path_rate:.6g} photons/s (phase 5: {rate:.6g}, "
        f"{path_rate / rate:.3f}x; phase 18: {grad_rate:.6g}, {path_rate / grad_rate:.3f}x), "
        f"d/dn(lsc) and d/dsize_z(lsc) of NONRADIATIVE "
        f"{gradients[Event.NONRADIATIVE][-2:].tolist()}, of EXIT "
        f"{gradients[Event.EXIT][-2:].tolist()}, launches {path_launches}; "
        f"{time.perf_counter() - start_s:.1f} s since the start | {smi}",
        flush=True,
    )

    # 24. K8's host-bundle entry against the twin, and against pvt_emit
    host_scene = lsc_slab_host(n_rec=4)
    host_compiled = compile_scene(host_scene)
    st_host = scene_tensors(host_compiled, dtype=torch.float32, device="cuda")
    np.random.seed(24)
    bundle = torch.from_numpy(tracer.bundle_rows(*emit_bundle(host_scene, N_CHECK)[:3],
                                                 np.float32)).cuda()
    bundle_rep = check.check_trace(st_host, seed, N_CHECK, bundle=bundle)
    bundle_log = check.check_log(st_host, seed, N_LOG, bundle=bundle[:, :N_LOG].contiguous())
    bundle_score = check.check_trace_scores(st_host, seed, N_CHECK, bundle=bundle)
    host_estimate = check.per_photon_loop_efficiency(bundle_score["tallies"]["photon_steps"])
    print(
        f"phase 24 pvt_trace bundle mode vs twin, slab lit by a histogram lamp, 4 recorders: "
        f"{N_CHECK} photons from one emit_bundle, fates {bundle_rep['fates']} vs "
        f"{bundle_rep['twin_fates']}, max diff {bundle_rep['max_abs_err']}, recorders max diff "
        f"{bundle_rep['tally_max_diff']} (limit {max(20, N_CHECK // 500)}); log of {N_LOG} "
        f"photons: {bundle_log['diverged']} diverged, floats within "
        f"{bundle_log['max_rel_err']:.3g} of their scale; score: {bundle_score['parted']} "
        f"photons parted, records at {bundle_score['record_used']:.3g} and sums at "
        f"{bundle_score['sums_used']:.3g} of their bounds, per-photon steps' loop estimate "
        f"{host_estimate:.4f}; kernel {bundle_rep['ms']:.4f} ms "
        f"(wrapper {bundle_rep['wrapper_ms']:.4f}) "
        f"(score {bundle_score['ms']:.2f} ms), lane efficiency "
        f"{bundle_rep['lane_efficiency']:.4f}, twin {bundle_rep['plain_ms']:.2f} ms, bound "
        f"{bundle_rep['bound_ms']:.4f} ms | {smi}",
        flush=True,
    )
    emitted = kernels.emit(st, seed, 0, N_CHECK)
    emitted = torch.stack([emitted[k] for k in tracer.BUNDLE_ROWS])
    again, _, _, _ = kernels.trace(st, seed, N_CHECK, bundle=emitted)
    if again.cpu().tolist() != trace_rep["fates"]:
        fail(f"pvt_emit's photons as a bundle: fates {again.cpu().tolist()} against phase 4's "
             f"{trace_rep['fates']}")
    state32 = kernels.emit(st32, seed, 0, N_CHECK)
    _, _, t32, _ = kernels.trace(st32, seed, N_CHECK,
                                 bundle=torch.stack([state32[k] for k in tracer.BUNDLE_ROWS]))
    for name in ("distinct", "cross", "bins"):
        if not torch.equal(t32[name], rec_rep["tallies"][name]):
            fail(f"pvt_emit's photons as a bundle, 32 recorders: {name} differs from phase 8's")
    print(f"phase 24 pvt_emit's photons fed back as a bundle: fates equal to phase 4's "
          f"{trace_rep['fates']} bit for bit, and with 32 recorders phase 8's distinct, "
          f"crossings and bins | {smi}", flush=True)

    # 25. the host-emission path at full width
    kernels.reset()
    tracer.eager_runs = 0
    tic = time.perf_counter()
    res = simulate(lsc_slab_host(), N_HOST, seed=25, record_every=0, dtype=np.float32)
    host_wall = time.perf_counter() - tic
    host_launches = dict(kernels.launches)
    host_run = dict(kernels.last_trace)
    fates = np.asarray(res.data["fates"])
    if host_launches["pvt_trace"] != 1 or host_launches["pvt_trace_bundle"] != 1 \
            or tracer.eager_runs:
        fail(f"the host-emission path did not run through pvt_trace in bundle mode: "
             f"{host_launches}, eager runs {tracer.eager_runs}")
    if int(fates.sum()) != N_HOST or any(fates[i] for i in range(11) if i not in LSC_FATES):
        fail(f"host-emission path: fates {fates.tolist()}")
    host_rate = N_HOST / res.elapsed
    print(
        f"phase 25 host-emission path: simulate(lsc_slab_host(), {N_HOST}) fates "
        f"{fates.tolist()}, {res.elapsed:.4f} s over elapsed (upload, pvt_trace "
        f"{host_run['ms']:.2f} ms, fetch), {efficiency('host emission', host_run, host_estimate)}, "
        f"{host_rate:.6g} photons/s (phase 5: "
        f"{rate:.6g}); numpy emission and set-up {host_wall - res.elapsed:.3f} s apart; "
        f"launches {host_launches} | {smi}",
        flush=True,
    )

    # 26. K14: NCCL as a world of one, then two gloo ranks sharing the card
    init_distributed(backend="nccl", init_method=f"tcp://localhost:{free_port()}",
                     world_size=1, rank=0, device="cuda")
    try:
        mesh = make_photon_mesh(device="cuda")
        rec4 = lsc_slab_recorders(4)
        rec4_compiled = compile_scene(rec4)
        shard.reduce_stats.update(calls=0, bytes=0)
        kernels.reset()
        sharded = shard_simulate(rec4, N_MAIN, mesh, seed=26, compiled=rec4_compiled)
        nccl = dict(shard.reduce_stats)
        nccl_launches = dict(kernels.launches)
        single = simulate(rec4, N_MAIN, seed=26, record_every=0, dtype=np.float32,
                          compiled=rec4_compiled).data
        for key in ("fates", "rec_distinct", "rec_crossings", "rec_bins"):
            if not np.array_equal(sharded[key], single[key]):
                fail(f"NCCL world of one: {key} differs from simulate's")
        int_err = max(int(np.abs(sharded[k] - single[k]).max())
                      for k in ("fates", "rec_distinct", "rec_crossings", "rec_bins"))
        sums_rel = float(np.max(np.abs(sharded["rec_sums"].astype(np.float64) - single["rec_sums"])
                                / np.maximum(np.abs(single["rec_sums"]), 1e-30)))
        if not sums_rel <= check.SUMS_RUNS_RTOL:
            fail(f"NCCL world of one: rec_sums off simulate's by {sums_rel:.3g}")
        if nccl["calls"] != 3 or nccl_launches["pvt_trace"] != 1:
            fail(f"NCCL world of one: {nccl['calls']} all-reduces, launches {nccl_launches}")
        one = json.loads(json.dumps(shard_runs(mesh)))
        # The new entry points on the same world: LSC.gradient(mesh=) and
        # simulate_checkpointed(mesh=) against their runs without a mesh
        shard.reduce_stats.update(calls=0, bytes=0)
        kernels.reset()
        meshed = lsc_gradient("concentration", N_LSC_MESH, 26, mesh=mesh)
        lsc_reduces = shard.reduce_stats["calls"]
        entry_run("LSC.gradient(mesh=)", dict(kernels.launches, all_reduce_tallies=lsc_reduces),
                  meshed[3])
        alone = lsc_gradient("concentration", N_LSC_MESH, 26)
        lsc_m = meshed[1]["rec_distinct"][:5]
        # The sums of |score| the two runs added: the same photons traced once more
        _, _, lsc_t, _ = kernels.trace(scene_tensors(meshed[3], dtype=torch.float32,
                                                     device="cuda"),
                                       rng.key_words(26), N_LSC_MESH, score=True)
        lsc_allow = 2 * check.score_runs_bound(lsc_m, lsc_t["rec_abs"][:5, 0].double().cpu().numpy())
        lsc_off = np.abs(meshed[1]["rec_scores"][:, 0].astype(np.float64)
                         - alone[1]["rec_scores"][:, 0])
        lsc_bound = lsc_gradient_bound(N_LSC_MESH, meshed[:2], alone[:2], lsc_allow)
        if not np.array_equal(lsc_m, alone[1]["rec_distinct"][:5]) \
                or meshed[0]["optical_efficiency"] != alone[0]["optical_efficiency"] \
                or not (lsc_off <= lsc_allow).all() \
                or not abs(meshed[0]["gradient"] - alone[0]["gradient"]) <= lsc_bound \
                or lsc_reduces != 3:
            fail(f"LSC.gradient(mesh=) on the world of one: {meshed[0]} against {alone[0]}, "
                 f"score sums off {lsc_off.tolist()} (bound {lsc_allow.tolist()}), "
                 f"{lsc_reduces} all-reduces")
        shard.reduce_stats.update(calls=0, bytes=0)
        kernels.reset()
        ckpt_meshed = simulate_checkpointed(rec4, N_SLAB, None, bundle=N_SLAB // 2, seed=26,
                                            mesh=mesh, record_every=0, dtype=np.float32,
                                            compiled=rec4_compiled)
        ckpt_reduces = shard.reduce_stats["calls"]
        entry_run("simulate_checkpointed(mesh=)",
                  dict(kernels.launches, all_reduce_tallies=ckpt_reduces), rec4_compiled)
        ckpt_alone = simulate_checkpointed(rec4, N_SLAB, None, bundle=N_SLAB // 2, seed=26,
                                           record_every=0, dtype=np.float32,
                                           compiled=rec4_compiled)
        for key in ("_fates", "_distinct", "_crossings", "_bins"):
            if not np.array_equal(getattr(ckpt_meshed, key), getattr(ckpt_alone, key)):
                fail(f"simulate_checkpointed(mesh=) on the world of one: {key} differs")
        if ckpt_reduces != 6:
            fail(f"simulate_checkpointed(mesh=): {ckpt_reduces} all-reduces, not 6")
        # Float64 on the same world: fate_gradients(mesh=) through score_f64
        # (its float64 score sums all-reduced) against the run without a
        # mesh, within two float64 runs' summation bound of the same
        # photons' |score| sums, and make_training_step on float64 photons.
        shard.reduce_stats.update(calls=0, bytes=0)
        kernels.reset()
        tracer.eager_runs = 0
        f64_fr, f64_gr = transport.fate_gradients(lsc_slab(), N_LSC_MESH, seed=26, wrt="all",
                                                  mesh=mesh, dtype=np.float64)
        f64_launches, f64_reduces = dict(kernels.launches_f64), shard.reduce_stats["calls"]
        f64_eager = tracer.eager_runs
        f64_alone = transport.fate_gradients(lsc_slab(), N_LSC_MESH, seed=26, wrt="all",
                                             dtype=np.float64)
        st64 = scene_tensors(compiled, dtype=torch.float64, device="cuda")
        f64_fates, _, f64_t, _ = kernels.trace(st64, rng.key_words(26), N_LSC_MESH, score=True)
        f64_bound = check.sharded_gradient_bound(f64_fates.double().cpu(),
                                                 f64_t["fate_abs"].cpu(), N_LSC_MESH,
                                                 torch.float64).numpy()
        f64_off = max(share_of_bound(np.abs(f64_gr[e] - f64_alone[1][e]), f64_bound[e.value])
                      for e in f64_gr)
        pos64, dir64, wav64 = check.absorbed_photons(st64, rng.key_words(19), N_SLAB)
        kernels.reset()
        f64_new, f64_loss = transport.make_training_step(compiled, mesh)(
            {"log_concentration": torch.zeros((), device="cuda", dtype=torch.float64)}, pos64,
            dir64, wav64)
        if f64_fr != f64_alone[0] or not f64_off <= 1.0 or f64_eager \
                or f64_launches["pvt_trace_score"] != 1 or f64_reduces != 3 \
                or kernels.launches_f64["pvt_absorbed"] != 1 \
                or f64_new["log_concentration"].dtype != torch.float64 \
                or not bool(torch.isfinite(f64_loss)):
            fail(f"NCCL world of one, float64: fate_gradients(mesh=) {f64_gr} against "
                 f"{f64_alone[1]} ({f64_off:.3g} of the bound), float64 launches "
                 f"{f64_launches}, {f64_reduces} all-reduces, training step {f64_new}")
    finally:
        shutdown_distributed()
    nccl_ms, nccl_bytes = one["reduce_ms"], one["reduce_bytes"]
    print(
        f"phase 26 NCCL world of one: shard_simulate(slab with 4 recorders, {N_MAIN}) equals "
        f"simulate: fates {sharded['fates'].tolist()}, distinct "
        f"{sharded['rec_distinct'].tolist()}, rec_sums within {sums_rel:.3g} (limit "
        f"{check.SUMS_RUNS_RTOL:.3g}, two runs' bound); {nccl['calls']} all-reduces of "
        f"{nccl['bytes']} bytes in all on the card in that run; {nccl_ms:.4f} ms per call of "
        f"{nccl_bytes:.0f} bytes (the score run's tallies, 150 calls after the first) | {smi}",
        flush=True,
    )
    print(
        f"phase 26 NCCL world of one, float64: fate_gradients(slab, {N_LSC_MESH}, mesh=, "
        f"dtype=float64) through score_f64 ({f64_reduces} all-reduces) equals the run without "
        f"a mesh: fractions equal, gradients at {f64_off:.3g} of two float64 runs' bound; "
        f"make_training_step on {N_SLAB} float64 photons through diff_f64, loss "
        f"{float(f64_loss):.9g} | {smi}", flush=True)
    print(
        f"phase 26 NCCL world of one, the new entry points: LSC.gradient(n={N_LSC_MESH}, mesh=) "
        f"{meshed[0]} against no mesh {alone[0]['gradient']!r}: distinct equal, score sums at "
        f"{share_of_bound(lsc_off, lsc_allow):.3g} of two runs' bound, {lsc_reduces} "
        f"all-reduces; "
        f"simulate_checkpointed(slab with 4 recorders, {N_SLAB}, bundle={N_SLAB // 2}, mesh=) "
        f"integers equal to the run without a mesh, {ckpt_reduces} all-reduces | {smi}",
        flush=True,
    )
    port, tmp = free_port(), tempfile.mkdtemp()
    paths = [os.path.join(tmp, f"rank{r}.json") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--world", str(RANKS), "--port", str(port), "--out", paths[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"gloo rank {r} exited {p.returncode}: {text[-3000:]}")
    ranks = []
    for path in paths:
        with open(path) as fh:
            ranks.append(json.load(fh))
    shutil.rmtree(tmp, ignore_errors=True)
    rec4_st = scene_tensors(rec4_compiled, dtype=torch.float32, device="cuda")
    slab_st = scene_tensors(compiled, dtype=torch.float32, device="cuda")
    grad_fates, _, grad_t, _ = kernels.trace(slab_st, rng.key_words(27), N_SLAB, score=True)
    grad_bound = check.sharded_gradient_bound(grad_fates.double().cpu(),
                                              grad_t["fate_abs"].double().cpu(), N_SLAB)
    worst = {"score": 0.0, "gradients": 0.0}
    for run in [one] + ranks:
        data = {k: np.asarray(v) for k, v in run["score_run"].items()}
        for key in ("fates", "rec_distinct", "rec_crossings", "rec_bins"):
            if not np.array_equal(data[key], np.asarray(one["score_run"][key])):
                fail(f"gloo rank {run['rank']} of {run['size']}: {key} differs from the world "
                     f"of one")
        worst["score"] = max(worst["score"], check.check_chunk_scores(
            rec4_st, rng.key_words(26), data, N_MAIN, N_MAIN // RANKS))
        if run["fractions"] != one["fractions"]:
            fail(f"fate_gradients(mesh=): fractions {run['fractions']} against {one['fractions']}")
        for e, g in run["gradients"].items():
            off = torch.as_tensor(g) - torch.as_tensor(one["gradients"][e])
            used = float((off.abs() / grad_bound[Event[e].value].clamp(min=1e-300)).max())
            if not used <= 1.0:
                fail(f"fate_gradients(mesh=): {e} gradients {g} against {one['gradients'][e]}")
            worst["gradients"] = max(worst["gradients"], used)
        (loss, lc), (one_loss, one_lc) = run["train"], one["train"]
        rel = np.log2(N_SLAB) * 2.0 ** -24
        if not (abs(loss - one_loss) <= 2 * np.sqrt(one_loss) * rel
                and abs(lc - one_lc) <= 4 * rel * abs(one_lc) + 2.0 ** -23 * abs(one_lc)):
            fail(f"make_training_step: (loss, log c) {run['train']} against {one['train']}")
    gloo_ms, gloo_bytes = max(r["reduce_ms"] for r in ranks), ranks[0]["reduce_bytes"]
    print(
        f"phase 26 gloo world of {RANKS} on the one card: shard_simulate(score=True, {N_MAIN}) "
        f"integers equal to the world of one, score sums at {worst['score']:.3g} of their "
        f"float64 bound; fate_gradients(mesh=, {N_SLAB}) fractions equal, gradients at "
        f"{worst['gradients']:.3g} of their bound; make_training_step (loss, log c) "
        f"{[r['train'] for r in ranks]} against {one['train']}; launches of pvt_trace_score a "
        f"rank {[r['score_launches'] for r in ranks]}; all-reduce on gloo (CPU copies) "
        f"{gloo_ms:.4f} ms per call of {gloo_bytes:.0f} bytes, the slower rank of 150 calls "
        f"after a barrier (NCCL, world of one: {nccl_ms:.4f}); two ranks share one card: no "
        f"multi-GPU speed measured | {smi}",
        flush=True,
    )

    # 27. K1's and K2's draws against the twin's words
    draws_rep = check.check_draws("cuda", N_CHECK)
    calls = draws_rep["refill_calls_per_warp"]
    print(
        f"phase 27 pvt_draws vs twin: {N_CHECK} lanes, keys, emission and step words bit for bit "
        f"for emission pairs 7, 0 and 4; threefry calls a warp's refill made (counted in the "
        f"kernel, equal to the twin's) {calls}; kernel "
        f"{draws_rep['ms']:.4f} ms, twin {draws_rep['plain_ms']:.4f} ms, bound "
        f"{draws_rep['bound_ms']:.5f} ms ({draws_rep['bound_by']}) | {smi}",
        flush=True,
    )

    # 28. simulate_stream at full width against one simulate
    def stream_run(n, bundle, seed_value):
        """The stream's fates, summed elapsed, host seconds from the first
        next() to the last, bundles and launches read around it."""
        kernels.reset()
        tracer.eager_runs = 0
        stream = simulate_stream(scene, n, bundle=bundle, seed=seed_value, record_every=0,
                                 dtype=np.float32, compiled=compiled)
        fates, elapsed, bundles = np.zeros(11, np.int64), 0.0, 0
        tic = time.perf_counter()
        for res, traced in stream:
            fates += res.data["fates"]
            elapsed += res.elapsed
            bundles += 1
        host = time.perf_counter() - tic
        launches, kernel_ms = dict(kernels.launches), kernels.launch_ms["pvt_trace"]
        if traced != n or launches["pvt_trace"] != bundles or tracer.eager_runs:
            fail(f"simulate_stream({n}, bundle={bundle}) did not run through pvt_trace: "
                 f"{traced} traced, launches {launches}, eager runs {tracer.eager_runs}")
        entry_run("simulate_stream", launches, compiled)
        one = simulate(scene, n, seed=seed_value, record_every=0, dtype=np.float32,
                       compiled=compiled)
        if not np.array_equal(fates, one.data["fates"]):
            fail(f"simulate_stream({n}, bundle={bundle}): fates {fates.tolist()} against one "
                 f"simulate's {one.data['fates'].tolist()}")
        return {"n": n, "bundle": bundle, "bundles": bundles, "elapsed_s": elapsed,
                "host_s": host, "kernel_ms": kernel_ms, "launches": launches["pvt_trace"],
                "photons_per_s": n / host, "one_photons_per_s": n / one.elapsed,
                "one_elapsed_s": one.elapsed, "fates": fates.tolist()}

    streams = [stream_run(N_MAIN, N_BUNDLE, 28), stream_run(N_SMALL_STREAM, SMALL_BUNDLE, 28)]
    if streams[0]["launches"] != -(-N_MAIN // N_BUNDLE):
        fail(f"simulate_stream: {streams[0]['launches']} pvt_trace launches")
    for run in streams:
        print(
            f"phase 28 simulate_stream(slab, {run['n']}, bundle={run['bundle']}): fates "
            f"{run['fates']} equal one simulate's bit for bit; {run['bundles']} bundles, "
            f"{run['launches']} pvt_trace launches ({run['kernel_ms']:.2f} ms), summed elapsed "
            f"{run['elapsed_s']:.4f} s, {run['host_s']:.4f} s from the first next() to the last, "
            f"{run['photons_per_s']:.6g} photons/s (one simulate: {run['one_elapsed_s']:.4f} s, "
            f"{run['one_photons_per_s']:.6g}); per bundle "
            f"{run['host_s'] / run['bundles'] * 1e3:.3f} ms on the host clock, of it "
            f"{run['kernel_ms'] / run['bundles']:.3f} ms of kernel | {smi}",
            flush=True,
        )

    # 29. simulate_checkpointed at full width: three bundles, a resume
    # without bundle=, against an uninterrupted run
    ckpt_dir = tempfile.mkdtemp()

    def checkpointed(run_scene, run_compiled, path, seed_value, **kwargs):
        return simulate_checkpointed(run_scene, N_MAIN, path, seed=seed_value, record_every=0,
                                     dtype=np.float32, compiled=run_compiled, **kwargs)

    ckpt = {}
    for label, run_scene, run_compiled, score in (
            ("slab R=32", lsc_slab_recorders(32), rec32, False),
            ("slab, score", scene, compiled, True)):
        path = os.path.join(ckpt_dir, f"run{len(ckpt)}.npz")
        kernels.reset()
        tracer.eager_runs = 0
        tic = time.perf_counter()
        partial = checkpointed(run_scene, run_compiled, path, 29, bundle=N_BUNDLE,
                               stop_after_bundles=3, score=score)
        resumed = checkpointed(run_scene, run_compiled, path, 29, score=score)
        wall = time.perf_counter() - tic
        launches = dict(kernels.launches)
        name = "pvt_trace_score" if score else "pvt_trace"
        if partial.traced != 3 * N_BUNDLE or not resumed.complete or resumed.bundle != N_BUNDLE \
                or launches[name] != -(-N_MAIN // N_BUNDLE) or tracer.eager_runs:
            fail(f"simulate_checkpointed, {label}: traced {partial.traced}, then "
                 f"{resumed.traced} (bundle {resumed.bundle}), launches {launches}")
        entry_run("simulate_checkpointed(score=True)" if score else "simulate_checkpointed",
                  launches, run_compiled)
        uninterrupted = checkpointed(run_scene, run_compiled, None, 29, bundle=N_BUNDLE,
                                     score=score)
        for a, b, key in ((resumed._fates, uninterrupted._fates, "fates"),
                          (resumed._distinct, uninterrupted._distinct, "rec_distinct"),
                          (resumed._crossings, uninterrupted._crossings, "rec_crossings"),
                          (resumed._bins, uninterrupted._bins, "rec_bins")):
            if not np.array_equal(a, b):
                fail(f"simulate_checkpointed, {label}: resumed {key} differs from the "
                     f"uninterrupted run's")
        saves = []
        for _ in range(3):
            tic = time.perf_counter()
            resumed.save(os.path.join(ckpt_dir, "again.npz"))
            saves.append(time.perf_counter() - tic)
        rep = {"wall_s": wall, "elapsed_s": resumed.elapsed, "save_s": saves,
               "photons_per_s": N_MAIN / wall, "launches": launches[name],
               "fates": resumed._fates.tolist()}
        if score:
            rep["sums_used"] = max(
                check.check_chunk_scores(st, rng.key_words(29), {"fates": r._fates,
                                                                 "fate_scores": r._fate_scores},
                                         N_MAIN, N_BUNDLE)
                for r in (resumed, uninterrupted))
            sums = f"fate_scores at {rep['sums_used']:.3g} of their float64 accumulation bound"
        else:
            rel = float(np.max(np.abs(resumed._sums - uninterrupted._sums)
                               / np.maximum(np.abs(uninterrupted._sums), 1e-30)))
            if not rel <= check.SUMS_RUNS_RTOL:
                fail(f"simulate_checkpointed, {label}: sums off the uninterrupted run's by {rel}")
            rep["sums_rel"] = rel
            sums = f"rec_sums within {rel:.3g} (limit {check.SUMS_RUNS_RTOL:.3g})"
        ckpt[label] = rep
        print(
            f"phase 29 simulate_checkpointed({label}, {N_MAIN}, bundle={N_BUNDLE}): 3 bundles, "
            f"then a resume without bundle= (took the stored {resumed.bundle}): integers equal "
            f"to the uninterrupted run's, {sums}; {launches[name]} {name} launches, "
            f"{wall:.4f} s for both calls ({N_MAIN / wall:.6g} photons/s; summed elapsed "
            f"{resumed.elapsed:.4f} s), a save {np.mean(saves) * 1e3:.3f} ms "
            f"({[round(t * 1e3, 3) for t in saves]}) a bundle | {smi}",
            flush=True,
        )
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # 30. LSC.simulate: histories through pvt_trace with the log and
    # pvt_log_pack, the dataframe built on the host
    def lsc_simulate(n, **kwargs):
        """LSC.simulate of the default 5x5x1 plate at seed 30 (np.random
        at 30): (lsc, dataframe, engine result, seconds to the end of the
        engine run, of the histories' host loop, of the dataframe,
        launches). Its `progress` calls, one after each history, mark
        where the host loop begins and ends."""
        marks = []

        def progress(i):
            if i == 1 or i == n:
                marks.append(time.perf_counter())

        kernels.reset()
        tracer.eager_runs = 0
        np.random.seed(30)
        lsc = LSC((5.0, 5.0, 1.0))
        tic = time.perf_counter()
        df = lsc.simulate(n, seed=30, progress=progress, **kwargs)
        end = time.perf_counter()
        return (lsc, df, lsc._last_result, marks[0] - tic, marks[-1] - marks[0],
                end - marks[-1], dict(kernels.launches))

    card = lsc_simulate(N_LOG)
    if not compile_scene(card[0]._scene).lights_supported:
        fail("LSC: the default lamp was not lowered to a device sampler")
    if card[6]["pvt_trace_log"] != 1 or card[6]["pvt_log_pack"] != 1 or tracer.eager_runs:
        fail(f"LSC.simulate did not run through pvt_trace with the log: {card[6]}")
    twin = lsc_simulate(N_LOG, device="cpu")
    tol = max(20, N_LOG // 500)
    counts_off = int((card[0].counts() - twin[0].counts()).abs().to_numpy().max())
    fates_k = card[1][card[1]["kind"] == "exit"]["event"].value_counts()
    fates_t = twin[1][twin[1]["kind"] == "exit"]["event"].value_counts()
    fates_off = int(fates_k.sub(fates_t, fill_value=0).abs().max())
    entrance = int((card[1]["kind"] == "entrance").sum())
    if counts_off > tol or fates_off > tol:
        fail(f"LSC.simulate on the card against the CPU twin: counts off by {counts_off}, "
             f"fates by {fates_off} (limit {tol})")
    if entrance != card[2].num_recorded or card[2].num_recorded != N_LOG:
        fail(f"LSC.simulate: {entrance} entrance rows for {card[2].num_recorded} recorded photons")
    entry_run("LSC.simulate", card[6], card[2].compiled)
    print(
        f"phase 30 LSC.simulate({N_LOG}) on the card against device='cpu' (float32, seed 30): "
        f"counts table within {counts_off}, exit rows' events "
        f"{ {k: int(v) for k, v in fates_k.items()} } within {fates_off} "
        f"(limit {tol}); {entrance} entrance rows for {card[2].num_recorded} recorded photons, "
        f"{len(card[1])} rows; launches {card[6]} | {smi}",
        flush=True,
    )
    big = lsc_simulate(N_LSC_LOG)
    if big[6]["pvt_trace_log"] != 1 or big[6]["pvt_log_pack"] != 1:
        fail(f"LSC.simulate({N_LSC_LOG}) did not run through pvt_trace with the log: {big[6]}")
    total = big[3] + big[4] + big[5]
    lsc_times = {"elapsed_s": big[2].elapsed, "to_first_history_s": big[3],
                 "histories_s": big[4], "dataframe_s": big[5], "total_s": total,
                 "host_share": 1.0 - big[2].elapsed / total, "rows": len(big[1]),
                 "launches": big[6], "fetch": dict(api.last_fetch)}
    print(
        f"phase 30 LSC.simulate({N_LSC_LOG}) on the card: {total:.4f} s, of it trace and fetch "
        f"(elapsed) {big[2].elapsed:.4f} s; {big[3]:.4f} s to the first history's progress "
        f"call, the histories' host loop {big[4]:.4f} s, dataframe {big[5]:.4f} s, "
        f"{len(big[1])} rows; host share (all but elapsed) {lsc_times['host_share']:.4f}; "
        f"launches pvt_trace_log "
        f"{big[6]['pvt_trace_log']}, pvt_log_pack {big[6]['pvt_log_pack']} | {smi}",
        flush=True,
    )

    # 31. LSC.gradient at full width, then against the CPU twin: the card's
    # side here, the CPU twin's in a child process beside phases 36-38,
    # compared after phase 38's random scenes (``lsc_cpu_checks``).
    lsc_grads, lsc_cards = {}, {}
    for wrt, name in LSC_PARAMS:
        kernels.reset()
        tracer.eager_runs = 0
        full_grad = lsc_gradient(wrt, N_MAIN, 31)
        launches = dict(kernels.launches)
        if launches[name] != -(-N_MAIN // 16_000_000) or tracer.eager_runs \
                or not np.isfinite(full_grad[0]["gradient"]):
            fail(f"LSC.gradient(wrt={wrt!r}) did not run through {name}: {launches}, "
                 f"{full_grad[0]}")
        entry_run(f"LSC.gradient(wrt={wrt!r})", launches, full_grad[3])
        card_g = lsc_gradient(wrt, N_CHECK, 32)
        # The same photons' records, kernel against the twin on the card
        st_lsc = scene_tensors(card_g[3], dtype=torch.float32, device="cuda")
        photons = check.check_trace_scores(st_lsc, rng.key_words(32), N_CHECK,
                                           pathwise=card_g[4])
        lsc_cards[wrt] = (card_g, photons)
        lsc_grads[wrt] = {"photons_per_s": N_MAIN / full_grad[2], "seconds": full_grad[2],
                          "launches": launches[name], "kernel_ms": kernels.launch_ms[name],
                          "result": full_grad[0], "photon_by_photon": {k: photons[k] for k in (
                              "parted", "saturated", "record_used", "sums_used", "ms",
                              "plain_ms", "bound_ms")}}
        print(
            f"phase 31 LSC.gradient(n={N_MAIN}, wrt={wrt!r}), cells on four edges: {full_grad[0]}"
            f" in {full_grad[2]:.4f} s, {N_MAIN / full_grad[2]:.6g} photons/s, "
            f"{launches[name]} {name} launches ({kernels.launch_ms[name]:.2f} ms); {name} "
            f"against the twin on the card photon by photon at {N_CHECK} (phase "
            f"{17 if wrt == 'concentration' else 21}'s check): {photons['parted']} parted, "
            f"{photons['saturated']} saturated (limit each {check.SCORE_PARTED * N_CHECK:g}), "
            f"records at {photons['record_used']:.3g} and sums at {photons['sums_used']:.3g} of "
            f"their bounds | {smi}",
            flush=True,
        )

    entry = entry_point_phases(smi)
    # Phase 31's CPU twins run in their own process from here, beside the
    # phases that the host's clock does not time.
    twins = start_lsc_twins()
    f64_rows, f64_summary = float64_phases(smi, {
        "main path": rate, "recorders R=32": rec_rates[32], "mesh": full["mesh"]["photons_per_s"],
        "history": full["mesh, record_every=1000"]["photons_per_s"], "host emission": host_rate})
    grad64_rows, grad64_summary = float64_gradient_phases(smi, {
        "phase 18": grad_rate, "phase 23": path_rate, "phase 18 mesh": mesh_score_rate,
        "phase 31 concentration": lsc_grads["concentration"]["photons_per_s"],
        "phase 31 n": lsc_grads["n"]["photons_per_s"],
        "phase 29": ckpt["slab, score"]["photons_per_s"]})
    random_summary = random_scene_phases(smi)
    tic = time.perf_counter()
    lsc_cpu_checks(smi, lsc_cards, lsc_grads, finish_lsc_twins(twins))
    lsc_wait = time.perf_counter() - tic
    tiles, tiles_s = many_node_phases(smi, built["tracer"][1] or "")
    random_summary["tiles"] = tiles
    random_summary["seconds"] += tiles_s
    print(f"phase 38 took {random_summary['seconds']:.1f} s (and phase 31's CPU checks "
          f"between its parts {lsc_wait:.1f} s) | {smi}", flush=True)
    for name, _, _, reached, _ in f64_rows:
        via, need = INSIDE.get(name, ((), None))
        if random_summary["launched_f64"].get(name):
            reached.append("random scenes (float64)")
        elif any(random_summary["launched_f64"].get(k) for k in via) \
                and (need is None or random_summary["meta"].get(need)):
            reached.append(f"random scenes (float64, inside {', '.join(via)})")

    stray = sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.") or m == "pvtrace_tpu"
        or m.startswith("pvtrace_tpu.")
    )
    if stray:
        fail(f"modules of JAX or of the JAX package were imported: {stray[:5]}")

    rows = [
        ("pvt_emit", emit_rep, {"n": N_CHECK}),
        ("pvt_step", step_rep, {"n": N_CHECK}),
        ("pvt_trace", trace_rep, {
            "n": N_CHECK, "wrapper_ms": trace_rep["wrapper_ms"],
            "lane_efficiency": trace_rep["lane_efficiency"],
            "main_path_kernel_ms": main_run["ms"],
            "main_path_lane_efficiency": main_run["lane_efficiency"],
            "per_photon_loop_efficiency": slab_estimate,
            "main_path_ms": result.elapsed * 1e3,
            "main_path_photons_per_s": rate,
            "photons_per_s_K5a": rates["K5a"], "photons_per_s_K5b": rates["K5b"],
            "photons_per_s_by_recorders": rec_rates,
            "launches_by_recorders": {R: v["pvt_trace"] for R, v in rec_launches.items()},
            "simulate_stream": streams, "simulate_checkpointed": ckpt["slab R=32"],
            "trace_profile": entry["profile"],
            "random_scenes": {k: random_summary[k] for k in ("seeds", "worst", "crafted_records",
                                                            "tiles")},
        }),
        ("pvt_cheb", cheb_rep, {
            "n_fits": cheb_rep["n_fits"], "n_t": cheb_rep["n_t"],
            "runs_inside": "pvt_trace (cheb_eval)", "device_memory_ms": cheb_dev["ms"],
            "in_trace_ms": 1e3 * (np.mean([N_MAIN / r for r in rates["K5a"]])
                                  - np.mean([N_MAIN / r for r in rates["K5b"]])),
            "tiles": {"table_bytes": 4 * st_tiles["meta"]["cheb_words"],
                      "trace_ms": tiles_rep["ms"], "trace_fates": tiles_rep["fates"]}}),
        ("pvt_tally", tally_rep, {"n": N_CHECK, "recorders": 32, "rule": tally_rep["rule"],
                                  "runs_inside": f"pvt_trace (tally_event; tally_warp past "
                                                 f"{kernels.WARP_GROUP} recorders a group)",
                                  **{label.replace(" ", "_"): {k: rep[k] for k in (
                                      "ms", "plain_ms", "bound_ms", "max_rel_err", "rule")}
                                     for label, rep in tally_reps.items()
                                     if label != "32 recorders"}}),
        ("pvt_mesh", mesh_reps["hex plate"], {
            "n": N_CHECK, "triangles": mesh_reps["hex plate"]["triangles"],
            "runs_inside": "pvt_trace (mesh_nearest_two)",
            "fine_slab": {k: mesh_reps["fine slab"][k] for k in ("ms", "plain_ms", "bound_ms")},
            "mesh_path_photons_per_s": full["mesh"]["photons_per_s"],
            "mesh_path_launches": full["mesh"]["launches"],
        }),
        ("pvt_trace_log", log_reps[("mesh LSC", 128)], {
            "n": N_LOG, "record_every": 1, "max_events": 128,
            "full_width": {k: {q: v[q] for q in ("n", "photons_per_s", "kernel_ms", "log_bytes",
                                                 "fetch")}
                           for k, v in full.items() if "record_every" in k},
            "lsc_simulate": lsc_times, "cli": entry["cli"], "cli_watch": entry["watch"],
            "studio_run": entry["studio"],
        }),
        ("pvt_log_pack", pack_rep, {
            "n": N_MAIN, "record_every": 1000, "library_ms": pack_rep["library_ms"],
            "library_is": "two boolean-mask gathers, ints[mask] and floats[mask]",
            **{k: pack_rep[k] for k in ("records", "slots", "packed_bytes", "dense_bytes")},
            "small": {f"{label}, max_events {events}": {
                k: rep["pack"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "records")}
                for (label, events), rep in log_reps.items()},
        }),
    ]
    rows += [
        ("pvt_score", score_reps["slab"], {
            "n": N_CHECK, "channels": score_reps["slab"]["channels"],
            "runs_inside": "pvt_trace_score (score_step)",
            "mixed_scene": {k: score_reps["mixed"][k] for k in ("ms", "plain_ms", "bound_ms")},
        }),
        ("pvt_fresnel", fresnel_rep, {"points": fresnel_rep["points"],
                                      "runs_inside": "pvt_trace_score (fresnel_dR)"}),
        ("pvt_trace_score", trace_score_reps["slab"], {
            "n": N_CHECK, "parted": trace_score_reps["slab"]["parted"],
            **{key: {k: trace_score_reps[label][k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "max_abs_err", "parted")}
               for key, label in (("slab_32_recorders", "slab R=32"), ("mesh_lsc", "mesh LSC"))},
            "gradient_path_photons_per_s": grad_rate, "main_path_photons_per_s": rate,
            "gradient_path_kernel_ms": grad_kernel_ms,
            "rows": {"shared_rows": trace_score_reps["slab"]["shared_rows"],
                     "ms_shared": trace_score_reps["slab"]["rows"]["ms_placed"],
                     "ms_device": trace_score_reps["slab"]["rows"]["ms_device"]},
            "mesh_score_photons_per_s": mesh_score_rate,
            "mesh_score_launches": mesh_score_launches["pvt_trace_score"],
            "analytic": analytic, "lsc_gradient": lsc_grads["concentration"],
            "simulate_checkpointed": ckpt["slab, score"],
        }),
        ("pvt_pathwise", path_rep, {
            "n": N_CHECK, "channels": path_rep["channels"], "left_out": path_rep["left_out"],
            "runs_inside": "pvt_trace_pathwise (step_tangent, pathwise_step)"}),
        ("pvt_trace_pathwise", path_trace_reps["slab"], {
            "n": N_CHECK, "parted": path_trace_reps["slab"]["parted"],
            **{key: {k: path_trace_reps[label][k] for k in ("ms", "plain_ms", "bound_ms",
                                                           "max_abs_err", "parted")}
               for key, label in (("slab_32_recorders", "slab R=32"), ("mesh_lsc", "mesh LSC"))},
            "pathwise_gradient_photons_per_s": path_rate, "gradient_path_photons_per_s": grad_rate,
            "pathwise_gradient_kernel_ms": path_kernel_ms,
            "rows": {"shared_rows": path_trace_reps["slab"]["shared_rows"],
                     "ms_shared": path_trace_reps["slab"]["rows"]["ms_placed"],
                     "ms_device": path_trace_reps["slab"]["rows"]["ms_device"],
                     "budget_two_channels": {k: {q: v[q] for q in ("placed", "ms_placed",
                                                                    "ms_device")}
                                              for k, v in budget.items()}},
            "main_path_photons_per_s": rate, "analytic": path_analytic,
            "lsc_gradient": lsc_grads["n"],
        }),
        ("pvt_absorbed", absorbed_rep, {"n": N_SLAB}),
        ("pvt_absorbed_grad", dict(absorbed_rep, ms=absorbed_rep["grad_ms"],
                                   plain_ms=absorbed_rep["grad_plain_ms"],
                                   bound_ms=absorbed_rep["grad_bound_ms"],
                                   bound_by=absorbed_rep["grad_bound_by"],
                                   max_abs_err=absorbed_rep["grad_abs_err"]), {"n": N_SLAB}),
    ]
    rows += [
        ("pvt_draws", draws_rep, {"n": N_CHECK, "refill_calls_per_warp": calls,
                                  "runs_inside": "pvt_trace (emit_draws, pvt_draw)"}),
        ("pvt_trace_bundle", bundle_rep, {
            "n": N_CHECK, "scene": "lsc_slab_host(n_rec=4)",
            "lane_efficiency": bundle_rep["lane_efficiency"],
            "host_path_kernel_ms": host_run["ms"],
            "host_path_lane_efficiency": host_run["lane_efficiency"],
            "per_photon_loop_efficiency": host_estimate,
            "log": {k: bundle_log[k] for k in ("diverged", "max_rel_err", "ms", "plain_ms")},
            "score": {k: bundle_score[k] for k in ("parted", "ms", "plain_ms", "bound_ms")},
            "host_path_photons_per_s": host_rate, "host_path_elapsed_s": res.elapsed,
            "host_path_emission_s": host_wall - res.elapsed, "n_host_path": N_HOST,
        }),
    ]
    collective = {
        "name": "all_reduce_tallies", "route": "torch.distributed",
        "source": SOURCE["all_reduce_tallies"], "replaces": REPLACES["all_reduce_tallies"],
        "launches": nccl["calls"], "max_abs_err": int_err, "rec_sums_max_rel_err": sums_rel,
        "ms": nccl_ms, "plain_ms": gloo_ms, "plain_is": "gloo all_reduce of CPU copies, "
        f"world of {RANKS} on one card, per call",
        "bound_ms": 2 * nccl_bytes / check.PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "bytes_per_call": nccl_bytes, "backend": "nccl, world of one",
        "reached_from": reached_from("all_reduce_tallies"),
        "new_entry_points_reduces": {"LSC.gradient": lsc_reduces,
                                     "simulate_checkpointed": ckpt_reduces,
                                     "fate_gradients(dtype=float64)": f64_reduces},
    }
    history_launches = full["mesh, record_every=1000"]["launches"]
    launches_of = dict(main_launches, pvt_trace_log=history_launches["pvt_trace_log"],
        pvt_log_pack=history_launches["pvt_log_pack"],
        pvt_trace_score=grad_launches["pvt_trace_score"],
        pvt_absorbed=sgd_launches["pvt_absorbed"],
        pvt_pathwise=path_launches["pvt_pathwise"],
        pvt_trace_pathwise=path_launches["pvt_trace_pathwise"],
        pvt_absorbed_grad=sgd_launches["pvt_absorbed_grad"],
        pvt_trace_bundle=host_launches["pvt_trace_bundle"], pvt_draws=main_launches["pvt_draws"])
    print(f"the script: {time.perf_counter() - start_s:.1f} s, of it phase 36 "
          f"{f64_summary['seconds']:.1f} s, phase 37 {grad64_summary['seconds']:.1f} s, phase 38 "
          f"{random_summary['seconds']:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches_of[name],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": None,
            "reached_from": reached_from(name), **extra,
        }
        for name, rep, extra in rows
    ] + [
        {
            "name": f"{name}_f64", "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "library": extra.pop("library", "tracer_f64"),
            "launches": launched,
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": extra.pop("library_ms", None), "reached_from": reached, **extra,
        }
        for name, rep, launched, reached, extra in f64_rows + grad64_rows
    ] + [collective]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lsc-twins"]:
        lsc_twins_main(sys.argv[2])
    elif len(sys.argv) > 1:
        import argparse

        parser = argparse.ArgumentParser(description="one rank of phase 26's gloo world")
        for flag, kind in (("--rank", int), ("--world", int), ("--port", int), ("--out", str)):
            parser.add_argument(flag, type=kind, required=True)
        args = parser.parse_args()
        rank_main(args.rank, args.world, args.port, args.out)
    else:
        main()
