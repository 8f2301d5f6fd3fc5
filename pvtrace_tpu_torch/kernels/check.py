"""On-card checks of each kernel against its plain-PyTorch twin.

``chip_smoke.py`` and the GPU tests run these on CUDA scene tensors. Each
check raises AssertionError on a mismatch and returns what it measured:
the largest deviation, the kernel's and the twin's times (CUDA events,
milliseconds per call), and the operations and bytes the call needs,
counted from the code and this call's inputs, for its bound (``bound``).
"""
import torch

from pvtrace_tpu_torch import kernels
from pvtrace_tpu_torch.engine import chebyshev, physics, tally, tracer
from pvtrace_tpu_torch.engine import tables as T

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
# A partial holds at most SUMS_FLUSH addends plus one in flight from each
# of the block's other 255 threads, so it is off by at most that many
# roundings, (SUMS_FLUSH + 255) * 2**-24 = 7.6e-5 of its value, however
# many photons the block traces; so is their total.
SUMS_BOUND = (T.SUMS_FLUSH + 255) * 2.0 ** -24
# pvt_tally's sums against the twin's, which adds one float32 reduction
# over the lanes (about log2(lanes) roundings) per step: SUMS_BOUND and
# that, rounded up.
SUMS_RTOL = 1e-4
# Two kernel runs of the same photons, one result cast to float32.
SUMS_RUNS_RTOL = 2 * SUMS_BOUND + 2.0 ** -24

# The card's peaks for the bound (H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores. Integer
# operations are counted at the float32 rate, which can only make the
# bound lower.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# Operations per unit of work, counted from tracer.cuh (add, multiply,
# compare, select and shift each count one; an FMA two; exp, log1p, sqrt,
# acos, sin and cos ten each):
OPS_THREEFRY = 123  # 20 rounds of add, rotate (3), xor, + key schedule
OPS_STEP = 4 * OPS_THREEFRY + 24 + 420  # draws, uniforms, one LSC-slab step
OPS_EMIT = 4 * OPS_THREEFRY + 80  # key, three draws, samplers, transform
OPS_CHEB_SEGMENT = 4  # two loads' compares and selects per segment scanned
OPS_CHEB_DEGREE = 4  # one Clenshaw step
OPS_CHEB_EVAL = 24  # affine map, final step, exp on a log segment
OPS_TALLY_LANE = 30  # key, candidate walk, acos, local frame
OPS_TALLY_MATCH = 12  # facet test, crossing
OPS_TALLY_NEW = 20  # seen bit, distinct, eight moments
OPS_TALLY_BIN = 10  # one histogram bin


def require(ok, message):
    """Raise AssertionError(message) unless `ok` (kept under python -O)."""
    if not ok:
        raise AssertionError(message)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of `ops` at the float32 peak and
    `nbytes` at the memory rate, and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


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


def check_emit(st, seed_words, B, index_offset=0, atol=1e-5, reps=10):
    """pvt_emit against the twin for B photons: keys and integer state
    bit-equal, floats within `atol`. Returns (state, report)."""
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
    # 14 lane outputs: 11 of 4 bytes, alive 1, the two int64 keys 16.
    report["bound_ms"], report["bound_by"] = bound(B * OPS_EMIT, B * 61)
    return twin, report


def check_step(st, state, steps=8, max_discrete=1e-4, rtol=1e-4, atol=1e-5,
               maxsteps=1000, emit_method=0, reps=10):
    """pvt_step against the twin for `steps` steps, both fed the twin's
    previous output. Discrete outcomes may differ on at most a fraction
    `max_discrete` of lanes (FMA contraction moves floats by ulps); the
    other lanes' floats must agree within rtol/atol."""
    B = state["px"].shape[0]
    worst_frac, err = 0.0, 0.0
    s = state
    for k in range(steps):
        twin = tracer.step_state(st, s, maxsteps, emit_method)
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
    # Reads the 14 lane inputs (61 bytes), writes them and 17 flags (45 bytes).
    report["bound_ms"], report["bound_by"] = bound(B * OPS_STEP, B * (2 * 61 + 45))
    return report


def check_cheb(st, n_t=4096, reps=10):
    """pvt_cheb against the twin: every fit of the scene at `n_t` values of
    t evenly spaced on [-1, 1], within CHEB_RTOL of the fit's scale."""
    dev = st["node_f"].device
    F = st["meta"]["cheb_n_fits"]
    require(F > 0, "pvt_cheb: the scene has no Chebyshev fits")
    t = torch.linspace(-1.0, 1.0, n_t, device=dev, dtype=torch.float32)
    fits = torch.arange(F, device=dev, dtype=torch.int64).repeat_interleave(n_t)
    got = kernels.cheb(st, t)
    twin = chebyshev.eval_fits(st, fits, t.repeat(F)).reshape(F, n_t)
    torch.cuda.synchronize()
    scale = twin.abs().amax(1).clamp(min=1e-30)
    diff = (got - twin).abs()
    rel = float((diff / scale[:, None]).max())
    require(rel <= CHEB_RTOL, f"pvt_cheb: max relative error {rel:.3g} > {CHEB_RTOL}")
    report = {
        "max_abs_err": float(diff.max()),
        "max_rel_err": rel,
        "n_fits": F,
        "n_t": n_t,
        "ms": cuda_ms(lambda: kernels.cheb(st, t), reps),
        "plain_ms": cuda_ms(lambda: chebyshev.eval_fits(st, fits, t.repeat(F)), reps),
    }
    # Per evaluation: the fit's segments scanned, and the Clenshaw chain of
    # the segment t falls in (t is uniform, so each segment's degree counts
    # by its width).
    fit_i = st["cheb_fit_i"].cpu()
    seg_f, seg_i = st["cheb_seg_f"].cpu().double(), st["cheb_seg_i"].cpu()
    ops = 0.0
    for kind, nseg, seg0 in fit_i.tolist():
        a, b = seg_f[seg0:seg0 + nseg, T.SF_A], seg_f[seg0:seg0 + nseg, T.SF_B]
        deg = seg_i[seg0:seg0 + nseg, T.SI_DEG].double()
        mean_deg = float(((b - a) / 2.0 * deg).sum())
        ops += n_t * (OPS_CHEB_SEGMENT * nseg + OPS_CHEB_DEGREE * mean_deg + OPS_CHEB_EVAL)
    nbytes = 4 * n_t + 4 * F * n_t + sum(
        st[name].numel() * st[name].element_size()
        for name in ("cheb_fit_i", "cheb_fit_f", "cheb_seg_f", "cheb_seg_i", "cheb_coef")
    )
    report["bound_ms"], report["bound_by"] = bound(ops, nbytes)
    return report


def _copy(t):
    return {k: v.clone() for k, v in t.items()}


def check_tally(st, state, steps=8, maxsteps=1000, emit_method=0, reps=10):
    """pvt_tally against the twin for `steps` steps of the lanes `state`,
    both fed the twin's physics step: distinct, crossings, bins and the
    seen bits equal after every step, moment sums within SUMS_RTOL."""
    require(st["meta"]["n_rec"] > 0, "pvt_tally: the scene has no recorders")
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
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    require(rel <= SUMS_RTOL, f"pvt_tally: sums off by {rel:.3g} relative > {SUMS_RTOL}")
    report = {
        "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": rel,
        "shared_bins": shared,
        "ms": cuda_ms(lambda: kernels.launch_tally(st, out, words, res), reps),
        "plain_ms": cuda_ms(lambda: tally.tally(_copy(twin_t), st, out), reps),
    }
    # Per step and lane: reads 6 floats, 2 ints, 2 flags, 4 normal floats
    # and the 32-byte seen words, writes the seen words back.
    lanes, matches, new, bins = (w / steps for w in work)
    ops = (B * OPS_TALLY_LANE + matches * OPS_TALLY_MATCH + new * OPS_TALLY_NEW
           + bins * OPS_TALLY_BIN)
    report["bound_ms"], report["bound_by"] = bound(ops, B * (50 + 2 * 32))
    report["events_per_step"] = lanes
    return report


def trace_bound(st, n, total_steps, tallies=None):
    """(bound_ms, bound_by) of pvt_trace for `n` photons that took
    `total_steps` steps in all, with this run's recorder tallies: emission
    per photon, the step per step (not counting K5a's segment search and
    Clenshaw chains, which only lowers the bound), and each crossing,
    distinct ray and bin add. Bytes: the scene tensors read once and the
    fates, counts and tallies written once."""
    ops = n * OPS_EMIT + total_steps * OPS_STEP
    nbytes = sum(
        v.numel() * v.element_size() for v in st.values() if isinstance(v, torch.Tensor)
    ) + 8 * physics.N_FATES
    if tallies is not None and st["meta"]["n_rec"]:
        ops += (int(tallies["cross"].sum()) * OPS_TALLY_MATCH
                + int(tallies["distinct"].sum()) * OPS_TALLY_NEW
                + int(tallies["bins"].sum()) * OPS_TALLY_BIN)
        nbytes += sum(v.numel() * v.element_size() for v in tallies.values())
    return bound(ops, nbytes)


def check_trace(st, seed_words, n, lanes=1 << 18, maxsteps=1000, emit_method=0):
    """pvt_trace against the twin, both on the card, for n photons: both
    account for every photon, and each fate count agrees within
    max(20, 0.2% of n) (the same photons take the same streams; FMA
    contraction flips a few discrete outcomes). With recorders, so do
    each recorder's distinct rays, crossings and bins, and its mean
    wavelength agrees within its standard error."""
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    got, longest, got_t = kernels.trace(
        st, seed_words, n, maxsteps=maxsteps, emit_method=emit_method
    )
    mid.record()
    ref, steps, ref_t = tracer.trace_eager(
        st, seed_words, n, lanes=lanes, maxsteps=maxsteps, emit_method=emit_method
    )
    stop.record()
    torch.cuda.synchronize()
    got, ref = got.cpu(), ref.cpu()
    require(int(got.sum()) == n, f"pvt_trace: fates sum to {int(got.sum())}, not {n}")
    require(int(ref.sum()) == n, f"twin: fates sum to {int(ref.sum())}, not {n}")
    tol = max(20, n // 500)
    err = int((got - ref).abs().max())
    require(err <= tol, f"pvt_trace: fates {got.tolist()} vs twin {ref.tolist()}")
    report = {
        "max_abs_err": err,
        "fates": got.tolist(),
        "twin_fates": ref.tolist(),
        "longest": longest,
        "twin_steps": steps,
        "total_steps": kernels.last_trace["total_steps"],
        "shared_bins": bool(kernels.last_trace["shared_bins"]),
        "ms": start.elapsed_time(mid),
        "plain_ms": mid.elapsed_time(stop),
        "tally_max_diff": 0,
    }
    report["bound_ms"], report["bound_by"] = trace_bound(
        st, n, report["total_steps"], got_t
    )
    R = st["meta"]["n_rec"]
    if R:
        for name in ("distinct", "cross", "bins"):
            d = (got_t[name] - ref_t[name]).abs()
            diff = int(d.max()) if d.numel() else 0
            report["tally_max_diff"] = max(report["tally_max_diff"], diff)
            require(diff <= tol, f"pvt_trace: recorder {name} off by {diff} > {tol}")
        worst = 0.0
        for r in range(R):
            nk, nt = int(got_t["distinct"][r]), int(ref_t["distinct"][r])
            if min(nk, nt) < 2:
                continue
            mk = float(got_t["sums"][r, 0]) / nk
            mt = float(ref_t["sums"][r, 0]) / nt
            var = max(float(ref_t["sums"][r, 1]) / nt - mt * mt, 0.0)
            se = (var / nt) ** 0.5
            require(abs(mk - mt) <= se, f"pvt_trace: recorder {r} mean wavelength "
                    f"{mk} vs twin {mt}, standard error {se}")
            worst = max(worst, abs(mk - mt) / se if se else 0.0)
        report["mean_wavelength_worst_se"] = worst
        report["distinct"] = got_t["distinct"][:R].tolist()
        report["tallies"] = got_t
        report["crossings"] = int(got_t["cross"][:R].sum())
        report["bin_adds"] = int(got_t["bins"].sum())
    return report


def check_chunks(st, seed_words, data, n, chunk=1 << 20):
    """The recorder tallies of one run of photons [0, n) (`data`, as
    ``simulate`` returns them) against the same photons traced by
    pvt_trace in runs of `chunk`, added in int64 and float64: integer
    tallies equal (a photon's events depend on (seed, pid) alone), moment
    sums within SUMS_RUNS_RTOL, which does not grow with n. Returns the
    sums' largest relative difference."""
    total = None
    for first in range(0, n, chunk):
        _, _, t = kernels.trace(st, seed_words, min(chunk, n - first), index_offset=first)
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
