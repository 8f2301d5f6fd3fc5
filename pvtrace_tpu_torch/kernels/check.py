"""On-card checks of each kernel against its plain-PyTorch twin.

``chip_smoke.py`` and the GPU tests run these on CUDA scene tensors. Each
check raises AssertionError on a mismatch and returns what it measured:
the largest deviation and the kernel's and the twin's times (CUDA events,
milliseconds per call).
"""
import torch

from pvtrace_tpu_torch import kernels
from pvtrace_tpu_torch.engine import physics, tracer

# Discrete outcomes of a step that must agree lane by lane.
DISCRETE = ("alive", "hit", "container", "source", "count") + physics.FLAGS


def require(ok, message):
    """Raise AssertionError(message) unless `ok` (kept under python -O)."""
    if not ok:
        raise AssertionError(message)


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
        for name in physics.STATE_FLOATS:
            ref, val = twin[name][~bad], got[name][~bad]
            fine = torch.isclose(val, ref, rtol=rtol, atol=atol, equal_nan=True)
            require(
                bool(fine.all()),
                f"pvt_step step {k}: {name} off by {float((val - ref).abs().max())}",
            )
            diff = (val - ref).abs()
            err = max(err, float(diff[torch.isfinite(diff)].max()) if diff.numel() else 0.0)
        s = twin
    return {
        "max_abs_err": err,
        "discrete_frac": worst_frac,
        "ms": cuda_ms(lambda: kernels.step(st, state, maxsteps, emit_method), reps),
        "plain_ms": cuda_ms(
            lambda: tracer.step_state(st, state, maxsteps, emit_method), reps
        ),
    }


def check_trace(st, seed_words, n, lanes=1 << 18, maxsteps=1000, emit_method=0):
    """pvt_trace against the twin, both on the card, for n photons: both
    account for every photon, and each fate count agrees within
    max(20, 0.2% of n) (the same photons take the same streams; FMA
    contraction flips a few discrete outcomes)."""
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    got, longest = kernels.trace(st, seed_words, n, maxsteps=maxsteps, emit_method=emit_method)
    mid.record()
    ref, steps = tracer.trace_eager(
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
    return {
        "max_abs_err": err,
        "fates": got.tolist(),
        "twin_fates": ref.tolist(),
        "longest": longest,
        "twin_steps": steps,
        "ms": start.elapsed_time(mid),
        "plain_ms": mid.elapsed_time(stop),
    }
