"""Smoke test of pvtrace_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain-PyTorch twin on the card, then drives the port's main
path, ``engine.simulate`` of the LSC benchmark scene, at 2**27 photons.
Phases, one line each:

0. the card (nvidia-smi name and power limit, torch's device name);
1. build the kernels with nvcc (sm_90a);
2. pvt_emit against the twin on 2**20 photons;
3. pvt_step against the twin for 8 steps from the emitted state;
4. simulate with the kernel against the eager twin, 2**20 photons;
5. simulate at 2**27 photons through pvt_trace (launch counts read
   around this run), with its photons/s.

Then one JSON line of per-kernel numbers, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; without a CUDA device nothing runs.
"""
import json
import subprocess
import sys
import time

N_CHECK = 1 << 20
N_MAIN = 1 << 27
SOURCE = "pvtrace_tpu_torch/kernels/csrc/tracer.cu"
REPLACES = {
    "pvt_emit": "pvtrace_tpu/engine/tracer.py:762",
    "pvt_step": "pvtrace_tpu/engine/tracer.py:1073",
    "pvt_trace": "pvtrace_tpu/engine/tracer.py:953",
}


def fail(message):
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")

    import numpy as np

    from pvtrace_tpu_torch import kernels
    from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, simulate, tracer
    from pvtrace_tpu_torch.kernels import build, check
    from pvtrace_tpu_torch.scenes import lsc_slab

    # 0. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(
        f"phase 0 card: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}",
        flush=True,
    )

    # 1. build
    tic = time.perf_counter()
    path, report = build.build()
    kernels.library()
    ptxas = [
        line.strip() for line in (report or "").splitlines()
        if "registers" in line or "spill" in line
    ]
    print(f"phase 1 build: {path.name} in {time.perf_counter() - tic:.1f} s", flush=True)
    for line in ptxas:
        print(f"  ptxas: {line}")

    scene = lsc_slab()
    compiled = compile_scene(scene)
    st = scene_tensors(compiled, dtype=torch.float32, device="cuda")
    seed = rng.key_words(1)

    # 2. emission
    state, emit_rep = check.check_emit(st, seed, N_CHECK)
    print(
        f"phase 2 pvt_emit: {N_CHECK} photons, keys bit-equal, max abs err "
        f"{emit_rep['max_abs_err']:.3g}; kernel {emit_rep['ms']:.4f} ms, "
        f"twin {emit_rep['plain_ms']:.4f} ms | {smi}",
        flush=True,
    )

    # 3. physics step
    step_rep = check.check_step(st, state, steps=8)
    print(
        f"phase 3 pvt_step: {N_CHECK} lanes x 8 steps, discrete mismatch "
        f"{step_rep['discrete_frac']:.2e}, max abs err {step_rep['max_abs_err']:.3g}; "
        f"kernel {step_rep['ms']:.4f} ms, twin {step_rep['plain_ms']:.4f} ms | {smi}",
        flush=True,
    )

    # 4. the trace against the eager twin
    trace_rep = check.check_trace(st, seed, N_CHECK)
    print(
        f"phase 4 pvt_trace vs twin: {N_CHECK} photons, fates {trace_rep['fates']} "
        f"vs {trace_rep['twin_fates']}, max diff {trace_rep['max_abs_err']}; "
        f"kernel {trace_rep['ms']:.2f} ms, twin {trace_rep['plain_ms']:.2f} ms | {smi}",
        flush=True,
    )

    # 5. the main path at full size
    kernels.reset()
    tracer.eager_runs = 0
    result = simulate(
        scene, N_MAIN, seed=2, record_every=0, dtype=np.float32, compiled=compiled
    )
    launches = dict(kernels.launches)
    threads = kernels.last_trace_threads
    eager = tracer.eager_runs
    fates = np.asarray(result.data["fates"])
    if int(fates.sum()) != N_MAIN:
        fail(f"main path: fates {fates.tolist()} do not sum to {N_MAIN}")
    if any(fates[i] for i in range(len(fates)) if i not in (4, 7, 9)):
        fail(f"main path: fates other than EXIT/NONRADIATIVE/KILL: {fates.tolist()}")
    if launches["pvt_trace"] < 1 or eager:
        fail(f"main path did not run through pvt_trace: {launches}, eager runs {eager}")
    # The exit fraction agrees with phase 4's twin (other photons, same physics).
    ref = trace_rep["twin_fates"]
    p1, p2 = fates[7] / N_MAIN, ref[7] / N_CHECK
    pooled = (fates[7] + ref[7]) / (N_MAIN + N_CHECK)
    z = abs(p1 - p2) / np.sqrt(pooled * (1 - pooled) * (1 / N_MAIN + 1 / N_CHECK))
    if not z < 5:
        fail(f"main path exit fraction {p1:.5f} vs twin {p2:.5f}: z = {z:.2f}")
    rate = N_MAIN / result.elapsed
    print(
        f"phase 5 main path: simulate({N_MAIN} photons) fates {fates.tolist()}, "
        f"exit z = {z:.2f}, longest photon {result.data['steps']} steps, "
        f"{threads} threads, "
        f"{result.elapsed:.3f} s, {rate:.6g} photons/s, launches {launches} | {smi}",
        flush=True,
    )
    if "jax" in sys.modules:
        fail("jax was imported")

    rows = [
        ("pvt_emit", emit_rep, {"n": N_CHECK}),
        ("pvt_step", step_rep, {"n": N_CHECK}),
        ("pvt_trace", trace_rep, {"n": N_CHECK, "main_path_ms": result.elapsed * 1e3,
                                  "main_path_photons_per_s": rate}),
    ]
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "on_main_path": name == "pvt_trace",
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], **extra,
        }
        for name, rep, extra in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
