"""Smoke test of pvtrace_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain-PyTorch twin on the card, then drives the port's main
paths, ``engine.simulate`` of the LSC benchmark scene without and with
recorders, at 2**27 photons. Phases, one line each:

0. the card (nvidia-smi name and power limit, torch's device name);
1. build the kernels with nvcc (sm_90a);
2. pvt_emit against the twin on 2**20 photons;
3. pvt_step against the twin for 8 steps from the emitted state;
4. pvt_trace against the eager twin, 2**20 photons, at the scene's
   defaults (Chebyshev spectra, K5a);
4b. phases 2-4 again on the table lerp (K5b, PVTRACE_TPU_NO_CHEB=1),
   against the K5b twin;
5. the main path: simulate at 2**27 photons through pvt_trace (launch
   counts set to 0 just before and read just after), with its photons/s;
6. pvt_cheb against the twin on every Chebyshev fit of the scene;
7. pvt_tally against the twin on phase 3's lanes, 32 recorders, 8 steps;
8. pvt_trace with 32 and with 256 recorders (the full width: all eight
   seen words, over 48 KB of shared memory a block), 2**20 photons,
   against the twin: distinct rays, crossings and bins per entry, mean
   wavelengths; simulate's RecorderResults against the kernel's tallies;
9. a recorder scene whose bins exceed a block's shared memory, so the
   kernel's global-atomic bins path runs, against the twin;
10. the main path with K5a and with the table lerp (K5b,
    PVTRACE_TPU_NO_CHEB=1), in turns a, b, b, a: photons/s of each;
11. the recorder path at 2**27 photons for 4, 32 and 256 recorders,
    each read around its own run: photons/s, and launches of pvt_trace
    with no eager run; at 32, its tallies against the same photons in
    128 runs of 2**20 (integers equal, sums within the stated bound).

Then the card's nvidia-smi line, one JSON line of per-kernel numbers,
and as the last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before the last line; without a CUDA device nothing runs.
"""
import json
import os
import subprocess
import sys
import time

N_CHECK = 1 << 20
N_MAIN = 1 << 27
N_CHUNK = 1 << 20
SOURCE = "pvtrace_tpu_torch/kernels/csrc/tracer.cu"
REPLACES = {
    "pvt_emit": "pvtrace_tpu/engine/tracer.py:762",
    "pvt_step": "pvtrace_tpu/engine/tracer.py:1073",
    "pvt_trace": "pvtrace_tpu/engine/tracer.py:953",
    "pvt_cheb": "pvtrace_tpu/engine/tracer.py:128",
    "pvt_tally": "pvtrace_tpu/engine/tracer.py:588",
}
# Fate slots of the LSC slab's photons: NONRADIATIVE, EXIT, KILL.
LSC_FATES = (4, 7, 9)


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
    from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_heatmap, lsc_slab_recorders

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

    # 1. build
    tic = time.perf_counter()
    path, report = build.build()
    kernels.library()
    ptxas = [
        line.strip() for line in (report or "").splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    ]
    print(f"phase 1 build: {path.name} in {time.perf_counter() - tic:.1f} s", flush=True)
    for line in ptxas:
        print(f"  ptxas: {line}")

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
        f"kernel {trace_rep['ms']:.2f} ms, twin {trace_rep['plain_ms']:.2f} ms, "
        f"bound {trace_rep['bound_ms']:.4f} ms | {smi}",
        flush=True,
    )

    def drive(run_scene, run_compiled, seed_value):
        """One main-path run, its launch counts read around it alone."""
        kernels.reset()
        tracer.eager_runs = 0
        result = simulate(
            run_scene, N_MAIN, seed=seed_value, record_every=0, dtype=np.float32,
            compiled=run_compiled,
        )
        launches, eager = dict(kernels.launches), tracer.eager_runs
        fates = np.asarray(result.data["fates"])
        if int(fates.sum()) != N_MAIN:
            fail(f"main path: fates {fates.tolist()} do not sum to {N_MAIN}")
        if any(fates[i] for i in range(len(fates)) if i not in LSC_FATES):
            fail(f"main path: fates other than EXIT/NONRADIATIVE/KILL: {fates.tolist()}")
        if launches["pvt_trace"] != 1 or eager:
            fail(f"main path did not run through pvt_trace: {launches}, eager runs {eager}")
        return result, launches

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
    print(
        f"phase 4b K5b: pvt_emit max abs err {emit_b['max_abs_err']:.3g}; pvt_step "
        f"discrete mismatch {step_b['discrete_frac']:.2e}, max abs err "
        f"{step_b['max_abs_err']:.3g}; pvt_trace fates {trace_b['fates']} vs "
        f"{trace_b['twin_fates']}, max diff {trace_b['max_abs_err']}; kernel "
        f"{trace_b['ms']:.2f} ms, twin {trace_b['plain_ms']:.2f} ms | {smi}",
        flush=True,
    )

    # 5. the main path at full size, at the scene's defaults (K5a)
    result, main_launches = drive(scene, compiled, 2)
    fates = np.asarray(result.data["fates"])
    z = exit_z(fates)
    if not z < 5:
        fail(f"main path exit fraction: z = {z:.2f} against the twin")
    rate = N_MAIN / result.elapsed
    print(
        f"phase 5 main path: simulate({N_MAIN} photons) fates {fates.tolist()}, "
        f"exit z = {z:.2f}, longest photon {result.data['steps']} steps, "
        f"{kernels.last_trace['threads']} threads, {result.elapsed:.4f} s, "
        f"{rate:.6g} photons/s, launches {main_launches} | {smi}",
        flush=True,
    )

    # 6. K5a: every fit of the scene on a grid of t
    cheb_rep = check.check_cheb(st, n_t=1 << 16)
    print(
        f"phase 6 pvt_cheb vs twin: {cheb_rep['n_fits']} fits x {cheb_rep['n_t']} t, "
        f"max rel err {cheb_rep['max_rel_err']:.3g} (limit {check.CHEB_RTOL}); "
        f"kernel {cheb_rep['ms']:.4f} ms, twin {cheb_rep['plain_ms']:.4f} ms, "
        f"bound {cheb_rep['bound_ms']:.5f} ms | {smi}",
        flush=True,
    )

    # 7. K9 lane by lane: phase 3's lanes in the scene with 32 recorders
    rec32 = compile_scene(lsc_slab_recorders(32))
    st32 = scene_tensors(rec32, dtype=torch.float32, device="cuda")
    tally_rep = check.check_tally(st32, state, steps=8)
    print(
        f"phase 7 pvt_tally vs twin: {N_CHECK} lanes x 8 steps, 32 recorders, "
        f"{tally_rep['events_per_step']:.0f} events a step, integer tallies equal, "
        f"sums max rel err {tally_rep['max_rel_err']:.3g} (limit {check.SUMS_RTOL}), "
        f"shared bins {tally_rep['shared_bins']}; kernel {tally_rep['ms']:.4f} ms, "
        f"twin {tally_rep['plain_ms']:.4f} ms, bound {tally_rep['bound_ms']:.5f} ms | {smi}",
        flush=True,
    )

    # 8. the recorder path against the eager twin, at 32 and 256 recorders
    st256 = scene_tensors(compile_scene(lsc_slab_recorders(256)), dtype=torch.float32,
                          device="cuda")
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
    st_heat = scene_tensors(compile_scene(lsc_slab_heatmap()), dtype=torch.float32,
                            device="cuda")
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
    for spectra in ("K5a", "K5b", "K5b", "K5a"):
        if spectra == "K5b":
            os.environ["PVTRACE_TPU_NO_CHEB"] = "1"
        try:
            res, _ = drive(scene, compiled, 3)
        finally:
            os.environ.pop("PVTRACE_TPU_NO_CHEB", None)
        rates[spectra].append(N_MAIN / res.elapsed)
        spectra_fates[spectra] = np.asarray(res.data["fates"])
        z_ab = exit_z(spectra_fates[spectra])
        if not z_ab < 5:
            fail(f"main path with {spectra}: exit z = {z_ab:.2f} against the twin")
    if np.array_equal(spectra_fates["K5a"], spectra_fates["K5b"]):
        fail("the main path gave the same fates with K5a and K5b: the switch did nothing")
    print(
        f"phase 10 spectra: photons/s K5a {[f'{r:.6g}' for r in rates['K5a']]}, "
        f"K5b {[f'{r:.6g}' for r in rates['K5b']]} ({N_MAIN} photons); fates K5a "
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
            f"{run['threads']} threads, launches {rec_launches[R]}{chunks} "
            f"| {smi}",
            flush=True,
        )

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
            "n": N_CHECK, "main_path_ms": result.elapsed * 1e3,
            "main_path_photons_per_s": rate,
            "photons_per_s_K5a": rates["K5a"], "photons_per_s_K5b": rates["K5b"],
            "photons_per_s_by_recorders": rec_rates,
            "launches_by_recorders": {R: v["pvt_trace"] for R, v in rec_launches.items()},
        }),
        ("pvt_cheb", cheb_rep, {"n_fits": cheb_rep["n_fits"], "n_t": cheb_rep["n_t"],
                                "runs_inside": "pvt_trace (cheb_eval)"}),
        ("pvt_tally", tally_rep, {"n": N_CHECK, "recorders": 32,
                                  "runs_inside": "pvt_trace (tally_event)"}),
    ]
    print(smi)
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": main_launches[name],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": None, **extra,
        }
        for name, rep, extra in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
