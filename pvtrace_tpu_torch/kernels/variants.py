"""Time builds of one kernel library that differ in one constant, or in
their sources, against each other on the card, in turns.

    python -m pvtrace_tpu_torch.kernels.variants --set kMinBlocks=1,2
    python -m pvtrace_tpu_torch.kernels.variants --lib score --csrc parent=OTHER/csrc

``--set NAME=V1,V2,..`` builds the library once for each value, with the
line ``constexpr int NAME = ...;`` of the sources rewritten to it;
``--csrc LABEL=DIR`` builds another checkout's sources as they stand
(their entry points must take the same arguments); ``--flags`` adds nvcc
flags to every build (``--flags=-fmad=false``). ``--lib`` picks the
library: ``tracer`` (pvt_trace), ``score`` (pvt_trace_score) or
``pathwise`` (pvt_trace_pathwise). Each build is one nvcc, all started
together, into a temporary directory under ``_build/``; ``--sass`` also
prints, from ``cuobjdump -sass``, each function's instruction count and
its count of each opcode of SASS_OPS (local-memory loads and stores,
shared-memory atomics, the integer adds, logic and shifts of the ALU pipe
against the multiply-adds of the FMA pipe, global and shared loads).
Then every run of the library's (the slab at 2**20 and at its path's
full size, K5b, the mesh LSC without and with the event log (at
``record_every`` 1000 and 1), recorders up to 256 and the heatmap's
global bins, the tessellated slab's 140 triangles, the host-lit slab's
bundle, the mixed scene's Lambertian facet, lifetimes and two lamps), or
those of ``--only``, goes through each build in turns, ``--rounds``
times, every other round in the reverse order: the kernel's time
(``last_trace["ms"]``), its lane efficiency, steps and lane-steps, its
fates, longest photon and recorder tallies.
Prints one line a run and build (the atomics of ``--sass`` by full
opcode, ``ATOMS.CAST.SPIN`` being a compare-and-swap loop), and the
card's nvidia-smi line; exits non-zero when the builds' fates, longest
photon, distinct rays, crossings or bins differ, or their moment sums
part by more than ``check.SUMS_RUNS_RTOL``. ``--entries`` times, in
place of the runs, the tracer library's standalone entries as
``chip_smoke.py`` does (pvt_emit and pvt_step on 2**20 lanes of the
slab, pvt_tally with 32 recorders, pvt_mesh on 24 and 140 triangles, the
K11 row: pvt_trace with the event log on 2**14 photons of the mesh LSC
at ``record_every=1``), ``--reps`` calls a build in turns, ``--rounds``
times, which build goes first alternating. Needs a CUDA device.
"""
import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from pvtrace_tpu_torch import kernels
from pvtrace_tpu_torch.diff import transport
from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, tally, tracer
from pvtrace_tpu_torch.engine.emit import emit_bundle
from pvtrace_tpu_torch.kernels import build, check
from pvtrace_tpu_torch.scenes import (lsc_slab, lsc_slab_heatmap, lsc_slab_host,
                                      lsc_slab_recorders, mesh_lsc, mesh_slab_fine, mixed_scene)

# Each library's runs: (label, scene, photons, PVTRACE_TPU_NO_CHEB, host
# bundle, seed[, record_every]). The score and pathwise runs trace with
# score channels, the pathwise ones with the slab's index and thickness
# channels too (the mesh LSC's plate index). The slab with 4 recorders and
# the mesh LSC at 2**27, with and without the event log, take
# chip_smoke.py's seeds of phases 11 and 15.
RUNS = {
    "tracer": (
        ("slab", lsc_slab, 1 << 20, False, False, 1),
        ("slab", lsc_slab, 1 << 27, False, False, 1),
        ("slab K5b", lsc_slab, 1 << 27, True, False, 1),
        ("mesh LSC", mesh_lsc, 1 << 27, False, False, 15),
        ("mesh LSC log=1000", mesh_lsc, 1 << 27, False, False, 15, 1000),
        ("mesh LSC log=1", mesh_lsc, 1 << 17, False, False, 15, 1),
        ("slab R=4", lambda: lsc_slab_recorders(4), 1 << 27, False, False, 4),
        ("slab R=32", lambda: lsc_slab_recorders(32), 1 << 24, False, False, 1),
        ("slab R=256", lambda: lsc_slab_recorders(256), 1 << 24, False, False, 1),
        ("heatmap", lsc_slab_heatmap, 1 << 24, False, False, 1),
        ("fine slab", mesh_slab_fine, 1 << 24, False, False, 1),
        ("host-lit slab, bundle", lsc_slab_host, 1 << 20, False, True, 1),
        ("mixed", mixed_scene, 1 << 24, False, False, 1),
    ),
    "score": (
        ("slab", lsc_slab, 1 << 20, False, False, 1),
        ("slab", lsc_slab, 1 << 24, False, False, 1),
        ("mesh LSC", mesh_lsc, 1 << 22, False, False, 1),
        ("slab R=32", lambda: lsc_slab_recorders(32), 1 << 22, False, False, 1),
    ),
}
RUNS["pathwise"] = RUNS["score"]
PATHWISE = {"mesh LSC": [("n", "plate")]}
SLAB_PATHWISE = [("n", "lsc"), ("size", "lsc", 2)]
SASS_OPS = ("LDL", "STL", "ATOMS", "IADD3", "LOP3", "SHF", "IMAD", "IMAD.IADD", "FFMA", "MUFU",
            "SHFL", "LDG", "LDS", "BRA")


def _sources(directory, name=None, value=None):
    """A copy of the csrc `directory` in a new temporary directory, with
    ``constexpr int name = ...;`` set to `value` when `name` is given."""
    out, hits = Path(tempfile.mkdtemp(dir=build.BUILD_DIR)), 0
    for path in Path(directory).iterdir():
        text = path.read_text()
        if name is not None:
            text, k = re.subn(rf"constexpr int {name} = [^;]+;",
                              f"constexpr int {name} = {value};", text)
            hits += k
        (out / path.name).write_text(text)
    if name is not None and hits != 1:
        raise SystemExit(f"variants: {hits} definitions of {name} in {directory}, not 1")
    return out


def build_variants(variants, lib, flags=()):
    """{label: csrc directory} built into library `lib` (nvcc `flags`
    added), one nvcc each, all at once: {label: (loaded library, its
    path)}."""
    jobs = {}
    for label, csrc in variants.items():
        path = csrc / f"lib{lib}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *build.LIBRARY_FLAGS.get(lib, ()), *flags,
               "-o", str(path), str(csrc / build.LIBRARIES[lib])]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), path)
    libs = {}
    for label, (proc, path) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")
        handle = ctypes.CDLL(str(path))
        for entry, argtypes in kernels._ENTRIES[lib].items():
            if not hasattr(handle, entry):
                continue  # an entry another checkout's sources do not have
            fn = getattr(handle, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[label] = (handle, path)
    return libs


def sass_counts(path):
    """{function: Counter of its SASS: "all" instructions and the opcodes of
    SASS_OPS, by base name ("IMAD") and, where listed, with a modifier
    ("IMAD.IADD")} of the library at `path`."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = build.short_name(m.group(1))
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)((?:\.\w+)*)",
                     line)
        if m and name:
            counts[name]["all"] += 1
            op, mods = m.group(1), m.group(2).split(".")
            for key in {op, ".".join([op] + mods[1:2])}:
                if key in SASS_OPS:
                    counts[name][key] += 1
            if op.startswith(("ATOM", "RED")):
                counts[name]["atomic " + op + ".".join(mods)] += 1
    return counts


def time_entries(libs, rounds, reps):
    """The tracer library's standalone entries (``--entries``) of each
    build in `libs`, in turns, as chip_smoke.py times them: pvt_emit and
    pvt_step on 2**20 lanes of the slab, pvt_tally (phase 7: the events of
    the eighth step of those lanes with 32 recorders, after seven), pvt_mesh
    (phase 12: 2**20 rays against the hex plate's 24 triangles and the
    tessellated slab's 140) and the log trace: {entry: {label: [mean ms of
    `reps` calls, a round]}}."""
    seed = rng.key_words(1)
    st = scene_tensors(compile_scene(lsc_slab()), dtype=torch.float32, device="cuda")
    st_log = scene_tensors(compile_scene(mesh_lsc()), dtype=torch.float32, device="cuda")
    st32 = scene_tensors(compile_scene(lsc_slab_recorders(32)), dtype=torch.float32,
                         device="cuda")
    state = tracer.initial_state(st, seed, torch.arange(1 << 20, device="cuda"))
    events, t32 = state, tally.empty(st32, 1 << 20)
    for step in range(8):
        events = tracer.step_state(st32, events, 1000, 0)
        if step < 7:
            tally.tally(t32, st32, events)
    words, res = kernels.pack_seen(t32["seen"]).contiguous(), kernels.zero_tally_out(st32)
    meshes = {}
    for label, make in (("24", mesh_lsc), ("140", mesh_slab_fine)):
        st_m = st_log if label == "24" else scene_tensors(compile_scene(make()),
                                                          dtype=torch.float32, device="cuda")
        meshes[label] = (st_m, *check.mesh_rays(st_m, 1, 1 << 20, seed=12))

    def log_ms():
        total = 0.0
        for _ in range(reps):
            kernels.trace(st_log, seed, 1 << 14, record_every=1, max_events=128)
            total += kernels.last_trace["ms"]
        return total / reps

    entries = {
        "pvt_emit": lambda: check.cuda_ms(lambda: kernels.emit(st, seed, 0, 1 << 20), reps),
        "pvt_step": lambda: check.cuda_ms(lambda: kernels.step(st, state), reps),
        "pvt_tally R=32": lambda: check.cuda_ms(
            lambda: kernels.launch_tally(st32, events, words, res), reps),
        **{f"pvt_mesh {label} triangles": (lambda m=m: check.cuda_ms(
            lambda: kernels.mesh(m[0], 1, m[1], m[2]), reps)) for label, m in meshes.items()},
        "pvt_trace_log": log_ms,
    }
    ms = {e: {v: [] for v in libs} for e in entries}
    for r in range(rounds):
        for e, fn in entries.items():
            # Every other round in the reverse order, so no build always goes first.
            for v, (handle, _) in list(libs.items())[::-1 if r % 2 else 1]:
                kernels._libs["tracer"] = handle
                ms[e][v].append(fn())
    return ms


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--set", default=None, help="NAME=V1,V2,..")
    parser.add_argument("--csrc", action="append", default=[], help="LABEL=DIR")
    parser.add_argument("--lib", default="tracer", choices=sorted(RUNS))
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--flags", default="", help="extra nvcc flags, space-separated")
    parser.add_argument("--only", default=None,
                        help="LABEL:LOG2N,.. runs to take (default: every run of --lib)")
    parser.add_argument("--entries", action="store_true")
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("variants: needs a CUDA device")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variants = {}
    if args.set:
        name, values = args.set.split("=")
        for v in values.split(","):
            variants[f"{name}={v}"] = _sources(build.CSRC, name, v)
    for item in args.csrc:
        label, directory = item.split("=", 1)
        variants[label] = _sources(directory)
    variants = variants or {"this": _sources(build.CSRC)}
    libs = build_variants(variants, args.lib, args.flags.split())
    if args.sass:
        for v, (_, path) in libs.items():
            for fn, c in sass_counts(path).items():
                atomics = sorted(k for k in c if k.startswith("atomic "))
                print(f"sass {args.lib} {v} {fn}: {c['all']} instructions, "
                      + ", ".join(f"{op} {c[op]}" for op in SASS_OPS)
                      + "".join(f", {k[7:]} {c[k]}" for k in atomics), flush=True)
    if args.entries:
        for e, by_build in time_entries(libs, args.rounds, args.reps).items():
            for v, t in by_build.items():
                print(f"entry {e}, {v}: ms {t} ({args.reps} calls a round)", flush=True)
    only = set() if args.entries else None if args.only is None else set(args.only.split(","))
    differ = []
    for label, make, n, no_cheb, host, seed_value, *every in RUNS[args.lib]:
        if only is not None and f"{label}:{n.bit_length() - 1}" not in only:
            continue
        seed = rng.key_words(seed_value)
        if no_cheb:
            os.environ["PVTRACE_TPU_NO_CHEB"] = "1"
        try:
            scene = make()
            compiled = compile_scene(scene)
            st = scene_tensors(compiled, dtype=torch.float32, device="cuda")
        finally:
            os.environ.pop("PVTRACE_TPU_NO_CHEB", None)
        bundle = None
        if host:
            np.random.seed(24)
            bundle = torch.from_numpy(tracer.bundle_rows(*emit_bundle(scene, n)[:3],
                                                         np.float32)).cuda()
        run = {"bundle": bundle, "record_every": every[0] if every else 0}
        if args.lib != "tracer":
            run["score"] = True
        if args.lib == "pathwise":
            run["pathwise"] = transport.resolve_pathwise_params(
                compiled, PATHWISE.get(label, SLAB_PATHWISE))
        ms, eff, fates, sums, steps = {v: [] for v in libs}, {}, {}, {}, {}
        R = st["meta"]["n_rec"]
        for r in range(args.rounds):
            # Every other round in the reverse order, so no build always goes first.
            for v, (handle, _) in list(libs.items())[::-1 if r % 2 else 1]:
                kernels._libs[args.lib] = handle
                got, longest, t, _ = kernels.trace(st, seed, n, **run)
                ms[v].append(kernels.last_trace["ms"])
                eff[v] = kernels.last_trace["lane_efficiency"] \
                    if kernels.last_trace["lane_steps"] else float("nan")
                steps[v] = (kernels.last_trace["total_steps"], kernels.last_trace["lane_steps"])
                fates[v] = (got.cpu().tolist(), longest,
                            *(t[k][:R].cpu().tolist() for k in ("distinct", "cross")),
                            t["bins"].cpu().tolist())
                sums[v] = t["sums"][:R].double().cpu()
        first, first_sums = next(iter(fates.values())), next(iter(sums.values()))
        for v in libs:
            rel = float(((sums[v] - first_sums).abs()
                         / first_sums.abs().clamp(min=1e-30)).max()) if R else 0.0
            bad = fates[v] != first or rel > check.SUMS_RUNS_RTOL
            print(f"{args.lib} {label}, {n} photons, {v}: kernel ms {ms[v]}, lane efficiency "
                  f"{eff[v]:.4f} (steps {steps[v][0]}, lane-steps {steps[v][1]}), fates "
                  f"{fates[v][0]}, longest {fates[v][1]}, distinct {fates[v][2][:8]}, sums "
                  f"within {rel:.3g} of the first build's{' DIFFER' if bad else ''}", flush=True)
            if bad and label not in differ:
                differ.append(label)
    for csrc in variants.values():
        shutil.rmtree(csrc, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if differ:
        raise SystemExit(f"variants: fates or rays differ between builds: {differ}")


if __name__ == "__main__":
    main()
