"""Time builds of one kernel library that differ in one constant, or in
their sources, against each other on the card, in turns.

    python -m pvtrace_tpu_torch.kernels.variants --set kMinBlocks=1,2
    python -m pvtrace_tpu_torch.kernels.variants --lib score --csrc parent=OTHER/csrc
    python -m pvtrace_tpu_torch.kernels.variants --lib tracer_f64 \
        --set "kBlockF64=128,192 kMinBlocksF64=5,3" --only "slab R=32,mesh LSC"

``--set NAME=V1,V2,..`` builds the library once for each value, with the
line ``constexpr int NAME = ...;`` of the sources rewritten to it; names
given together in one ``--set``, space-separated, take their i-th values
together in the i-th build, and ``--set`` may be given again;
``--csrc LABEL=DIR`` builds another checkout's sources as they stand
(their entry points must take the same arguments); ``--flags`` adds nvcc
flags to every build (``--flags=-fmad=false``). ``--lib`` picks the
library: ``tracer`` (pvt_trace), ``score`` (pvt_trace_score) or
``pathwise`` (pvt_trace_pathwise), or the float64 build of one of them
(``tracer_f64``, ``score_f64``, ``pathwise_f64``: the same runs on float64
scene tensors). Each build is one nvcc, all started
together, into a temporary directory under ``_build/``; ``--sass`` also
prints, from ``cuobjdump -sass``, each function's instruction count and
its count of each opcode of SASS_OPS (local-memory loads and stores,
shared-memory atomics, the integer adds, logic and shifts of the ALU pipe
against the multiply-adds of the FMA pipe, global and shared loads, the
float64 pipe's multiply-adds, products and sums).
Then every run of the library's (the slab at 2**20 and at its path's
full size, K5b, the mesh LSC without and with the event log (at
``record_every`` 1000 and 1), recorders up to 256 and the heatmap's
global bins, 256 recorders with the event log at 1000, the tessellated
slab's 140 triangles, the host-lit slab's bundle, without recorders and
with 4 and the log at 1000, the mesh LSC from a bundle with and without
the log, the slab with the log at 1, the mixed scene's Lambertian facet,
lifetimes and two lamps), or
those of ``--only`` (``LABEL:LOG2N``, or a label for all its sizes: ``--only
"slab R=32,mesh LSC"``), goes through each build in turns, ``--rounds``
times, every other round in the reverse order: the kernel's time
(``last_trace["ms"]``), its lane efficiency, steps and lane-steps, its
fates, longest photon and recorder tallies.
Prints one line a run and build (the atomics of ``--sass`` by full
opcode, ``ATOMS.CAST.SPIN`` being a compare-and-swap loop), and the
card's nvidia-smi line; exits non-zero when the builds' fates, steps,
longest photon, distinct rays, crossings or bins differ, when a run with
the event log packs any record or count that is not the first build's
bit for bit (``kernels.log_pack``), or when their moment sums part by
more than ``check.SUMS_RUNS_RTOL`` (``check.F64_RTOL`` for a float64
build). Each line names the instantiation the launch reported
(``last_trace["instantiation"]``). ``--entries`` times, in
place of the runs, the tracer library's (or ``tracer_f64``'s) standalone entries as
``chip_smoke.py`` does (pvt_emit and pvt_step on 2**20 lanes of the
slab, pvt_cheb on the slab's fits at 4096 t, pvt_tally with 32
recorders, pvt_mesh on 24 and 140 triangles, the K11 row: pvt_trace
with the event log on 2**14 photons of the mesh LSC at
``record_every=1``), ``--reps`` calls a build in turns, ``--rounds``
times, which build goes first alternating. ``--sincos`` counts, on the
card, the angles at which double ``sincos`` differs from ``sin`` and
``cos`` bit for bit: every angle 2 pi u a trace takes (u a float32
uniform, 2**23 of them) and 2**24 angles spread over [-1e6, 1e6] (the
float64 main path takes ``sincos``; ``tracer.cuh::pvt_sincos``). Needs a
CUDA device.
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
# chip_smoke.py's seeds of phases 11 and 15. "slab log=1" is simulate's
# default record_every on the bench slab (its dense float64 log 4 GB);
# the host-lit slab with 4 recorders is phase 36's bundle scene.
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
        ("slab R=32", lambda: lsc_slab_recorders(32), 1 << 27, False, False, 1),
        ("slab R=256", lambda: lsc_slab_recorders(256), 1 << 24, False, False, 1),
        ("slab R=256", lambda: lsc_slab_recorders(256), 1 << 27, False, False, 1),
        ("slab R=256, log=1000", lambda: lsc_slab_recorders(256), 1 << 24, False, False, 1,
         1000),
        ("heatmap", lsc_slab_heatmap, 1 << 24, False, False, 1),
        ("fine slab", mesh_slab_fine, 1 << 24, False, False, 1),
        ("fine slab", mesh_slab_fine, 1 << 27, False, False, 1),
        ("host-lit slab, bundle", lsc_slab_host, 1 << 20, False, True, 1),
        ("host-lit slab R=4, bundle", lambda: lsc_slab_host(n_rec=4), 1 << 20, False, True, 1),
        ("host-lit slab R=4, bundle", lambda: lsc_slab_host(n_rec=4), 1 << 24, False, True, 1),
        ("host-lit slab R=4, bundle, log=1000", lambda: lsc_slab_host(n_rec=4), 1 << 24, False,
         True, 1, 1000),
        ("slab log=1", lsc_slab, 1 << 18, False, False, 1, 1),
        ("mesh LSC, bundle", mesh_lsc, 1 << 24, False, True, 15),
        ("mesh LSC, bundle, log=1000", mesh_lsc, 1 << 24, False, True, 15, 1000),
        ("mixed", mixed_scene, 1 << 24, False, False, 1),
    ),
    "score": (
        ("slab", lsc_slab, 1 << 20, False, False, 1),
        ("slab", lsc_slab, 1 << 24, False, False, 1),
        ("slab", lsc_slab, 1 << 27, False, False, 1),
        ("mesh LSC", mesh_lsc, 1 << 22, False, False, 1),
        ("mesh LSC", mesh_lsc, 1 << 27, False, False, 1),
        ("slab R=32", lambda: lsc_slab_recorders(32), 1 << 22, False, False, 1),
        ("slab R=256", lambda: lsc_slab_recorders(256), 1 << 22, False, False, 1),
    ),
}
RUNS["pathwise"] = RUNS["score"]
for _kind in ("tracer", "score", "pathwise"):
    RUNS[f"{_kind}_f64"] = RUNS[_kind]
PATHWISE = {"mesh LSC": [("n", "plate")]}
SLAB_PATHWISE = [("n", "lsc"), ("size", "lsc", 2)]
# --sincos: angle i of n is 2 pi u_i, u_i = i 2**-23 in float32 (wide = 0),
# or spread over [-1e6, 1e6] (wide = 1); `bad` counts where sincos(phi)
# differs from (sin(phi), cos(phi)) in any bit.
SINCOS_CU = r"""
#include <cstdio>
__global__ void differ(long long n, int wide, unsigned long long* bad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double phi = wide ? (i - n / 2) * (2e6 / n) + 1e-3 * (i % 7)
                          : 6.283185307179586 * (double)((float)i * 1.1920928955078125e-7f);
  double s, c;
  sincos(phi, &s, &c);
  if (__double_as_longlong(s) != __double_as_longlong(sin(phi)) ||
      __double_as_longlong(c) != __double_as_longlong(cos(phi)))
    atomicAdd(bad, 1ull);
}
int main() {
  unsigned long long* bad;
  cudaMallocManaged(&bad, sizeof *bad);
  for (int wide = 0; wide < 2; ++wide) {
    const long long n = wide ? 1LL << 24 : 1LL << 23;
    *bad = 0;
    differ<<<(unsigned)((n + 255) / 256), 256>>>(n, wide, bad);
    if (cudaDeviceSynchronize() != cudaSuccess) return 1;
    printf("sincos against sin and cos, %s: %lld angles, %llu differ\n",
           wide ? "[-1e6, 1e6]" : "2 pi u", n, *bad);
  }
  return 0;
}
"""
SASS_OPS = ("LDL", "STL", "ATOMS", "IADD3", "LOP3", "SHF", "IMAD", "IMAD.IADD", "FFMA", "MUFU",
            "SHFL", "LDG", "LDS", "BRA", "CALL", "DFMA", "DMUL", "DADD")


def _sources(directory, values=None):
    """A copy of the csrc `directory` in a new temporary directory, with
    ``constexpr int NAME = ...;`` set to V for each NAME: V of `values`."""
    out, hits = Path(tempfile.mkdtemp(dir=build.BUILD_DIR)), collections.Counter()
    for path in Path(directory).iterdir():
        text = path.read_text()
        for name, value in (values or {}).items():
            text, k = re.subn(rf"constexpr int {name} = [^;]+;",
                              f"constexpr int {name} = {value};", text)
            hits[name] += k
        (out / path.name).write_text(text)
    for name in values or {}:
        if hits[name] != 1:
            raise SystemExit(f"variants: {hits[name]} definitions of {name} in {directory}, "
                             f"not 1")
    return out


def set_variants(spec):
    """The builds of one ``--set`` (``NAME=V1,V2 NAME2=W1,W2``): {label:
    {NAME: Vi, NAME2: Wi}} for each i."""
    columns = {}
    for item in spec.split():
        name, values = item.split("=")
        columns[name] = values.split(",")
    counts = {len(v) for v in columns.values()}
    if len(counts) != 1:
        raise SystemExit(f"variants: --set {spec!r} gives its names different numbers of values")
    builds = [dict(zip(columns, row)) for row in zip(*columns.values())]
    return {" ".join(f"{k}={v}" for k, v in b.items()): b for b in builds}


def build_variants(variants, lib, flags=()):
    """{label: csrc directory} built into library `lib` (nvcc `flags`
    added), one nvcc each, all at once: {label: (loaded library, its
    path)}. Prints each build's registers, stack and spills of every
    trace instantiation (nvcc's report)."""
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
        print(f"ptxas {lib} {label}: " + "; ".join(
            f"{fn} {regs}/{stack}/{stores}/{loads}" for fn, regs, stack, stores, loads
            in build.ptxas_rows(out) if fn.startswith("trace_kernel")), flush=True)
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


def time_entries(libs, rounds, reps, lib="tracer", real=torch.float32):
    """The tracer library's standalone entries (``--entries``; of
    ``tracer_f64`` on float64 tensors, `real`) of each build in `libs`, in
    turns, as chip_smoke.py times them: pvt_emit and
    pvt_step on 2**20 lanes of the slab, pvt_tally (phase 7: the events of
    the eighth step of those lanes with 32 recorders, after seven), pvt_cheb
    (phase 6: the slab's fits at 4096 t, the table in shared memory, graphed
    launches as ``check.check_cheb`` times them), pvt_mesh
    (phase 12: 2**20 rays against the hex plate's 24 triangles and the
    tessellated slab's 140) and the log trace: {entry: {label: [mean ms of
    `reps` calls, a round]}}."""
    seed = rng.key_words(1)
    st = scene_tensors(compile_scene(lsc_slab()), dtype=real, device="cuda")
    st_log = scene_tensors(compile_scene(mesh_lsc()), dtype=real, device="cuda")
    st32 = scene_tensors(compile_scene(lsc_slab_recorders(32)), dtype=real, device="cuda")
    state = tracer.initial_state(st, seed, torch.arange(1 << 20, device="cuda"))
    grid = torch.linspace(-1.0, 1.0, 4096, device="cuda", dtype=real)
    events, t32 = state, tally.empty(st32, 1 << 20)
    for step in range(8):
        events = tracer.step_state(st32, events, 1000, 0)
        if step < 7:
            tally.tally(t32, st32, events)
    words, res = kernels.pack_seen(t32["seen"]).contiguous(), kernels.zero_tally_out(st32)
    meshes = {}
    for label, make in (("24", mesh_lsc), ("140", mesh_slab_fine)):
        st_m = st_log if label == "24" else scene_tensors(compile_scene(make()), dtype=real,
                                                          device="cuda")
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
        "pvt_cheb": lambda: check.graph_ms(lambda: kernels.cheb(st, grid), reps),
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
                kernels._libs[lib] = handle
                ms[e][v].append(fn())
    return ms


def check_sincos():
    """Builds and runs SINCOS_CU on the card (``--sincos``): its lines."""
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src, exe = Path(tmp) / "sincos.cu", Path(tmp) / "sincos"
        src.write_text(SINCOS_CU)
        flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([build.nvcc_path(), *flags, "-o", str(exe), str(src)], check=True,
                       capture_output=True, timeout=600)
        return subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                              timeout=600).stdout


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--set", action="append", default=[],
                        help="NAME=V1,V2,.. [NAME2=W1,W2,..]")
    parser.add_argument("--csrc", action="append", default=[], help="LABEL=DIR")
    parser.add_argument("--lib", default="tracer", choices=sorted(RUNS))
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--flags", default="", help="extra nvcc flags, space-separated")
    parser.add_argument("--only", default=None,
                        help="LABEL:LOG2N or LABEL (every size),.. runs to take (default: "
                             "every run of --lib)")
    parser.add_argument("--entries", action="store_true")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--sincos", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("variants: needs a CUDA device")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if args.sincos:
        out = check_sincos()
        print(out, end="", flush=True)
        if re.search(r", [1-9]\d* differ", out):
            raise SystemExit("variants: sincos differs from sin and cos")
        if not (args.set or args.csrc):
            return
    if args.entries and args.lib not in ("tracer", "tracer_f64"):
        raise SystemExit("variants: --entries times the tracer library's entries")
    kind = args.lib.removesuffix("_f64")
    real = torch.float64 if args.lib.endswith("_f64") else torch.float32
    runs_rtol = check.F64_RTOL if real == torch.float64 else check.SUMS_RUNS_RTOL
    variants = {}
    for spec in args.set:
        for label, values in set_variants(spec).items():
            variants[label] = _sources(build.CSRC, values)
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
        for e, by_build in time_entries(libs, args.rounds, args.reps, args.lib, real).items():
            for v, t in by_build.items():
                print(f"entry {e}, {v}: ms {t} ({args.reps} calls a round)", flush=True)
    # Labels are split at commas not followed by a space ("host-lit slab, bundle").
    only = set() if args.entries else None if args.only is None else set(
        re.split(r",(?! )", args.only))
    differ = []
    for label, make, n, no_cheb, host, seed_value, *every in RUNS[args.lib]:
        if only is not None and not {label, f"{label}:{n.bit_length() - 1}"} & only:
            continue
        seed = rng.key_words(seed_value)
        if no_cheb:
            os.environ["PVTRACE_TPU_NO_CHEB"] = "1"
        try:
            scene = make()
            compiled = compile_scene(scene)
            st = scene_tensors(compiled, dtype=real, device="cuda")
        finally:
            os.environ.pop("PVTRACE_TPU_NO_CHEB", None)
        bundle = None
        if host:
            np.random.seed(24)
            bundle = torch.from_numpy(tracer.bundle_rows(
                *emit_bundle(scene, n)[:3], np.float64 if real == torch.float64 else np.float32
            )).cuda()
        run = {"bundle": bundle, "record_every": every[0] if every else 0}
        if kind != "tracer":
            run["score"] = True
        if kind == "pathwise":
            run["pathwise"] = transport.resolve_pathwise_params(
                compiled, PATHWISE.get(label, SLAB_PATHWISE))
        ms, eff, fates, sums, steps, placed = {v: [] for v in libs}, {}, {}, {}, {}, {}
        records, first_log = {}, None
        R = st["meta"]["n_rec"]
        for r in range(args.rounds):
            # Every other round in the reverse order, so no build always goes first.
            for v, (handle, _) in list(libs.items())[::-1 if r % 2 else 1]:
                kernels._libs[args.lib] = handle
                got, longest, t, log = kernels.trace(st, seed, n, **run)
                ms[v].append(kernels.last_trace["ms"])
                eff[v] = kernels.last_trace["lane_efficiency"] \
                    if kernels.last_trace["lane_steps"] else float("nan")
                steps[v] = (kernels.last_trace["total_steps"], kernels.last_trace["lane_steps"])
                placed[v] = {k: kernels.last_trace[k]
                             for k in ("instantiation", "block", *kernels._PLACEMENT)}
                fates[v] = (got.cpu().tolist(), longest, steps[v][0],
                            *(t[k][:R].cpu().tolist() for k in ("distinct", "cross")),
                            t["bins"].cpu().tolist())
                sums[v] = t["sums"][:R].double().cpu()
                if log is not None:
                    # Every record bit for bit against the first build's.
                    packed = (log["counts"], *kernels.log_pack(log))
                    first_log = first_log or packed
                    records[v] = (int(packed[1].shape[0]), all(
                        a.shape == b.shape and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                        for a, b in zip(packed, first_log)))
                    del log, packed
        first, first_sums = next(iter(fates.values())), next(iter(sums.values()))
        for v in libs:
            rel = float(((sums[v] - first_sums).abs()
                         / first_sums.abs().clamp(min=1e-30)).max()) if R else 0.0
            bad = fates[v] != first or rel > runs_rtol or not records.get(v, (0, True))[1]
            logged = f", {records[v][0]} log records, equal to the first build's: " \
                     f"{records[v][1]}" if v in records else ""
            print(f"{args.lib} {label}, {n} photons, {v}: kernel ms {ms[v]}, lane efficiency "
                  f"{eff[v]:.4f} (steps {steps[v][0]}, lane-steps {steps[v][1]}), placement "
                  f"{placed[v]}, fates "
                  f"{fates[v][0]}, longest {fates[v][1]}, distinct {fates[v][3][:8]}, sums "
                  f"within {rel:.3g} of the first build's{logged}{' DIFFER' if bad else ''}",
                  flush=True)
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
