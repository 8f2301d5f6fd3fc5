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
prints, from ``cuobjdump -sass``, each trace instantiation's instruction
count and its local-memory loads and stores and shared-memory atomics.
Then every run of the library's (the slab at 2**20 and at its path's
full size, K5b, the mesh LSC, recorders, the host-lit slab's bundle)
goes through each build in turns, ``--rounds`` times: the kernel's time
(``last_trace["ms"]``), its lane efficiency and its fates and recorders'
distinct rays. Prints one line a run and build, and the card's
nvidia-smi line; exits non-zero when the builds' fates or rays differ.
Needs a CUDA device.
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
from pvtrace_tpu_torch.engine import compile_scene, rng, scene_tensors, tracer
from pvtrace_tpu_torch.engine.emit import emit_bundle
from pvtrace_tpu_torch.kernels import build
from pvtrace_tpu_torch.scenes import lsc_slab, lsc_slab_host, lsc_slab_recorders, mesh_lsc

# Each library's runs: (label, scene, photons, PVTRACE_TPU_NO_CHEB, host
# bundle, seed). The score and pathwise runs trace with score channels,
# the pathwise ones with the slab's index and thickness channels too (the
# mesh LSC's plate index). The slab with 4 recorders and the mesh LSC at
# 2**27 take chip_smoke.py's seeds of phases 11 and 15.
RUNS = {
    "tracer": (
        ("slab", lsc_slab, 1 << 20, False, False, 1),
        ("slab", lsc_slab, 1 << 27, False, False, 1),
        ("slab K5b", lsc_slab, 1 << 27, True, False, 1),
        ("mesh LSC", mesh_lsc, 1 << 27, False, False, 15),
        ("slab R=4", lambda: lsc_slab_recorders(4), 1 << 27, False, False, 4),
        ("slab R=32", lambda: lsc_slab_recorders(32), 1 << 24, False, False, 1),
        ("host-lit slab, bundle", lsc_slab_host, 1 << 20, False, True, 1),
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
SASS_OPS = ("LDL", "STL", "ATOMS")


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
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(path),
               str(csrc / build.LIBRARIES[lib])]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), path)
    libs = {}
    for label, (proc, path) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")
        handle = ctypes.CDLL(str(path))
        for entry, argtypes in kernels._ENTRIES[lib].items():
            fn = getattr(handle, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[label] = (handle, path)
    return libs


def sass_counts(path):
    """{trace instantiation: Counter of its SASS: "all" instructions and
    the opcodes of SASS_OPS} of the library at `path`."""
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
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and name:
            counts[name]["all"] += 1
            if m.group(1) in SASS_OPS:
                counts[name][m.group(1)] += 1
    return {k: v for k, v in counts.items() if k.startswith("trace_kernel")}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--set", default=None, help="NAME=V1,V2,..")
    parser.add_argument("--csrc", action="append", default=[], help="LABEL=DIR")
    parser.add_argument("--lib", default="tracer", choices=sorted(RUNS))
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--flags", default="", help="extra nvcc flags, space-separated")
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
                print(f"sass {args.lib} {v} {fn}: {c['all']} instructions, "
                      + ", ".join(f"{op} {c[op]}" for op in SASS_OPS), flush=True)
    differ = []
    for label, make, n, no_cheb, host, seed_value in RUNS[args.lib]:
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
        run = {"bundle": bundle}
        if args.lib != "tracer":
            run["score"] = True
        if args.lib == "pathwise":
            run["pathwise"] = transport.resolve_pathwise_params(
                compiled, PATHWISE.get(label, SLAB_PATHWISE))
        ms, eff, fates = {v: [] for v in libs}, {}, {}
        for _ in range(args.rounds):
            for v, (handle, _) in libs.items():
                kernels._libs[args.lib] = handle
                got, _, t, _ = kernels.trace(st, seed, n, **run)
                ms[v].append(kernels.last_trace["ms"])
                eff[v] = kernels.last_trace["lane_efficiency"] \
                    if kernels.last_trace["lane_steps"] else float("nan")
                fates[v] = (got.cpu().tolist(), t["distinct"][:st["meta"]["n_rec"]].cpu().tolist())
        first = next(iter(fates.values()))
        for v in libs:
            print(f"{args.lib} {label}, {n} photons, {v}: kernel ms {ms[v]}, lane efficiency "
                  f"{eff[v]:.4f}, fates {fates[v][0]}, distinct {fates[v][1][:8]}"
                  f"{'' if fates[v] == first else ' DIFFER'}", flush=True)
        if any(f != first for f in fates.values()):
            differ.append(label)
    for csrc in variants.values():
        shutil.rmtree(csrc, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if differ:
        raise SystemExit(f"variants: fates or rays differ between builds: {differ}")


if __name__ == "__main__":
    main()
