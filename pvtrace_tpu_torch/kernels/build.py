"""Build the CUDA kernels with nvcc into shared libraries for ctypes.

Four libraries, one per translation unit of ``csrc/``: ``tracer`` (the
score-free kernels), ``score`` (K12: the score instantiations of the trace
kernel, ``pvt_score``, ``pvt_fresnel``), ``pathwise`` (K13: the
instantiations with pathwise channels, ``pvt_pathwise``) and ``diff``
(K15); and the float64 build of each, ``tracer_f64``, ``score_f64``,
``pathwise_f64`` and ``diff_f64`` (``-DPVT_F64``: every real of the
headers a double), which float64 tensors launch. They go to
``pvtrace_tpu_torch/kernels/_build/`` (listed in ``.gitignore``), named by
a hash of the sources and flags, so a build happens at first use and
again only when a source changes; ``build_all`` starts one nvcc per
library, all at once. Run ``python -m pvtrace_tpu_torch.kernels.build``
to build ahead of use and print nvcc's registers, stack frame and spills
of every function (``ptxas_rows``); with ``--against DIR`` it builds
every library from this checkout's ``csrc/`` and from DIR (another
checkout's, e.g. a ``git archive`` of the parent) into a temporary
directory and prints, library by library, whether nvcc's report and the
device code (``cuobjdump -sass``, the anonymous namespace's tag, which
nvcc derives from the source's path, masked) are equal, each function
whose report differs, and each function whose device code differs (with
what another function's change moves in it made equal: ``functions``).
"""
import argparse
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# Library name -> its translation unit; every one includes headers of csrc/.
LIBRARIES = {"tracer": "tracer.cu", "score": "score.cu", "pathwise": "pathwise.cu",
             "diff": "diff.cu", "tracer_f64": "tracer.cu", "score_f64": "score.cu",
             "pathwise_f64": "pathwise.cu", "diff_f64": "diff.cu"}
# Flags a library adds to NVCC_FLAGS.
LIBRARY_FLAGS = {name: ("-DPVT_F64",) for name in LIBRARIES if name.endswith("_f64")}
SOURCES = ("tracer.cu", "score.cu", "pathwise.cu", "diff.cu", "tracer.cuh", "trace_kernel.cuh",
           "diff.cuh")
# No --use_fast_math: log1p, sqrt and division stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def library_path(name="tracer"):
    """Path of library `name` for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LIBRARY_FLAGS.get(name, ())).encode()
                       + name.encode())
    for source in SOURCES:
        h.update((CSRC / source).read_bytes())
    prefix = "libpvtrace_kernels" if name == "tracer" else f"libpvtrace_{name}"
    return BUILD_DIR / f"{prefix}_{h.hexdigest()[:16]}.so"


def _start(name, csrc=CSRC, directory=BUILD_DIR):
    """Start nvcc on library `name` of the sources in `csrc` into a
    temporary file in `directory`: (process, tmp, cmd)."""
    directory.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=directory)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *LIBRARY_FLAGS.get(name, ()), "-o", tmp,
           str(Path(csrc) / LIBRARIES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def _finish(name, proc, tmp, cmd):
    try:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        os.replace(tmp, library_path(name))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names=tuple(LIBRARIES)):
    """Build the libraries `names` that are missing, one nvcc each, all
    started together; returns {name: (path, nvcc report or None when it
    was already built)}."""
    started = {name: _start(name) for name in names if not library_path(name).exists()}
    done = {name: (library_path(name), None) for name in names if name not in started}
    for name, job in started.items():
        done[name] = (library_path(name), _finish(name, *job))
    return done


def build(name="tracer"):
    """Build library `name` if it is missing; returns (path, nvcc report),
    the report being None when the library was already built."""
    return build_all((name,))[name]


def short_name(mangled):
    """A function's name from its mangled one (an anonymous namespace
    left out), a trace instantiation's with its template flags:
    ``trace_kernel<0,0,0,0,0,0>``."""
    at = 3 if mangled.startswith("_ZN") else 2
    while True:
        m = re.match(r"\d+", mangled[at:])
        if not m:
            return mangled
        k, at = int(m.group()), at + m.end()
        name, at = mangled[at:at + k], at + k
        if not name.startswith("_GLOBAL__N"):
            break
    flags = re.match(r"I((?:Lb[01]E)+)E", mangled[at:])
    return name + (f"<{','.join(re.findall(r'Lb([01])E', flags.group(1)))}>" if flags else "")


def ptxas_rows(report):
    """nvcc's ``-Xptxas -v`` report as one row a function: (name,
    registers or None for a function kept out of line, stack frame bytes,
    spill stores, spill loads)."""
    order, regs, frames, current = [], {}, {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            current = m.group(1)
            if current not in order:
                order.append(current)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and current:
            frames[current] = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            regs[current] = int(m.group(1))
    return [(short_name(f), regs.get(f), *frames.get(f, (0, 0, 0))) for f in order]


def device_code(path):
    """The SASS of the library at `path` (``cuobjdump -sass``) with the
    anonymous namespace's path-derived tag masked."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}", "_GLOBAL__N__", text)


def functions(sass):
    """{function's short name: its SASS} of ``device_code``'s text, with
    what one function's change moves in every other's text made equal:
    each instruction without its encoding and its column padding (both
    set library-wide), the branch labels (``.L_x_N``, numbered across the
    library) renumbered from 0 in the order they first appear in the
    function, and the slots of constant bank 4 (the addresses of the
    library's global tables, such as the trig reduction's, in the order
    the library first uses them) masked."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # device_code masked the namespace's tag: give its length back.
            name = short_name(m.group(1).replace("_GLOBAL__N__", "_GLOBAL__N__00000000"))
            out[name] = []
        elif name:
            out[name].append(line)
    renumbered = {}
    for k, lines in out.items():
        labels = {}
        text = "\n".join(" ".join(re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line).split())
                         for line in lines)
        text = re.sub(r"c\[0x4\]\[[^\]]*\]", "c[0x4][.]", text)
        renumbered[k] = re.sub(r"\.L_x_(\d+)",
                               lambda m: f".L_x_{labels.setdefault(m.group(1), len(labels))}",
                               text)
    return renumbered


def compare(other):
    """Builds every library from CSRC and from `other` (a csrc directory),
    one nvcc each, all at once, and prints whether each library's nvcc
    report and device code are equal, and the rows that differ."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = {(label, name): _start(name, csrc, Path(tmp)) for label, csrc in
                (("this", CSRC), ("other", Path(other))) for name in LIBRARIES}
        rows, code = {}, {}
        for key, (proc, so, cmd) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            rows[key], code[key] = ptxas_rows(out), device_code(so)
        for name in LIBRARIES:
            a, b = rows["this", name], rows["other", name]
            same_code = code["this", name] == code["other", name]
            print(f"{name}: {len(a)} functions, nvcc report "
                  f"{'equal' if sorted(a) == sorted(b) else 'differs'}, device code "
                  f"{'equal' if same_code else 'differs'}", flush=True)
            for row in sorted(set(a) ^ set(b)):
                print(f"  {'this' if row in a else 'other'}: {row[0]} {row[1]}/{row[2]}/{row[3]}/"
                      f"{row[4]}")
            if not same_code:
                fa, fb = functions(code["this", name]), functions(code["other", name])
                print(f"  device code equal: {sorted(f for f in fa if fa[f] == fb.get(f))}")
                differ = sorted(f for f in fa.keys() | fb.keys() if fa.get(f) != fb.get(f))
                print(f"  device code differs: {differ}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", default=None, help="another checkout's csrc directory")
    args = parser.parse_args()
    if args.against:
        compare(args.against)
        raise SystemExit(0)
    for name, (path, report) in build_all().items():
        print(path)
        for fn, regs, stack, stores, loads in ptxas_rows(report or ""):
            print(f"  {fn}: {regs if regs is not None else '-'} registers, {stack} bytes stack, "
                  f"{stores} bytes spill stores, {loads} bytes spill loads")
