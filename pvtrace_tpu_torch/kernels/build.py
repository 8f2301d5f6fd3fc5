"""Build the CUDA kernels with nvcc into shared libraries for ctypes.

Four libraries, one per translation unit of ``csrc/``: ``tracer`` (the
score-free kernels), ``score`` (K12: the score instantiations of the trace
kernel, ``pvt_score``, ``pvt_fresnel``), ``pathwise`` (K13: the
instantiations with pathwise channels, ``pvt_pathwise``) and ``diff``
(K15); and a fifth, ``tracer_f64``, the float64 build of ``tracer.cu``
(``-DPVT_F64``: every real of ``tracer.cuh`` a double), which float64
scene tensors launch. They go to
``pvtrace_tpu_torch/kernels/_build/`` (listed in ``.gitignore``), named by
a hash of the sources and flags, so a build happens at first use and
again only when a source changes; ``build_all`` starts one nvcc per
library, all at once. Run ``python -m pvtrace_tpu_torch.kernels.build``
to build ahead of use and print nvcc's registers, stack frame and spills
of every function (``ptxas_rows``).
"""
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
             "diff": "diff.cu", "tracer_f64": "tracer.cu"}
# Flags a library adds to NVCC_FLAGS.
LIBRARY_FLAGS = {"tracer_f64": ("-DPVT_F64",)}
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


def _start(name):
    """Start nvcc on library `name` into a temporary file: (process, tmp, cmd)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *LIBRARY_FLAGS.get(name, ()), "-o", tmp,
           str(CSRC / LIBRARIES[name])]
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


if __name__ == "__main__":
    for name, (path, report) in build_all().items():
        print(path)
        for fn, regs, stack, stores, loads in ptxas_rows(report or ""):
            print(f"  {fn}: {regs if regs is not None else '-'} registers, {stack} bytes stack, "
                  f"{stores} bytes spill stores, {loads} bytes spill loads")
