"""Build the CUDA kernels with nvcc into shared libraries for ctypes.

Four libraries, one per translation unit of ``csrc/``: ``tracer`` (the
score-free kernels), ``score`` (K12: the score instantiations of the trace
kernel, ``pvt_score``, ``pvt_fresnel``), ``pathwise`` (K13: the
instantiations with pathwise channels, ``pvt_pathwise``) and ``diff``
(K15). They go to
``pvtrace_tpu_torch/kernels/_build/`` (listed in ``.gitignore``), named by
a hash of the sources and flags, so a build happens at first use and
again only when a source changes; ``build_all`` starts one nvcc per
library, all at once. Run ``python -m pvtrace_tpu_torch.kernels.build``
to build ahead of use and print nvcc's register and spill report.
"""
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# Library name -> its translation unit; every one includes headers of csrc/.
LIBRARIES = {"tracer": "tracer.cu", "score": "score.cu", "pathwise": "pathwise.cu",
             "diff": "diff.cu"}
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + name.encode())
    for source in SOURCES:
        h.update((CSRC / source).read_bytes())
    prefix = "libpvtrace_kernels" if name == "tracer" else f"libpvtrace_{name}"
    return BUILD_DIR / f"{prefix}_{h.hexdigest()[:16]}.so"


def _start(name):
    """Start nvcc on library `name` into a temporary file: (process, tmp, cmd)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / LIBRARIES[name])]
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


if __name__ == "__main__":
    for name, (path, report) in build_all().items():
        print(path)
        if report:
            print(report, file=sys.stderr)
