"""Build the CUDA kernels with nvcc into a shared library for ctypes.

The library goes to ``pvtrace_tpu_torch/kernels/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so a build
happens at first use and again only when a source changes. Run
``python -m pvtrace_tpu_torch.kernels.build`` to build ahead of use and
print nvcc's register and spill report.
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
SOURCES = ("tracer.cu", "tracer.cuh")
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


def library_path():
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libpvtrace_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Build the library if it is missing; returns (path, nvcc report),
    the report being None when the library was already built."""
    lib = library_path()
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / "tracer.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


if __name__ == "__main__":
    path, report = build()
    print(path)
    if report:
        print(report, file=sys.stderr)
