"""Packaging for pvtrace_tpu.

Parity: reference setup.py — console script entry point, extras for the
optional layers. No native build step is required for the compute path
(JAX/XLA); the optional C++ mesh kernel builds via
``python -m pvtrace_tpu.native.build``.
"""
from setuptools import find_packages, setup

setup(
    name="pvtrace-tpu",
    version="0.1.0",
    description=(
        "TPU-native Monte Carlo photon transport for luminescent solar "
        "concentrators and non-imaging optics"
    ),
    packages=find_packages(exclude=("tests",)),
    package_data={
        "pvtrace_tpu.cli": ["schema.json"],
        "pvtrace_tpu.data": ["schema.sql"],
        "pvtrace_tpu.studio": ["static/*"],
        "pvtrace_tpu.native": ["*.cpp"],
        "pvtrace_tpu_torch.kernels": ["csrc/*.cu", "csrc/*.cuh"],
        "pvtrace_tpu_torch.cli": ["schema.json"],
        "pvtrace_tpu_torch.data": ["schema.sql"],
        "pvtrace_tpu_torch.studio": ["static/*"],
    },
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "jax",
        "pyyaml",
        "jsonschema",
        "pandas",
        "scipy",
    ],
    # The PyTorch + CUDA port, pvtrace_tpu_torch, needs torch.
    extras_require={"torch": ["torch"]},
    # The studio is dependency-free (stdlib HTTP + Server-Sent Events),
    # so unlike the reference there are no optional extras to install.
    entry_points={
        "console_scripts": [
            "pvtrace-tpu-cli = pvtrace_tpu.cli.main:app",
            "pvtrace-tpu-torch-cli = pvtrace_tpu_torch.cli.main:app",
        ]
    },
)
