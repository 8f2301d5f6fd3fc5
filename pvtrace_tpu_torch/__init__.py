"""pvtrace_tpu_torch — the PyTorch + CUDA port of pvtrace_tpu.

The scene API (nodes, geometry, materials, lights) and the scene
compiler are framework-free and are shared with ``pvtrace_tpu`` rather
than copied: a scene built from the names re-exported here compiles to
the same ``CompiledScene`` the JAX package traces. What differs is the
engine: ``pvtrace_tpu_torch.engine.simulate`` traces on an NVIDIA GPU
through hand-written CUDA kernels (``pvtrace_tpu_torch.kernels``), with a
plain-PyTorch twin of every kernel for CPU tensors.

Importing this package imports ``torch`` and never ``jax``.
"""
from pvtrace_tpu.data import fluro_red, lumogen_f_red_305
from pvtrace_tpu.geometry.box import Box
from pvtrace_tpu.geometry.cylinder import Cylinder
from pvtrace_tpu.geometry.sphere import Sphere
from pvtrace_tpu.light.event import Event
from pvtrace_tpu.light.light import (
    CircularMask,
    ConstantWavelengthMask,
    CubeMask,
    Light,
    RectangularMask,
    SpectrumWavelengthMask,
    circular_mask,
    cube_mask,
    rectangular_mask,
)
from pvtrace_tpu.material.component import Absorber, Luminophore, Reactor, Scatterer
from pvtrace_tpu.material.distribution import Distribution
from pvtrace_tpu.material.material import Material
from pvtrace_tpu.material.surface import (
    FacetOverride,
    FacetOverrideSurfaceDelegate,
    FresnelSurfaceDelegate,
    NullSurfaceDelegate,
    Surface,
)
from pvtrace_tpu.material.utils import (
    Cone,
    HenyeyGreenstein,
    cone,
    henyey_greenstein,
    isotropic,
    lambertian,
)
from pvtrace_tpu.scene.node import Node
from pvtrace_tpu.scene.scene import Scene

from pvtrace_tpu_torch import engine

__version__ = "0.1.0"
