"""pvtrace_tpu_torch — the PyTorch + CUDA port of pvtrace_tpu.

The port keeps its own copy of the JAX package's framework-free host
layers, under the same sub-paths: the scene API (nodes, geometry,
materials, lights, ``scene``), the per-ray oracle
(``algorithm.photon_tracer``), the scene compiler and recorder specs
(``engine.compiler``, ``engine.recorder``) and the result objects
(``engine.result``). Each copy differs from its original only in its
imports. A scene built from the names re-exported here compiles, with
the port's compiler, to the same tables as the same scene built from
``pvtrace_tpu`` with the JAX package's. What differs is the engine:
``pvtrace_tpu_torch.engine.simulate`` traces on an NVIDIA GPU through
hand-written CUDA kernels (``pvtrace_tpu_torch.kernels``), with a
plain-PyTorch twin of every kernel for CPU tensors, from lights emitted
on the device or, where the compiler cannot lower them, on the host
(``engine.emit``). ``pvtrace_tpu_torch.parallel`` shards a run over a
``torch.distributed`` process group, one process per device;
``pvtrace_tpu_torch.diff.transport`` has the gradients.

Importing this package imports ``torch``, never ``jax``, and nothing of
``pvtrace_tpu``.
"""
from pvtrace_tpu_torch.data import fluro_red, lumogen_f_red_305
from pvtrace_tpu_torch.engine.recorder import Heatmap, Histogram, Recorder
from pvtrace_tpu_torch.geometry.box import Box
from pvtrace_tpu_torch.geometry.cylinder import Cylinder
from pvtrace_tpu_torch.geometry.mesh import Mesh
from pvtrace_tpu_torch.geometry.sphere import Sphere
from pvtrace_tpu_torch.light.event import Event
from pvtrace_tpu_torch.light.light import (
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
from pvtrace_tpu_torch.material.component import Absorber, Luminophore, Reactor, Scatterer
from pvtrace_tpu_torch.material.distribution import Distribution
from pvtrace_tpu_torch.material.material import Material
from pvtrace_tpu_torch.material.surface import (
    FacetOverride,
    FacetOverrideSurfaceDelegate,
    FresnelSurfaceDelegate,
    NullSurfaceDelegate,
    Surface,
)
from pvtrace_tpu_torch.material.utils import (
    Cone,
    HenyeyGreenstein,
    cone,
    henyey_greenstein,
    isotropic,
    lambertian,
)
from pvtrace_tpu_torch.scene.node import Node
from pvtrace_tpu_torch.scene.scene import Scene

from pvtrace_tpu_torch import engine

__version__ = "0.1.0"
