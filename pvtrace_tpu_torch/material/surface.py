"""Surface interface physics via the delegate pattern.

Parity: reference ``pvtrace/material/surface.py`` — `SurfaceDelegate`
protocol, Fresnel and Null delegates, and the `Surface` Monte Carlo coin
flip. Custom delegates work with the Python oracle tracer; the device
compiler recognises the built-in delegates plus the facet-override
delegates in ``pvtrace_tpu.device.lsc``.
"""
import abc
from dataclasses import replace
from typing import Tuple

import numpy as np

from pvtrace_tpu_torch.geometry.utils import angle_between, flip
from pvtrace_tpu_torch.material.utils import (
    fresnel_reflectivity,
    fresnel_refraction,
    specular_reflection,
)


class SurfaceDelegate(abc.ABC):
    """Interface for custom surface interactions."""

    @abc.abstractmethod
    def reflectivity(self, surface, ray, geometry, container, adjacent) -> float:
        """Reflectivity for this interaction (0 to 1)."""

    @abc.abstractmethod
    def reflected_direction(
        self, surface, ray, geometry, container, adjacent
    ) -> Tuple[float, float, float]:
        """Reflected direction unit vector (ix, iy, iz)."""

    @abc.abstractmethod
    def transmitted_direction(
        self, surface, ray, geometry, container, adjacent
    ) -> Tuple[float, float, float]:
        """Transmitted direction unit vector (ix, iy, iz)."""


class NullSurfaceDelegate(SurfaceDelegate):
    """Transmits every ray unchanged. Useful for counting."""

    def reflectivity(self, surface, ray, geometry, container, adjacent):
        return 0.0

    def reflected_direction(self, surface, ray, geometry, container, adjacent):
        raise NotImplementedError("This surface delegate does not reflect.")

    def transmitted_direction(self, surface, ray, geometry, container, adjacent):
        return ray.direction


def _interface(ray, geometry, container, adjacent):
    """(n1, n2, outgoing-oriented normal) for an interaction: indices of
    the medium the ray is in and the one behind the surface, with the
    surface normal flipped (if needed) to point along the ray."""
    n1 = container.geometry.material.refractive_index
    n2 = adjacent.geometry.material.refractive_index
    normal = geometry.normal(ray.position)
    if np.dot(normal, ray.direction) < 0.0:
        normal = flip(normal)  # tolerate either orientation convention
    return n1, n2, normal


class FresnelSurfaceDelegate(SurfaceDelegate):
    """Fresnel reflection and Snell refraction."""

    def reflectivity(self, surface, ray, geometry, container, adjacent):
        n1, n2, normal = _interface(ray, geometry, container, adjacent)
        incidence = angle_between(normal, np.asarray(ray.direction))
        return float(fresnel_reflectivity(incidence, n1, n2))

    def reflected_direction(self, surface, ray, geometry, container, adjacent):
        normal = geometry.normal(ray.position)
        return tuple(specular_reflection(ray.direction, normal).tolist())

    def transmitted_direction(self, surface, ray, geometry, container, adjacent):
        n1, n2, normal = _interface(ray, geometry, container, adjacent)
        return tuple(fresnel_refraction(ray.direction, normal, n1, n2).tolist())


# Facet override modes understood by both the oracle tracer and the
# device compiler.
OVERRIDE_MIRROR = 0            # perfect specular mirror (R = 1)
OVERRIDE_ABSORB = 1            # perfectly index-matched absorber (R = 0,
                               # transmitted direction unchanged)
OVERRIDE_LAMBERTIAN_MIRROR = 2 # perfect diffuse reflector (R = 1)


class FacetOverride:
    """Per-facet surface behaviour override.

    `normal` is the outward facet normal in the geometry's local frame;
    interactions whose surface normal matches within `atol` per
    component use `mode` instead of the base Fresnel behaviour.
    """

    def __init__(self, normal, mode, atol=1e-6):
        if mode not in (OVERRIDE_MIRROR, OVERRIDE_ABSORB, OVERRIDE_LAMBERTIAN_MIRROR):
            raise ValueError("Unknown facet override mode.")
        self.normal = tuple(float(v) for v in normal)
        self.mode = int(mode)
        self.atol = float(atol)


class FacetOverrideSurfaceDelegate(FresnelSurfaceDelegate):
    """Fresnel surface with per-facet overrides (mirrors, ideal solar
    cells, diffuse reflectors).

    This generalises the custom delegates the reference LSC device uses
    (device/lsc.py:22-86 OptionalMirrorAndSolarCell / AirGapMirror) into
    a declarative form the compiler can lower to device tables, so LSC
    scenes run on the TPU fast path instead of falling back to the
    per-ray tracer.
    """

    def __init__(self, overrides=None):
        super(FacetOverrideSurfaceDelegate, self).__init__()
        self.overrides = list(overrides) if overrides else []

    def _match(self, geometry, position):
        normal = np.asarray(geometry.normal(position), dtype=float)
        for override in self.overrides:
            if np.all(np.abs(np.asarray(override.normal) - normal) <= override.atol):
                return override
        return None

    def reflectivity(self, surface, ray, geometry, container, adjacent):
        override = self._match(geometry, ray.position)
        if override is not None:
            if override.mode in (OVERRIDE_MIRROR, OVERRIDE_LAMBERTIAN_MIRROR):
                return 1.0
            return 0.0  # OVERRIDE_ABSORB
        return super(FacetOverrideSurfaceDelegate, self).reflectivity(
            surface, ray, geometry, container, adjacent
        )

    def reflected_direction(self, surface, ray, geometry, container, adjacent):
        override = self._match(geometry, ray.position)
        if override is not None and override.mode == OVERRIDE_LAMBERTIAN_MIRROR:
            from pvtrace_tpu_torch.material.utils import lambertian

            # Sample about the normal flipped to the incidence side so the
            # outgoing direction returns into the container.
            normal = np.asarray(geometry.normal(ray.position), dtype=float)
            if np.dot(normal, ray.direction) > 0.0:
                normal = -normal
            z = np.array([0.0, 0.0, 1.0])
            sample = lambertian()
            if np.allclose(normal, z):
                return tuple(sample.tolist())
            if np.allclose(normal, -z):
                return tuple((-sample).tolist())
            axis = np.cross(z, normal)
            axis /= np.linalg.norm(axis)
            c = float(np.dot(z, normal))
            s = np.sqrt(1 - c * c)
            K = np.array(
                [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
            )
            R = np.identity(3) + s * K + (1 - c) * (K @ K)
            return tuple((R @ sample).tolist())
        return super(FacetOverrideSurfaceDelegate, self).reflected_direction(
            surface, ray, geometry, container, adjacent
        )

    def transmitted_direction(self, surface, ray, geometry, container, adjacent):
        override = self._match(geometry, ray.position)
        if override is not None and override.mode == OVERRIDE_ABSORB:
            return ray.direction
        return super(FacetOverrideSurfaceDelegate, self).transmitted_direction(
            surface, ray, geometry, container, adjacent
        )


class BaseSurface(abc.ABC):
    @property
    @abc.abstractmethod
    def delegate(self):
        """An object implementing the `SurfaceDelegate` protocol."""

    @abc.abstractmethod
    def is_reflected(self, ray, geometry, container, adjacent):
        """True when the ray is reflected."""

    @abc.abstractmethod
    def reflect(self, ray, geometry, container, adjacent):
        """Ray reflected from the interface."""

    @abc.abstractmethod
    def transmit(self, ray, geometry, container, adjacent):
        """Ray transmitted through the interface."""


class Surface(BaseSurface):
    """Monte Carlo surface event sampler driven by a delegate.

    The default delegate performs Fresnel reflection and refraction.
    """

    def __init__(self, delegate=None):
        super(Surface, self).__init__()
        self._delegate = FresnelSurfaceDelegate() if delegate is None else delegate

    @property
    def delegate(self):
        return self._delegate

    def is_reflected(self, ray, geometry, container, adjacent):
        """Coin flip against the delegate's reflectivity.

        R = 0 short-circuits WITHOUT consuming a uniform (part of the
        draw-order contract: null surfaces are draw-free)."""
        r = self.delegate.reflectivity(self, ray, geometry, container, adjacent)
        if not isinstance(r, (int, float)):
            raise ValueError("Reflectivity must be a number.")
        return r != 0.0 and np.random.uniform() < r

    def _redirect(self, method_name, ray, geometry, container, adjacent):
        method = getattr(self.delegate, method_name)
        direction = method(self, ray, geometry, container, adjacent)
        if not isinstance(direction, tuple) or len(direction) != 3:
            raise ValueError(
                f"Delegate method `{method_name}` should return a tuple "
                "of length 3."
            )
        return replace(ray, direction=direction)

    def reflect(self, ray, geometry, container, adjacent):
        return self._redirect(
            "reflected_direction", ray, geometry, container, adjacent
        )

    def transmit(self, ray, geometry, container, adjacent):
        return self._redirect(
            "transmitted_direction", ray, geometry, container, adjacent
        )
