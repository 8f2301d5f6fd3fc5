"""Light sources.

Role parity with the reference's ``pvtrace/light/light.py``: a source
is three delegate callables — wavelength(), position(), direction() —
sampled once per emitted ray. The mask classes below are the built-in
delegates the YAML schema can express; the scene compiler recognises
them by type and lowers them to device-side samplers, and the engine's
host bundle emission vectorises them (engine/emit.py), so custom
callables still work but take the per-ray path.

Every sampler draws its uniforms in a fixed order; seeded golden tests
depend on it.
"""
from typing import Iterator, Sequence

import numpy as np

from pvtrace_tpu_torch.light.ray import Ray


class Light(object):
    """A source assembled from three delegates.

    Undelegated aspects fall back to a monochromatic 555 nm ray leaving
    the node origin along local +z (reference light/light.py:159-233).
    """

    def __init__(self, wavelength=None, position=None, direction=None,
                 name="Light"):
        self.wavelength = wavelength or default_wavelength
        self.position = position or default_position
        self.direction = direction or default_direction
        self.name = name

    def emit(self, num_rays=None) -> Iterator[Ray]:
        """Yield `num_rays` rays sampled from the delegates."""
        for _ in range(num_rays or 0):
            yield Ray(
                wavelength=self.wavelength(),
                position=self.position(),
                direction=self.direction(),
                source=self.name,
            )


# -- default delegates -------------------------------------------------


def default_wavelength():
    return 555.0


def default_position():
    return (0.0, 0.0, 0.0)


def default_direction():
    return (0.0, 0.0, 1.0)


class DefaultWavelength(object):
    """Monochromatic 555 nm."""

    __call__ = staticmethod(default_wavelength)


class DefaultPosition(object):
    """Every ray starts at the node origin."""

    __call__ = staticmethod(default_position)


class DefaultDirection(object):
    """Every ray leaves along local +z."""

    __call__ = staticmethod(default_direction)


# -- position masks ----------------------------------------------------


def rectangular_mask(X, Y):
    """Uniform over the centred rectangle with half-widths (X, Y), z=0."""
    return (np.random.uniform(-X, X), np.random.uniform(-Y, Y), 0.0)


def circular_mask(radius: float) -> Sequence[float]:
    """Uniform over the centred disc of `radius`, z=0 (sqrt-radius law)."""
    azimuth = np.random.uniform(0, 2.0 * np.pi)
    rho = radius * np.sqrt(np.random.uniform())
    return (rho * np.cos(azimuth), rho * np.sin(azimuth), 0.0)


def cube_mask(X, Y, Z):
    """Uniform over the centred box with half-widths (X, Y, Z)."""
    return tuple(np.random.uniform(-h, h) for h in (X, Y, Z))


class RectangularMask(object):
    def __init__(self, x, y):
        self.x = float(x)
        self.y = float(y)

    def __call__(self):
        return rectangular_mask(self.x, self.y)


class CircularMask(object):
    def __init__(self, radius):
        self.radius = radius

    def __call__(self):
        return circular_mask(self.radius)


class CubeMask(object):
    def __init__(self, x, y, z):
        self.x = x
        self.y = y
        self.z = z

    def __call__(self):
        return cube_mask(self.x, self.y, self.z)


# -- wavelength masks --------------------------------------------------


class ConstantWavelengthMask(object):
    def __init__(self, nanometers):
        self.nanometers = float(nanometers)

    def __call__(self):
        return self.nanometers


class SpectrumWavelengthMask(object):
    """Inverse-CDF sampling of a spectral Distribution."""

    def __init__(self, distribution):
        self.distribution = distribution

    def __call__(self):
        return self.distribution.sample(np.random.uniform(0, 1))
