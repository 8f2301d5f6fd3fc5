"""Material: refractive index + surface + volume components.

Parity: reference ``pvtrace/material/material.py`` — Beer-Lambert
penetration-depth sampling and component roulette proportional to the
attenuation coefficient.  Each sampling method consumes exactly one
uniform draw; the engine compiler lowers the same distributions to
device tables so the oracle and the device tracer stay statistically
interchangeable.
"""
from typing import Tuple

import numpy as np

from pvtrace_tpu_torch.material.component import Component
from pvtrace_tpu_torch.material.surface import Surface


class Material(object):
    """A bulk optical medium: one refractive index, one surface model and
    any number of attenuating volume components."""

    def __init__(self, refractive_index: float, surface=None, components=None):
        self.refractive_index = refractive_index
        self.surface = surface if surface is not None else Surface()
        self.components = list(components) if components is not None else []

    def _component_coefficients(self, wavelength: float) -> np.ndarray:
        """Attenuation coefficient of every component at `wavelength`."""
        return np.array([c.coefficient(wavelength) for c in self.components])

    def total_attenutation_coefficient(self, wavelength: float) -> float:
        """Sum of component attenuation coefficients at `wavelength`.

        (Spelling kept for API parity with the reference.)
        """
        return float(self._component_coefficients(wavelength).sum())

    def is_absorbed(self, ray, full_distance) -> Tuple[bool, float]:
        """Beer-Lambert test over a segment of length `full_distance`:
        returns (absorbed?, sampled interaction depth)."""
        depth = self.penetration_depth(ray.wavelength)
        return depth < full_distance, depth

    def penetration_depth(self, wavelength: float) -> float:
        """Sample the Beer-Lambert penetration depth (cm).

        Transparent media (alpha ~ 0) never absorb (infinite depth); an
        infinite coefficient absorbs immediately.  Consumes one uniform.
        """
        alpha = self.total_attenutation_coefficient(wavelength)
        if np.isclose(alpha, 0.0):
            return float("inf")
        if not np.isfinite(alpha):
            return 0.0
        return -np.log(1 - np.random.uniform()) / alpha

    def component(self, wavelength: float) -> Component:
        """Monte Carlo roulette: which component absorbed the ray.

        Selection probability is proportional to each component's
        coefficient at this wavelength.  Consumes one uniform.
        """
        coefs = self._component_coefficients(wavelength)
        if (coefs < 0.0).any():
            raise ValueError("Must be positive.")
        cdf = np.cumsum(coefs)
        target = np.random.uniform() * cdf[-1]
        pick = min(int(np.searchsorted(cdf, target)), len(self.components) - 1)
        return self.components[pick]
