"""Volume physics components attachable to a Material.

Parity: reference ``pvtrace/material/component.py`` — class hierarchy
Component -> Scatterer -> (Absorber -> Reactor, Luminophore), quantum
yield from `quantum_yield` or (tau_rad, tau_nr), emission sampling with
kT / redshift / full truncation, exponential lifetime delays.

The class/argument surface matches the reference for API compatibility;
the internals are organised around three module-level helpers
(`build_spectrum`, `resolve_quantum_yield`, `exponential_delay`) that the
scene compiler also reaches into when lowering components to device
tables.  Random draw order inside each method is a compatibility
contract pinned by the golden-history tests: phase function first, then
wavelength, then lifetime delay.
"""
from dataclasses import replace
from typing import Callable, Optional, Union

import numpy as np

from pvtrace_tpu_torch.light.ray import Ray
from pvtrace_tpu_torch.material.distribution import Distribution
from pvtrace_tpu_torch.material.utils import gaussian, isotropic

#: Boltzmann constant in eV/K (CODATA k_B divided by the elementary charge).
KB_EV = 1.380649e-23 / 1.60217662e-19

#: hc/e in nm·eV — converts between photon wavelength and energy.
EV_NM = 1240.0


def build_spectrum(values, x=None, hist=False) -> Distribution:
    """Coerce any of the accepted spectrum forms into a Distribution.

    Accepted forms (shared by attenuation and emission spectra):

    * a scalar — constant over all wavelengths;
    * an ``(N, 2)`` array of ``(wavelength, value)`` rows;
    * a list/tuple of callables summed over the grid `x`.
    """
    if values is None:
        raise ValueError("Coefficient must be specified.")
    if isinstance(values, (float, int)):
        return Distribution(x=None, y=float(values), hist=hist)
    if isinstance(values, np.ndarray):
        return Distribution(x=values[:, 0], y=values[:, 1], hist=hist)
    if isinstance(values, (list, tuple)):
        if x is None:
            raise ValueError("Requires `x`.")
        return Distribution.from_functions(x, values, hist=hist)
    raise ValueError("Unsupported coefficient type.")


def resolve_quantum_yield(quantum_yield, tau_rad, tau_nr) -> float:
    """Quantum yield from lifetimes when both are given, else the explicit value.

    With both lifetimes the radiative branching ratio is
    ``(1/tau_rad) / (1/tau_rad + 1/tau_nr) = tau_nr / (tau_nr + tau_rad)``.
    """
    if tau_rad is not None and tau_nr is not None:
        qy = tau_nr / (tau_nr + tau_rad)
    elif quantum_yield is not None:
        qy = quantum_yield
    else:
        qy = np.nan
    if not np.isfinite(qy):
        raise ValueError(
            "Specify either `quantum yield` or both `tau_rad` and `tau_nr`"
        )
    return float(qy)


def exponential_delay(tau: float) -> float:
    """One draw from the single-exponential lifetime distribution (consumes
    exactly one uniform — part of the draw-order contract)."""
    return -np.log(1 - np.random.uniform()) * tau


class Component(object):
    """Base class for things added to a host material."""

    def __init__(self, name: str = "Component"):
        super(Component, self).__init__()
        self.name = name

    def is_radiative(self, ray):
        return False

    def nonradiative_absorb(self, ray):
        return ray


class Scatterer(Component):
    """Scattering centre with attenuation coefficient per unit length."""

    def __init__(
        self,
        coefficient: Union[float, list, tuple, np.ndarray],
        x=None,
        quantum_yield: Optional[float] = 1.0,
        tau_rad: Optional[float] = None,
        tau_nr: Optional[float] = None,
        phase_function: Optional[Callable] = None,
        hist: bool = False,
        name: str = "Scatterer",
    ):
        """The argument surface mirrors the reference (component.py:52-139):
        a constant or spectral `coefficient` (see `build_spectrum`), quantum
        yield either explicit or derived from the lifetime pair, and an
        optional phase function (isotropic when omitted)."""
        super(Scatterer, self).__init__(name=name)
        self._coefficient = coefficient
        self._abs_dist = build_spectrum(coefficient, x=x, hist=hist)
        self.quantum_yield = resolve_quantum_yield(quantum_yield, tau_rad, tau_nr)
        self.tau_rad = tau_rad
        self.tau_nr = tau_nr
        self.phase_function = phase_function or isotropic

    def coefficient(self, wavelength):
        """Scattering coefficient at `wavelength`."""
        return self._abs_dist(wavelength)

    def is_radiative(self, ray):
        """Monte Carlo branch: radiative with probability `quantum_yield`."""
        return np.random.uniform() < self.quantum_yield

    def nonradiative_absorb(self, ray: Ray) -> Ray:
        """Apply a non-radiative lifetime delay when tau_nr is set."""
        if not self.tau_nr:
            return ray
        return replace(ray, duration=ray.duration + exponential_delay(self.tau_nr))

    def emit(self, ray: Ray, **kwargs) -> Ray:
        """Redirect the ray using the phase function."""
        return replace(
            ray, direction=tuple(self.phase_function()), source=self.name
        )


class Absorber(Scatterer):
    """Attenuates by purely non-radiative absorption (quantum yield 0)."""

    def __init__(self, coefficient, x=None, tau_nr=None, name="Absorber", hist=False):
        super(Absorber, self).__init__(
            coefficient,
            x=x,
            quantum_yield=0.0,
            tau_nr=tau_nr,
            tau_rad=0.0,
            phase_function=None,
            hist=hist,
            name=name,
        )

    def is_radiative(self, ray):
        return False


class Reactor(Absorber):
    """Absorbed photons drive a photochemical reaction (REACT event)."""

    def __init__(self, coefficient, x=None, name="Reactor", hist=False):
        super(Reactor, self).__init__(coefficient, x=x, hist=hist, name=name)


def _default_emission_grid(x, hist):
    """Fallback emission spectrum: unit Gaussian centred at 600 nm."""
    return Distribution.from_functions(
        x, [lambda w: gaussian(w, 1.0, 600.0, 40.0)], hist=hist
    )


class Luminophore(Scatterer):
    """Absorbs and re-emits light with a sampled emission spectrum."""

    def __init__(
        self,
        coefficient,
        emission=None,
        x=None,
        hist=False,
        quantum_yield=1.0,
        tau_rad=None,
        tau_nr=None,
        phase_function=None,
        name="Luminophore",
    ):
        super(Luminophore, self).__init__(
            coefficient,
            x=x,
            quantum_yield=quantum_yield,
            tau_rad=tau_rad,
            tau_nr=tau_nr,
            phase_function=phase_function,
            hist=hist,
            name=name,
        )
        self._emission = emission
        if emission is None:
            self._ems_dist = _default_emission_grid(x, hist)
        else:
            # A constant emission "spectrum" has no CDF to invert, so a
            # scalar is a construction-time error (reference raises the
            # same message, material/component.py:273-340).
            if isinstance(emission, (float, int)):
                raise ValueError("Luminophore `emission` arg has wrong type.")
            try:
                self._ems_dist = build_spectrum(emission, x=x, hist=hist)
            except ValueError as err:
                if "Requires `x`" in str(err):
                    raise
                raise ValueError("Luminophore `emission` arg has wrong type.")

    def _emission_cdf_floor(self, wavelength_nm, method, T):
        """Lower CDF bound for emission sampling.

        ``'full'`` samples the whole spectrum; ``'redshift'`` forbids any
        energy gain (floor at the absorbed wavelength); ``'kT'`` lets the
        emitted photon gain up to 3/2·kB·T of thermal energy (Boltzmann,
        three degrees of freedom) before truncating — reference
        component.py:381-440.  Out-of-grid wavelengths are clamped to the
        spectrum support rather than erroring (robustness improvement
        over the reference, which raises).
        """
        if method == "full":
            return 0.0
        if method == "kT":
            thermal_ev = EV_NM / wavelength_nm + 1.5 * KB_EV * T
            wavelength_nm = EV_NM / thermal_ev
        elif method != "redshift":
            raise ValueError("emit_method must be one of 'kT', 'redshift', 'full'")
        dist = self._ems_dist
        return dist.lookup(np.clip(wavelength_nm, *dist._x_range))

    def emit(self, ray: Ray, method="kT", T=300.0, **kwargs) -> Ray:
        """Sample a new direction, wavelength and delay for the emitted ray.

        Draw order (pinned by golden tests): phase function, then the
        truncated inverse-CDF wavelength draw, then the radiative
        lifetime delay.
        """
        new_direction = tuple(self.phase_function())
        floor = self._emission_cdf_floor(ray.wavelength, method, T)
        new_wavelength = self._ems_dist.sample(np.random.uniform(floor, 1.0))
        delay = exponential_delay(self.tau_rad) if self.tau_rad else 0.0
        return replace(
            ray,
            direction=new_direction,
            wavelength=new_wavelength,
            source=self.name,
            duration=ray.duration + delay,
        )
