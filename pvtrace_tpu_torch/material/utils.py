"""Host-side optics: Fresnel formulae, spectral lineshapes, direction
samplers.

Role parity with the reference's ``pvtrace/material/utils.py``. These
numpy scalar versions serve the per-ray oracle tracer and scene
construction; the device tracer inlines vectorised jnp equivalents of
the same distributions. The per-sampler ``np.random`` draw ORDER is
part of the golden-test contract (seeded histories pin it) and must not
change.
"""
import numpy as np

from pvtrace_tpu_torch.geometry.utils import close_to_zero, flip

# Physical constants (SI), shared by the spectral helpers.
_PLANCK = 6.62607015e-34        # J s
_LIGHT_SPEED = 299792458.0      # m / s
_CHARGE = 1.60217662e-19        # C
_BOLTZMANN = 1.38064852e-23     # J / K
_NM_PER_EV = _PLANCK * _LIGHT_SPEED / _CHARGE * 1e9

_TAU = 2.0 * np.pi


# -- Fresnel -----------------------------------------------------------


def fresnel_reflectivity(angle, n1, n2):
    """Unpolarised reflectivity at an n1 -> n2 interface.

    Total internal reflection (angle beyond arcsin(n2/n1) when going
    into the rarer medium) returns exactly 1.
    """
    going_rarer = n2 < n1
    if going_rarer and angle > np.arcsin(n2 / n1):
        return 1.0
    incident_cos = np.cos(angle)
    refracted_cos = np.sqrt(1.0 - (n1 / n2 * np.sin(angle)) ** 2)
    s_pol = _amplitude(n1 * incident_cos, n2 * refracted_cos)
    p_pol = _amplitude(n1 * refracted_cos, n2 * incident_cos)
    return 0.5 * (s_pol + p_pol)


def _amplitude(a, b):
    """Squared Fresnel amplitude ratio ((a - b) / (a + b))^2."""
    return ((a - b) / (a + b)) ** 2


def specular_reflection(direction, normal):
    """Mirror `direction` about `normal` (auto-flipped along the ray)."""
    d = np.asarray(direction, dtype=float)
    n = np.asarray(normal, dtype=float)
    if n @ d < 0.0:
        n = flip(n)
    return d - 2.0 * (n @ d) * n


def fresnel_refraction(direction, normal, n1, n2):
    """Snell-bent transmitted direction.

    `normal` should point along the ray; the sign bookkeeping below
    keeps the result correct either way.
    """
    d = np.asarray(direction, dtype=float)
    n = np.asarray(normal, dtype=float)
    ratio = n1 / n2
    along = d @ n
    out_cos = np.sqrt(1.0 - ratio * ratio * (1.0 - along * along))
    orient = 1.0 if along >= 0.0 else -1.0
    return ratio * d + orient * (out_cos - orient * ratio * along) * n


# -- Lineshapes --------------------------------------------------------


def gaussian(x, c1, c2, c3):
    """Gaussian lineshape: amplitude c1, centre c2, width c3."""
    return c1 * np.exp(-(((c2 - x) / c3) ** 2))


def bandgap(x, cutoff, alpha):
    """Step absorption: `alpha` below the `cutoff` wavelength, 0 above."""
    return np.where(
        x < cutoff, alpha, np.where(x == cutoff, 0.5 * alpha, 0.0)
    )


def simple_convert_spectum(spec):
    """Re-express a (wavelength nm, value) spectrum on an energy (eV)
    axis. Involutive: applying it twice returns the input."""
    converted = np.array(spec, dtype=float)
    converted[:, 0] = _NM_PER_EV / converted[:, 0]
    return converted


def thermodynamic_emission(abs_spec, T=300, mu=0.5):
    """Emission implied by absorption via the generalised Planck law
    (Würfel relation), peak-normalised, on the wavelength axis.

    `mu` is the photon chemical potential in eV, `T` the temperature.
    """
    energy, absorptance = simple_convert_spectum(abs_spec).T
    kT_eV = (_BOLTZMANN / _CHARGE) * T
    density = 2.0 * energy ** 2 / (
        _LIGHT_SPEED ** 2 * (_PLANCK / _CHARGE) ** 3
    )
    flux = absorptance * density / np.expm1((energy - mu) / kT_eV)
    flux = flux / np.max(flux)
    return simple_convert_spectum(np.column_stack((energy, flux)))


# -- Coordinates -------------------------------------------------------


def spherical_to_cart(theta, phi, r=1):
    """(theta, phi[, r]) -> cartesian; vectorises over angle arrays."""
    sin_t = np.sin(theta)
    points = r * np.column_stack(
        (sin_t * np.cos(phi), sin_t * np.sin(phi), np.cos(theta))
    )
    return points[0, :] if points.size == 3 else points


# -- Direction samplers ------------------------------------------------
#
# Each sampler draws its uniforms in a FIXED order (golden tests).


def isotropic():
    """Uniform direction on the unit sphere."""
    u_phi, u_mu = np.random.uniform(0, 1, 2)
    return spherical_to_cart(np.arccos(2.0 * u_mu - 1.0), _TAU * u_phi)


def henyey_greenstein(g=0.0):
    """Henyey-Greenstein phase sample about +z (isotropic as g -> 0)."""
    if close_to_zero(g):
        return isotropic()
    s = 2.0 * np.random.uniform(0, 1) - 1.0
    mu = (1.0 + g * g - ((1.0 - g * g) / (1.0 + g * s)) ** 2) / (2.0 * g)
    return spherical_to_cart(np.arccos(mu), _TAU * np.random.uniform())


def cone(theta_max: float):
    """Uniform direction within a cone of half-angle `theta_max` about +z."""
    if np.isclose(theta_max, 0.0) or theta_max > np.pi / 2:
        raise ValueError("Expected 0 < theta_max <= pi/2")
    u_theta, u_phi = np.random.uniform(0, 1, 2)
    theta = np.arcsin(np.sqrt(u_theta) * np.sin(theta_max))
    return spherical_to_cart(theta, _TAU * u_phi)


def lambertian():
    """Cosine-weighted direction about +z (never negative z)."""
    u_theta, u_phi = np.random.uniform(0, 1, 2)
    return spherical_to_cart(np.arcsin(np.sqrt(u_theta)), _TAU * u_phi)


class HenyeyGreenstein:
    """Callable HG sampler carrying its asymmetry; the scene compiler
    recognises the class and lowers it to the device phase table."""

    def __init__(self, g: float):
        self.g = float(g)

    def __call__(self):
        return henyey_greenstein(self.g)


class Cone:
    """Callable cone sampler carrying its half-angle; compiler-lowered."""

    def __init__(self, theta_max: float):
        self.theta_max = float(theta_max)

    def __call__(self):
        return cone(self.theta_max)
