"""Analytic spectra for Coumarin Fluro Red.

Parity: reference ``pvtrace/data/fluro_red.py`` — the fit parameters are
physical data describing the dye (four-Gaussian absorption fit and an
exponentially modified Gaussian emission fit), reproduced for the
validation scenes.
"""
import numpy as np
from scipy.special import erf

_ABS_GAUSSIANS = (
    (439.06754804626956, 549.06438843562137, 24.298601639828647),
    (85.177292848284353, 379.48645797468572, 13.513987279089216),
    (660.1731296017241, 519.58858977131513, 38.263352007649125),
    (511.11501615291041, 490.05625608592726, 52.213294432464529),
)

# Exponentially modified Gaussian emission fit (a, b, c, d)
_EMS_EMG = (1.1477763237584664, 592.06478874548839, 19.981040318195117, 12.723704058786568)


def absorption(x):
    """Absorption coefficient spectrum normalised to peak 1.0."""
    x = np.asarray(x, dtype=float)
    spec = np.zeros_like(x)
    for a, p, w in _ABS_GAUSSIANS:
        spec += a * np.exp(-(((p - x) / w) ** 2))
    return spec / np.max(spec)


def emission(x):
    """Emission spectrum normalised to peak 1.0."""
    x = np.asarray(x, dtype=float)
    a, b, c, d = _EMS_EMG
    r2 = np.sqrt(2)
    return (
        a
        * c
        * np.sqrt(2 * np.pi)
        / (2 * d)
        * np.exp((c ** 2 / (2 * d ** 2)) - ((x - b) / d))
        * (d / np.abs(d) + erf((x - b) / (r2 * c) - c / (r2 * d)))
    )
