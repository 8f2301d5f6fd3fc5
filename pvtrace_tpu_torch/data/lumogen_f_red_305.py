"""Analytic spectra for BASF Lumogen F Red 305.

Parity: reference ``pvtrace/data/lumogen_f_red_305.py`` — the Gaussian
fit parameters are physical data describing the dye, reproduced here so
the default LSC device matches the reference device model.
"""
import numpy as np

# Gaussian fit parameters (amplitude, centre / nm, width / nm) for the
# absorption coefficient spectrum.
_ABS_GAUSSIANS = (
    (0.9454846839252642, 578.6167306868869, 22.69760939870020),
    (0.6430326869158796, 535.1850303736512, 28.63029894331116),
    (0.1243340609168971, 494.5721783546976, 13.98438275367119),
    (0.3651471532322375, 440.4679754085741, 34.91923613222621),
    (0.7042787252835550, 336.0548556730901, 34.24136755250487),
)


def absorption(x):
    """Absorption coefficient spectrum normalised to peak 1.0 for
    wavelengths `x` in nanometers (valid roughly 200-900 nm)."""
    x = np.asarray(x, dtype=float)
    spec = np.zeros_like(x)
    for a, p, w in _ABS_GAUSSIANS:
        spec += a * np.exp(-(((p - x) / w) ** 2))
    return spec / np.max(spec)


def emission(x):
    """Emission spectrum normalised to peak 1.0 (single Gaussian fit)."""
    x = np.asarray(x, dtype=float)
    return 1.0 * np.exp(-(((600.0 - x) / 38.60) ** 2))
