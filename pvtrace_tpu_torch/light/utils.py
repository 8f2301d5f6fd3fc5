"""Wavelength to colour conversion for visualisation.

Parity: reference ``pvtrace/light/utils.py`` (standard CIE-approximate
piecewise formula with intensity roll-off at the visible band edges).
"""


def wavelength_to_rgb(wavelength, gamma=0.8):
    """Approximate RGB (0..1 floats) for a wavelength in nm (380-750)."""
    wavelength = float(wavelength)
    if wavelength < 380:
        wavelength = 380.0
    if wavelength > 750:
        wavelength = 750.0
    if 380 <= wavelength <= 440:
        attenuation = 0.3 + 0.7 * (wavelength - 380) / (440 - 380)
        r = ((-(wavelength - 440) / (440 - 380)) * attenuation) ** gamma
        g = 0.0
        b = attenuation ** gamma
    elif 440 <= wavelength <= 490:
        r = 0.0
        g = ((wavelength - 440) / (490 - 440)) ** gamma
        b = 1.0
    elif 490 <= wavelength <= 510:
        r = 0.0
        g = 1.0
        b = (-(wavelength - 510) / (510 - 490)) ** gamma
    elif 510 <= wavelength <= 580:
        r = ((wavelength - 510) / (580 - 510)) ** gamma
        g = 1.0
        b = 0.0
    elif 580 <= wavelength <= 645:
        r = 1.0
        g = (-(wavelength - 645) / (645 - 580)) ** gamma
        b = 0.0
    else:
        attenuation = 0.3 + 0.7 * (750 - wavelength) / (750 - 645)
        r = attenuation ** gamma
        g = 0.0
        b = 0.0
    return (r, g, b)


def rgb_to_hex_int(rgb):
    """(r, g, b) floats in 0..1 to a 0xRRGGBB integer."""
    r, g, b = (int(max(0.0, min(1.0, c)) * 255) for c in rgb)
    return (r << 16) | (g << 8) | b


def wavelength_to_hex_int(wavelength):
    return rgb_to_hex_int(wavelength_to_rgb(wavelength))
