"""Spectral distribution container with inverse-CDF Monte Carlo sampling.

Parity: reference ``pvtrace/material/distribution.py`` — trapezoid CDF in
interpolation mode, step CDF in histogram mode, `__call__`/`lookup`/
`sample` trio. The precomputed (x, y, cdf) grids are exactly what the
scene compiler lowers to device tables.
"""
import numpy as np

from pvtrace_tpu_torch.geometry.utils import allinrange


def _scalarise(values):
    """Return a python float for size-1 results, the array otherwise."""
    if np.size(values) == 1:
        return float(np.asarray(values).ravel()[0])
    return values


class Distribution(object):
    """Statistical distribution over a wavelength grid.

    Two sampling modes share one API: interpolation mode treats `y` as
    vertex values with a trapezoid-rule CDF; histogram mode (`hist=True`)
    treats `y` as bin counts with a step CDF and no interpolation. A
    scalar `y` with `x=None` is a wavelength-independent constant.
    """

    def __init__(self, x, y, hist=False):
        self.hist = hist
        if x is None and isinstance(y, (float, int)):
            self._x = None
            self._y = float(y)
            return

        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        if not np.all(np.diff(x) > 0):
            raise ValueError("x must be sorted and ascending.")
        if not np.isfinite(y).any():
            raise ValueError("All values of y must be finite.")
        if np.any(y < 0.0):
            raise ValueError(
                "Distributions are like histograms all counts must be positive."
            )
        self._x = x
        self._y = y
        self._x_range = (float(x[0]), float(x[-1]))
        if hist:
            cdf = np.cumsum(y, dtype=float)
            self._cdf = cdf / cdf[-1]
            # Right edge of the last bin mirrors the final grid spacing.
            self._edges = np.append(x, 2 * x[-1] - x[-2])
        else:
            # Trapezoid-rule cumulative integral, normalised to 1.
            areas = 0.5 * (y[:-1] + y[1:])
            cdf = np.cumsum(areas)
            self._cdf = np.concatenate([[0.0], cdf / np.max(cdf)])

    def _check_domain(self, x):
        if not allinrange(x, self._x_range):
            raise ValueError(
                "x is outside data range.", {"x": x, "x_range": self._x_range}
            )

    def _bin_of(self, x):
        return np.searchsorted(self._edges[:-1], x)

    def __call__(self, x):
        """Value of the distribution at `x` (interpolated or histogram)."""
        if self._x is None:
            if isinstance(x, (list, tuple, np.ndarray)):
                return np.zeros(len(x)) + self._y
            return self._y
        self._check_domain(x)
        if self.hist:
            return self._y[self._bin_of(x)]
        return np.interp(x, self._x, self._y, left=np.nan, right=np.nan)

    def lookup(self, x):
        """CDF probability corresponding to the value `x`."""
        self._check_domain(x)
        if self.hist:
            return self._cdf[self._bin_of(x)]
        return _scalarise(
            np.interp(x, self._x, self._cdf, left=np.nan, right=np.nan)
        )

    def sample(self, p):
        """Inverse-CDF sample: x-value corresponding to probability `p`."""
        if not allinrange(p, (0.0, 1.0)):
            raise ValueError("p is outside valid range.")
        if self.hist:
            pick = np.minimum(
                np.searchsorted(self._cdf, p), len(self._x) - 1
            )
            return _scalarise(self._x[pick])
        return _scalarise(
            np.interp(p, self._cdf, self._x, left=np.nan, right=np.nan)
        )

    @classmethod
    def from_functions(cls, x, callables, hist=False):
        """Sum of callables evaluated on grid `x` (non-finite values zeroed)."""
        x = np.asarray(x, dtype=float)
        if x.ndim != 1:
            raise ValueError("Requires a 1D array.")
        total = np.zeros(len(x))
        for fn in callables:
            contribution = np.asarray(fn(x), dtype=float)
            contribution[~np.isfinite(contribution)] = 0.0
            total = total + contribution
        return cls(x=x, y=total, hist=hist)
