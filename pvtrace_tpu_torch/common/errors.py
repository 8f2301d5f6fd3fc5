"""Exception hierarchy.

Parity: reference ``pvtrace/common/errors.py:1-13``.
"""


class AppError(Exception):
    """Catch-all application error."""


class TraceError(AppError):
    """Raised when the ray tracing algorithm has a problem."""


class GeometryError(AppError):
    """Raised when geometrical attributes cannot be computed."""
