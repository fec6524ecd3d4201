"""Ghost-cell extrapolation helpers.

The port's own copy of ``odil_tpu/stencil.py:19-31`` (reference
``src/odil/core.py:1439-1450``).  Operators use them to overwrite the
periodic wraparound of shifted samples with boundary values; they work on
tensors and on numpy arrays alike.
"""

__all__ = ["extrap_quadh", "extrap_quad", "extrap_linear"]


def extrap_quadh(u0, u1, u1p):
    """Quadratic extrapolation from points 0, 1, 1.5 to point 2."""
    return (u0 - 6 * u1 + 8 * u1p) / 3


def extrap_quad(u0, u1, u2):
    """Quadratic extrapolation from points 0, 1, 2 to point 3."""
    return u0 - 3 * u1 + 3 * u2


def extrap_linear(u0, u1):
    """Linear extrapolation from points 0, 1 to point 2."""
    return 2 * u1 - u0
