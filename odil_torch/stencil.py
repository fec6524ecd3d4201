"""Ghost-cell extrapolation helpers and the 5-point stencil toolkit.

The port's own copy of ``odil_tpu/stencil.py`` (reference
``src/odil/core.py:1439-1561``).  Operators use the ``extrap_*`` helpers to
overwrite the periodic wraparound of shifted samples with boundary values;
they work on tensors and on numpy arrays alike.  ``Approx`` builds 5-point
stencils on a 2-D domain from ``domain.mod`` (rolls and selects on the
domain's device).
"""

import numpy as np

__all__ = ["extrap_quadh", "extrap_quad", "extrap_linear", "Approx", "struct_to_numpy"]


def extrap_quadh(u0, u1, u1p):
    """Quadratic extrapolation from points 0, 1, 1.5 to point 2."""
    return (u0 - 6 * u1 + 8 * u1p) / 3


def extrap_quad(u0, u1, u2):
    """Quadratic extrapolation from points 0, 1, 2 to point 3."""
    return u0 - 3 * u1 + 3 * u2


def extrap_linear(u0, u1):
    """Linear extrapolation from points 0, 1 to point 2."""
    return 2 * u1 - u0


class Approx:
    """Finite-difference helpers on a 2D domain: 5-point stencils, central
    derivatives, boundary extrapolation, vorticity."""

    def __init__(self, domain):
        self.domain = domain
        self.mod = domain.mod

    def stencil(self, q):
        "Returns [q, qxm, qxp, qym, qyp]."
        mod = self.mod
        return [q, mod.roll(q, 1, 0), mod.roll(q, -1, 0), mod.roll(q, 1, 1), mod.roll(q, -1, 1)]

    def stencil5(self, st):
        "Returns [qxmm, qxpp, qymm, qypp] from a 5-point stencil."
        mod = self.mod
        return [mod.roll(st[1], 1, 0), mod.roll(st[2], -1, 0), mod.roll(st[3], 1, 1), mod.roll(st[4], -1, 1)]

    def central(self, st):
        hx, hy = self.domain.step()
        q, qxm, qxp, qym, qyp = st
        return (qxp - qxm) / (2 * hx), (qyp - qym) / (2 * hy)

    def apply_bc_extrap_linear(self, st):
        "Linear extrapolation from inner cells into halo cells."
        nx, ny = self.domain.size()
        ix, iy = self.domain.indices()
        mod = self.mod
        st[1] = mod.where(ix == 0, extrap_linear(st[2], st[0]), st[1])
        st[2] = mod.where(ix == nx - 1, extrap_linear(st[1], st[0]), st[2])
        st[3] = mod.where(iy == 0, extrap_linear(st[4], st[0]), st[3])
        st[4] = mod.where(iy == ny - 1, extrap_linear(st[3], st[0]), st[4])
        return st

    def apply_bc_extrap_quad(self, st, st5):
        "Quadratic extrapolation into halo cells."
        nx, ny = self.domain.size()
        ix, iy = self.domain.indices()
        mod = self.mod
        st[1] = mod.where(ix == 0, extrap_quad(st5[1], st[2], st[0]), st[1])
        st[2] = mod.where(ix == nx - 1, extrap_quad(st5[0], st[1], st[0]), st[2])
        st[3] = mod.where(iy == 0, extrap_quad(st5[3], st[4], st[0]), st[3])
        st[4] = mod.where(iy == ny - 1, extrap_quad(st5[2], st[3], st[0]), st[4])
        return st

    def vorticity(self, u, v):
        u_st = self.stencil(u)
        v_st = self.stencil(v)
        self.apply_bc_extrap_quad(u_st, self.stencil5(u_st))
        self.apply_bc_extrap_quad(v_st, self.stencil5(v_st))
        _, u_y = self.central(u_st)
        v_x, _ = self.central(v_st)
        return v_x - u_y


def struct_to_numpy(mod, d):
    """Recursively converts the tensors in nested containers to numpy arrays
    (copied to the host)."""
    if mod.is_tensor(d):
        return mod.numpy(d)
    if isinstance(d, dict):
        return {k: struct_to_numpy(mod, v) for k, v in d.items()}
    if isinstance(d, list):
        return [struct_to_numpy(mod, v) for v in d]
    if isinstance(d, tuple):
        return tuple(struct_to_numpy(mod, v) for v in d)
    return d
