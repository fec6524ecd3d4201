"""Multigrid transfer operators: prolongation and restriction.

PyTorch counterpart of ``odil_tpu/transfer.py`` (reference
``src/odil/core.py:606-755``), with its own copy of the separable per-axis
rules:

- ``interp_to_finer``: per axis, 'n' (node) doubles resolution with
  midpoints, 'c' (cell) with weights (1,3)/4 and (3,1)/4 after padding one
  ghost value on each side by *linear extrapolation* (not periodic), '.'
  leaves the axis untouched.  Exact on linear fields.
- ``restrict_to_coarser``: 'n' full weighting [1,2,1]/4 with
  linear-extrapolation ghosts, 'c' pair averages.

Every rule is an exact 2-tap stencil.  ``interp_to_finer`` applies it per
axis as one dense matrix product with the (n_fine, n) prolongation matrix
that ``_interp_matrix`` builds from the stencil, on every device: a handful
of kernel launches per level instead of some thirty slice and interleave
kernels.  The matrices' entries are dyadic, and fp32 products stay in full
fp32 (``runtime.pin_fp32``), so the product agrees with the stencils to
rounding.  The split-operand dots of the JAX package work around the TPU
matrix unit and have no counterpart here.
"""

import functools
import math

import numpy as np
import torch

__all__ = ["interp_to_finer", "restrict_to_coarser"]

_METHODS = (None, "stack", "conv", "matmul")


def _axslice(ndim, axis, sl):
    out = [slice(None)] * ndim
    out[axis] = sl
    return tuple(out)


def _xp_of(u):
    return torch if torch.is_tensor(u) else np


def _stack(xs, axis, xp):
    return torch.stack(xs, dim=axis) if xp is torch else np.stack(xs, axis=axis)


def _cat(xs, axis, xp):
    return torch.cat(xs, dim=axis) if xp is torch else np.concatenate(xs, axis=axis)


def _interleave(a, b, axis, xp):
    """out[..., 2i, ...] = a[..., i, ...], out[..., 2i+1, ...] = b[..., i, ...]."""
    shape = list(a.shape)
    shape[axis] = 2 * shape[axis]
    return _stack([a, b], axis + 1, xp).reshape(shape)


def _pad_linear(u, axis, xp):
    """Appends one ghost entry on each side of `axis` by linear extrapolation."""
    nd = u.ndim
    left = 2 * u[_axslice(nd, axis, slice(0, 1))] - u[_axslice(nd, axis, slice(1, 2))]
    right = 2 * u[_axslice(nd, axis, slice(-1, None))] - u[_axslice(nd, axis, slice(-2, -1))]
    return _cat([left, u, right], axis, xp)


def _interp_axis(u, axis, loc, xp=None):
    xp = xp or _xp_of(u)
    nd = u.ndim
    if loc == ".":
        return u
    if loc == "n":
        head = u[_axslice(nd, axis, slice(0, -1))]
        tail = u[_axslice(nd, axis, slice(1, None))]
        fine = _interleave(head, (head + tail) * 0.5, axis, xp)
        return _cat([fine, u[_axslice(nd, axis, slice(-1, None))]], axis, xp)
    if loc == "c":
        # fine[2i] = (u[i-1] + 3 u[i]) / 4, fine[2i+1] = (3 u[i] + u[i+1]) / 4.
        p = _pad_linear(u, axis, xp)
        lo = p[_axslice(nd, axis, slice(0, -2))]
        mid = p[_axslice(nd, axis, slice(1, -1))]
        hi = p[_axslice(nd, axis, slice(2, None))]
        return _interleave((lo + 3 * mid) * 0.25, (3 * mid + hi) * 0.25, axis, xp)
    raise ValueError(f"Invalid loc character '{loc}'")


def _restrict_axis(u, axis, loc, xp):
    nd = u.ndim
    n = u.shape[axis]
    if loc == ".":
        return u
    if loc == "c":
        even = u[_axslice(nd, axis, slice(0, 2 * (n // 2), 2))]
        odd = u[_axslice(nd, axis, slice(1, 2 * (n // 2), 2))]
        return (even + odd) * 0.5
    if loc == "n":
        p = _pad_linear(u, axis, xp)
        a = p[_axslice(nd, axis, slice(0, n, 2))]
        b = p[_axslice(nd, axis, slice(1, n + 1, 2))]
        c = p[_axslice(nd, axis, slice(2, n + 2, 2))]
        return (a + 2 * b + c) * 0.25
    raise ValueError(f"Invalid loc character '{loc}'")


def _interp_matrix(n, loc, dtype=np.float64):
    """Dense (n_fine, n) one-level prolongation matrix along one axis: the
    separable rule applied to an identity (numpy).  The plain versions of
    the mg kernels contract with it; every entry is dyadic and exact."""
    eye = np.eye(n, dtype=np.float64)
    cols = _interp_axis(eye.T, 1, loc, np)
    return np.ascontiguousarray(cols.T).astype(dtype)


@functools.lru_cache(maxsize=64)
def _interp_matrix_on(n, loc, dtype, device):
    return torch.as_tensor(_interp_matrix(n, loc), dtype=dtype, device=device)


def _interp_axis_matmul(u, axis, loc):
    """``_interp_axis`` as one matrix product along `axis` (a tensor)."""
    if loc == ".":
        return u
    n = u.shape[axis]
    mat = _interp_matrix_on(n, loc, u.dtype, u.device)
    if axis == u.ndim - 1:
        return torch.matmul(u, mat.T)
    lead, trail = u.shape[:axis], u.shape[axis + 1 :]
    out = torch.matmul(mat, u.reshape(math.prod(lead), n, math.prod(trail)))
    return out.reshape(*lead, mat.shape[0], *trail)


def _check(u, loc, method):
    if method not in _METHODS:
        raise ValueError(f"Unknown method='{method}'")
    loc = loc or "c" * u.ndim
    if len(loc) != u.ndim:
        raise ValueError(f"Expected len(loc)=={u.ndim}, got loc='{loc}'")
    return loc


def interp_to_finer(u, loc=None, method=None, mod=None, depth=1):
    """Interpolates a tensor to a grid refined 2x along each active axis.

    loc: one character per axis -- 'c' (cell, n -> 2n), 'n' (node,
    n -> 2(n-1)+1), '.' (inactive).  `method` and `mod` are accepted for
    parity with the JAX package; every method gives the same product."""
    loc = _check(u, loc, method)
    for _ in range(depth):
        for axis in reversed(range(u.ndim)):
            u = _interp_axis_matmul(u, axis, loc[axis])
    return u


def restrict_to_coarser(u, loc=None, method=None, mod=None, depth=1):
    """Restricts a field to a grid coarsened 2x along each active axis."""
    loc = _check(u, loc, method)
    xp = _xp_of(u)
    for _ in range(depth):
        for axis, l in enumerate(loc):
            u = _restrict_axis(u, axis, l, xp)
    return u
