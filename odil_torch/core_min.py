"""A geometry-only Domain for plotting and post-processing.

The port's counterpart of ``odil_tpu/core_min.py`` (numpy only): the
constructor keywords and ``points_1d`` of the full ``Domain``, with no
tensors and no device, so that scripts replot saved data without torch on a
card.  Cell centres sit half a step past an endpoint-free linspace; nodes
are the closed linspace over ``cshape + 1`` points, as in ``grid.Domain``.
"""

import numpy as np

__all__ = ["Domain"]

_DEFAULTS = dict(lower=0.0, upper=1.0, dimnames=None, dtype=None, cshape=None)


class Domain:
    def __init__(self, domain=None, ndim=None, lower=None, upper=None, dimnames=None, dtype=None, cshape=None):
        # Explicit keywords win; otherwise the source domain's (a full Domain
        # or another core_min.Domain), then the defaults.
        given = dict(lower=lower, upper=upper, dimnames=dimnames, dtype=dtype, cshape=cshape)
        for name, value in given.items():
            if value is None:
                value = getattr(domain, name, None) if domain is not None else None
            if value is None:
                value = _DEFAULTS[name]
            given[name] = value

        self.cshape = tuple(int(n) for n in given["cshape"])
        self.ndim = len(self.cshape)
        names = given["dimnames"]
        self.dimnames = list(names) if names else list("xyzw"[: self.ndim])
        self.dtype = given["dtype"]
        self.lower = np.full(self.ndim, given["lower"], dtype=self.dtype)
        self.upper = np.full(self.ndim, given["upper"], dtype=self.dtype)

    def _dim_indices(self, dims):
        if not dims:
            dims = range(self.ndim)
        return tuple(self.dimnames.index(d) if isinstance(d, str) else d for d in dims)

    def _points_1d(self, d, loc):
        lo, hi, n = self.lower[d], self.upper[d], self.cshape[d]
        if loc == "n":
            return np.linspace(lo, hi, n + 1, dtype=self.dtype)
        if loc != "c":
            raise ValueError(f"Unknown loc={loc}")
        x = np.linspace(lo, hi, n, endpoint=False, dtype=self.dtype)
        return x + (x[1] - x[0]) * 0.5 if n > 1 else x

    def points_1d(self, *dims, loc=None):
        loc = loc or "c" * self.ndim
        axes = [self._points_1d(i, c) for i, c in zip(self._dim_indices(dims), loc)]
        return axes[0] if len(dims) == 1 else axes
