"""Poisson source inversion in an N-dimensional cube (ndim 1..6) with zero
Dirichlet boundary conditions.

PyTorch counterpart of ``odil_tpu/models/poisson.py:27-123``: a central
second-order Laplacian with quadratic-half ghost extrapolation through the
boundary value, and an optional multigrid-norm loss that appends the
residual restricted to coarser grids (``restrict_to_coarser``).  The
reference fields are computed in numpy on the host and cast to the
domain's device.  ``mesh=``/``partition=`` go to the Domain: the GSPMD
route without ``halo``, the per-shard route with it.
"""

import argparse

import numpy as np

from ..fields import State
from ..grid import Domain
from ..problem import Problem
from ..stencil import extrap_quadh
from ..transfer import restrict_to_coarser

__all__ = ["reference_solution", "reference_rhs", "discrete_rhs", "laplacian_dirichlet", "operator", "build"]


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _points(domain):
    pts = domain.points()
    pts = pts if isinstance(pts, tuple) else (pts,)
    return [_host(p) for p in pts]


def reference_solution(name, args, domain):
    pts = _points(domain)
    if name == "hat":
        p = 5
        u = np.prod([(1 - x) * x * 5 for x in pts], axis=0)
        return (u**p / (1 + u**p)) ** (1 / p)
    if name == "osc":
        k = args.osc_k
        x, y = pts
        return np.sin(np.pi * (k * x) ** 2) * np.sin(np.pi * y)
    raise ValueError("Unknown ref=" + name)


def reference_rhs(name, args, domain):
    if name != "osc":
        raise ValueError("Exact rhs only available for ref='osc'")
    x, y = _points(domain)
    pi, k = np.pi, args.osc_k
    return (
        (-4 * k**4 * pi**2 * x**2 - pi**2) * np.sin(k**2 * pi * x**2) + 2 * k**2 * pi * np.cos(k**2 * pi * x**2)
    ) * np.sin(pi * y)


def laplacian_dirichlet(center, minus, plus, steps, indices, sizes, mod):
    """Discrete Laplacian with zero-Dirichlet ghost cells: wrapped samples
    outside the boundary are overwritten by quadratic extrapolation through
    u=0 at the wall."""
    zero = mod.cast(0, center.dtype)
    lap = 0
    for d, (um, up) in enumerate(zip(minus, plus)):
        um = mod.where(indices[d] == 0, extrap_quadh(up, center, zero), um)
        up = mod.where(indices[d] == sizes[d] - 1, extrap_quadh(um, center, zero), up)
        lap = lap + (up - 2 * center + um) / steps[d] ** 2
    return lap


def discrete_rhs(u, domain, mod):
    """RHS consistent with the discretization: Laplacian of the reference."""
    ndim = domain.ndim
    steps = [domain.step_by_dim(d) for d in range(ndim)]
    indices = domain.indices()
    indices = indices if isinstance(indices, tuple) else (indices,)
    sizes = [domain.size(d) for d in range(ndim)]
    center = mod.cast(u, domain.dtype)
    minus = [mod.roll(center, 1, d) for d in range(ndim)]
    plus = [mod.roll(center, -1, d) for d in range(ndim)]
    return laplacian_dirichlet(center, minus, plus, steps, indices, sizes, mod)


def operator(ctx):
    domain = ctx.domain
    mod = domain.mod
    args = ctx.extra.args
    ndim = domain.ndim
    steps = [domain.step_by_dim(d) for d in range(ndim)]
    indices = ctx.indices()
    indices = indices if isinstance(indices, tuple) else (indices,)
    sizes = [ctx.size(d) for d in range(ndim)]

    center = ctx.field("u")
    minus = [ctx.field("u", *[-(d == j) for j in range(ndim)]) for d in range(ndim)]
    plus = [ctx.field("u", *[+(d == j) for j in range(ndim)]) for d in range(ndim)]

    fu = laplacian_dirichlet(center, minus, plus, steps, indices, sizes, mod) - ctx.extra.rhs
    res = [fu]
    # Multigrid-norm loss: the residual restricted to coarser grids.
    for _ in range(getattr(args, "mgloss", 0)):
        fu = restrict_to_coarser(fu, loc="c" * ndim, mod=mod)
        res.append(fu)
    return res


def build(n=64, ndim=2, ref="hat", rhs="discrete", osc_k=2.0, mgloss=0, dtype=np.float64, multigrid=True,
          mesh=None, partition=None, device="cuda", args=None):
    """Builds the Poisson inversion problem: (problem, state, extra)."""
    if args is None:
        args = argparse.Namespace(ref=ref, rhs=rhs, osc_k=osc_k, mgloss=mgloss)
    domain = Domain(
        cshape=[n] * ndim,
        dimnames=["x", "y", "z", "sx", "sy", "sz"][:ndim],
        multigrid=multigrid,
        dtype=dtype,
        device=device,
        mesh=mesh,
        partition=partition,
    )
    mod = domain.mod
    ref_u = reference_solution(args.ref, args, domain)
    if args.rhs == "discrete":
        rhs_arr = discrete_rhs(ref_u, domain, mod)
    else:
        rhs_arr = reference_rhs(args.ref, args, domain)
    state = domain.init_state(State(fields={"u": None}))
    extra = argparse.Namespace(ref_u=ref_u, rhs=mod.cast(rhs_arr, domain.dtype), args=args)
    return Problem(operator, domain, extra), state, extra
