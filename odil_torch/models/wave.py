"""Wave-equation data assimilation: recover u(t, x) from the initial u and
u_t and the boundary traces.

PyTorch counterpart of ``odil_tpu/models/wave.py:20-145``.  Second-order
space-time stencil (time shift -2); Dirichlet boundaries by quadratic-half
extrapolation to the traces.  Two operators:

- ``operator(ctx)``: the plain path through ``ctx.field`` stencils;
- ``operator_fused(ctx)``: the same residual through the row-wise kernels
  (``ctx.rowwise_terms``, ops/rowwise.py) with hist=2, the traces as
  per-row data of shape (T, 1), on 1-D planes.
"""

import argparse

import numpy as np
import torch

from ..fields import State
from ..grid import Domain
from ..halo import refuse_plane_partition
from ..ops.rowwise import RowModel
from ..problem import Problem
from ..stencil import extrap_quadh

__all__ = ["exact_solution", "operator", "operator_fused", "build"]

MODES = [1, 2, 3, 4, 5]


def exact_solution(t, x):
    """Standing superposition of travelling cosines; returns (u, u_t)."""
    t = np.asarray(t, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    u = np.zeros(np.broadcast(t, x).shape)
    ut = np.zeros_like(u)
    for i in MODES:
        k = i * np.pi
        u += np.cos((x - t + 0.5) * k) + np.cos((x + t - 0.5) * k)
        ut += k * np.sin((x - t + 0.5) * k) - k * np.sin((x + t - 0.5) * k)
    scale = 2 * len(MODES)
    return u / scale, ut / scale


def operator(ctx):
    extra = ctx.extra
    mod = ctx.mod
    args = extra.args
    dt, dx = ctx.step()
    it, ix = ctx.indices()
    nt, nx = ctx.size()

    u = ctx.field("u")
    utm = ctx.field("u", -1, 0)
    utmm = ctx.field("u", -2, 0)
    uxm = ctx.field("u", -1, -1)
    uxp = ctx.field("u", -1, 1)

    # Boundary traces at the previous time row, via quadratic-half ghosts.
    left_utm = mod.roll(extra.left_u, 1, 0)
    right_utm = mod.roll(extra.right_u, 1, 0)
    uxm = mod.where(ix == 0, extrap_quadh(uxp, utm, left_utm[:, None]), uxm)
    uxp = mod.where(ix == nx - 1, extrap_quadh(uxm, utm, right_utm[:, None]), uxp)

    u_t_here = (u - utm) / dt
    u_t_prev = (utm - utmm) / dt
    u_t_prev = mod.where(it == 1, extra.init_ut[None, :], u_t_prev)

    u_tt = (u_t_here - u_t_prev) / dt
    u_xx = (uxm - 2 * utm + uxp) / dx**2
    fu = u_tt - u_xx

    # First row carries the initial condition (staggered half step).
    u0 = extra.init_u + 0.5 * dt * extra.init_ut
    fu = mod.where(it == 0, (u - u0[None, :]) * args.kimp, fu)
    return [("fu", fu)]


def _make_row_fn(dt, dx, nx, kimp):
    """The residual rows of ``operator_fused`` over (R, N) stacks: rows[0] =
    (u at it, it-1, it-2), data = the left and right traces at it - 1 as
    (R, 1), consts = (u0, ut0, ix) planes."""

    def row_fn(it, T, rows, data_rows, params, consts):
        (cur, tm, tmm) = rows[0]
        left_row, right_row = data_rows
        u0, ut0, ixv = consts
        uxm = torch.roll(tm, 1, -1)
        uxp = torch.roll(tm, -1, -1)
        uxm = torch.where(ixv == 0, extrap_quadh(uxp, tm, left_row), uxm)
        uxp = torch.where(ixv == nx - 1, extrap_quadh(uxm, tm, right_row), uxp)
        u_t_here = (cur - tm) / dt
        u_t_prev = torch.where(it == 1, ut0, (tm - tmm) / dt)
        fu = (u_t_here - u_t_prev) / dt - (uxm - 2 * tm + uxp) / dx**2
        first = u0 + 0.5 * dt * ut0
        fu = torch.where(it == 0, (cur - first) * kimp, fu)
        return (fu,)

    return row_fn


def _make_row_vjp(dt, dx, nx, kimp):
    """Closed-form adjoint of ``_make_row_fn``: ``row_vjp(it, T, rows,
    data_rows, params, consts, cots) -> ((d_cur, d_tm, d_tmm), ())``.  The
    boundary extrapolations are transposed right edge first (it reads the
    left one), then the periodic x-rolls."""

    def row_vjp(it, T, rows, data_rows, params, consts, cots):
        ixv = consts[2]
        (w,) = cots
        first = it == 0
        wi = torch.where(first, 0.0, w)  # the interior residual's weight
        a = wi / dt / dt
        d_cur = torch.where(first, w * kimp, a)
        g_lap = -wi / dx**2  # cotangent of each of uxm, tm (x -2), uxp in the Laplacian
        not1 = it != 1
        d_tm = -a - 2 * g_lap + torch.where(not1, -a, 0.0)
        d_tmm = torch.where(not1, a, 0.0)
        right, left = ixv == nx - 1, ixv == 0
        g_uxm = g_lap + torch.where(right, g_lap / 3, 0.0)
        d_tm = d_tm + torch.where(right, -2 * g_lap, 0.0)
        g_next = torch.where(right, 0.0, g_lap) + torch.where(left, g_uxm / 3, 0.0)  # of tm at x + 1
        d_tm = d_tm + torch.where(left, -2 * g_uxm, 0.0)
        g_prevx = torch.where(left, 0.0, g_uxm)  # of tm at x - 1
        d_tm = d_tm + torch.roll(g_next, 1, -1) + torch.roll(g_prevx, -1, -1)
        return (d_cur, d_tm, d_tmm), ()

    return row_vjp


def _row_model(ctx):
    dt, dx = map(float, ctx.step())
    nx = int(ctx.size("x"))
    kimp = float(ctx.extra.args.kimp)
    return RowModel(
        _make_row_fn(dt, dx, nx, kimp),
        _make_row_vjp(dt, dx, nx, kimp),
        cuda_model="wave",
        scalars=dict(dt=dt, dx=dx, kimp=kimp),
    )


def operator_fused(ctx):
    """``operator`` through the row-wise kernels (hist=2); the boundary
    traces enter as per-row data of shape (T, 1)."""
    extra = ctx.extra
    mod = ctx.mod
    refuse_plane_partition(ctx, "wave")
    nt, nx = ctx.size()
    left_utm = mod.reshape(mod.roll(extra.left_u, 1, 0), (nt, 1))
    right_utm = mod.reshape(mod.roll(extra.right_u, 1, 0), (nt, 1))
    ix = torch.arange(nx, dtype=extra.init_u.dtype, device=extra.init_u.device)  # on the device: no host copy
    (term,) = ctx.rowwise_terms(
        _row_model(ctx), ("u",), data=(left_utm, right_utm), consts=(extra.init_u, extra.init_ut, ix), nterms=1,
        hist=2, halox=1,
    )
    return [("fu", term)]


def build(nt=64, nx=64, kimp=1.0, dtype=np.float64, multigrid=True, kernel="xla", device="cuda", mesh=None,
          partition=None, args=None):
    """Builds the wave assimilation problem: (problem, state, extra).

    kernel: "pallas" (the row-wise kernels) or "xla" (the plain operator);
    the names are the JAX package's.  mesh/partition: the shards of the halo
    path (``parallel.Mesh``; evaluate with ``halo=True``)."""
    if kernel not in ("pallas", "xla"):
        raise ValueError(f"kernel={kernel!r}: wave has 'pallas' and 'xla'")
    if args is None:
        args = argparse.Namespace(kimp=kimp)
    domain = Domain(
        cshape=(nt, nx), dimnames=("t", "x"), lower=(0, -1), upper=(1, 1), multigrid=multigrid, dtype=dtype,
        device=device, mesh=mesh, partition=partition,
    )
    tt, xx = (p.cpu().numpy() for p in domain.points())
    t1, x1 = (p.cpu().numpy() for p in domain.points_1d())
    ref_u, ref_ut = exact_solution(tt, xx)
    left_u, _ = exact_solution(t1, t1 * 0 + domain.lower[1])
    right_u, _ = exact_solution(t1, t1 * 0 + domain.upper[1])
    init_u, init_ut = exact_solution(x1 * 0 + domain.lower[0], x1)
    extra = argparse.Namespace(
        args=args,
        ref_u=ref_u,
        ref_ut=ref_ut,
        left_u=domain.cast(left_u),
        right_u=domain.cast(right_u),
        init_u=domain.cast(init_u),
        init_ut=domain.cast(init_ut),
    )
    state = domain.init_state(State(fields={"u": np.zeros(domain.cshape)}))
    op = operator_fused if kernel == "pallas" else operator
    return Problem(op, domain, extra), state, extra
