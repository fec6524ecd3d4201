"""Advection-diffusion model: infer constant coefficients (diffusivity,
source, velocity) from snapshots at the initial and final time.

PyTorch counterpart of ``odil_tpu/models/advection.py:17-84``:
Crank-Nicolson discretization, the initial and final rows imposed exactly
by concatenation, the unknown field node-located in time (``loc="nc"``)
and an ``Array`` of three unknown coefficients.
"""

import argparse

import numpy as np

from ..fields import Array, Field, State
from ..grid import Domain
from ..problem import Problem

__all__ = ["exact_u", "clamp_rows", "operator", "build"]


def exact_u(t, x, c_diff, c_src, c_vel):
    """Solution of u_t + c_vel u_x = c_diff u_xx + c_src on periodic [-1, 1]
    (numpy)."""
    t = np.asarray(t)
    x = np.asarray(x)
    u = np.zeros_like(x, dtype=float)
    xx = x - t * c_vel
    modes = [1, 2, 3]
    for i in modes:
        k = 2 * i * np.pi
        u = u + np.cos(xx * k) * np.exp(-c_diff * k**2 * t)
    u = u / (2 * len(modes))
    return u + c_src * t


def clamp_rows(u, extra, mod):
    """Imposes the initial and final rows exactly."""
    return mod.concatenate([extra.u_init[None, :], u[1:-1], extra.u_final[None, :]], axis=0)


def operator(ctx):
    mod = ctx.mod
    dt, dx = ctx.step("t", "x")
    coeff = ctx.field("coeff")
    extra = ctx.extra

    u0 = clamp_rows(ctx.field("u"), extra, mod)
    offsets = [(0, 0), (0, -1), (0, 1), (-1, 0), (-1, -1), (-1, 1)]
    u, uxm, uxp, um, umxm, umxp = [mod.roll(u0, [-s for s in o], (0, 1)) for o in offsets]

    u_t = (u - um) / dt
    lap = 0.5 * ((uxm - 2 * u + uxp) + (umxm - 2 * um + umxp)) / dx**2
    upw = 0.5 * ((u - uxm) + (um - umxm)) / dx

    fu = u_t - coeff[0] * lap - coeff[1] + coeff[2] * upw
    return [fu[1:]]


def build(nt=64, nx=64, c_diff=0.01, c_src=0.1, c_vel=0.2, dtype=np.float64, multigrid=True, mg_interp=None,
          mg_nlvl=None, device="cuda", args=None):
    """Builds the coefficient-inference problem: (problem, state, extra)."""
    if args is None:
        args = argparse.Namespace(c_diff=c_diff, c_src=c_src, c_vel=c_vel)
    domain = Domain(
        cshape=(nt, nx),
        dimnames=("t", "x"),
        lower=(0, -1),
        upper=(1, 1),
        dtype=dtype,
        multigrid=multigrid,
        mg_interp=mg_interp,
        mg_nlvl=mg_nlvl,
        device=device,
    )
    tt, xx = (p.cpu().numpy() for p in domain.points())
    xone = domain.points_1d("x", loc="c").cpu().numpy()
    ref_u = exact_u(tt, xx, args.c_diff, args.c_src, args.c_vel)
    u_init = exact_u(xone * 0 + domain.lower[0], xone, args.c_diff, args.c_src, args.c_vel)
    u_final = exact_u(xone * 0 + domain.upper[0], xone, args.c_diff, args.c_src, args.c_vel)

    state = domain.init_state(State(fields={"coeff": Array([0, 0, 0.001]), "u": Field(None, loc="nc")}))
    extra = argparse.Namespace(ref_u=ref_u, u_init=domain.cast(u_init), u_final=domain.cast(u_final), args=args)
    return Problem(operator, domain, extra), state, extra
