"""Velocity-from-tracer model: reconstruct a 2D velocity field from tracer
images at the initial and final time (the flagship ODIL case).

PyTorch counterpart of ``odil_tpu/models/veltracer.py``.  First-order upwind
advection on a (t, x, y) space-time grid with frozen-velocity switching,
imposed tracer endpoints, Laplacian and time-derivative velocity
regularization.  Three operators:

- ``operator(ctx)``: the plain path through ``ctx.field`` stencils;
- ``operator_fused(ctx)``: the same residuals through the row-wise kernels
  over the fine fields (``ctx.rowwise_terms``, ops/rowwise.py);
- ``operator_fused_mg(ctx)``: the same residuals through the MG-fused row
  kernel (ops/rowwise_mg.py), with ``loss_and_grads`` for the training step.
"""

import argparse

import numpy as np
import torch

from ..context import Context
from ..fields import Field, State
from ..grid import Domain
from ..ops.rowwise import RowModel
from ..ops.rowwise_mg import rowwise_loss_terms_mg, rowwise_mg_loss_and_grads
from ..problem import Problem

__all__ = ["tracer_blob", "operator", "operator_fused", "operator_fused_mg", "build"]


def tracer_blob(x, y, t):
    """A single blob advected and sheared by a uniform velocity field."""
    u0, v0, r0 = 0.2, 0.2, 0.2
    k = 1 + t
    dx = (x - u0 * t - 0.3) * k
    dy = (y - v0 * t - 0.3) / k
    res = np.maximum(0, 1 - (dx**2 + dy**2) / r0**2)
    return res**0.2


def operator(ctx):
    mod = ctx.mod
    extra = ctx.extra
    args = extra.args
    dt, dx, dy = ctx.step()
    it = ctx.indices("t", loc="ncc")
    nt = ctx.size("t")

    def cross(key, shift_t=0, frozen=False):
        """5-point spatial cross at time shift_t: [c, xm, xp, ym, yp]."""
        return [
            ctx.field(key, shift_t, 0, 0, frozen=frozen),
            ctx.field(key, shift_t, -1, 0, frozen=frozen),
            ctx.field(key, shift_t, 1, 0, frozen=frozen),
            ctx.field(key, shift_t, 0, -1, frozen=frozen),
            ctx.field(key, shift_t, 0, 1, frozen=frozen),
        ]

    def laplace(st):
        c, xm, xp, ym, yp = st
        return (xp - 2 * c + xm) / dx**2 + (yp - 2 * c + ym) / dy**2

    def upwind(um, u, up, v):
        return mod.where(v > 0, u - um, mod.where(v < 0, up - u, (up - um) * 0.5))

    vx_st = cross("vx")
    vy_st = cross("vy")
    vx, vy = vx_st[0], vy_st[0]
    vxf = ctx.field("vx", 0, 0, 0, frozen=True)
    vyf = ctx.field("vy", 0, 0, 0, frozen=True)

    u_prev = cross("u", shift_t=-1)
    du_x = upwind(u_prev[1], u_prev[0], u_prev[2], vxf)
    du_y = upwind(u_prev[3], u_prev[0], u_prev[4], vyf)

    u = ctx.field("u")
    um = mod.where(it == 1, extra.u_init[None, :], u_prev[0])
    fu = (u - um) / dt + vx * du_x / dx + vy * du_y / dy
    fu = mod.where(it == 0, (u - extra.u_init[None, :]) / dx, fu)

    zero = ctx.cast(0)
    fimp = mod.where(it == nt - 1, (u - extra.u_final[None, :]) / dx, zero)
    res = [fu, fimp * args.kimp]

    if args.kxreg:
        res += [laplace(vx_st) * args.kxreg, laplace(vy_st) * args.kxreg]

    if args.ktreg:
        k = args.ktreg / dt
        for key in ("vx", "vy"):
            dv = (ctx.field(key) - ctx.field(key, -1, 0, 0)) * k
            res += [mod.where(it == 0, zero, dv)]

    return res


def _roll(q, shift, axis):
    # Plane axes are the last two of a row stack: x = -2, y = -1.
    return torch.roll(q, shift, axis - 2)


def _upwind(um, uc, up, v):
    return torch.where(v > 0, uc - um, torch.where(v < 0, up - uc, (up - um) * 0.5))


def _make_row_fn(dt, dx, dy, kimp, kxreg, ktreg):
    """The per-row residual function of the fused kernel (row stacks)."""

    def row_fn(it, T, rows, data_rows, params, consts):
        (u_r, vx_r, vy_r) = rows
        u0, u1 = consts
        ucur, uprev = u_r
        vxc, vxp = vx_r
        vyc, vyp = vy_r
        vxf = vxc.detach()
        vyf = vyc.detach()
        du_x = _upwind(_roll(uprev, 1, 0), uprev, _roll(uprev, -1, 0), vxf)
        du_y = _upwind(_roll(uprev, 1, 1), uprev, _roll(uprev, -1, 1), vyf)
        um = torch.where(it == 1, u0, uprev)
        fu = (ucur - um) / dt + vxc * du_x / dx + vyc * du_y / dy
        fu = torch.where(it == 0, (ucur - u0) / dx, fu)
        # Imposed-final row at it == T - 2 (the reference's `nt` is the cell
        # count while `it` runs over T nodes), not at the last node.
        fimp = torch.where(it == T - 2, (ucur - u1) / dx, 0.0) * kimp
        res = [fu, fimp]

        def laplace(q):
            return (_roll(q, -1, 0) - 2 * q + _roll(q, 1, 0)) / dx**2 + (
                _roll(q, -1, 1) - 2 * q + _roll(q, 1, 1)
            ) / dy**2

        if kxreg:
            res += [laplace(vxc) * kxreg, laplace(vyc) * kxreg]
        if ktreg:
            k = ktreg / dt
            res += [
                torch.where(it == 0, 0.0, (vxc - vxp) * k),
                torch.where(it == 0, 0.0, (vyc - vyp) * k),
            ]
        return tuple(res)

    return row_fn


def _make_row_vjp(dt, dx, dy, kimp, kxreg, ktreg):
    """Closed-form adjoint of ``_make_row_fn``'s residual rows:
    ``row_vjp(it, T, rows, data_rows, params, consts, cots) ->
    (flat_row_cotangents, ())`` in (field, cur/prev) order.  The transposes
    of the upwind switches (frozen velocities: the masks carry no gradient),
    the self-adjoint periodic Laplacian and the it-masked branches."""

    def row_vjp(it, T, rows, data_rows, params, consts, cots):
        (u_r, vx_r, vy_r) = rows
        ucur, uprev = u_r
        vxc, vxp = vx_r
        vyc, vyp = vy_r
        w = list(cots)
        w0, w1 = w[0], w[1]
        pos = 2
        if kxreg:
            w2, w3 = w[pos], w[pos + 1]
            pos += 2
        if ktreg:
            w4, w5 = w[pos], w[pos + 1]

        one = torch.ones((), dtype=ucur.dtype, device=ucur.device)
        zero = torch.zeros((), dtype=ucur.dtype, device=ucur.device)
        m0 = it == 0
        not1 = torch.where(it == 1, zero, one)
        b0 = torch.where(m0, zero, w0)

        vxf = vxc.detach()
        vyf = vyc.detach()
        du_x = _upwind(_roll(uprev, 1, 0), uprev, _roll(uprev, -1, 0), vxf)
        du_y = _upwind(_roll(uprev, 1, 1), uprev, _roll(uprev, -1, 1), vyf)

        d_ucur = torch.where(m0, w0 / dx, w0 / dt) + torch.where(it == T - 2, w1 * (kimp / dx), zero)
        d_uprev = -(b0 / dt) * not1

        def adv_adjoint(c, vf, axis):
            guc = torch.where(vf > 0, one, torch.where(vf < 0, -one, zero))
            gum = torch.where(vf > 0, -one, torch.where(vf < 0, zero, -0.5 * one))
            gup = torch.where(vf > 0, zero, torch.where(vf < 0, one, 0.5 * one))
            return c * guc + _roll(c * gum, -1, axis) + _roll(c * gup, 1, axis)

        d_uprev = d_uprev + adv_adjoint(b0 * vxc / dx, vxf, 0)
        d_uprev = d_uprev + adv_adjoint(b0 * vyc / dy, vyf, 1)

        def laplace(q):
            return (_roll(q, -1, 0) - 2 * q + _roll(q, 1, 0)) / dx**2 + (
                _roll(q, -1, 1) - 2 * q + _roll(q, 1, 1)
            ) / dy**2

        d_vxc = b0 * du_x / dx
        d_vyc = b0 * du_y / dy
        d_vxp = torch.zeros_like(vxp)
        d_vyp = torch.zeros_like(vyp)
        if kxreg:
            d_vxc = d_vxc + laplace(w2) * kxreg
            d_vyc = d_vyc + laplace(w3) * kxreg
        if ktreg:
            k = ktreg / dt
            b4 = torch.where(m0, zero, w4) * k
            b5 = torch.where(m0, zero, w5) * k
            d_vxc = d_vxc + b4
            d_vxp = d_vxp - b4
            d_vyc = d_vyc + b5
            d_vyp = d_vyp - b5

        return (d_ucur, d_uprev, d_vxc, d_vxp, d_vyc, d_vyp), ()

    return row_vjp


def _row_model(ctx):
    """The veltracer row model: plain row_fn/row_vjp and the CUDA kernel's
    scalars.  Returns (model, nterms)."""
    args = ctx.extra.args
    dt, dx, dy = map(float, ctx.step())
    kimp, kxreg, ktreg = float(args.kimp), float(args.kxreg), float(args.ktreg)
    model = RowModel(
        _make_row_fn(dt, dx, dy, kimp, kxreg, ktreg),
        _make_row_vjp(dt, dx, dy, kimp, kxreg, ktreg),
        cuda_model="veltracer",
        scalars=dict(dt=dt, dx=dx, dy=dy, kimp=kimp, kxreg=kxreg, ktreg=ktreg),
    )
    nterms = 2 + (2 if kxreg else 0) + (2 if ktreg else 0)
    return model, nterms


_KEYS = ("u", "vx", "vy")


def _kernel_decl(ctx):
    """The row-wise kernel declaration of ``operator_fused``: the row model,
    field keys, const planes, term count and declared stencil reaches."""
    model, nterms = _row_model(ctx)
    return dict(
        row_fn=model, keys=_KEYS, consts=(ctx.extra.u_init, ctx.extra.u_final), nterms=nterms, hist=1, halox=1
    )


def operator_fused(ctx):
    """``operator`` through the row-wise kernels over the fine fields: the
    loss terms come back as ``Context.Raw`` means."""
    d = _kernel_decl(ctx)
    return ctx.rowwise_terms(
        d["row_fn"], d["keys"], consts=d["consts"], nterms=d["nterms"], hist=d["hist"], halox=d["halox"]
    )


def operator_fused_mg(ctx):
    """``operator`` with the finest multigrid Horner step fused into the row
    kernel: fine rows are rebuilt from the level-0 terms plus the level-1
    partial (``ctx.mg_partials``, from ``Problem(mg_partial=True)``).  Falls
    back to ``operator_fused`` as the JAX package does: without partials
    (plain-Field states, paths that flatten fully), for 64-bit fields on the
    card (the mg kernel takes float32) and for shapes the mg kernel does not
    take."""
    parts = ctx.mg_partials
    if not all(k in parts for k in _KEYS):
        return operator_fused(ctx)
    t0s = tuple(parts[k][0] for k in _KEYS)
    if (t0s[0].is_cuda and t0s[0].element_size() > 4) or not _mg_supported(
        tuple(tuple(t.shape) for t in t0s), ctx.dtype
    ):
        return operator_fused(ctx)
    model, nterms = _row_model(ctx)
    terms = rowwise_loss_terms_mg(
        model,
        t0s=t0s,
        coarse=tuple(parts[k][2] for k in _KEYS),
        factors0=tuple(parts[k][1] for k in _KEYS),
        consts=(ctx.extra.u_init, ctx.extra.u_final),
        nterms=nterms,
        hist=1,
    )
    return [Context.Raw(t) for t in terms]


def _mg_loss_and_grads(ctx):
    """Fused one-pass loss+gradients for the training step
    (Problem.make_loss_grad_fn).  Returns (terms, {key: (d_t0, d_coarse)}),
    or at two levels (partials (t0, f0, t1, f1, P2)) (terms, {key: (d_t0,
    d_t1, d_P2)})."""
    parts = ctx.mg_partials
    model, nterms = _row_model(ctx)
    if len(parts[_KEYS[0]]) == 5:
        terms, (dt0, dt1, dP2, _) = rowwise_mg_loss_and_grads(
            model,
            t0s=tuple(parts[k][0] for k in _KEYS),
            coarse=tuple(parts[k][4] for k in _KEYS),
            factors0=tuple(parts[k][1] for k in _KEYS),
            consts=(ctx.extra.u_init, ctx.extra.u_final),
            nterms=nterms,
            hist=1,
            t1s=tuple(parts[k][2] for k in _KEYS),
            factors1=tuple(parts[k][3] for k in _KEYS),
        )
        return list(terms), {k: (dt0[i], dt1[i], dP2[i]) for i, k in enumerate(_KEYS)}
    terms, (dt0, dcoarse, _) = rowwise_mg_loss_and_grads(
        model,
        t0s=tuple(parts[k][0] for k in _KEYS),
        coarse=tuple(parts[k][2] for k in _KEYS),
        factors0=tuple(parts[k][1] for k in _KEYS),
        consts=(ctx.extra.u_init, ctx.extra.u_final),
        nterms=nterms,
        hist=1,
    )
    return list(terms), {k: (dt0[i], dcoarse[i]) for i, k in enumerate(_KEYS)}


def _mg_supported(t0_shapes, dtype):
    """The shapes the mg kernels take (``_prepare_mg``'s conditions): 3D
    fields of one shape, an odd node count T > 2 along t, even x and y."""
    if len(set(t0_shapes)) != 1 or len(t0_shapes[0]) != 3:
        return False
    T, X, Y = t0_shapes[0]
    return T % 2 == 1 and T > 2 and X % 2 == 0 and Y % 2 == 0 and X >= 4 and Y >= 4


def _mg_partial_depth(t0_shapes, dtype):
    """Single-level fusion by default, as the JAX package chose on its chip
    (``odil_tpu/models/veltracer.py:396-412``); two levels stay available
    through the ``partial_depth`` hook, and only where the mg kernel takes
    the shapes."""
    depth = 1
    if depth >= 2 and not _mg_supported(t0_shapes, dtype):
        return 1
    return depth


_mg_loss_and_grads.supported = _mg_supported
_mg_loss_and_grads.partial_depth = _mg_partial_depth
operator_fused_mg.loss_and_grads = _mg_loss_and_grads
# The halo one-pass builder rebuilds the kernel call from this declaration
# and runs it per shard (halo._make_halo_mg_loss_grad_fn), where ctx.extra
# holds the shard's const planes.
operator_fused_mg.kernel_decl = _kernel_decl


def build(
    nt=64,
    nx=64,
    ny=64,
    kxreg=0.01,
    ktreg=1.0,
    kimp=10.0,
    dtype=np.float32,
    multigrid=True,
    mg_interp="conv",
    mg_nlvl=None,
    kernel="xla",
    device="cuda",
    mesh=None,
    partition=None,
    args=None,
):
    """Builds the velocity-from-tracer problem: (problem, state, extra).

    kernel: "pallas_mg" (the MG-fused kernel), "pallas" (the row-wise
    kernels over the fine fields) or "xla" (the plain operator); the names
    are the JAX package's.  mesh/partition: the shards of the Domain
    (``parallel.Mesh``): the halo path with ``halo=True``, the GSPMD route
    without it."""
    if kernel not in ("pallas_mg", "pallas", "xla"):
        raise ValueError(f"kernel={kernel!r}: the port has 'pallas_mg', 'pallas' and 'xla'")
    if args is None:
        args = argparse.Namespace(kxreg=kxreg, ktreg=ktreg, kimp=kimp)
    domain = Domain(
        cshape=(nt, nx, ny),
        dimnames=("t", "x", "y"),
        lower=(0, 0, 0),
        upper=(1, 1, 1),
        dtype=dtype,
        multigrid=multigrid,
        mg_interp=mg_interp,
        mg_nlvl=mg_nlvl,
        device=device,
        mesh=mesh,
        partition=partition,
    )
    x, y = (p.cpu().numpy() for p in domain.points("x", "y", loc=".cc"))
    u_init = tracer_blob(x, y, 0)
    u_final = tracer_blob(x, y, 1)

    state = State()
    for key in _KEYS:
        state.fields[key] = Field(None, loc="ncc")
    state = domain.init_state(state)

    exact_uu = np.zeros(domain.get_field_shape(loc="ncc"))
    exact_uu[0] = u_init
    exact_uu[-1] = u_final
    extra = argparse.Namespace(
        u_init=domain.cast(u_init),
        u_final=domain.cast(u_final),
        exact_uu=exact_uu,
        args=args,
    )
    if kernel == "pallas_mg":
        op, mg_partial = operator_fused_mg, bool(multigrid)
    elif kernel == "pallas":
        op, mg_partial = operator_fused, False
    else:
        op, mg_partial = operator, False
    return Problem(op, domain, extra, mg_partial=mg_partial), state, extra
