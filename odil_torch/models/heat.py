"""Heat-conduction model family.

PyTorch counterpart of ``odil_tpu/models/heat.py``:

1. Inverse conductivity: infer k(u) as a neural network from sparse
   temperature measurements.  Finite-volume discretization with a
   frozen-field flux linearization, imposed measurements with weight
   rescaling and annealed regularizers driven by the epoch tracer.  Three
   operators:

   - ``operator_odil(ctx)``: the plain path through ``ctx.field`` stencils
     and ``ctx.neural_net``;
   - ``operator_odil_fused(ctx)``: the same residuals through the row-wise
     kernels (``ctx.rowwise_terms``, ops/rowwise.py), the conductivity
     net's weights as differentiated kernel params, the measurements as
     per-row data and the annealed weights as (1, 1) const planes;
   - ``operator_pinn(ctx)``: the PINN solver, the temperature a network of
     (t, x) differentiated at collocation points by forward mode
     (``torch.func.jvp``, nested for the flux), the loss then by reverse
     mode with respect to the nets' weights.

   The fused row function has a hand adjoint (``_make_row_vjp``, through
   the network for the param cotangents), which the JAX package does not
   have: its kernel differentiates the row function with ``jax.vjp``.
2. ``tmax`` inference: recover the final time of a diffusion run from one
   measured value; the scalar unknown rescales dt inside the operator.
"""

import argparse

import numpy as np
import torch

from ..fields import Array, Field, State
from ..grid import Domain
from ..halo import refuse_plane_partition
from ..nn import eval_neural_net
from ..ops.rowwise import _HEAT_LAYERS, RowModel
from ..problem import Problem
from ..stencil import extrap_linear, extrap_quadh

__all__ = [
    "initial_temperature",
    "true_conductivity",
    "anneal",
    "squash_k",
    "operator_odil",
    "operator_odil_fused",
    "operator_pinn",
    "pinn_collocation",
    "pick_imposed",
    "build",
    "exact_u_tmax",
    "clamp_initial_row",
    "operator_tmax",
    "build_tmax",
    "eval_u_net",
]


def initial_temperature(t, x, mod):
    def bump(z):
        return mod.exp(-((z - 0.5) ** 2) * 50)

    return bump(x) - bump(-mod.cast(0.5, x.dtype))


def true_conductivity(u, mod=np):
    return 0.02 * mod.exp(-((u - 0.5) ** 2) * 20)


def anneal(epoch, period):
    """Exponential decay factor halving every `period` epochs."""
    return 0.5 ** (epoch / period) if period else 1


def squash_k(raw, mod, kmax):
    return mod.sigmoid(raw) * kmax


def operator_odil(ctx):
    extra = ctx.extra
    mod = ctx.mod
    args = extra.args
    dt, dx = ctx.step()
    it, ix = ctx.indices()
    nt, nx = ctx.size()
    epoch = ctx.tracers["epoch"]

    def row_samples(key, tshift, frozen):
        return [ctx.field(key, tshift, s, frozen=frozen) for s in (0, -1, 1)]

    def two_rows(key, frozen=False):
        if not args.keep_frozen:
            frozen = False
        return [row_samples(key, 0, frozen), row_samples(key, -1, frozen)]

    def impose_bc(rows):
        """Overwrites wrapped halo samples: initial condition in time (linear
        extrapolation), zero Dirichlet in space (quadratic-half)."""
        if args.keep_init:
            u0 = extra.init_u
            u0row = [u0, mod.roll(u0, 1, 0), mod.roll(u0, -1, 0)]
            cur, prev = rows
            for i in range(3):
                prev[i] = mod.where(it == 0, extrap_linear(cur[i], u0row[i][None, :]), prev[i])
        for row in rows:
            row[1] = mod.where(ix == 0, extrap_quadh(row[2], row[0], 0), row[1])
            row[2] = mod.where(ix == nx - 1, extrap_quadh(row[1], row[0], 0), row[2])
        return rows

    rows = impose_bc(two_rows("u"))
    cur, prev = rows
    u_t = (cur[0] - prev[0]) / dt
    du_m = ((cur[0] + prev[0]) - (cur[1] + prev[1])) / (2 * dx)
    du_p = ((cur[2] + prev[2]) - (cur[0] + prev[0])) / (2 * dx)

    # Face temperatures from the frozen stencil (linearizes the flux).
    fcur, fprev = impose_bc(two_rows("u", frozen=True))
    uface_m = ((fcur[0] + fprev[0]) + (fcur[1] + fprev[1])) * 0.25
    uface_p = ((fcur[2] + fprev[2]) + (fcur[0] + fprev[0])) * 0.25

    if args.infer_k:
        km = squash_k(ctx.neural_net("k_net")(uface_m)[0], mod, args.kmax)
        kp = squash_k(ctx.neural_net("k_net")(uface_p)[0], mod, args.kmax)
    else:
        km = true_conductivity(uface_m, mod=mod)
        kp = true_conductivity(uface_p, mod=mod)

    flux_div = (du_p * kp - du_m * km) / dx
    fu = u_t - flux_div
    if not args.keep_init:
        fu = mod.where(it == 0, ctx.cast(0), fu)
    res = [("fu", fu)]

    if extra.imp_size:
        weight = args.kimp * (np.prod(ctx.size()) / extra.imp_size) ** 0.5
        res += [("imp", extra.imp_mask * (cur[0] - extra.imp_u) * weight)]

    if args.kxreg:
        k = args.kxreg * anneal(epoch, args.kxregdecay)
        u_x = mod.where(ix == 0, ctx.cast(0), (cur[0] - cur[1]) / dx)
        res += [("xreg", u_x * k)]

    if args.ktreg:
        k = args.ktreg * anneal(epoch, args.ktregdecay)
        du = mod.where(it == 0, ctx.cast(0), (cur[0] - prev[0]) / dt)
        res += [("treg", du * k)]

    if args.kwreg and args.infer_k:
        ww = ctx.domain.arrays_from_field(ctx.state.fields["k_net"])
        ww = mod.concatenate([mod.flatten(w) for w in ww], axis=0)
        k = args.kwreg * anneal(epoch, args.kwregdecay)
        res += [("wreg", (mod.stop_gradient(ww) - ww) * k)]
    return res


# -- The fused row model -------------------------------------------------------


def _sigmoid(x):
    return 1 / (1 + torch.exp(-x))


def _make_net(layer_shapes, kmax):
    """k(x) of the conductivity net as unrolled scalar-weighted sums, as the
    JAX package's fused operator writes it (``heat.py:154-169``), and the
    vjp of its params.  ``forward(x, params) -> (k, cache)``;
    ``param_vjp(cache, gk) -> [dW..., db...]`` summed over the stack."""
    nl = len(layer_shapes)

    def forward(x, params):
        ws, bs = params[:nl], params[nl:]
        hs = [[x]]
        for li, (w, b) in enumerate(zip(ws, bs)):
            no, ni = layer_shapes[li]
            out = []
            for o in range(no):
                acc = b[o]
                for i in range(ni):
                    acc = acc + w[o, i] * hs[-1][i]
                out.append(acc)
            hs.append([torch.tanh(v) for v in out] if li < nl - 1 else out)
        s = _sigmoid(hs[-1][0])
        return s * kmax, (hs, s, params)

    def param_vjp(cache, gk):
        hs, s, params = cache
        ws = params[:nl]
        g = [gk * kmax * (s * (1 - s))]  # cotangents of the last layer's outputs
        dws, dbs = [None] * nl, [None] * nl
        for li in range(nl - 1, -1, -1):
            no, ni = layer_shapes[li]
            hin = hs[li]
            dws[li] = torch.stack([torch.stack([torch.sum(g[o] * hin[i]) for i in range(ni)]) for o in range(no)])
            dbs[li] = torch.stack([torch.sum(g[o]) for o in range(no)])
            if li:
                gin = [sum(ws[li][o, i] * g[o] for o in range(no)) for i in range(ni)]
                g = [gi * (1 - h * h) for gi, h in zip(gin, hin)]
        return dws + dbs

    return forward, param_vjp


def _make_row_fn(dt, dx, nx, kmax, imp_weight, flags, layer_shapes):
    """The residual rows of ``operator_odil_fused`` over (R, N) stacks:
    rows[0] = (u at it, it-1); data = (imp_mask, imp_u) rows when there are
    measurements; consts = (u0, u0 at x-1, u0 at x+1, ix, kx, kt) with kx and
    kt as (1, 1) planes; params = the conductivity net's weights, then its
    biases (none without infer_k)."""
    has_imp, has_x, has_t, infer_k, keep_init, keep_frozen = flags
    net = _make_net(layer_shapes, kmax)[0] if infer_k else None

    def k_of(x, params):
        return net(x, params)[0] if infer_k else true_conductivity(x, mod=torch)

    def row_fn(it, T, rows, data_rows, params, consts):
        cur0, prev0 = rows[0]
        u0c, u0m, u0p, ix, kx, kt = consts

        def shifted(row):
            return [row, torch.roll(row, 1, -1), torch.roll(row, -1, -1)]

        def impose(cur, prev):
            if keep_init:
                prev = [torch.where(it == 0, extrap_linear(c, z), p) for c, p, z in zip(cur, prev, (u0c, u0m, u0p))]
            out = []
            for row in (cur, prev):
                r1 = torch.where(ix == 0, extrap_quadh(row[2], row[0], 0.0), row[1])
                r2 = torch.where(ix == nx - 1, extrap_quadh(r1, row[0], 0.0), row[2])
                out.append([row[0], r1, r2])
            return out

        cur, prev = impose(shifted(cur0), shifted(prev0))
        u_t = (cur[0] - prev[0]) / dt
        du_m = ((cur[0] + prev[0]) - (cur[1] + prev[1])) / (2 * dx)
        du_p = ((cur[2] + prev[2]) - (cur[0] + prev[0])) / (2 * dx)
        if keep_frozen:
            fcur, fprev = impose(shifted(cur0.detach()), shifted(prev0.detach()))
        else:
            fcur, fprev = cur, prev
        uface_m = ((fcur[0] + fprev[0]) + (fcur[1] + fprev[1])) * 0.25
        uface_p = ((fcur[2] + fprev[2]) + (fcur[0] + fprev[0])) * 0.25
        km = k_of(uface_m, params)
        kp = k_of(uface_p, params)
        fu = u_t - (du_p * kp - du_m * km) / dx
        if not keep_init:
            fu = torch.where(it == 0, 0.0, fu)
        res = [fu]
        if has_imp:
            mask_row, impu_row = data_rows
            res += [mask_row * (cur[0] - impu_row) * imp_weight]
        if has_x:
            res += [torch.where(ix == 0, 0.0, (cur[0] - cur[1]) / dx) * kx[0, 0]]
        if has_t:
            res += [torch.where(it == 0, 0.0, (cur[0] - prev[0]) / dt) * kt[0, 0]]
        return tuple(res)

    return row_fn


def _shared_faces(u_right, u_left):
    """Which faces two cells see alike: face x lies between cells x and x+1,
    ``u_right`` holds each cell's right-face temperature and ``u_left`` its
    left-face one (the last axis is x).  The interior faces where both have
    the same value share one network pass; the wall faces of the periodic
    seam (the right one of x = nx-1, the left one of x = 0) never do."""
    shared = torch.zeros(u_right.shape, dtype=torch.bool, device=u_right.device)
    shared[..., :-1] = u_right[..., :-1] == u_left[..., 1:]
    return shared


def _make_row_vjp(dt, dx, nx, kmax, imp_weight, flags, layer_shapes, faces=False):
    """Closed-form adjoint of ``_make_row_fn`` with keep_init and keep_frozen
    on: ``row_vjp(...) -> ((d_cur, d_prev), dparams)``.  The face
    temperatures are frozen, so d/du does not pass through k; d/dparams does,
    through both faces.  Transposes, in order: the terms, the quadratic-half
    ghosts at ix = nx-1 then ix = 0, the linear extrapolation of the previous
    row at it = 0, the periodic x-rolls.

    ``faces=True``: the param cotangents in the order of the CUDA kernel's
    face form (``csrc/heat_row.cuh``), one network pass and one param adjoint
    a face: where a face's two cells see the same temperature
    (``_shared_faces``) their conductivity cotangents add, left cell then
    right, into the left cell's pass; the wall faces and the faces whose two
    temperatures differ (row 0 with initial temperatures that disagree) keep
    one pass a cell.  The same function; another summation order."""
    has_imp, has_x, has_t, infer_k, keep_init, keep_frozen = flags
    assert keep_init and keep_frozen, "the hand adjoint takes keep_init=1 and keep_frozen=1"
    net, param_vjp = _make_net(layer_shapes, kmax) if infer_k else (None, None)

    def k_of(x, params):
        return net(x, params) if infer_k else (true_conductivity(x, mod=torch), None)

    def quadh_adjoint(g, ix):
        g0, g1, g2 = g
        right, left = ix == nx - 1, ix == 0
        g1 = g1 + torch.where(right, g2 / 3, 0.0)
        g0 = g0 + torch.where(right, -2 * g2, 0.0)
        gp = torch.where(right, 0.0, g2) + torch.where(left, g1 / 3, 0.0)
        g0 = g0 + torch.where(left, -2 * g1, 0.0)
        return [g0, torch.where(left, 0.0, g1), gp]

    def row_vjp(it, T, rows, data_rows, params, consts, cots):
        cur0, prev0 = rows[0]
        u0c, u0m, u0p, ix, kx, kt = consts
        first = it == 0

        def shifted(row):
            return [row, torch.roll(row, 1, -1), torch.roll(row, -1, -1)]

        cur = shifted(cur0)
        prev = [torch.where(first, extrap_linear(c, z), p) for c, p, z in zip(cur, shifted(prev0), (u0c, u0m, u0p))]
        for row in (cur, prev):
            row[1] = torch.where(ix == 0, extrap_quadh(row[2], row[0], 0.0), row[1])
            row[2] = torch.where(ix == nx - 1, extrap_quadh(row[1], row[0], 0.0), row[2])
        s0, s1, s2 = (c + p for c, p in zip(cur, prev))
        du_m = (s0 - s1) / (2 * dx)
        du_p = (s2 - s0) / (2 * dx)
        km, cache_m = k_of((s0 + s1) * 0.25, params)
        kp, cache_p = k_of((s2 + s0) * 0.25, params)

        w = list(cots)
        w0 = w[0]
        g_dup, g_dum = -w0 * kp / dx, w0 * km / dx
        gs0, gs1, gs2 = (g_dum - g_dup) / (2 * dx), -g_dum / (2 * dx), g_dup / (2 * dx)
        gc = [gs0 + w0 / dt, gs1, gs2]
        gp = [gs0 - w0 / dt, gs1, gs2]
        pos = 1
        if has_imp:
            gc[0] = gc[0] + w[pos] * data_rows[0] * imp_weight
            pos += 1
        if has_x:
            wx = torch.where(ix == 0, 0.0, w[pos] * kx[0, 0]) / dx
            gc[0], gc[1] = gc[0] + wx, gc[1] - wx
            pos += 1
        if has_t:
            wt = torch.where(first, 0.0, w[pos] * kt[0, 0]) / dt
            gc[0], gp[0] = gc[0] + wt, gp[0] - wt
        gc, gp = quadh_adjoint(gc, ix), quadh_adjoint(gp, ix)
        gc = [c - torch.where(first, p, 0.0) for c, p in zip(gc, gp)]
        gp = [torch.where(first, 0.0, p) for p in gp]
        d_cur = gc[0] + torch.roll(gc[1], -1, -1) + torch.roll(gc[2], 1, -1)
        d_prev = gp[0] + torch.roll(gp[1], -1, -1) + torch.roll(gp[2], 1, -1)
        dparams = []
        if infer_k:
            g_km, g_kp = w0 * du_m / dx, -w0 * du_p / dx
            if faces:
                shared = _shared_faces((s2 + s0) * 0.25, (s0 + s1) * 0.25)
                g_kp = g_kp + torch.where(shared, torch.roll(g_km, -1, -1), 0.0)
                g_km = torch.where(torch.roll(shared, 1, -1), 0.0, g_km)
            dm = param_vjp(cache_m, g_km)
            dp = param_vjp(cache_p, g_kp)
            dparams = [a + b for a, b in zip(dm, dp)]
        return (d_cur, d_prev), dparams

    return row_vjp


def _row_model(ctx):
    """The heat row model of ``operator_odil_fused``: (model, names of its
    terms, params)."""
    extra = ctx.extra
    args = extra.args
    dt, dx = map(float, ctx.step())
    nx = int(ctx.size("x"))
    infer_k = bool(args.infer_k)
    flags = (bool(extra.imp_size), bool(args.kxreg), bool(args.ktreg), infer_k, bool(args.keep_init),
             bool(args.keep_frozen))
    imp_weight = float(args.kimp * (np.prod(ctx.size()) / extra.imp_size) ** 0.5) if extra.imp_size else 0.0
    params, shapes = (), ()
    if infer_k:
        net = ctx.state.fields["k_net"]
        params = tuple(ctx.domain.arrays_from_field(net))
        shapes = tuple(tuple(w.shape) for w in net.weights)
    kmax = float(args.kmax)
    hand = bool(args.keep_init) and bool(args.keep_frozen)
    # The heat CUDA model carries the hand adjoint and the [1, 5, 5, 1] net;
    # other models run plain torch on the card.
    kernel_ok = hand and (not infer_k or shapes == _HEAT_LAYERS)
    model = RowModel(
        _make_row_fn(dt, dx, nx, kmax, imp_weight, flags, shapes),
        _make_row_vjp(dt, dx, nx, kmax, imp_weight, flags, shapes) if hand else None,
        cuda_model="heat" if kernel_ok else None,
        scalars=dict(dt=dt, dx=dx, kmax=kmax, imp_weight=imp_weight, has_imp=flags[0], has_x=flags[1],
                     has_t=flags[2], infer_k=infer_k, layers=shapes),
    )
    names = ["fu"] + ["imp"] * flags[0] + ["xreg"] * flags[1] + ["treg"] * flags[2]
    return model, names, params


def operator_odil_fused(ctx):
    """``operator_odil`` through the row-wise kernels, the conductivity
    net's weights as differentiated kernel params.  The weight
    regularization (wreg) has no grid shape and stays on the regular path."""
    extra = ctx.extra
    mod = ctx.mod
    args = extra.args
    epoch = ctx.tracers["epoch"]
    refuse_plane_partition(ctx, "heat")
    model, names, params = _row_model(ctx)
    u0 = extra.init_u
    # Made on the device (no host copy per epoch): ix as a plane constant,
    # the annealed weights as (1, 1) planes.
    scalar = lambda v: torch.full((1, 1), v, dtype=u0.dtype, device=u0.device)
    consts = (
        u0,
        mod.roll(u0, 1, 0),
        mod.roll(u0, -1, 0),
        torch.arange(u0.shape[0], dtype=u0.dtype, device=u0.device),
        scalar(args.kxreg * anneal(epoch, args.kxregdecay)),
        scalar(args.ktreg * anneal(epoch, args.ktregdecay)),
    )
    data = (extra.imp_mask, extra.imp_u) if extra.imp_size else ()
    terms = ctx.rowwise_terms(
        model, ("u",), params=params, data=data, consts=consts, nterms=len(names), hist=1, halox=1
    )
    res = list(zip(names, terms))
    if args.kwreg and args.infer_k:
        ww = mod.concatenate([mod.flatten(w) for w in params], axis=0)
        k = args.kwreg * anneal(epoch, args.kwregdecay)
        res += [("wreg", (mod.stop_gradient(ww) - ww) * k)]
    return res


def operator_pinn(ctx):
    """PINN variant: the temperature is a neural network of (t, x);
    derivatives at collocation points by forward mode (``torch.func.jvp``,
    one nested inside the flux's function as ``jax.jvp`` is in
    ``odil_tpu/models/heat.py:281-291``).  The nets' weights are captured by
    closure, so reverse mode of the loss reaches them."""
    extra = ctx.extra
    mod = ctx.mod
    args = extra.args
    jvp = torch.func.jvp

    u_of = ctx.neural_net("u_net")
    if args.infer_k:
        k_net = ctx.neural_net("k_net")

        def k_of(u):
            return squash_k(k_net(u)[0], mod, args.kmax)

    else:

        def k_of(u):
            return true_conductivity(u, mod=mod)

    t_in = mod.cast(extra.t_inner, ctx.dtype)
    x_in = mod.cast(extra.x_inner, ctx.dtype)

    u_t = jvp(lambda t: u_of(t, x_in)[0], (t_in,), (mod.ones_like(t_in),))[1]

    def flux(x):
        u, u_x = jvp(lambda xx: u_of(t_in, xx)[0], (x,), (mod.ones_like(x),))
        return k_of(u) * u_x

    q_x = jvp(flux, (x_in,), (mod.ones_like(x_in),))[1]

    res = [("eqn", u_t - q_x)]

    u_bound = u_of(mod.cast(extra.t_bound, ctx.dtype), mod.cast(extra.x_bound, ctx.dtype))[0]
    res += [("bound", u_bound - extra.u_bound)]

    if args.keep_init:
        u_init = u_of(mod.cast(extra.t_init, ctx.dtype), mod.cast(extra.x_init, ctx.dtype))[0]
        res += [("init", u_init - extra.u_init)]

    if extra.imp_size:
        imp_t, imp_x = mod.cast(extra.imp_points, ctx.dtype).T
        u_imp_net = u_of(imp_t, imp_x)[0]
        index = torch.as_tensor(extra.imp_indices, device=ctx.domain.device)
        u_imp = mod.flatten(mod.cast(extra.imp_u, ctx.dtype))[index]
        res += [("imp", (u_imp_net - u_imp) * args.kimp)]

    return res


def pinn_collocation(domain, args, extra):
    """Fills `extra` with the PINN's collocation points as the JAX example
    draws them (``examples/heat/heat.py``: the inner points, the x = 0 and
    x = 1 boundaries, then the initial row, from numpy's global RNG), the
    exact temperatures there and the measurements' points and flat indices,
    each a tensor on the domain's device (so the operator copies nothing to
    the card an epoch).  Returns the numbers of inner, initial and boundary
    points."""
    mod = domain.mod
    t_inner, x_inner = domain.random_inner(args.Nci)
    tb0, xb0 = domain.random_boundary(1, 0, args.Ncb)
    tb1, xb1 = domain.random_boundary(1, 1, args.Ncb)
    t_bound, x_bound = np.hstack((tb0, tb1)), np.hstack((xb0, xb1))
    t_init, x_init = domain.random_boundary(0, 0, args.Ncb)
    for name, value in (("t_inner", t_inner), ("x_inner", x_inner), ("t_bound", t_bound), ("x_bound", x_bound),
                        ("t_init", t_init), ("x_init", x_init)):
        setattr(extra, name, domain.cast(value))
    extra.u_init = initial_temperature(extra.t_init, extra.x_init, mod)
    extra.u_bound = initial_temperature(extra.t_bound, extra.x_bound, mod)
    extra.imp_points = domain.cast(extra.imp_points)
    extra.imp_indices = torch.as_tensor(np.asarray(extra.imp_indices, dtype=np.int64), device=domain.device)
    return len(t_inner), len(t_init), len(t_bound)


def pick_imposed(domain, args):
    """Chooses imposed-measurement cells; returns (mask, points, flat
    indices) as numpy arrays.  The band test runs on the domain's points in
    its dtype, as the JAX package's does."""
    rng = np.random.default_rng(args.seed)
    size = int(np.prod(domain.cshape))
    flat = np.arange(size)
    if args.imposed == "random":
        chosen = rng.permutation(flat)[: min(args.nimp, size)]
    elif args.imposed == "stripe":
        t = domain.points("t").cpu().numpy().flatten()
        band = flat[np.abs(t[flat] - 0.5) < 1 / 6]
        chosen = rng.permutation(band)[: min(args.nimp, band.size)]
    elif args.imposed == "none":
        chosen = np.array([], dtype=int)
    else:
        raise ValueError("Unknown imposed=" + args.imposed)
    chosen = np.unique(chosen)
    mask = np.zeros(size)
    if len(chosen):
        mask[chosen] = 1
        coords = [domain.points(i).cpu().numpy().flatten() for i in range(domain.ndim)]
        points = np.array(coords)[:, chosen].T
    else:
        points = np.zeros((0, domain.ndim))
    return mask.reshape(domain.cshape), points, chosen


def build(nt=64, nx=64, infer_k=False, imposed="none", nimp=200, noise=0.0, seed=1000, kimp=2.0, kxreg=0.0,
          ktreg=0.0, kwreg=0.0, kmax=0.1, arch_k=(5, 5), dtype=np.float32, multigrid=True, kernel="xla",
          device="cuda", ref_u=None, mesh=None, partition=None, args=None):
    """Builds the (inverse-)conductivity problem with a synthetic reference:
    (problem, state, extra).  The conductivity net's initial weights come
    from ``torch.Generator().manual_seed(seed)``.

    kernel: "pallas" (the row-wise kernels) or "xla" (the plain operator);
    the names are the JAX package's.  ref_u: the reference temperature on
    the grid (numpy; the measurements are taken from it), by default the
    initial temperature's bump at every time.  mesh/partition: the shards of
    the halo path (``parallel.Mesh``; evaluate with ``halo=True``)."""
    if kernel not in ("pallas", "xla"):
        raise ValueError(f"kernel={kernel!r}: heat has 'pallas' and 'xla'")
    if args is None:
        args = argparse.Namespace(
            infer_k=infer_k, imposed=imposed, nimp=nimp, noise=noise, seed=seed, kimp=kimp, kxreg=kxreg,
            kxregdecay=0, ktreg=ktreg, ktregdecay=0, kwreg=kwreg, kwregdecay=0, kmax=kmax, keep_frozen=1,
            keep_init=1, solver="odil",
        )
    domain = Domain(cshape=(nt, nx), dimnames=("t", "x"), multigrid=multigrid, dtype=dtype, device=device,
                    mesh=mesh, partition=partition)
    mod = domain.mod
    tt, xx = domain.points()
    x1 = domain.points_1d("x")
    init_u = initial_temperature(x1 * 0, mod.cast(x1, dtype), mod)
    ref_u = initial_temperature(tt, xx, mod) if ref_u is None else domain.cast(ref_u)

    imp_u = ref_u.cpu().numpy().copy()
    if args.noise:
        rng = np.random.default_rng(args.seed)
        imp_u = imp_u + rng.normal(loc=0, scale=args.noise, size=imp_u.shape)
    imp_mask, imp_points, imp_indices = pick_imposed(domain, args)

    extra = argparse.Namespace(
        args=args,
        ref_u=ref_u,
        ref_uk=np.linspace(0, 1, 200).astype(domain.dtype),
        init_u=mod.cast(init_u, dtype),
        imp_mask=mod.cast(imp_mask, dtype),
        imp_size=len(imp_points),
        imp_u=mod.cast(imp_u, dtype),
        imp_indices=imp_indices,
        imp_points=imp_points,
    )
    extra.ref_k = true_conductivity(extra.ref_uk)

    state = State(fields={"u": np.zeros(domain.cshape)})
    if args.infer_k:
        gen = torch.Generator().manual_seed(int(args.seed))
        state.fields["k_net"] = domain.make_neural_net([1] + list(arch_k) + [1], gen)
    state = domain.init_state(state)
    op = operator_odil_fused if kernel == "pallas" else operator_odil
    return Problem(op, domain, extra), state, extra


# -- tmax inference ---------------------------------------------------------


def exact_u_tmax(t, x, tmax_ref):
    """Solution of u_t = u_xx on [0, pi]: sin(x) exp(-t), time scaled (numpy)."""
    return np.sin(np.asarray(x)) * np.exp(-np.asarray(t) * tmax_ref)


def clamp_initial_row(u, extra, mod):
    """Replaces the first time row with the exact initial condition."""
    return mod.concatenate([extra.u_init[None, :], u[1:]], axis=0)


def operator_tmax(ctx):
    mod = ctx.mod
    dt, dx = ctx.step("t", "x")
    it, ix = ctx.indices("t", "x", loc="nc")
    nt, nx = ctx.size("t", "x")
    coeff = ctx.field("coeff")
    extra = ctx.extra
    args = extra.args

    offsets = [(0, 0), (0, -1), (0, 1), (-1, 0), (-1, -1), (-1, 1)]

    def sample(offset):
        # Shift, clamp the initial row in the unshifted frame, shift back:
        # ctx.field stays the only source of the stencil's samples.
        raw = ctx.field("u", *offset)
        unshifted = mod.roll(raw, offset, (0, 1))
        clamped = clamp_initial_row(unshifted, extra, mod)
        return mod.roll(clamped, [-s for s in offset], (0, 1))

    u, uxm, uxp, um, umxm, umxp = [sample(o) for o in offsets]

    # Zero Dirichlet via odd reflection at both walls.
    uxm = mod.where(ix == 0, -u, uxm)
    uxp = mod.where(ix == nx - 1, -u, uxp)
    umxm = mod.where(ix == 0, -um, umxm)
    umxp = mod.where(ix == nx - 1, -um, umxp)

    dt = dt * coeff[0]  # The inferred tmax stretches the time axis.

    u_t = (u - um) / dt
    lap_prev = (umxm - 2 * um + umxp) / dx**2
    lap_here = (uxm - 2 * u + uxp) / dx**2
    fu = u_t - 0.5 * (lap_here + lap_prev)
    fu = mod.where(it == 0, ctx.cast(0), fu)
    res = [("eqn", fu)]

    # One measured value at the center of the final row.
    ixc = nx // 2
    res += [("imp", args.kimp * (u[-1, ixc] - extra.u_final[ixc]))]
    return res


def build_tmax(nt=64, nx=64, tmax_ref=4.5, tmax_init=1.0, kimp=1.0, dtype=np.float64, multigrid=True,
               mg_interp=None, mg_nlvl=None, device="cuda", args=None):
    """Builds the tmax-inference problem: (problem, state, extra)."""
    if args is None:
        args = argparse.Namespace(kimp=kimp, tmax_ref=tmax_ref, tmax_init=tmax_init)
    domain = Domain(
        cshape=(nt, nx),
        dimnames=("t", "x"),
        lower=(0, 0),
        upper=(1, np.pi),
        dtype=dtype,
        multigrid=multigrid,
        mg_interp=mg_interp,
        mg_nlvl=mg_nlvl,
        device=device,
    )
    tt, xx = (p.cpu().numpy() for p in domain.points(loc="nc"))
    xone = domain.points_1d("x", loc="c").cpu().numpy()
    ref_u = exact_u_tmax(tt, xx, args.tmax_ref)
    u_init = exact_u_tmax(np.full_like(xone, domain.lower[0]), xone, args.tmax_ref)
    u_final = exact_u_tmax(np.full_like(xone, domain.upper[0]), xone, args.tmax_ref)

    state = domain.init_state(
        State(fields={"u": Field(np.tile(u_init, [nt + 1, 1]), loc="nc"), "coeff": Array([args.tmax_init])})
    )
    extra = argparse.Namespace(ref_u=ref_u, u_init=domain.cast(u_init), u_final=domain.cast(u_final), args=args)
    return Problem(operator_tmax, domain, extra), state, extra


def eval_u_net(domain, state):
    """The PINN temperature net evaluated at the cell centers."""
    tt, xx = domain.points()
    return eval_neural_net(state.fields["u_net"], [tt, xx])[0]
