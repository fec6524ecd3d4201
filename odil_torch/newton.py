"""Matrix-free Gauss-Newton on the device.

PyTorch counterpart of ``odil_tpu/newton.py``.  The products J v and J^T w
of the concatenated-residual map f (``Problem.residual_fn``) are
``torch.func.jvp`` and ``torch.func.vjp`` of f, so the damped normal
equations

    (J^T J + damp^2 I + dampdiag^2 diag(J^T J)) delta = -J^T r

are solved by (preconditioned) conjugate gradients with no Jacobian ever
formed, every vector on the domain's device.  The preconditioners:

- Jacobi, with diag(J^T J) estimated by Hutchinson probes
  (``estimate_normal_diag``);
- squared BPX (``make_bpx_parts``) and the geometric V-cycle with Chebyshev
  smoothing and an exact coarse solve (``make_vcycle_parts``), for states
  of plain grid Fields.

``cg`` is the algorithm of ``jax.scipy.sparse.linalg.cg`` (jax 0.9:
``_cg_solve`` and ``_isolve``), run in chunks of iterations whose updates
are masked once the stopping test fails, so the host waits for the device
once a chunk rather than once an iteration.

Every random probe (Rademacher and normal) comes from ``draw`` with the
``torch.Generator`` that the driver seeds from ``--seed``, in the order in
which the JAX package draws from ``jax.random``; a test can replace
``draw`` to replay the JAX package's draws.

Over several processes (a residual map of ``halo.make_halo_residual_fn``
on a mesh that spans them) the packed state and every x-space vector are
whole and the same on every process, and the residual vector is split: each
process holds its shards' part.  A transposed product J^T w is the sum, in
rank order, of the processes' pullbacks (``f.reduce_x``), and the
residual's sums of squares are folded over the shards in shard order
(``f.term_sums``); the residual-space probes are drawn whole on every
process from the same generator and each keeps its part (``f.local_part``).
Everything else (CG, the Jacobi diagonal, BPX, the V-cycle) runs unchanged
on the whole x-space vectors, so every process's iterate has the same bits.
"""

from argparse import Namespace

import numpy as np
import torch
from torch.func import jvp, vjp

from .fields import Field, field_arrays
from .transfer import interp_to_finer
from .util import printlog

__all__ = [
    "cg",
    "draw",
    "estimate_normal_diag",
    "gauss_newton_step",
    "make_bpx_parts",
    "make_bpx_preconditioner",
    "make_vcycle_parts",
    "make_vcycle_preconditioner",
    "optimize_gauss_newton",
]

# CG iterations between two host syncs.
CG_CHUNK = 10


def draw(kind, shape, dtype, device, generator):
    """One random probe: ``kind`` "rademacher" (+-1 with equal odds) or
    "normal" (standard normal), of `shape` and `dtype` on `device`."""
    shape = tuple(int(n) for n in shape)
    if kind == "rademacher":
        bits = torch.randint(0, 2, shape, generator=generator, device=device)
        return (2 * bits - 1).to(dtype)
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    raise ValueError(f"Unknown draw kind {kind!r}")


def _vdot(a, b):
    return torch.sum(a * b)


def _pullback(f, x):
    """(r(x), w -> J^T w): over processes (``f.reduce_x``) the sum of every
    process's pullback of its part of w."""
    r0, pullback = vjp(f, x)
    reduce = getattr(f, "reduce_x", None)
    if reduce is None:
        return r0, lambda w: pullback(w)[0]
    return r0, lambda w: reduce(pullback(w)[0])


def _term_means(f, r, sizes):
    """The mean square of each term of the residual vector r; over
    processes (``f.term_sums``) of the whole vector, from every process's
    part."""
    sums = getattr(f, "term_sums", None)
    if sums is None:
        return [torch.mean(torch.square(p)) for p in torch.split(r, list(sizes))]
    return [s / n for s, n in zip(sums(r).unbind(), f.term_counts)]


def _mean_square(f, r):
    """The mean square of the whole residual vector r."""
    sums = getattr(f, "term_sums", None)
    if sums is None:
        return torch.mean(torch.square(r))
    return torch.sum(sums(r)) / sum(f.term_counts)


def cg(A, b, tol=1e-5, atol=0.0, maxiter=None, M=None):
    """Solves A x = b for a symmetric positive definite operator `A`
    (a function of a vector) from x0 = 0: ``jax.scipy.sparse.linalg.cg``'s
    iteration, its stopping test ``rs > max(tol^2 |b|^2, atol^2)`` with
    ``rs = gamma`` without a preconditioner and ``|r|^2`` with one, and at
    most `maxiter` iterations (10 n by default).

    The iterations run in chunks of ``CG_CHUNK``; within
    a chunk each update is masked by the stopping test, so the iterate is
    the one of JAX's ``while_loop`` and the host reads the test once a
    chunk.  Returns (x, stats): stats = {"iterations": updates made,
    "matvecs": products with A, "syncs": host reads}."""
    if maxiter is None:
        maxiter = 10 * b.numel()
    precond = M is not None
    M = M if precond else (lambda v: v)
    atol2 = torch.clamp(tol * tol * _vdot(b, b), min=atol * atol)
    x = torch.zeros_like(b)
    r = b - A(x)
    p = z = M(r)
    gamma = _vdot(r, z)
    done = torch.zeros((), dtype=torch.int64, device=b.device)
    live = torch.ones((), dtype=torch.bool, device=b.device)
    stats = {"iterations": 0, "matvecs": 1, "syncs": 0}
    k = 0
    while k < maxiter:
        for _ in range(min(CG_CHUNK, maxiter - k)):
            rs = _vdot(r, r) if precond else gamma
            live = live & (rs > atol2)
            Ap = A(p)
            alpha = gamma / _vdot(p, Ap)
            x_ = x + alpha * p
            r_ = r - alpha * Ap
            z_ = M(r_)
            gamma_ = _vdot(r_, z_)
            p_ = z_ + (gamma_ / gamma) * p
            x, r, p = torch.where(live, x_, x), torch.where(live, r_, r), torch.where(live, p_, p)
            gamma = torch.where(live, gamma_, gamma)
            done = done + live.to(done.dtype)
            stats["matvecs"] += 1
            k += 1
        stats["syncs"] += 1
        if not bool(live):
            break
    stats["iterations"] = int(done)
    return x, stats


def estimate_normal_diag(f, x, generator, nprobe=8):
    """Hutchinson estimate of diag(J^T J) at x: the mean of (J^T z)^2 over
    `nprobe` Rademacher probes z in the residual space (in r(x)'s dtype)."""
    r0, pullback = _pullback(f, x)
    local = getattr(f, "local_part", None)
    shape = r0.shape if local is None else (sum(f.term_counts),)
    probes = [draw("rademacher", shape, r0.dtype, r0.device, generator) for _ in range(nprobe)]
    if local is not None:
        probes = [local(z) for z in probes]
    return torch.mean(torch.stack([torch.square(pullback(z)) for z in probes]), dim=0)


def _field_layout(domain, state):
    """(key, loc, shape, offset, size) of every plain grid Field in the
    packed vector; None if any unknown is not a plain Field."""
    layout = []
    offset = 0
    for key, fobj in state.fields.items():
        size = sum(int(np.prod(a.shape)) for a in field_arrays(fobj))
        if not isinstance(fobj, Field):
            return None
        layout.append((key, fobj.loc, tuple(fobj.array.shape), offset, size))
        offset += size
    return layout


def _mg_levels(shape, loc):
    """Level count: how many times every axis can halve (cells >= 4)."""
    cells = [n - (1 if c == "n" else 0) for n, c in zip(shape, loc)]
    nlvl = 1
    while all(n % 2 == 0 and n >= 4 for n in cells):
        cells = [n // 2 for n in cells]
        nlvl += 1
    return nlvl


def _level_cshape(shape, loc, lvl):
    return tuple(((n - (1 if c == "n" else 0)) >> lvl) + (1 if c == "n" else 0) for n, c in zip(shape, loc))


def _adjoint(fn, zeros):
    """The adjoint of the linear map `fn` (a function of the tensors
    `zeros` are shaped like): its vjp, taken once and reused."""
    return vjp(fn, *zeros)[1]


def make_bpx_parts(domain, state, normal_mv_at, x_template, nprobe=4):
    """Squared-BPX preconditioner as a (setup, apply) pair
    (``odil_tpu/newton.py:89``).

    normal_mv_at(x, v): the normal matvec linearized at x.
    setup(x, generator) -> pstate, the per-level scales (0-dim tensors on
    the device); apply(pstate, v) applies M = H o H with
    H = sum_l s_l P_l P_l^T per grid field (P_l the prolongation chain,
    P_l^T its adjoint) and s_l ~ 1/sqrt(mean diag of P_l^T N P_l) from
    Rademacher probes through the normal operator.  None for non-Field
    unknowns."""
    layout = _field_layout(domain, state)
    if layout is None:
        return None
    x0 = x_template

    def prolong_fn(loc, lvl):
        return lambda z: interp_to_finer(z, loc=loc, depth=lvl)

    # The restrictions P_l^T of each field and level, fixed linear maps.
    adjoints = []
    for _, loc, shape, _, _ in layout:
        adjoints.append({
            lvl: _adjoint(prolong_fn(loc, lvl), [torch.zeros(_level_cshape(shape, loc, lvl), dtype=x0.dtype,
                                                             device=x0.device)])
            for lvl in range(1, _mg_levels(shape, loc))
        })

    def setup(x, generator):
        scales = []
        for _, loc, shape, offset, size in layout:
            s_levels = []
            for lvl in range(_mg_levels(shape, loc)):
                cshape_l = _level_cshape(shape, loc, lvl)
                acc = 0.0
                for _ in range(nprobe):
                    z = draw("rademacher", cshape_l, x0.dtype, x0.device, generator)
                    pz = interp_to_finer(z, loc=loc, depth=lvl)
                    w = torch.zeros_like(x0)
                    w[offset : offset + size] = pz.reshape(-1)
                    acc = acc + _vdot(w, normal_mv_at(x, w))
                est = acc / (nprobe * int(np.prod(cshape_l)))
                s_levels.append(1.0 / torch.sqrt(torch.clamp(est, min=1e-30)))
            scales.append(s_levels)
        return scales

    def apply(pstate, v):
        def half_sweep(v):
            out = torch.zeros_like(v)
            for (_, loc, shape, offset, size), s_levels, adj in zip(layout, pstate, adjoints):
                vf = v[offset : offset + size].reshape(shape)
                contrib = s_levels[0] * vf
                for lvl in range(1, len(s_levels)):
                    contrib = contrib + s_levels[lvl] * interp_to_finer(adj[lvl](vf)[0], loc=loc, depth=lvl)
                out[offset : offset + size] = contrib.reshape(-1)
            return out

        return half_sweep(half_sweep(v))

    return setup, apply


def make_bpx_preconditioner(domain, state, normal_matvec, x0, generator, nprobe=4):
    """The squared-BPX preconditioner M(v) frozen at x0 (normal_matvec is
    already linearized there); None for non-Field unknowns."""
    parts = make_bpx_parts(domain, state, lambda x, v: normal_matvec(v), x0, nprobe=nprobe)
    if parts is None:
        return None
    setup, apply = parts
    pstate = setup(x0, generator)
    return lambda v: apply(pstate, v)


def _columns(fn, m, dtype, device, batch):
    """The rows fn(e_j) for the unit vectors e_j of size m, batched with
    ``torch.func.vmap`` over chunks of `batch` unit vectors: (m, m)."""
    eye = torch.eye(m, dtype=dtype, device=device)
    return torch.cat([torch.func.vmap(fn)(eye[i : i + batch]) for i in range(0, m, batch)])


def make_vcycle_parts(
    domain,
    state,
    normal_mv_at,
    x_template,
    degree=3,
    cheb_alpha=16.0,
    nprobe=8,
    npower=12,
    max_nlvl=None,
    coarse_ridge=1e-8,
    dense_cutoff=1024,
):
    """Geometric V-cycle preconditioner as a (setup, apply) pair
    (``odil_tpu/newton.py:184``).

    The level-l operator is the matrix-free Galerkin product
    N_l = P_l^T N P_l.  One symmetric V-cycle per application: Chebyshev
    smoothing of the given degree on D_l^-1 N_l over [lmax/cheb_alpha,
    lmax] (D_l a Hutchinson diagonal, lmax by power iteration on
    D_l^-1 N_l), and an exact solve on the first level with at most
    `dense_cutoff` unknowns, whose Galerkin matrix is formed column by
    column (``torch.func.vmap`` over chunks of unit vectors) and inverted
    on the host.  setup(x, generator) -> pstate rebuilds it at a new
    linearization point; apply(pstate, v) applies it.  None for non-Field
    unknowns, fewer than two levels or a coarse level above 4096
    unknowns."""
    layout = _field_layout(domain, state)
    if layout is None:
        return None
    x0 = x_template
    dtype, device = x0.dtype, x0.device

    nlvls = [_mg_levels(shape, loc) for _, loc, shape, _, _ in layout]
    L = max(nlvls)
    if max_nlvl:
        L = min(L, int(max_nlvl))
    if L < 2:
        return None

    def fdepth(i, lvl):
        # Fields shallower than the hierarchy stay at their own coarsest.
        return min(lvl, nlvls[i] - 1)

    def shapes_at(lvl):
        return [_level_cshape(shape, loc, fdepth(i, lvl)) for i, (_, loc, shape, _, _) in enumerate(layout)]

    # Truncate at the first level small enough for an exact dense solve.
    for lvl in range(1, L):
        if sum(int(np.prod(s)) for s in shapes_at(lvl)) <= dense_cutoff:
            L = lvl + 1
            break

    def zeros_at(lvl):
        return tuple(torch.zeros(s, dtype=dtype, device=device) for s in shapes_at(lvl))

    def unflatten0(v):
        return tuple(v[offset : offset + size].reshape(shape) for (_, _, shape, offset, size) in layout)

    def flatten0(fields):
        return torch.cat([f.reshape(-1) for f in fields])

    def make_N(lvl):
        depths = [fdepth(i, lvl) for i in range(len(layout))]

        def prolong(*fields_l):
            return flatten0(tuple(
                interp_to_finer(z, loc=loc, depth=d) if d else z for (_, loc, *_), z, d in zip(layout, fields_l, depths)
            ))

        adj = _adjoint(prolong, zeros_at(lvl))

        def N_l(x, fields_l):
            return adj(normal_mv_at(x, prolong(*fields_l)))

        return N_l

    N_ops = [make_N(lvl) for lvl in range(L)]

    def prolong_adj(lvl):
        def fn(*fields_c):
            out = []
            for i, ((_, loc, *_), z) in enumerate(zip(layout, fields_c)):
                if fdepth(i, lvl + 1) > fdepth(i, lvl):
                    z = interp_to_finer(z, loc=loc, depth=1)
                out.append(z)
            return tuple(out)

        return fn

    prolongs = [prolong_adj(lvl) for lvl in range(L - 1)]
    restricts = [_adjoint(prolongs[lvl], zeros_at(lvl + 1)) for lvl in range(L - 1)]

    def setup_level(x, generator, lvl):
        """The smoother data of level `lvl` at x: (D^-1, theta, delta)."""
        N_l = N_ops[lvl]
        zeros_l = zeros_at(lvl)
        acc = [torch.zeros_like(z) for z in zeros_l]
        for _ in range(nprobe):
            z = tuple(draw("rademacher", zl.shape, dtype, device, generator) for zl in zeros_l)
            nz = N_l(x, z)
            acc = [a + zi * ni for a, zi, ni in zip(acc, z, nz)]

        def _fix(a):
            m = torch.mean(torch.abs(a)) / nprobe + 1e-30
            a = a / nprobe
            return torch.where(a > 0.01 * m, a, m)

        dinv = [1.0 / _fix(a) for a in acc]
        # Power iteration on D^-1 N for a stable Chebyshev upper bound.
        y = tuple(draw("normal", zl.shape, dtype, device, generator) for zl in zeros_l)
        lam = torch.ones((), dtype=dtype, device=device)
        for _ in range(npower):
            ny = torch.sqrt(sum(torch.sum(torch.square(yi)) for yi in y))
            y = tuple(yi / (ny + 1e-30) for yi in y)
            w = tuple(di * ni for di, ni in zip(dinv, N_l(x, y)))
            lam = torch.sqrt(sum(torch.sum(torch.square(wi)) for wi in w))
            y = w
        lmax = 1.1 * lam
        lmin = lmax / cheb_alpha
        return dinv, 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)

    def cheb_smooth(Nx_l, dinv, theta, delta, b, v=None):
        """`degree` steps of preconditioned Chebyshev for N_l v = b on the
        interval [theta-delta, theta+delta] of D^-1 N_l (Saad Alg. 12.1);
        v=None starts from zero (one matvec fewer)."""
        r = b if v is None else tuple(bi - ni for bi, ni in zip(b, Nx_l(v)))
        d = tuple(di * ri / theta for di, ri in zip(dinv, r))
        v = d if v is None else tuple(vi + di for vi, di in zip(v, d))
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            r = tuple(ri - ni for ri, ni in zip(r, Nx_l(d)))
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = tuple((rho_new * rho) * dk + (2.0 * rho_new / delta) * di * ri for dk, di, ri in zip(d, dinv, r))
            v = tuple(vi + di for vi, di in zip(v, d))
            rho = rho_new
        return v

    # Exact coarse solve.
    N_c = N_ops[L - 1]
    zeros_c = zeros_at(L - 1)
    sizes_c = [int(np.prod(z.shape)) for z in zeros_c]
    m = sum(sizes_c)
    if m > 4096:
        return None

    def unpack_c(v):
        out, o = [], 0
        for zl, n in zip(zeros_c, sizes_c):
            out.append(v[o : o + n].reshape(zl.shape))
            o += n
        return tuple(out)

    def pack_c(fields):
        return torch.cat([f.reshape(-1) for f in fields])

    def setup(x, generator):
        """The preconditioner state at linearization point x."""
        smoothers = [setup_level(x, generator, lvl) for lvl in range(L - 1)]
        # Chunks of unit vectors sized so that a chunk's fine vectors stay
        # near 2^24 entries.
        batch = max(1, min(256, 2**24 // x.numel()))
        A = _columns(lambda e: pack_c(N_c(x, unpack_c(e))), m, dtype, device, batch).cpu().numpy()
        A = 0.5 * (A + A.T)
        ridge = coarse_ridge * max(float(np.trace(A)) / m, 1e-30)
        Minv_c = torch.as_tensor(np.linalg.inv(A + ridge * np.eye(m)), dtype=dtype, device=device)
        return {"x": x, "smooth": smoothers, "Minv": Minv_c}

    def apply(pstate, v):
        x = pstate["x"]

        def vcycle(r, lvl):
            if lvl == L - 1:
                return unpack_c(pstate["Minv"] @ pack_c(r))
            N_l = N_ops[lvl]

            def Nx_l(fl):
                return N_l(x, fl)

            dinv, theta, delta = pstate["smooth"][lvl]
            v = cheb_smooth(Nx_l, dinv, theta, delta, r)  # pre-smooth from zero
            res = tuple(ri - ni for ri, ni in zip(r, Nx_l(v)))
            vc = vcycle(restricts[lvl](res), lvl + 1)
            v = tuple(vi + pi for vi, pi in zip(v, prolongs[lvl](*vc)))
            return cheb_smooth(Nx_l, dinv, theta, delta, r, v=v)  # post-smooth

        return flatten0(vcycle(unflatten0(v), 0))

    return setup, apply


def make_vcycle_preconditioner(domain, state, normal_matvec, x0, generator, **kwargs):
    """The V-cycle preconditioner M(v) frozen at x0 (normal_matvec is
    already linearized there)."""
    parts = make_vcycle_parts(domain, state, lambda x, v: normal_matvec(v), x0, **kwargs)
    if parts is None:
        return None
    setup, apply = parts
    pstate = setup(x0, generator)
    return lambda v: apply(pstate, v)


def gauss_newton_step(f, x, damp=0.0, dampdiag=0.0, tol=1e-6, maxiter=100, precond_diag=None, precond=None,
                      term_sizes=None):
    """One Gauss-Newton update of the residual map `f` at `x`: (x + delta,
    info) with delta from CG on the damped normal equations.

    precond_diag: an estimate of diag(J^T J), for Jacobi preconditioning
    and the dampdiag term; precond: a preconditioner M(v).  info holds
    "loss" (the mean square of r(x)), the CG's "iterations", "matvecs" and
    "syncs", and with `term_sizes` the per-term mean squares of r(x)
    ("terms"), "step_norm" and "x_norm" (0-dim tensors on the device)."""
    r0, pullback = _pullback(f, x)

    def normal_matvec(v):
        av = pullback(jvp(f, (x,), (v,))[1])
        if damp:
            av = av + (damp * damp) * v
        if dampdiag and precond_diag is not None:
            av = av + (dampdiag * dampdiag) * precond_diag * v
        return av

    M = precond
    if M is None and precond_diag is not None:
        inv = 1.0 / torch.clamp(precond_diag + damp * damp, min=1e-30)

        def M(v):
            return inv * v

    rhs = -pullback(r0)
    delta, stats = cg(normal_matvec, rhs, tol=tol, maxiter=maxiter, M=M)
    info = dict(stats, loss=_mean_square(f, r0.detach()))
    if term_sizes is not None:
        info["terms"] = _term_means(f, r0.detach(), term_sizes)
        info["step_norm"] = torch.linalg.norm(delta)
        info["x_norm"] = torch.linalg.norm(x)
    return (x + delta).detach(), info


def optimize_gauss_newton(args, problem, state, callback=None, **kwargs):
    """The Gauss-Newton driver (``odil_tpu/newton.py:511``): one matrix-free
    step an epoch.

    Flags of the linsolver group: --linsolver_tol, --linsolver_damp,
    --linsolver_dampdiag, --linsolver_maxiter (CG iterations, default 100).
    --linsolver multigrid: squared BPX, vcycle: the geometric V-cycle (both
    for states of plain grid Fields, else Jacobi); cg (or dampdiag > 0):
    Jacobi; otherwise plain CG.  The callback of epoch e fires one epoch
    late, from the terms of the step's own residual, and the last one from
    one more evaluation.  A multilevel preconditioner is rebuilt every
    --linsolver_precond_every epochs, or (0) when the loss reduction stalls
    below 1.5x while the iterate still moves, at most every 3 epochs.

    Sets ``problem.solver_stats``: epochs, normal matvecs, CG iterations and
    host syncs of the CG, summed over the run."""
    domain = problem.domain
    f, x = problem.residual_fn(state, halo=bool(getattr(args, "halo", 0)))
    damp = getattr(args, "linsolver_damp", 0.0) or 0.0
    dampdiag = getattr(args, "linsolver_dampdiag", 0.0) or 0.0
    tol = getattr(args, "linsolver_tol", 1e-6)
    maxiter = getattr(args, "linsolver_maxiter", None) or 100
    linsolver = getattr(args, "linsolver", "")
    use_bpx = linsolver == "multigrid"
    use_vcycle = linsolver == "vcycle"
    use_jacobi = linsolver == "cg" or dampdiag > 0
    generator = torch.Generator(device=x.device)
    generator.manual_seed(int(getattr(args, "seed", 0) or 0))

    def normal_mv_at(xl, v):
        return _pullback(f, xl)[1](jvp(f, (xl,), (v,))[1])

    names = f.term_names
    sizes = f.term_sizes
    setup = None
    if use_bpx or use_vcycle:
        if use_vcycle:
            # --nlvl caps the hierarchy depth, --smooth_pre sets the
            # Chebyshev degree, --ndirect^2 scales the coarse-solve cutoff.
            nlvl = getattr(args, "nlvl", None)
            degree = getattr(args, "smooth_pre", None) or 3
            ndirect = getattr(args, "ndirect", None)
            parts = make_vcycle_parts(
                domain, state, normal_mv_at, x, degree=max(1, int(degree)),
                max_nlvl=nlvl if nlvl and nlvl < 100 else None,
                dense_cutoff=max(1024, int(ndirect) ** 2) if ndirect else 1024,
            )
        else:
            parts = make_bpx_parts(domain, state, normal_mv_at, x)
        if parts is None:
            printlog("Multilevel preconditioner unavailable (non-Field unknowns or no grid hierarchy); using Jacobi")
            use_bpx, use_vcycle, use_jacobi = False, False, True
        else:
            setup, apply_M = parts
            pstate = setup(x, generator)

            def step(x):
                return gauss_newton_step(f, x, damp=damp, tol=tol, maxiter=maxiter,
                                         precond=lambda v: apply_M(pstate, v), term_sizes=sizes)
    if setup is None and use_jacobi:
        nprobe = int(getattr(args, "gn_nprobe", 0) or 8)

        def step(x):
            diag = estimate_normal_diag(f, x, generator, nprobe=nprobe)
            return gauss_newton_step(f, x, damp=damp, dampdiag=dampdiag, tol=tol, maxiter=maxiter,
                                     precond_diag=diag, term_sizes=sizes)
    elif setup is None:

        def step(x):
            return gauss_newton_step(f, x, damp=damp, tol=tol, maxiter=maxiter, term_sizes=sizes)

    def term_stats(x):
        with torch.no_grad():
            return _term_means(f, f(x), sizes)

    def pinfo_from_terms(terms):
        terms = list(torch.stack(terms).cpu().numpy())
        norms = [np.sqrt(max(float(t), 0.0)) for t in terms]
        return {"terms": terms, "names": names, "norms": norms, "loss": float(np.sum(terms))}

    kind = ", BPX-preconditioned" if use_bpx else ", V-cycle-preconditioned" if use_vcycle else \
        ", Jacobi-preconditioned" if use_jacobi else ""
    printlog(f"Running Gauss-Newton (matrix-free CG{kind}) optimizer")
    if callback:
        callback(state, args.epoch_start, pinfo_from_terms(term_stats(x)))

    precond_every = int(getattr(args, "linsolver_precond_every", 0) or 0)
    last_rebuild = args.epoch_start
    loss_prev = None
    stats = problem.solver_stats = {"epochs": 0, "matvecs": 0, "iterations": 0, "syncs": 0}
    evals = 0
    for epoch in range(args.epoch_start, args.epochs):
        x_new, info = step(x)
        evals += 1
        for k in ("matvecs", "iterations", "syncs"):
            stats[k] += info[k]
        stats["epochs"] += 1
        # info["terms"] describe the pre-step point: the callback of this
        # boundary fires now, one iteration late.
        pinfo = pinfo_from_terms(info["terms"])
        if callback and epoch > args.epoch_start:
            domain.unpack_state(x, state)
            callback(state, epoch, pinfo)
        loss_now = pinfo["loss"]
        if setup is not None:
            due = precond_every > 0 and (epoch + 1 - last_rebuild) >= precond_every
            stalled = (
                precond_every == 0
                and loss_prev is not None
                and loss_now > loss_prev / 1.5
                and float(info["step_norm"]) > 1e-6 * (1.0 + float(info["x_norm"]))
                and (epoch + 1 - last_rebuild) >= 3
            )
            if due or stalled:
                pstate = setup(x_new, generator)
                last_rebuild = epoch + 1
        loss_prev = loss_now
        x = x_new
    domain.unpack_state(x, state)
    if callback and args.epochs > args.epoch_start:
        callback(state, args.epochs, pinfo_from_terms(term_stats(x)))
    if stats["epochs"]:
        n = stats["epochs"]
        printlog(f"Gauss-Newton: {stats['matvecs'] / n:.1f} normal matvecs, {stats['iterations'] / n:.1f} CG "
                 f"iterations and {stats['syncs'] / n:.1f} CG host syncs an epoch")
    arrays = domain.arrays_from_state(state)
    return arrays, Namespace(epochs=args.epochs, evals=evals)
