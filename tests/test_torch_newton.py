"""Newton's method and the linear solvers of the port against the JAX package
on the CPU in fp64.

- The linearization on the fixture of tests/test_newton.py (staggered
  locations with a shift, masked boundary rows, an ``Array`` and a linear
  ``NeuralNet``): ``eval_operator_grad`` (the same descriptors, arrays
  within 1e-12), ``linearize`` (the same CSR structure, values within
  1e-12), one exact Newton step (RMS < 1e-6) and a scalar residual term.
- ``linsolver.solve`` over its menu and ``amg.build_hierarchy`` with its
  cycle: the same numbers as the JAX package's on the same matrix (to the
  bit: both are NumPy and SciPy).
- ``newton.cg`` against ``jax.scipy.sparse.linalg.cg`` on a seeded SPD
  system, with and without a preconditioner, stopping by ``tol`` and by
  ``maxiter`` (the iterate within 1e-12); the chunked, masked loop gives the
  same bits for every chunk length.
- The forward-mode products through each model's plain operator (heat,
  poisson, wave, veltracer, advection, heat_tmax): ``torch.func.jvp`` and
  ``vjp`` of ``residual_fn`` against ``jax.jvp``/``jax.vjp`` at one state.
- ``estimate_normal_diag``, the BPX and V-cycle ``setup``/``apply`` and
  ``optimize_gauss_newton`` with ``cg``, ``multigrid`` and ``vcycle`` on
  Poisson, with the JAX package's random probes replayed: on the JAX side
  ``jax.random.rademacher`` and ``jax.random.normal`` record their draws
  through ordered ``jax.debug.callback``s (``jax.vmap`` as a loop, so the
  Hutchinson probes are single draws), and ``odil_torch.newton.draw``
  hands them out in order.  pstate and the driver's rows within 1e-9.

CG amplifies a one-ulp difference in the normal matvec, in either package:
on Poisson 8^2 with BPX the step's distance grows ~100-fold an iteration
from the third (the packages' rows part by 3% after two 5-iteration
epochs), and plain CG on Poisson 16^2 keeps 1e-15 for 20 iterations and
parts by ~1e-6 after 40.  So the drivers run CG budgets short enough for
roundoff to stay below 1e-9 over three epochs (2 iterations with BPX).
"""

import argparse
import contextlib
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import odil_torch as todil  # noqa: E402
from odil_torch import amg as tamg  # noqa: E402
from odil_torch import linsolver as tlin  # noqa: E402
from odil_torch import newton as tn  # noqa: E402
from odil_torch.convert import arrays_from_numpy  # noqa: E402

DT = np.float64


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


# -- the fixture of tests/test_newton.py ------------------------------------


def _operator(ctx):
    mod = ctx.mod
    extra = ctx.extra
    res = []
    # Face values read at cells: derivative equation.
    u_xm = ctx.field("ufx", 0, 0, loc="cc")
    u_xp = ctx.field("ufx", 1, 0, loc="cc")
    hx = ctx.step("x")
    res += [(u_xp - u_xm) / hx - extra.ref["dudx"]]
    # Boundary rows at x=0, masked elsewhere.
    ufx = ctx.field("ufx")
    ixfx = ctx.indices("x", loc="nc")
    mask = mod.where(ixfx == 0, ctx.cast(1), ctx.cast(0))
    res += [(ufx - extra.ref["ufx"]) * mask]
    # Cell average of the two faces.
    uc = ctx.field("uc")
    res += [(u_xp + u_xm) * 0.5 - uc]
    # Non-grid array: full Jacobian.
    a = ctx.field("a")
    res += [a - extra.ref["a"]]
    # Linear neural network.
    net_out = ctx.neural_net("net")(*extra.ref["net_in"])
    for i in range(extra.nnet):
        res += [(f"net{i}", net_out[i] - extra.ref["net_out"][i])]
    return res


def _fixture(Nx=3, Ny=2, Na=5, Nnet=5, seed=1000):
    """The linear fixture of tests/test_newton.py in both packages, the same
    numbers in each (the JAX package's linear net carried across)."""
    import odil_tpu as jodil

    rng = np.random.RandomState(seed)
    jdom = jodil.Domain(cshape=(Nx, Ny), dimnames=["x", "y"], lower=(0, 0), upper=(Nx, Ny), dtype=DT)
    # The JAX backend seeds an unseeded key from the OS: the net would differ run to run.
    jdom.mod.random.set_seed(seed)
    net = jdom.make_neural_net([Nnet, Nnet], activation="none")
    jstate = jdom.init_state(jodil.State(fields={
        "uc": jodil.Field(np.ones(jdom.size(loc="cc")), loc="cc"),
        "ufx": jodil.Field(np.ones(jdom.size(loc="nc")), loc="nc"),
        "a": jodil.Array(np.zeros(Na, dtype=DT)),
        "net": net,
    }))
    tdom = todil.Domain(cshape=(Nx, Ny), dimnames=["x", "y"], lower=(0, 0), upper=(Nx, Ny), dtype=DT, device="cpu")
    tnet = todil.NeuralNet([torch.tensor(np.asarray(w)) for w in net.weights],
                           [torch.tensor(np.asarray(b)) for b in net.biases])
    tstate = tdom.init_state(todil.State(fields={
        "uc": todil.Field(np.ones(tdom.size(loc="cc")), loc="cc"),
        "ufx": todil.Field(np.ones(tdom.size(loc="nc")), loc="nc"),
        "a": todil.Array(np.zeros(Na, dtype=DT)),
        "net": tnet,
    }))

    def func(x, y):
        return 0.25 * x * y

    xc, yc = map(np.asarray, jdom.points(loc="cc"))
    xfx, yfx = map(np.asarray, jdom.points(loc="nc"))
    ref = {"uc": func(xc, yc), "ufx": func(xfx, yfx), "dudx": 0.25 * yc, "a": np.linspace(0, 1, Na, dtype=DT),
           "net_in": rng.rand(Nnet, Nnet + 1), "net_out": rng.rand(Nnet, Nnet + 1)}
    jextra = argparse.Namespace(ref=ref, nnet=Nnet)
    textra = argparse.Namespace(ref={k: torch.tensor(v) for k, v in ref.items()}, nnet=Nnet)
    return jodil.Problem(_operator, jdom, jextra), jstate, todil.Problem(_operator, tdom, textra), tstate


def _check_state(problem, state, tol=1e-6):
    domain, ref = problem.domain, problem.extra.ref
    for key in ("ufx", "uc", "a"):
        err = np.sqrt(np.mean(np.square(_host(domain.field(state, key)) - _host(ref[key]))))
        assert err < tol, (key, err)
    out = torch.stack(domain.neural_net(state, "net")(*ref["net_in"]))
    err = np.sqrt(np.mean(np.square(_host(out) - _host(ref["net_out"]))))
    assert err < tol, ("net_out", err)


def _dense(g):
    return np.concatenate([_host(b).reshape(-1) for b in g]) if isinstance(g, (list, tuple)) else _host(g)


def test_eval_operator_grad_matches_jax():
    jp, js, tp, ts = _fixture()
    jv, jg, jnames = jp.eval_operator_grad(js)
    tv, tg, tnames = tp.eval_operator_grad(ts)
    assert tnames == jnames and len(tv) == len(jv) == len(tg) == len(jg)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(_host(a), np.asarray(b), rtol=0, atol=1e-12)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert set(a) == set(b), (i, set(a) ^ set(b))
        for d in b:
            want = _dense(b[d])
            got = np.zeros_like(want) if a[d] is None else _dense(a[d])
            assert got.shape == want.shape, (i, d)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=str((i, d)))


def test_linearize_matches_jax_and_solves_in_one_step():
    jp, js, tp, ts = _fixture()
    jvec, jmat = jp.linearize(js)
    tvec, tmat = tp.linearize(ts)
    assert tmat.shape == jmat.shape and tmat.dtype == jmat.dtype
    np.testing.assert_allclose(tvec, np.asarray(jvec), rtol=0, atol=1e-12)
    for m in (tmat, jmat):
        m.sort_indices()
    np.testing.assert_array_equal(tmat.indptr, jmat.indptr)
    np.testing.assert_array_equal(tmat.indices, jmat.indices)
    np.testing.assert_allclose(tmat.data, jmat.data, rtol=0, atol=1e-12)
    # One exact Newton step on the linear fixture.
    domain = tp.domain
    delta = sp.linalg.spsolve((tmat.T @ tmat).tocsc(), -tmat.T @ tvec)
    packed = _host(domain.pack_state(ts))
    domain.unpack_state(domain.mod.cast(packed + delta, domain.dtype), ts)
    _check_state(tp, ts)


@pytest.mark.parametrize("linsolver", ["direct", "lsqr", "multigrid", "bicgstab"])
def test_optimize_newton_driver(linsolver):
    """util.optimize_newton with the fixture's menu (tests/test_newton.py:
    the one step lands within 1e-6, 1e-5 for the iterative solvers)."""
    _, _, tp, ts = _fixture()
    args = argparse.Namespace(epochs=1, epoch_start=0, linsolver=linsolver, linsolver_maxiter=2000,
                              linsolver_tol=1e-14, linsolver_damp=0, linsolver_dampdiag=0, linsolver_verbose=0,
                              linsolver_history=0)
    todil.util.optimize(args, "newton", tp, ts)
    _check_state(tp, ts, tol=1e-6 if linsolver == "direct" else 1e-5)
    assert tp.solver_stats["epochs"] == 1


def test_linearize_scalar_residual_term():
    """A scalar residual from grid samples (heat_tmax's one-point
    measurement) assembles into a single Jacobian row, as in the JAX
    package, and matches the jvp of the residual map."""
    import odil_tpu as jodil

    u0 = np.random.RandomState(0).rand(3, 4)

    def operator(ctx):
        u = ctx.field("u")
        return [("grid", u - 1.0), ("point", 2.0 * (u[-1, 1] - 0.5))]

    mats = []
    for odil, kw in ((jodil, {}), (todil, {"device": "cpu"})):
        domain = odil.Domain(cshape=(3, 4), dimnames=["t", "x"], dtype=DT, **kw)
        state = domain.init_state(odil.State(fields={"u": odil.Field(u0, loc="cc")}))
        problem = odil.Problem(operator, domain)
        vector, matrix = problem.linearize(state)
        mats.append((np.asarray(vector), matrix.toarray()))
    (tv, tm), (jv, jm) = mats[1], mats[0]
    assert tm.shape == (13, 12) and np.count_nonzero(tm[12]) == 1 and tm[12, 2 * 4 + 1] == 2.0
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-15)
    f, x0 = problem.residual_fn(state)
    v = torch.tensor(np.random.RandomState(1).normal(size=tuple(x0.shape)))
    jvp = torch.func.jvp(f, (x0,), (v,))[1]
    np.testing.assert_allclose(tm @ v.numpy(), jvp.numpy(), rtol=0, atol=1e-12)


def test_residual_fn_halo_and_mesh_raise():
    """The per-shard residual map (halo=True) and a Domain with a mesh
    without halo (the GSPMD route) both give the unsharded residual map:
    the same vector (cell-located fields: no ghost-node rows) and the same
    Jacobian products."""
    mesh = todil.parallel.mesh_from_spec("x:2", devices=[torch.device("cpu")] * 2)
    maps = []
    for kw, halo in (({}, False), ({"mesh": mesh, "partition": {"x": "x"}}, False),
                     ({"mesh": mesh, "partition": {"x": "x"}}, True)):
        domain = todil.Domain(cshape=(4, 4), dimnames=["x", "y"], dtype=DT, device="cpu", **kw)
        state = domain.init_state(todil.State(fields={"u": np.arange(16.0).reshape(4, 4)}))
        problem = todil.Problem(lambda ctx: [ctx.field("u", 1, 0) - ctx.field("u") ** 2], domain)
        maps.append(problem.residual_fn(state, halo=halo))
    (f0, x0), *others = maps
    v = torch.tensor(np.random.RandomState(2).normal(size=tuple(x0.shape)))
    for f, x in others:
        assert torch.equal(x, x0) and f.term_sizes == f0.term_sizes and f.term_names == f0.term_names
        np.testing.assert_allclose(f(x).numpy(), f0(x0).numpy(), rtol=1e-15)
        np.testing.assert_allclose(torch.func.jvp(f, (x,), (v,))[1].numpy(), torch.func.jvp(f0, (x0,), (v,))[1].numpy(),
                                   rtol=1e-14)


# -- linsolver and amg ---------------------------------------------------------


def _laplacian_system(n=12, seed=0):
    """A rectangular least-squares system: the 2-D 5-point Laplacian on n^2
    cells with a row of identity constraints below (CSR), and its rhs."""
    lap1 = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(n, n))
    lap = (sp.kron(lap1, sp.eye(n)) + sp.kron(sp.eye(n), lap1)).tocsr()
    matr = sp.vstack([lap, 0.1 * sp.eye(n * n)]).tocsr()
    rhs = np.random.default_rng(seed).normal(size=matr.shape[0])
    return matr, rhs


def _solve_args(**kw):
    base = dict(linsolver="direct", linsolver_maxiter=None, linsolver_tol=1e-10, linsolver_damp=0,
                linsolver_dampdiag=0, smooth_pre=3, ndirect=3)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("linsolver,kw", [
    ("direct", {}), ("direct", {"linsolver_damp": 0.3, "linsolver_dampdiag": 0.2}), ("directsq", {}),
    ("lsqr", {"linsolver_maxiter": 300}), ("lsqr", {"linsolver_damp": 0.1}), ("cg", {}),
    ("multigrid", {}), ("vcycle", {"smooth_pre": 2}), ("bicgstab", {"linsolver_maxiter": 40}),
])
def test_solve_menu_matches_jax(linsolver, kw):
    """Every method on the same matrix: the same solution and status as the
    JAX package's ``solve`` (fp32 input too, which both cast to float64)."""
    from odil_tpu import linsolver as jlin

    matr, rhs = _laplacian_system()
    if linsolver == "directsq":
        matr, rhs = matr[: 144], rhs[:144]
    for m in (matr, matr.astype(np.float32)):
        out = {}
        for name, mod in (("jax", jlin), ("torch", tlin)):
            args, status = _solve_args(linsolver=linsolver, **kw), {}
            out[name] = (mod.solve(m, rhs, args, status, linsolver), status, args.linsolver_maxiter)
        np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
        assert out["torch"][1:] == out["jax"][1:]


@pytest.mark.parametrize("name,error", [("direct_cu", ImportError), ("sparseqr", ImportError),
                                        ("lsqr_cu", ValueError)])
def test_solve_menu_without_optional_modules(name, error):
    matr, rhs = _laplacian_system(4)
    with pytest.raises(error):
        tlin.solve(matr, rhs, _solve_args(), {}, name)


def test_amg_hierarchy_and_cycle_match_jax_to_the_bit():
    from odil_tpu import amg as jamg

    matr, _ = _laplacian_system(16)
    A = (matr.T @ matr).tocsr()
    r = np.random.default_rng(1).normal(size=A.shape[0])
    hs = [mod.build_hierarchy(A, theta=0.2, cheb_degree=3, max_coarse=16) for mod in (jamg, tamg)]
    assert hs[0].nlevels == hs[1].nlevels >= 3
    for a, b in zip(hs[0].levels, hs[1].levels):
        assert (a.A != b.A).nnz == 0 and a.rho == b.rho
        np.testing.assert_array_equal(a.diag, b.diag)
        if a.P is not None:
            assert (a.P != b.P).nnz == 0
            np.testing.assert_array_equal(a.cheb_coefs, b.cheb_coefs)
    np.testing.assert_array_equal(hs[1].precond(r), hs[0].precond(r))


# -- CG -------------------------------------------------------------------------


def _spd(n=200, cond=10.0, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = q @ np.diag(np.geomspace(1.0, cond, n)) @ q.T
    return 0.5 * (A + A.T), rng.normal(size=n)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("stop", ["tol", "maxiter"])
def test_cg_matches_jax_cg(precond, stop, monkeypatch):
    """``newton.cg`` against ``jax.scipy.sparse.linalg.cg``: the same
    iterate within 1e-12 (relative to its largest entry), stopped by the
    tolerance (before maxiter) or by maxiter; every chunk length gives the
    same bits, and the counts add up."""
    import jax
    import jax.numpy as jnp
    import odil_tpu

    odil_tpu.runtime.ensure_x64()
    A, b = _spd()
    d = np.diag(A) * np.random.default_rng(5).uniform(0.5, 2.0, size=len(b))
    tol, maxiter = (1e-10, 200) if stop == "tol" else (1e-14, 7)
    jA, tA = jnp.asarray(A), torch.tensor(A)
    jM = (lambda v: v / jnp.asarray(d)) if precond else None
    tM = (lambda v: v / torch.tensor(d)) if precond else None
    want, _ = jax.scipy.sparse.linalg.cg(lambda v: jA @ v, jnp.asarray(b), tol=tol, maxiter=maxiter, M=jM)
    want = np.asarray(want)
    runs = {}
    for c in (1, 3, 10):
        monkeypatch.setattr(tn, "CG_CHUNK", c)
        runs[c] = tn.cg(lambda v: tA @ v, torch.tensor(b), tol=tol, maxiter=maxiter, M=tM)
    x, stats = runs[10]
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    for c, (xc, sc) in runs.items():
        np.testing.assert_array_equal(xc.numpy(), x.numpy())
        assert sc["iterations"] == stats["iterations"] and sc["syncs"] == -(-min(sc["matvecs"] - 1, maxiter) // c)
    if stop == "tol":
        assert 0 < stats["iterations"] < maxiter
        res = np.linalg.norm(b - A @ want) if not precond else None
        assert res is None or res <= tol * np.linalg.norm(b) * 10
    else:
        assert stats["iterations"] == maxiter and stats["matvecs"] == maxiter + 1


# -- forward mode through the models' plain operators ---------------------------


def _model_pair(name):
    """(JAX problem, state, port problem, state) of a model's plain operator
    at a small size, fp64, with the same seeded arrays in both."""
    from odil_tpu.models import advection as jad
    from odil_tpu.models import heat as jh
    from odil_tpu.models import poisson as jpo
    from odil_tpu.models import veltracer as jvt
    from odil_tpu.models import wave as jw

    from odil_torch.models import advection as tad
    from odil_torch.models import heat as th
    from odil_torch.models import poisson as tpo
    from odil_torch.models import veltracer as tvt
    from odil_torch.models import wave as tw

    cpu = {"device": "cpu"}
    if name == "heat":
        kw = dict(nt=8, nx=8, infer_k=True, imposed="random", nimp=10, kwreg=0.5, ktreg=0.1, kxreg=0.1, dtype=DT,
                  multigrid=False)
        jp, js, _ = jh.build(**kw)
        tp, ts, _ = th.build(**kw, **cpu)
    elif name == "heat_tmax":
        jp, js, _ = jh.build_tmax(nt=8, nx=8, multigrid=True)
        tp, ts, _ = th.build_tmax(nt=8, nx=8, multigrid=True, **cpu)
    elif name == "poisson":
        jp, js, _ = jpo.build(n=8, ndim=2, ref="osc", rhs="exact", multigrid=False)
        tp, ts, _ = tpo.build(n=8, ndim=2, ref="osc", rhs="exact", multigrid=False, **cpu)
    elif name == "wave":
        jp, js, _ = jw.build(nt=8, nx=8, multigrid=True)
        tp, ts, _ = tw.build(nt=8, nx=8, multigrid=True, **cpu)
    elif name == "veltracer":
        jp, js, _ = jvt.build(nt=4, nx=8, ny=8, dtype=DT, multigrid=True)
        tp, ts, _ = tvt.build(nt=4, nx=8, ny=8, dtype=DT, multigrid=True, **cpu)
    else:
        jp, js, _ = jad.build(nt=8, nx=8, multigrid=True)
        tp, ts, _ = tad.build(nt=8, nx=8, multigrid=True, **cpu)
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    arrays = [0.3 * rng.normal(size=a.shape) for a in jp.domain.arrays_from_state(js)]
    jp.domain.arrays_to_state([jnp.asarray(a) for a in arrays], js)
    tp.domain.arrays_to_state(arrays_from_numpy(arrays, device="cpu"), ts)
    return jp, js, tp, ts


@pytest.mark.parametrize("name", ["heat", "poisson", "wave", "veltracer", "advection", "heat_tmax"])
def test_jvp_vjp_through_plain_operators_match_jax(name):
    """The residual map's value, J v (``torch.func.jvp``) and J^T w
    (``torch.func.vjp``) of each model's plain operator at one seeded state
    and direction, against the JAX package's (rtol 1e-11 of the largest
    entry); its term names and sizes too."""
    import jax
    import jax.numpy as jnp

    jp, js, tp, ts = _model_pair(name)
    jf, jx = jp.residual_fn(js)
    tf, tx = tp.residual_fn(ts)
    assert tf.term_names == jf.term_names and tf.term_sizes == jf.term_sizes
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    rng = np.random.default_rng(7)
    v = rng.normal(size=tuple(tx.shape))
    r = np.asarray(jf(jx))
    w = rng.normal(size=r.shape)
    jr, jjv = jax.jit(lambda x, v: jax.jvp(jf, (x,), (v,)))(jx, jnp.asarray(v))
    jjtw = jax.jit(lambda x, w: jax.vjp(jf, x)[1](w)[0])(jx, jnp.asarray(w))
    tr, tjv = torch.func.jvp(tf, (tx,), (torch.tensor(v),))
    tjtw = torch.func.vjp(tf, tx)[1](torch.tensor(w))[0]
    for got, want in ((tr, jr), (tjv, jjv), (tjtw, jjtw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-11 * max(np.abs(want).max(), 1.0))


# -- the preconditioners and the driver, with the JAX package's draws replayed --


@contextlib.contextmanager
def _jax_draws():
    """Records the JAX package's Rademacher and normal draws in order:
    ``jax.random.rademacher`` and ``jax.random.normal`` hand each result to
    an ordered ``jax.debug.callback`` (so jitted code records too), and
    ``jax.vmap`` runs as a loop, so the draws under it are single draws.
    Yields the list of (kind, array)."""
    import jax
    import jax.numpy as jnp

    draws = []
    orig = {"rademacher": jax.random.rademacher, "normal": jax.random.normal, "vmap": jax.vmap}

    def recorder(kind):
        def fn(key, shape=(), dtype=jnp.float64, **kw):
            out = orig[kind](key, shape, dtype=dtype, **kw)
            jax.debug.callback(lambda a: draws.append((kind, np.array(a))), out, ordered=True)
            return out

        return fn

    def loop_vmap(f):
        return lambda xs: jnp.stack([f(xs[i]) for i in range(xs.shape[0])])

    jax.random.rademacher, jax.random.normal, jax.vmap = recorder("rademacher"), recorder("normal"), loop_vmap
    try:
        yield draws
    finally:
        jax.effects_barrier()
        jax.random.rademacher, jax.random.normal, jax.vmap = orig["rademacher"], orig["normal"], orig["vmap"]


@contextlib.contextmanager
def _replayed(draws, monkeypatch):
    """``odil_torch.newton.draw`` handing out `draws` in order (the kind and
    shape checked); asserts that every draw was taken."""
    queue = list(draws)

    def replay(kind, shape, dtype, device, generator):
        k, a = queue.pop(0)
        assert k == kind and tuple(a.shape) == tuple(int(n) for n in shape), (k, a.shape, kind, shape)
        return torch.as_tensor(a, dtype=dtype, device=device)

    monkeypatch.setattr(tn, "draw", replay)
    yield
    assert not queue, f"{len(queue)} draws left"


def _poisson(n=16):
    from odil_tpu.models import poisson as jpo

    from odil_torch.models import poisson as tpo

    jp, js, jext = jpo.build(n=n, ndim=2, ref="hat", rhs="discrete", dtype=DT, multigrid=False)
    tp, ts, text = tpo.build(n=n, ndim=2, ref="hat", rhs="discrete", dtype=DT, multigrid=False, device="cpu")
    return jp, js, tp, ts


def _normal_ops(jp, js, tp, ts):
    import jax

    jf, jx = jp.residual_fn(js)
    tf, tx = tp.residual_fn(ts)
    jpb = jax.vjp(jf, jx)[1]
    tpb = torch.func.vjp(tf, tx)[1]

    def jnm(v):
        return jpb(jax.jvp(jf, (jx,), (v,))[1])[0]

    def tnm(v):
        return tpb(torch.func.jvp(tf, (tx,), (v,))[1])[0]

    return (jf, jx, jnm), (tf, tx, tnm)


GN_N = int(os.environ.get("GN_N", 8))


def _close(got, want, tol=1e-9):
    got, want = _host(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


def test_estimate_normal_diag_matches_jax(monkeypatch):
    import jax

    from odil_tpu.newton import estimate_normal_diag as jest

    jp, js, tp, ts = _poisson(8)
    (jf, jx, _), (tf, tx, _) = _normal_ops(jp, js, tp, ts)
    with _jax_draws() as draws:
        want = jest(jf, jx, jax.random.PRNGKey(4), nprobe=5)
        jax.block_until_ready(want)
    assert [k for k, _ in draws] == ["rademacher"] * 5
    with _replayed(draws, monkeypatch):
        got = tn.estimate_normal_diag(tf, tx, None, nprobe=5)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("kind", ["bpx", "vcycle"])
def test_preconditioner_setup_and_apply_match_jax(kind, monkeypatch):
    """setup at the linearization point (the pstate: BPX's per-level scales;
    the V-cycle's smoother diagonals, Chebyshev bounds and coarse inverse)
    and apply on a seeded vector, within 1e-9; the V-cycle stays symmetric;
    the frozen form gives apply's bits."""
    import jax

    from odil_tpu import newton as jn

    jp, js, tp, ts = _poisson(8)
    (jf, jx, jnm), (tf, tx, tnm) = _normal_ops(jp, js, tp, ts)
    make = {"bpx": ("make_bpx_parts", {}), "vcycle": ("make_vcycle_parts", {"degree": 3, "nprobe": 4, "npower": 8})}
    fn, kw = make[kind]
    v = np.random.default_rng(2).normal(size=tuple(tx.shape))
    with _jax_draws() as draws:
        jsetup, japply = getattr(jn, fn)(jp.domain, js, lambda x, u: jnm(u), jx, **kw)
        jstate = jsetup(jx, jax.random.PRNGKey(0))
        jout = japply(jstate, jax.numpy.asarray(v))
    with _replayed(draws, monkeypatch):
        tsetup, tapply = getattr(tn, fn)(tp.domain, ts, lambda x, u: tnm(u), tx, **kw)
        tstate = tsetup(tx, None)
    tout = tapply(tstate, torch.tensor(v))
    # The frozen form (make_*_preconditioner) is setup then apply at x0.
    frozen = {"bpx": tn.make_bpx_preconditioner, "vcycle": tn.make_vcycle_preconditioner}[kind]
    with _replayed(draws, monkeypatch):
        M = frozen(tp.domain, ts, tnm, tx, None, **kw)
    np.testing.assert_array_equal(M(torch.tensor(v)).numpy(), tout.numpy())
    if kind == "bpx":
        for a, b in zip(tstate, jstate):
            assert len(a) == len(b) >= 2
            for sa, sb in zip(a, b):
                _close(sa, sb)
    else:
        assert len(tstate["smooth"]) == len(jstate["smooth"]) >= 1
        for (da, ta, la), (db, tb, lb) in zip(tstate["smooth"], jstate["smooth"]):
            for x, y in zip(da, db):
                _close(x, y)
            _close(ta, tb)
            _close(la, lb)
        _close(tstate["Minv"], jstate["Minv"])
        w = np.random.default_rng(3).normal(size=v.shape)
        a = float(torch.dot(tapply(tstate, torch.tensor(v)), torch.tensor(w)))
        b = float(torch.dot(torch.tensor(v), tapply(tstate, torch.tensor(w))))
        assert abs(a - b) <= 1e-10 * abs(a)
    _close(tout, jout)


def rows_within(got, want, rtol=1e-9, floors=None):
    """Each value of `got` (lists of numbers, row by row) within rtol of
    `want`'s; where `floors` gives a column's floor, two values both below
    it pass.  Returns the largest relative distance."""
    worst = 0.0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for j, (x, y) in enumerate(zip(a, b)):
            floor = floors[j] if floors else 0.0
            if abs(x) < floor and abs(y) < floor:
                continue
            assert abs(x - y) <= rtol * abs(y), (j, x, y)
            worst = max(worst, abs(x - y) / abs(y) if y else 0.0)
    return worst


@pytest.mark.parametrize("linsolver,maxiter", [("cg", 6), ("multigrid", 2), ("vcycle", 3), ("direct", 6)])
def test_optimize_gauss_newton_matches_jax(linsolver, maxiter, monkeypatch):
    """The gn driver on Poisson 8^2, three epochs from the same state, the
    JAX package's probes replayed: the rows the callback receives (one
    epoch late, and the last from one more evaluation: the loss and each
    term) within 1e-9 of the JAX package's, or both below 1e-12 of epoch
    0's.  With ``multigrid`` and ``--linsolver_precond_every 1`` the BPX
    preconditioner is rebuilt every epoch."""
    from odil_tpu import util as jutil

    def args():
        return argparse.Namespace(epochs=3, epoch_start=0, seed=0, linsolver=linsolver, linsolver_maxiter=maxiter,
                                  linsolver_tol=1e-12, linsolver_damp=0, linsolver_dampdiag=0,
                                  linsolver_precond_every=1 if linsolver == "multigrid" else 0)

    def run(problem, state, runner):
        rows = []
        runner(args(), "gn", problem, state, lambda st, e, p: rows.append([p["loss"]] + [float(t) for t in p["terms"]]))
        return rows

    jp, js, tp, ts = _poisson(8)
    with _jax_draws() as draws:
        want = run(jp, js, jutil.optimize)
    with _replayed(draws, monkeypatch):
        got = run(tp, ts, todil.util.optimize)
    stats = tp.solver_stats
    assert len(got) == len(want) == 4
    floors = [1e-12 * abs(v) for v in want[0]]
    worst = rows_within(got, want, floors=floors)
    print(f"gn --linsolver {linsolver}: largest relative distance from the JAX package's rows {worst:.3e}")
    assert stats["epochs"] == 3 and 0 < stats["iterations"] <= 3 * maxiter and stats["syncs"] >= 3
