"""The port's mesh routes on one device against the JAX package, fp64.

The JAX package runs on the conftest's 8 virtual host devices, the port on
a mesh of eight CPU devices (``[torch.device("cpu")] * 8``):

- the halo residual map (``make_halo_residual_fn``, Gauss-Newton under
  ``--halo``) element by element against the JAX package's, its products
  through ``torch.func``, and Gauss-Newton's iterate under it;
- the global multigrid ladder of ``make_halo_loss_fn``;
- the GSPMD route (a Domain with a mesh, evaluated without ``halo``): the
  unsharded loss, gradients and Gauss-Newton iterates, the sharding specs
  and the replication warning of ``Domain.field_sharding``;
- the poisson CLI with ``--mesh``, with and without ``--halo``."""

import argparse
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odil_torch as todil
import odil_tpu as jodil
from odil_torch import parallel as tpar
from odil_torch import util as tutil
from odil_torch.convert import arrays_from_numpy
from odil_torch.halo import make_halo_loss_fn
from odil_torch.models import heat as th
from odil_torch.models import veltracer as tvt
from odil_torch.models import wave as tw
from odil_tpu import parallel as jpar
from odil_tpu.models import veltracer as jvt

CPU8 = [torch.device("cpu")] * 8
XY = {"x": "x", "y": "y"}


@pytest.fixture(autouse=True, scope="module")
def _unoptimized_xla():
    """The JAX references compile with most XLA optimizations off: at these
    sizes their trace and compile, not their run, take the time."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _poisson_like(odil, spec=None, partition=None, N=16):
    """``tests/test_sharding.py::poisson_like_problem`` in either package
    (the port on the CPU), on the mesh of ``spec``: (problem, state)."""
    if odil is jodil:
        mesh = jpar.mesh_from_spec(spec, devices=jax.devices()[:8]) if spec else None
        kw = {}
    else:
        mesh = tpar.mesh_from_spec(spec, devices=CPU8) if spec else None
        kw = {"device": "cpu"}
    domain = odil.Domain(cshape=(N, N), dimnames=["x", "y"], dtype=np.float64, mesh=mesh, partition=partition, **kw)
    xc = (np.arange(N) + 0.5) / N
    xx, yy = np.meshgrid(xc, xc, indexing="ij")
    rhs = np.sin(xx * np.pi) * yy

    def operator(ctx):
        u = ctx.field("u")
        uxm = ctx.field("u", -1, 0)
        uxp = ctx.field("u", 1, 0)
        uym = ctx.field("u", 0, -1)
        uyp = ctx.field("u", 0, 1)
        hx, hy = ctx.step()
        lap = (uxp - 2 * u + uxm) / hx**2 + (uyp - 2 * u + uym) / hy**2
        return [lap - ctx.extra.rhs, u * 0.1]

    extra = argparse.Namespace(rhs=domain.cast(rhs))
    state = domain.init_state(odil.State(fields={"u": np.random.RandomState(0).rand(N, N)}))
    return odil.Problem(operator, domain, extra), state


def _vt_pair(spec, part, nt=8, nx=8, ny=8, kernel="xla", multigrid=True, seed=0):
    """velocity_from_tracer in both packages on the mesh of ``spec``, and a
    random state."""
    jp, js, _ = jvt.build(nt=nt, nx=nx, ny=ny, kernel=kernel, multigrid=multigrid, dtype=np.float64,
                          mesh=jpar.mesh_from_spec(spec, devices=jax.devices()[:8]), partition=part)
    tp, ts, _ = tvt.build(nt=nt, nx=nx, ny=ny, kernel=kernel, multigrid=multigrid, dtype=np.float64, device="cpu",
                          mesh=tpar.mesh_from_spec(spec, devices=CPU8), partition=part)
    rng = np.random.default_rng(seed)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(np.float64) for a in jp.domain.arrays_from_state(js)]
    return (jp, js), (tp, ts), arrays


def _close(got, want, rtol, atol_frac=0.0):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * max(1.0, float(np.abs(want).max())))


# -- The halo residual map -------------------------------------------------


def test_halo_residual_map_matches_jax():
    """The per-shard residual map of the port equals the JAX package's
    element by element (the same length and order: the ghost-noded global
    layout of ``shard_map``'s out_specs), with the same term names and
    sizes; J^T r and J^T J v through ``torch.func`` equal the JAX
    package's ``jax.vjp``/``jax.jvp`` (tests/test_sharding.py:384-420)."""
    jp, js = _poisson_like(jodil, "x:2,y:4", XY)
    tp, ts = _poisson_like(todil, "x:2,y:4", XY)
    fj, xj = jp.residual_fn(js, halo=True)
    ft, xt = tp.residual_fn(ts, halo=True)
    assert ft.term_names == fj.term_names and ft.term_sizes == fj.term_sizes
    fj = jax.jit(fj)
    _close(xt, xj, 0.0)
    _close(ft(xt), fj(xj), 1e-12, 1e-12)

    rj, pbj = jax.vjp(fj, xj)
    rt, pbt = torch.func.vjp(ft, xt)
    _close(pbt(rt)[0], pbj(rj)[0], 1e-11, 1e-9)
    v = np.random.RandomState(3).randn(xj.size)
    jvj = jax.jvp(fj, (xj,), (jnp.asarray(v),))[1]
    jvt = torch.func.jvp(ft, (xt,), (torch.tensor(v),))[1]
    _close(pbt(jvt)[0], pbj(jvj)[0], 1e-11, 1e-9)
    # Autograd of the map: the same pullback.
    x = xt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(ft(x), x, rt)
    _close(g, pbj(rj)[0], 1e-11, 1e-9)


@pytest.mark.parametrize("multigrid", [False, True], ids=["plain", "multigrid"])
def test_halo_residual_map_ghost_nodes_match_jax(multigrid):
    """Node-located t on t:2,x:2 (velocity_from_tracer's "ncc" fields, the
    local ladder with multigrid): the ghost-node rows, zero on every shard
    but the first, sit where the JAX package's out_specs put them."""
    (jp, js), (tp, ts), arrays = _vt_pair("t:2,x:2", {"t": "t", "x": "x"}, multigrid=multigrid)
    x = np.concatenate([a.reshape(-1) for a in arrays])
    fj, _ = jp.residual_fn(js, halo=True)
    ft, _ = tp.residual_fn(ts, halo=True)
    assert ft.term_names == fj.term_names and ft.term_sizes == fj.term_sizes
    rj = np.asarray(jax.jit(fj)(jnp.asarray(x)))
    rt = ft(torch.tensor(x)).numpy()
    assert np.count_nonzero(rt == 0) == np.count_nonzero(rj == 0) > 0
    _close(rt, rj, 1e-12, 1e-12)


def test_halo_residual_map_is_the_plain_map_permuted():
    """Against the port's unsharded map: the sorted magnitudes with the zero
    pad stripped, and the same J^T r (tests/test_sharding.py:384-420)."""
    tp0, ts0 = _poisson_like(todil)
    f0, x0 = tp0.residual_fn(ts0)
    tp1, ts1 = _poisson_like(todil, "x:2,y:4", XY)
    f1, x1 = tp1.residual_fn(ts1, halo=True)
    assert torch.equal(x0, x1) and f1.term_names == f0.term_names
    r0, r1 = f0(x0).numpy(), f1(x1).numpy()
    pad = len(r1) - len(r0)
    assert pad >= 0
    s0, s1 = np.sort(np.abs(r0)), np.sort(np.abs(r1))
    if pad:
        assert s1[:pad].max() == 0.0
        s1 = s1[pad:]
    np.testing.assert_allclose(s1, s0, rtol=1e-13, atol=1e-13)
    _, pb0 = torch.func.vjp(f0, x0)
    _, pb1 = torch.func.vjp(f1, x1)
    _close(pb1(f1(x1))[0], pb0(f0(x0))[0].numpy(), 1e-11, 1e-9)


def test_halo_residual_map_declines_kernel_operators():
    mesh = tpar.mesh_from_spec("t:2,x:2", devices=CPU8)
    tp, ts, _ = tvt.build(nt=8, nx=8, ny=8, kernel="pallas", dtype=np.float64, device="cpu", mesh=mesh,
                          partition={"t": "t", "x": "x"})
    with pytest.raises(ValueError, match="kernel operators"):
        tp.residual_fn(ts, halo=True)


def _gn_args(linsolver, maxiter, damp=0.0, epochs=2):
    return argparse.Namespace(
        epochs=epochs, epoch_start=0, linsolver=linsolver, linsolver_tol=1e-12, linsolver_damp=damp,
        linsolver_dampdiag=0, linsolver_maxiter=maxiter, linsolver_precond_every=0, seed=0, nlvl=100,
        smooth_pre=3, ndirect=3,
    )


@pytest.mark.parametrize("halo", [0, 1], ids=["gspmd", "halo"])
def test_gauss_newton_on_a_mesh_matches_unsharded(halo):
    """Gauss-Newton (Jacobi-preconditioned CG, the port's own probes) on
    x:2,y:4 through the halo residual map or the GSPMD route reproduces the
    unsharded iterate (tests/test_sharding.py:361-381); with plain CG at a
    budget of 20 iterations, where the packages agree, the JAX package's
    halo iterate too."""
    from odil_torch.newton import optimize_gauss_newton as tgn
    from odil_tpu.newton import optimize_gauss_newton as jgn

    tp0, ts0 = _poisson_like(todil)
    tgn(_gn_args("cg", 100, damp=1e4), tp0, ts0)
    u0 = tp0.domain.field(ts0, "u").numpy()
    tp1, ts1 = _poisson_like(todil, "x:2,y:4", XY)
    args = _gn_args("cg", 100, damp=1e4)
    args.halo = halo
    tgn(args, tp1, ts1)
    np.testing.assert_allclose(tp1.domain.field(ts1, "u").numpy(), u0, rtol=0, atol=1e-9 * max(1.0, np.abs(u0).max()))

    jp, js = _poisson_like(jodil, "x:2,y:4", XY)
    tp, ts = _poisson_like(todil, "x:2,y:4", XY)
    for odil_gn, p, s in ((jgn, jp, js), (tgn, tp, ts)):
        args = _gn_args("", 20)
        args.halo = halo
        odil_gn(args, p, s)
    _close(tp.domain.field(ts, "u"), jp.domain.field(js, "u"), 1e-9, 1e-12)


# -- The global multigrid ladder -------------------------------------------


@pytest.mark.parametrize("spec", ["x:4", "t:2,x:2"])
def test_global_ladder_matches_jax(spec):
    """``make_halo_loss_fn(mg_ladder="global")`` on velocity_from_tracer
    8x16x16 with multigrid (tests/test_halo.py:77-121): loss and gradients
    equal to the JAX package's global ladder and to the port's local one."""
    from odil_tpu.halo import make_halo_loss_fn as jmake

    part = {a: a for a in ("t", "x") if a + ":" in spec}
    (jp, js), (tp, ts), arrays = _vt_pair(spec, part, nt=8, nx=16, ny=16)
    loss_fn, _ = jmake(jp, js, mg_ladder="global")
    (jl, (jterms, _)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        [jnp.asarray(a) for a in arrays], jp.tracers)
    got = {}
    for ladder in ("global", "local"):
        fn, _ = make_halo_loss_fn(tp, ts, mg_ladder=ladder)
        x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
        loss, (terms, _) = fn(x, tp.tracers)
        got[ladder] = (loss, terms, torch.autograd.grad(loss, x))
    for loss, terms, grads in got.values():
        _close(loss, jl, 1e-9)
        for a, b in zip(terms, jterms):
            _close(a, b, 1e-9)
        for a, b in zip(grads, jg):
            _close(a, b, 1e-9, 1e-10)


def test_global_ladder_on_the_kernel_route():
    """The kernel operator (``kernel="pallas"``: the masked per-shard
    kernels, their plain versions here) gives the same loss and gradients
    with either ladder; an unknown ladder raises."""
    mesh = tpar.mesh_from_spec("t:2,x:2", devices=CPU8)
    tp, ts, _ = tvt.build(nt=8, nx=16, ny=16, kernel="pallas", dtype=np.float64, device="cpu", mesh=mesh,
                          partition={"t": "t", "x": "x"})
    rng = np.random.default_rng(1)
    arrays = [0.3 * torch.tensor(rng.normal(size=tuple(a.shape))) for a in tp.domain.arrays_from_state(ts)]
    got = []
    for ladder in ("global", "local"):
        fn, _ = make_halo_loss_fn(tp, ts, mg_ladder=ladder)
        x = [a.clone().requires_grad_(True) for a in arrays]
        loss, _ = fn(x, tp.tracers)
        got.append((loss, torch.autograd.grad(loss, x)))
    _close(got[0][0], got[1][0].detach().numpy(), 1e-12)
    for a, b in zip(got[0][1], got[1][1]):
        _close(a, b.numpy(), 1e-9, 1e-10)
    with pytest.raises(ValueError, match="mg_ladder"):
        make_halo_loss_fn(tp, ts, mg_ladder="nearby")


# -- The GSPMD route -------------------------------------------------------


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_gspmd_loss_matches_single_device():
    """A Domain with a mesh evaluated without halo gives the unsharded
    loss and gradients to the bit, and the JAX package's single-device ones
    (tests/test_sharding.py:54-68); its arrays are whole on the mesh's
    device."""
    jp, js = _poisson_like(jodil)
    jl, jg, *_ = jp.eval_loss_grad(js)
    tp0, ts0 = _poisson_like(todil)
    tp1, ts1 = _poisson_like(todil, "x:2,y:4", XY)
    assert tp1.domain.field_sharding(shape=(16, 16)).spec == ("x", "y")
    l0, g0, *_ = tp0.eval_loss_grad(ts0)
    l1, g1, *_ = tp1.eval_loss_grad(ts1)
    assert l0 == l1 and _same(g0, g1)
    _close(l1, jl, 1e-12)
    _close(g1[0], jg[0], 1e-12, 1e-12)
    assert tp1.make_loss_grad_fn(ts1) is None  # no kernel: autograd of make_loss_fn, as unsharded


@pytest.mark.parametrize("kernel", ["pallas", "pallas_mg"])
def test_gspmd_kernel_routes_are_the_unsharded_routes(kernel):
    """velocity_from_tracer on t:2,x:2 without halo: ``make_loss_grad_fn``
    takes the unsharded fused route (the same kernels; their plain versions
    here) and gives the unsharded loss and gradients to the bit; the loss-only
    path too."""
    mesh = tpar.mesh_from_spec("t:2,x:2", devices=CPU8)
    kw = dict(nt=8, nx=16, ny=16, kernel=kernel, dtype=np.float32, device="cpu")
    tp0, ts0, _ = tvt.build(**kw)
    tp1, ts1, _ = tvt.build(**kw, mesh=mesh, partition={"t": "t", "x": "x"})
    rng = np.random.default_rng(2)
    arrays = [torch.tensor(0.3 * rng.normal(size=tuple(a.shape)), dtype=torch.float32)
              for a in tp0.domain.arrays_from_state(ts0)]
    outs = []
    for p, s in ((tp0, ts0), (tp1, ts1)):
        fn = p.make_loss_grad_fn(s)
        assert fn is not None
        (loss, (terms, _)), grads = fn(arrays, p.tracers)
        loss_fn, _ = p.make_loss_fn(s)
        x = [a.clone().requires_grad_(True) for a in arrays]
        l2, _ = loss_fn(x, p.tracers)
        outs.append([loss, *terms, *grads, l2, *torch.autograd.grad(l2, x)])
    assert _same(*outs)


def test_gspmd_multigrid_state():
    """Multigrid decomposition with the fine level on x:2 (GSPMD,
    tests/test_sharding.py:102-122): finite, and the unsharded loss."""
    losses = []
    for mesh in (None, tpar.mesh_from_spec("x:2", devices=CPU8)):
        domain = todil.Domain(cshape=(16, 16), dimnames=["x", "y"], dtype=np.float64, multigrid=True, device="cpu",
                              mesh=mesh, partition={"x": "x"} if mesh else None)
        state = domain.init_state(todil.State(fields={"u": None}))
        problem = todil.Problem(lambda ctx: [ctx.field("u") - 1.0], domain)
        losses.append(problem.eval_loss_grad(state)[0])
    assert np.isfinite(losses[1]) and losses[0] == losses[1]


def test_shard_state_arrays_and_replicated():
    """The specs of ``shard_state_arrays``'s placements and of ``replicated``
    are the JAX package's NamedSharding specs (tests/test_sharding.py:
    125-133); on one device the arrays come back as the same tensors."""
    out = {}
    for odil, par, devs in ((jodil, jpar, jax.devices()[:8]), (todil, tpar, CPU8)):
        mesh = par.mesh_from_spec("x:2,y:2", devices=devs)
        kw = {"device": "cpu"} if odil is todil else {}
        domain = odil.Domain(cshape=(8, 8), dimnames=["x", "y"], mesh=mesh, partition=XY, dtype=np.float64, **kw)
        state = domain.init_state(odil.State(fields={"u": np.zeros((8, 8)), "v": odil.Field(np.zeros((9, 8)), loc="nc"),
                                                     "a": odil.Array(np.zeros(3))}))
        arrays = domain.arrays_from_state(state)
        placed = par.shard_state_arrays(domain, arrays)
        specs = [domain.field_sharding(shape=tuple(a.shape)).spec for a in arrays if a.ndim == 2]
        out[odil] = (placed, arrays, specs, par.replicated(mesh), mesh)
    (jplaced, _, jspecs, jrep, _), (tplaced, tarrays, tspecs, trep, tmesh) = out[jodil], out[todil]
    assert [tuple(s) for s in tspecs] == [tuple(p.sharding.spec) for p in jplaced if p.ndim == 2] == [tuple(s) for s in jspecs]
    assert tspecs[0] == ("x", "y") and tspecs[1] == (None, "y")
    assert all(a is b for a, b in zip(tplaced, tarrays))
    assert tuple(trep.spec) == tuple(jrep.spec) == () and trep.is_fully_replicated and jrep.is_fully_replicated
    assert not tpar.NamedSharding(tmesh, tspecs[0]).is_fully_replicated
    assert tpar.NamedSharding(tpar.mesh_from_spec("x:1", devices=CPU8), ("x",)).is_fully_replicated
    with pytest.raises(ValueError, match="not an axis"):
        tpar.NamedSharding(tmesh, ("t",))


def _log_of(fn):
    """What ``fn()`` writes through printlog."""
    buf = io.StringIO()
    old_stream, old_echo = tutil._log_sink.stream, tutil._log_sink.echo
    tutil.set_log_file(buf, echo=False)
    try:
        fn()
    finally:
        tutil.set_log_file(old_stream, echo=old_echo)
    return buf.getvalue()


def test_replication_warning_once():
    """A finest-level axis that does not divide its mesh axis replicates and
    warns once, with the JAX package's text; coarse levels replicate
    silently; a dividing axis says nothing (tests/test_sharding.py:
    200-240)."""
    from odil_tpu import util as jutil

    def shardings(odil, par, devs):
        mesh = par.mesh_from_spec("x:8", devices=devs)
        kw = {"device": "cpu"} if odil is todil else {}
        domain = odil.Domain(cshape=(12, 12), dimnames=["x", "y"], mesh=mesh, partition={"x": "x"}, **kw)
        got = [domain.field_sharding(shape=(12, 12)), domain.field_sharding(shape=(12, 12)),
               domain.field_sharding(shape=(6, 6))]
        return got

    got = []
    text = _log_of(lambda: got.extend(shardings(todil, tpar, CPU8)))
    buf = io.StringIO()
    old = jutil._log_sink.stream, jutil._log_sink.echo
    jutil.set_log_file(buf, echo=False)
    try:
        jgot = shardings(jodil, jpar, jax.devices()[:8])
    finally:
        jutil.set_log_file(old[0], echo=old[1])
    assert text == buf.getvalue() and text.count("warning: replicating dim 'x'") == 1 and "size 12" in text
    assert all(s.is_fully_replicated for s in got) and [tuple(s.spec) for s in got] == [tuple(s.spec) for s in jgot]

    mesh = tpar.mesh_from_spec("x:2", devices=CPU8)
    domain = todil.Domain(cshape=(16, 16), dimnames=["x", "y"], mesh=mesh, partition={"x": "x"}, device="cpu")
    assert _log_of(lambda: got.append(domain.field_sharding(shape=(16, 16)))) == ""
    assert not got[-1].is_fully_replicated
    # The same Domain with halo: its plan takes dividing partitions only.
    mesh = tpar.mesh_from_spec("x:8", devices=CPU8)
    _log_of(lambda: got.append(todil.Domain(cshape=(12, 12), dimnames=["x", "y"], mesh=mesh, partition={"x": "x"},
                                            device="cpu", dtype=np.float64)))
    domain = got[-1]
    state = domain.init_state(todil.State(fields={"u": None}))
    problem = todil.Problem(lambda ctx: [ctx.field("u", 1, 0) - ctx.field("u")], domain)
    assert problem.eval_loss_grad(state)[0] == 0.0
    with pytest.raises(ValueError, match="not divisible"):
        problem.make_loss_fn(state, halo=True)


def test_gspmd_node_axis_t8():
    """A node-located time axis (N+1 entries) on t:8 under GSPMD
    (tests/test_sharding.py:271-330): the unsharded loss and gradients and no
    replication warning; the specs of the flattened fields keep t sharded
    (uneven), their storage layout replicates it silently."""
    mesh = tpar.mesh_from_spec("t:8", devices=CPU8)
    kw = dict(nt=16, nx=16, ny=16, kernel="xla", multigrid=True, dtype=np.float64, device="cpu")
    tp0, ts0, _ = tvt.build(**kw)
    got = []
    text = _log_of(lambda: got.extend(tvt.build(**kw, mesh=mesh, partition={"t": "t"})))
    tp1, ts1, _ = got
    assert "warning: replicating" not in text
    l0, g0, *_ = tp0.eval_loss_grad(ts0)
    l1, g1, *_ = tp1.eval_loss_grad(ts1)
    assert l0 == l1 and _same(g0, g1)
    d = tp1.domain
    assert d.field_sharding(shape=(17, 16, 16), allow_uneven=True).spec == ("t", None, None)
    assert d.field_sharding(shape=(17, 16, 16)).spec == (None, None, None)


@pytest.mark.parametrize("model", ["wave", "heat"])
def test_gspmd_plane_partition(model):
    """Heat and wave with x partitioned (t:2,x:2), which ``--halo`` refuses:
    the GSPMD route evaluates them exactly, the kernel route included; GSPMD
    Gauss-Newton on wave (t:4) gives the unsharded iterate
    (tests/test_sharding.py:252-268)."""
    mesh = tpar.mesh_from_spec("t:2,x:2", devices=CPU8)
    part = {"t": "t", "x": "x"}
    if model == "wave":
        build = lambda **kw: tw.build(nt=16, nx=16, dtype=np.float32, multigrid=False, kernel="pallas",  # noqa: E731
                                      device="cpu", **kw)[:2]
    else:
        build = lambda **kw: th.build(nt=16, nx=16, kernel="pallas", device="cpu", **kw)[:2]  # noqa: E731
    (tp0, ts0), (tp1, ts1) = build(), build(mesh=mesh, partition=part)
    l0, g0, *_ = tp0.eval_loss_grad(ts0)
    l1, g1, *_ = tp1.eval_loss_grad(ts1)
    assert l0 == l1 and _same(g0, g1)
    fns = [p.make_loss_grad_fn(s) for p, s in ((tp0, ts0), (tp1, ts1))]
    arrays = tp0.domain.arrays_from_state(ts0)
    (a0, _), d0 = fns[0](arrays, tp0.tracers)
    (a1, _), d1 = fns[1](arrays, tp1.tracers)
    assert torch.equal(a0, a1) and _same(d0, d1)
    with pytest.raises(ValueError, match="partition of t only"):
        tp1.make_loss_fn(ts1, halo=True)[0](arrays, tp1.tracers)
    if model == "wave":
        from odil_torch.newton import optimize_gauss_newton

        us = []
        for kw in ({}, {"mesh": tpar.mesh_from_spec("t:4", devices=CPU8), "partition": {"t": "t"}}):
            p, s, _ = tw.build(nt=16, nx=16, dtype=np.float64, multigrid=False, device="cpu", **kw)
            optimize_gauss_newton(_gn_args("cg", 100, damp=1e4), p, s)
            us.append(p.domain.field(s, "u"))
        assert torch.equal(*us)


# -- The poisson CLI with --mesh ---------------------------------------------


@pytest.fixture
def outdir(tmp_path, monkeypatch):
    """A working directory for a CLI run; the cwd and the log sink are
    restored afterwards (setup_outdir chdirs and opens train.log)."""
    monkeypatch.chdir(tmp_path)
    sink, stream, echo = tutil._log_sink, tutil._log_sink.stream, tutil._log_sink.echo
    yield tmp_path
    if sink.stream is not stream:
        sink.stream.close()
    sink.stream, sink.echo = stream, echo


def _poisson_cli(outdir, name, *argv):
    from odil_torch.examples import poisson

    out = outdir / name
    poisson.main(["--N", "16", "--epochs", "2", "--history_every", "1", "--report_every", "1", "--plot_every", "0",
                  "--device", "cpu", "--outdir", str(out), *argv])
    import csv

    with open(out / "train.csv") as fh:
        rows = [{k: v for k, v in r.items() if k not in ("walltime", "memory", "gpu_used", "gpu_pool")}
                for r in csv.DictReader(fh)]
    with open(out / "train.log") as fh:
        return rows, fh.read()


def test_poisson_cli_with_mesh(outdir):
    """``poisson --mesh x:2,y:2`` (GSPMD, Adam) gives the unsharded rows to
    the bit; with ``--halo 1 --optimizer gn --multigrid 0`` (the halo
    residual map) its rows are the unsharded Gauss-Newton rows within rtol
    1e-9 at a CG budget of 20."""
    base, _ = _poisson_cli(outdir, "plain")
    rows, log = _poisson_cli(outdir, "gspmd", "--mesh", "x:2,y:2")
    assert "mesh: {'x': 2, 'y': 2}, partition: {'x': 'x', 'y': 'y'}" in log
    assert rows == base and len(rows) == 3
    gn = ("--ref", "osc", "--rhs", "exact", "--optimizer", "gn", "--multigrid", "0", "--linsolver_maxiter", "20")
    base, _ = _poisson_cli(outdir, "gn", *gn)
    rows, log = _poisson_cli(outdir, "gn_halo", *gn, "--mesh", "x:2,y:2", "--halo", "1")
    assert "Gauss-Newton" in log and len(rows) == len(base) == 3
    for a, b in zip(rows, base):
        assert a.keys() == b.keys() and a["epoch"] == b["epoch"]
        for k in a:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-9, atol=1e-300, err_msg=k)
