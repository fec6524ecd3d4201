"""Heat and wave under ``--halo``: the per-shard form of the 1-D row models
against the JAX package on the CPU.

Both packages build the problem from one numpy seed in fp64 on a t:4 mesh
(the JAX package on the conftest's virtual host devices, its Pallas kernels
in interpret mode as ``tests/test_halo.py:222-249`` run them; the port on a
mesh of CPU devices, the plain versions of its kernels).  Held at rtol 1e-10
(atol 1e-12 * max|ref| for gradients): the loss-only route and the generic
one-pass route against the JAX package's halo loss, and against the port's
unsharded route.  Heat's measurements arrive as shard-local extras and are
extended from the neighbouring shards (``halo._exchange_data``); wave's
boundary traces are global (T, 1) data with hist=2.  A partitioned x axis
raises (``halo.refuse_plane_partition``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch import parallel as tpar
from odil_torch.convert import arrays_from_numpy
from odil_torch.models import heat as tht
from odil_torch.models import wave as twv
from odil_torch.ops import rowwise as trw
from odil_tpu import halo as jhalo
from odil_tpu import parallel as jpar
from odil_tpu.models import heat as jht
from odil_tpu.models import wave as jwv

CPU8 = [torch.device("cpu")] * 8
RTOL, ATOL = 1e-10, 1e-12
BUILDS = {
    "wave": (jwv.build, twv.build, dict(nt=16, nx=16)),
    "heat": (jht.build, tht.build, dict(nt=16, nx=16, infer_k=True, imposed="random", nimp=40, kxreg=0.3,
                                        ktreg=0.2)),
}


@pytest.fixture(autouse=True, scope="module")
def _unoptimized_xla():
    """The JAX references compile with most XLA optimizations off: at these
    sizes their trace and compile, not their run, take the time."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _pair(name, spec, part, seed=0):
    jbuild, tbuild, kw = BUILDS[name]
    jmesh = jpar.mesh_from_spec(spec, devices=jax.devices()[:8]) if spec else None
    tmesh = tpar.mesh_from_spec(spec, devices=CPU8) if spec else None
    jp, js, _ = jbuild(kernel="pallas", dtype=np.float64, mesh=jmesh, partition=part, **kw)
    tp, ts, _ = tbuild(kernel="pallas", dtype=np.float64, device="cpu", mesh=tmesh, partition=part, **kw)
    rng = np.random.default_rng(seed)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(np.float64) for a in jp.domain.arrays_from_state(js)]
    return (jp, js), (tp, ts), arrays


def _check(loss, terms, grads, jl, jterms, jg):
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    assert len(terms) == len(jterms) and len(grads) == len(jg)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=RTOL)
    for a, b in zip(grads, jg):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(b).max())))


def _port_loss_route(tp, ts, arrays, halo=True):
    loss_fn, _ = tp.make_loss_fn(ts, halo=halo)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    loss, (terms, _) = loss_fn(x, tp.tracers)
    return loss, terms, torch.autograd.grad(loss, x)


@pytest.mark.parametrize("name", list(BUILDS))
def test_halo_routes_match_jax(name):
    """The loss-only route and the generic one-pass route on t:4 against the
    JAX package's halo loss (``tests/test_halo.py:222-249``) and against the
    port's unsharded loss."""
    (jp, js), (tp, ts), arrays = _pair(name, "t:4", {"t": "t"})
    loss_fn, _ = jhalo.make_halo_loss_fn(jp, js)
    (jl, (jterms, _)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        [jnp.asarray(a) for a in arrays], jp.tracers
    )
    _check(*_port_loss_route(tp, ts, arrays), jl, jterms, jg)
    fn = tp.make_loss_grad_fn(ts, halo=True)
    assert fn is not None and fn.route == "generic"
    (loss, (terms, _)), grads = fn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
    _check(loss, terms, grads, jl, jterms, jg)
    _, (up, us), _ = _pair(name, None, None)
    _check(loss, terms, grads, *_port_loss_route(up, us, arrays, halo=False))


def test_local_data_come_from_the_neighbours():
    """Heat's measurements reach each shard as its block of the extras; the
    halo row of a shard's data is the last row of its left neighbour's
    block (the ring wraps at shard 0)."""
    _, (tp, ts), arrays = _pair("heat", "t:4", {"t": "t"})
    from odil_torch import halo as thalo

    plan = thalo._HaloPlan(tp, ts)
    grid, params = thalo._localize(tp, plan, thalo._mg_metas(tp, ts, plan), arrays_from_numpy(arrays, device="cpu"))
    results = thalo._run_operators(tp, plan, thalo._extended(plan, grid), params, tp.tracers)
    imp_u = tp.extra.imp_u
    B = imp_u.shape[0] // 4
    for ctx, _ in results:
        (rec,) = ctx.rowwise_deferred
        assert set(rec["local_data"]) == {0, 1}
        i = ctx.shard.index["t"]
        rows = [(i * B - 1) % imp_u.shape[0]] + list(range(i * B, (i + 1) * B))
        torch.testing.assert_close(rec["data"][1], imp_u[rows], rtol=0, atol=0)
        torch.testing.assert_close(rec["data"][0], tp.extra.imp_mask[rows], rtol=0, atol=0)


@pytest.mark.parametrize("name", list(BUILDS))
def test_plane_partition_raises(name):
    """t:2,x:2: the port raises; the JAX package raises for wave and gives
    heat another loss than its unsharded one (the walls at the seams)."""
    (jp, js), (tp, ts), arrays = _pair(name, "t:2,x:2", {"t": "t", "x": "x"})
    loss_fn, _ = tp.make_loss_fn(ts, halo=True)
    with pytest.raises(ValueError, match="partition of t only"):
        loss_fn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
    jfn = jax.jit(jhalo.make_halo_loss_fn(jp, js)[0])
    if name == "wave":
        with pytest.raises(TypeError):
            jfn([jnp.asarray(a) for a in arrays], jp.tracers)
        return
    (jq, jqs), _, _ = _pair(name, None, None)
    jl = float(jfn([jnp.asarray(a) for a in arrays], jp.tracers)[0])
    ref_fn = jax.jit(jq.make_loss_fn(jqs)[0])
    ref = float(ref_fn([jnp.asarray(a) for a in arrays], jq.tracers)[0])
    assert abs(jl - ref) > 1e-3 * ref


def test_data_of_another_extent_raise():
    """Data neither global nor local along t raise, naming the shape."""
    _, (tp, ts), arrays = _pair("wave", "t:4", {"t": "t"})
    from odil_torch import halo as thalo

    plan = thalo._HaloPlan(tp, ts)
    grid, params = thalo._localize(tp, plan, thalo._mg_metas(tp, ts, plan), arrays_from_numpy(arrays, device="cpu"))
    (ctx,) = thalo._contexts(tp, plan, thalo._extended(plan, grid), params, tp.tracers)[:1]
    with pytest.raises(ValueError, match=r"shape \(5, 1\)"):
        ctx.rowwise_terms(trw.RowModel(lambda *a: (a[2][0][0],)), ("u",), data=(torch.zeros(5, 1),), hist=2)


def test_heat_halo_trajectory_matches_unsharded_fp64():
    """Heat at the converged lane's 64^2 configuration from the JAX
    package's initial net (``odil_torch/data/heat_inverse_64.json``), plain
    route in fp64: 100 Adam epochs (lr 1e-3) on t:4 under ``--halo`` and
    unsharded, each epoch's loss within rtol 1e-8.  The two orders of
    summation part by roundoff only, which Adam amplifies along this
    trajectory, so the rows of a fp32 run on the card part by a few percent
    later on; this holds every state of the first 100 epochs to the
    unsharded route."""
    import json
    import os

    from odil_torch.optim import Adam

    with open(os.path.join(os.path.dirname(tht.__file__), "..", "data", "heat_inverse_64.json")) as fh:
        ref = json.load(fh)
    lane = ref["config"]
    losses = {}
    for spec in (None, "t:4"):
        mesh = tpar.mesh_from_spec(spec, devices=CPU8[:4]) if spec else None
        p, s, _ = tht.build(nt=lane["nt"], nx=lane["nx"], infer_k=True, imposed=lane["imposed"], nimp=lane["nimp"],
                            seed=lane["seed"], kernel="pallas", dtype=np.float64, device="cpu", mesh=mesh,
                            partition={"t": "t"} if spec else None)
        net = s.fields["k_net"]
        net.weights = [torch.tensor(w, dtype=torch.float64) for w in ref["weights"]]
        net.biases = [torch.tensor(b, dtype=torch.float64) for b in ref["biases"]]
        loss_fn, _ = p.make_loss_fn(s, halo=bool(spec))

        def grad_fn(arrays, tracers, loss_fn=loss_fn):
            x = [a.detach().requires_grad_(True) for a in arrays]
            loss, aux = loss_fn(x, tracers)
            return (loss.detach(), aux), torch.autograd.grad(loss, x)

        opt = Adam(grad_fn, p.domain.arrays_from_state(s), lr=1e-3)
        losses[spec] = torch.cat([opt.run_chunk(10) for _ in range(10)]).numpy()
    np.testing.assert_allclose(losses["t:4"], losses[None], rtol=1e-8)


def test_heat_halo_every_keep_flag_off_matches_unsharded():
    """Heat with keep_init=0 and keep_frozen=0 (the hand adjoint through the
    face temperatures, row 0 reading the periodic row T-1) on t:2 under
    --halo, fp64: the generic one-pass route and the loss-only route against
    the port's unsharded route (rtol 1e-10)."""
    import argparse

    args = argparse.Namespace(infer_k=True, imposed="random", nimp=40, noise=0.0, seed=1000, kimp=2.0, kxreg=0.3,
                              kxregdecay=0, ktreg=0.2, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1, keep_frozen=0,
                              keep_init=0, solver="odil")
    out = {}
    for spec in ("t:2", None):
        mesh = tpar.mesh_from_spec(spec, devices=CPU8[:2]) if spec else None
        tp, ts, _ = tht.build(nt=16, nx=16, kernel="pallas", dtype=np.float64, device="cpu", mesh=mesh,
                              partition={"t": "t"} if spec else None, arch_k=(3, 4), args=args)
        rng = np.random.default_rng(5)
        arrays = [(0.3 * rng.normal(size=tuple(a.shape))).astype(np.float64) for a in tp.domain.arrays_from_state(ts)]
        if spec:
            fn = tp.make_loss_grad_fn(ts, halo=True)
            assert fn is not None and fn.route == "generic"
            (loss, (terms, _)), grads = fn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
            out["onepass"] = (loss, terms, grads)
        out[spec or "unsharded"] = _port_loss_route(tp, ts, arrays, halo=bool(spec))
    ul, uterms, ugrads = out["unsharded"]
    for name in ("onepass", "t:2"):
        _check(*out[name], float(ul.detach()), [float(t.detach()) for t in uterms], [g.detach().numpy() for g in ugrads])

