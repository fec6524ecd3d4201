"""``parallel.multi_start`` of the port against the JAX package, fp64.

The JAX package on the conftest's 8 virtual host devices, the port on a
mesh of CPU devices (tests/test_sharding.py:129-197): data parallelism with
``mesh``/``batch_axis``, per-instance data, the validation of
``per_instance``; the batched loss on the JAX package's own stacked starts;
the form ``loss_fn_b`` takes (``torch.func.vmap`` of a plain loss, a loop
over the instances where the loss reaches a kernel) and the kernel route's
instances against their single-start runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odil_torch as todil
import odil_tpu as jodil
from odil_torch import parallel as tpar
from odil_torch.convert import arrays_from_numpy
from odil_torch.models import heat as th
from odil_torch.models import veltracer as tvt
from odil_torch.optim import Adam
from odil_torch.optim.adam import AdamOptimizer
from odil_torch.optim.base import autograd_loss_grad_fn
from odil_tpu import parallel as jpar
from test_torch_mesh_routes import _poisson_like

CPU8 = [torch.device("cpu")] * 8


def _instance_losses(problem, state, stacked):
    loss_fn, _ = problem.make_loss_fn(state)
    with torch.no_grad():
        return np.array([float(loss_fn([a[i] for a in stacked], problem.tracers)[0]) for i in range(len(stacked[0]))])


def test_multi_start_data_parallel():
    """Batched starts through the registry's Adam with the instance axis on
    a mesh axis (tests/test_sharding.py:136-164): the batch mean at the
    start is the mean of the instances' losses, the mean halves in 50
    epochs and every instance improves."""
    problem, state = _poisson_like(todil, N=8)
    mesh = tpar.mesh_from_spec("b:4", devices=CPU8)
    loss_b, stacked = tpar.multi_start(problem, state, nstarts=4, seed=1, scale=0.5, mesh=mesh, batch_axis="b")
    assert loss_b.form == "vmap"
    assert [tuple(a.shape) for a in stacked] == [(4, 8, 8)] and stacked[0].device == torch.device("cpu")
    assert torch.equal(stacked[0][0], problem.domain.arrays_from_state(state)[0])
    l0 = _instance_losses(problem, state, stacked)
    loss0, (terms0, norms0) = loss_b(stacked, {"epoch": 0})
    np.testing.assert_allclose(float(loss0), l0.mean(), rtol=1e-12)
    assert len(terms0) == len(norms0) == 2
    opt = AdamOptimizer(dtype=problem.domain.dtype)
    opt.bind(loss_b, tracers=problem.tracers, task_epochs=[50], names=["fu", "reg"])
    out, _ = opt.run(stacked, epochs=50, lr=0.05)
    loss1 = float(loss_b(out, {"epoch": 0})[0])
    assert loss1 < float(loss0) * 0.5, (float(loss0), loss1)
    assert np.all(_instance_losses(problem, state, out) < l0)


def test_multi_start_per_instance_data():
    """Per-instance data in a frozen Field: each instance recovers its own
    target and its data stay (tests/test_sharding.py:167-197)."""
    domain = todil.Domain(cshape=(8, 8), dimnames=["x", "y"], dtype=np.float64, device="cpu")
    state = domain.init_state(todil.State(fields={"u": None, "g": todil.Field(np.zeros(domain.size()))}))
    problem = todil.Problem(lambda ctx: [ctx.field("u") - ctx.field("g", frozen=True)], domain)
    targets = np.stack([np.full((8, 8), c) for c in (1.0, -2.0, 0.5)])
    loss_b, stacked = tpar.multi_start(problem, state, nstarts=3, seed=0, scale=0.1, per_instance={"g": targets})
    opt = AdamOptimizer(dtype=domain.dtype)
    opt.bind(loss_b, tracers=problem.tracers, task_epochs=[400], names=[""])
    out, _ = opt.run(stacked, epochs=400, lr=0.05)
    for i, c in enumerate((1.0, -2.0, 0.5)):
        assert abs(float(out[0][i].mean()) - c) < 0.05, (i, float(out[0][i].mean()))
    np.testing.assert_allclose(out[1].numpy(), targets, atol=1e-5)


def test_multi_start_validation():
    problem, state = _poisson_like(todil, N=8)
    with pytest.raises(KeyError):
        tpar.multi_start(problem, state, 2, per_instance={"nope": np.zeros((2, 8, 8))})
    with pytest.raises(ValueError):
        tpar.multi_start(problem, state, 2, per_instance={"u": np.zeros((3, 8, 8))})
    with pytest.raises(ValueError, match="field shape"):
        tpar.multi_start(problem, state, 2, per_instance={"u": np.zeros((2, 8, 9))})
    mesh = tpar.mesh_from_spec("b:4", devices=CPU8)
    with pytest.raises(ValueError, match="not an axis"):
        tpar.multi_start(problem, state, 4, mesh=mesh, batch_axis="i")
    tp, ts, _ = tvt.build(nt=8, nx=8, ny=8, kernel="xla", dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="multigrid/NN"):
        tpar.multi_start(tp, ts, 2, per_instance={"u": np.zeros((2, 9, 8, 8))})


def test_batched_loss_on_the_jax_starts():
    """``loss_fn_b`` of the port on the JAX package's stacked starts (and
    per-instance data) equals the JAX package's ``loss_fn_b``: loss, terms
    and norms, rtol 1e-12; and its gradient is the JAX package's."""
    jp, js = _poisson_like(jodil, N=8)
    tp, ts = _poisson_like(todil, N=8)
    data = np.random.default_rng(4).normal(size=(4, 8, 8))
    jloss_b, jstacked = jpar.multi_start(jp, js, nstarts=4, seed=3, scale=0.5,
                                         mesh=jpar.mesh_from_spec("b:4", devices=jax.devices()[:8]), batch_axis="b")
    tloss_b, _ = tpar.multi_start(tp, ts, nstarts=4, seed=3, scale=0.5)
    x = arrays_from_numpy([np.asarray(a) for a in jstacked], device="cpu")
    (jl, (jt, jn)), jg = jax.value_and_grad(jloss_b, has_aux=True)(jstacked, {"epoch": 0})
    leaves = [a.requires_grad_(True) for a in x]
    tl, (tt, tn) = tloss_b(leaves, {"epoch": 0})
    (tg,) = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-12)
    for a, b in zip(tt + tn, list(jt) + list(jn)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg[0]), rtol=1e-11, atol=1e-12 * float(np.abs(jg[0]).max()))

    # Per-instance data through the JAX package's arrays.
    for odil, par in ((jodil, jpar), (todil, tpar)):
        kw = {"device": "cpu"} if odil is todil else {}
        domain = odil.Domain(cshape=(8, 8), dimnames=["x", "y"], dtype=np.float64, **kw)
        st = domain.init_state(odil.State(fields={"u": None, "g": odil.Field(np.zeros(domain.size()))}))
        pr = odil.Problem(lambda ctx: [ctx.field("u") - ctx.field("g", frozen=True), 0.1 * ctx.field("u")], domain)
        if odil is jodil:
            jl_b, js_b = par.multi_start(pr, st, nstarts=4, seed=5, scale=0.3, per_instance={"g": jnp.asarray(data)})
        else:
            tl_b, _ = par.multi_start(pr, st, nstarts=4, seed=5, scale=0.3, per_instance={"g": data})
    want = float(jl_b(js_b, {"epoch": 0})[0])
    got = float(tl_b(arrays_from_numpy([np.asarray(a) for a in js_b], device="cpu"), {"epoch": 0})[0])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _heat(nt=16, nx=16, kernel="pallas", dtype=np.float32):
    return th.build(nt=nt, nx=nx, kernel=kernel, infer_k=True, imposed="stripe", dtype=dtype, device="cpu")[:2]


def test_kernel_route_loops_over_the_instances():
    """Where the loss reaches a kernel Function (heat's row kernels,
    velocity_from_tracer's mg kernels) ``loss_fn_b`` is a loop of
    single-instance calls; with plain operators it is ``vmap``.  On heat's
    kernel route (the plain versions here, fp32) each instance trained by
    Adam on the batch mean follows its single-start run (the loss scaled by
    1/nstarts, so the updates are the same) within the fp32 floor."""
    assert tpar.multi_start(*_heat(kernel="xla"), nstarts=2)[0].form == "vmap"
    vp, vs, _ = tvt.build(nt=8, nx=8, ny=8, kernel="pallas_mg", dtype=np.float32, device="cpu")
    assert tpar.multi_start(vp, vs, nstarts=2)[0].form == "loop"
    problem, state = _heat()
    nstarts, epochs = 4, 20
    loss_b, stacked = tpar.multi_start(problem, state, nstarts=nstarts, seed=2, scale=0.05)
    assert loss_b.form == "loop"
    batched = Adam(autograd_loss_grad_fn(loss_b), stacked, lr=1e-3)
    losses = batched.run_chunk(epochs, problem.tracers)
    loss_fn, _ = problem.make_loss_fn(state)

    def scaled(arrays, tracers):
        loss, (terms, norms) = loss_fn(arrays, tracers)
        return loss / nstarts, (terms, norms)

    rows = []
    for i in range(nstarts):
        single = Adam(autograd_loss_grad_fn(scaled), [a[i] for a in stacked], lr=1e-3)
        rows.append(single.run_chunk(epochs, problem.tracers) * nstarts)
        for a, b in zip(batched.x, single.x):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    np.testing.assert_allclose(losses.numpy(), torch.stack(rows).mean(0).numpy(), rtol=1e-5)
    assert np.all(_instance_losses(problem, state, batched.x) < _instance_losses(problem, state, stacked))
