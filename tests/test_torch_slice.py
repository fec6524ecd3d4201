"""The flagship slice of the port against the JAX package on the CPU:
velocity_from_tracer built in both packages at (Nt, Nx, Ny) = (8, 16, 16),
the same random state carried across by ``convert.arrays_from_numpy``, then
the fused loss+grad route, the loss-only route with autograd, the plain
operator, and five Adam steps of the ``bench.py`` update rule."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odil_torch
from odil_torch.convert import arrays_from_numpy
from odil_torch.models import veltracer as tvt
from odil_torch.ops import rowwise as trw
from odil_torch.optim import Adam, plan_chunks
from odil_tpu.models import veltracer as jvt
from odil_tpu.optim.base import plan_chunks as jplan_chunks

SIZE = dict(nt=8, nx=16, ny=16)


def _pair(kernel, dtype=np.float32, seed=0):
    jp, js, _ = jvt.build(kernel=kernel, dtype=dtype, **SIZE)
    tp, ts, _ = tvt.build(kernel=kernel, dtype=dtype, device="cpu", **SIZE)
    rng = np.random.default_rng(seed)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(dtype) for a in jp.domain.arrays_from_state(js)]
    return (jp, js), (tp, ts), arrays


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol, atol=atol_frac * max(1.0, float(np.abs(want).max()))
    )


def test_fused_loss_grad_matches_jax():
    (jp, js), (tp, ts), arrays = _pair("pallas_mg")
    (jl, (jterms, _)), jg = jax.jit(jp.make_loss_grad_fn(js))([jnp.asarray(a) for a in arrays], jp.tracers)
    fn = tp.make_loss_grad_fn(ts)
    assert fn is not None
    (loss, (terms, norms)), grads = fn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
    assert len(terms) == len(jterms) == 6 and len(grads) == len(jg) == 9
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5)
    for a, b in zip(grads, jg):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, 1e-4, 1e-6)


def test_loss_only_route_matches_fused_route():
    """make_loss_fn + autograd (forward kernel, backward kernel with the sums
    off) against the fused one-pass route of make_loss_grad_fn."""
    _, (tp, ts), arrays = _pair("pallas_mg", seed=1)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    loss_fn, x0 = tp.make_loss_fn(ts)
    assert [tuple(a.shape) for a in x0] == [tuple(a.shape) for a in x]
    loss, (terms, _) = loss_fn(x, tp.tracers)
    grads = torch.autograd.grad(loss, x)
    (loss2, (terms2, _)), grads2 = tp.make_loss_grad_fn(ts)([a.detach() for a in x], tp.tracers)
    np.testing.assert_allclose(loss.detach().numpy(), loss2.numpy(), rtol=1e-6)
    for a, b in zip(grads, grads2):
        _close(a.numpy(), b.numpy(), 1e-5, 1e-7)


@pytest.mark.parametrize("kernel", ["xla", "pallas_mg"])
def test_fp64_loss_and_grads_match_jax_plain_operator(kernel):
    """fp64: the port's plain operator and its MG-fused route (plain kernel
    versions; make_loss_grad_fn declines 64-bit like the JAX package)
    against the JAX package's plain operator, to rtol 1e-10."""
    (jp, js), (tp, ts), arrays = _pair("xla", dtype=np.float64, seed=2)
    if kernel != "xla":
        tp, ts, _ = tvt.build(kernel=kernel, dtype=np.float64, device="cpu", **SIZE)
        assert tp.make_loss_grad_fn(ts) is None
    jloss_fn, _ = jp.make_loss_fn(js)
    (jl, (jterms, _)), jg = jax.value_and_grad(jloss_fn, has_aux=True)([jnp.asarray(a) for a in arrays], jp.tracers)
    loss_fn, _ = tp.make_loss_fn(ts)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    loss, (terms, _) = loss_fn(x, tp.tracers)
    grads = torch.autograd.grad(loss, x)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-10)
    for a, b in zip(grads, jg):
        _close(a.numpy(), b, 1e-10, 1e-12)


def test_adam_matches_bench_update_rule():
    """Five epochs of the port's Adam against the update of bench.py:116-126
    (fp32 slots) driven by the JAX package's fused loss+grad."""
    (jp, js), (tp, ts), arrays = _pair("pallas_mg", seed=3)
    grad_fn = jax.jit(jp.make_loss_grad_fn(js))
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-7
    x = [jnp.asarray(a) for a in arrays]
    m = [jnp.zeros_like(a) for a in x]
    v = [jnp.zeros_like(a) for a in x]
    jlosses = []
    for t in range(5):
        (loss, _), grads = grad_fn(x, {"epoch": t})
        jlosses.append(float(loss))
        tt = jnp.float32(t + 1)
        alpha = lr * jnp.sqrt(1 - b2**tt) / (1 - b1**tt)
        m = [mi + (g - mi) * (1 - b1) for mi, g in zip(m, grads)]
        v = [vi + (jnp.square(g) - vi) * (1 - b2) for vi, g in zip(v, grads)]
        x = [xi - mi * alpha / (jnp.sqrt(vi) + eps) for xi, mi, vi in zip(x, m, v)]

    opt = Adam(tp.make_loss_grad_fn(ts), arrays_from_numpy(arrays, device="cpu"), lr=lr)
    losses = opt.run_chunk(5)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    for a, b in zip(opt.x, x):
        _close(a.numpy(), b, 1e-4, 1e-6)


def test_adam_bf16_slots_track_fp32():
    _, (tp, ts), arrays = _pair("pallas_mg", seed=4)
    fn = tp.make_loss_grad_fn(ts)
    full = Adam(fn, arrays_from_numpy(arrays, device="cpu"), lr=0.01)
    half = Adam(fn, arrays_from_numpy(arrays, device="cpu"), lr=0.01, slot_dtype=torch.bfloat16)
    l32, l16 = full.run_chunk(5), half.run_chunk(5)
    assert half.m[0].dtype == torch.bfloat16 and half.x[0].dtype == torch.float32
    np.testing.assert_allclose(l16.numpy(), l32.numpy(), rtol=2e-2)


def test_state_flat_order_roundtrip():
    """state_from_arrays(arrays_from_state(state)) keeps every tensor in place:
    the flat order the loss pipeline relies on."""
    _, (tp, ts), arrays = _pair("pallas_mg")
    flat = tp.domain.arrays_from_state(ts)
    tp._capture_structure(ts)
    back = tp.domain.arrays_from_state(tp.state_from_arrays(flat))
    assert len(back) == len(flat) == 9
    assert all(a is b for a, b in zip(back, flat))
    assert [tuple(a.shape) for a in flat] == [a.shape for a in arrays]


def test_flagship_multigrid_levels():
    d = odil_torch.Domain(cshape=(64, 256, 256), dimnames=("t", "x", "y"), multigrid=True, device="cpu")
    assert d.mg_nlvl == 6
    assert [d._get_field_shape(cs, "ncc") for cs in d.mg_cshapes] == [
        (65, 256, 256), (33, 128, 128), (17, 64, 64), (9, 32, 32), (5, 16, 16), (3, 8, 8)
    ]


def test_unported_paths_raise():
    """What is still to port raises: sharding and the streaming kernels.  The
    plain operator has no fused route."""
    with pytest.raises(NotImplementedError):
        odil_torch.Domain(cshape=(4, 4), mesh=object(), device="cpu")
    tp, ts, extra = tvt.build(kernel="pallas_mg", multigrid=False, device="cpu", **SIZE)
    fields = tp.domain.arrays_from_state(ts)
    model = trw.RowModel(lambda it, T, rows, data_rows, params, consts: (rows[0][0] - rows[0][1],))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trw.rowwise_loss_terms(model, fields[:1], stream=True)
    assert tvt.build(kernel="xla", device="cpu", **SIZE)[0].make_loss_grad_fn(ts) is None


@pytest.mark.parametrize(
    "start,epochs,tasks,max_chunk",
    [(0, 25, [10, 20, 25], 512), (5, 30, [10, 12, 35], 8), (0, 3, None, 512), (0, 10, [], 4)],
)
def test_plan_chunks_matches_jax(start, epochs, tasks, max_chunk):
    assert list(plan_chunks(start, epochs, tasks, max_chunk)) == list(jplan_chunks(start, epochs, tasks, max_chunk))


def test_env_dtype_read_at_call_time(monkeypatch):
    monkeypatch.setenv("ODIL_DTYPE", "float32")
    assert odil_torch.Domain(cshape=(4,), device="cpu").dtype == np.float32
    monkeypatch.setenv("ODIL_DTYPE", "float64")
    assert odil_torch.Domain(cshape=(4,), device="cpu").dtype == np.float64
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_build_uses_the_given_args_namespace():
    args = argparse.Namespace(kxreg=0.0, ktreg=0.0, kimp=5.0)
    tp, ts, extra = tvt.build(kernel="pallas_mg", device="cpu", args=args, **SIZE)
    (loss, (terms, _)), _ = tp.make_loss_grad_fn(ts)(tp.domain.arrays_from_state(ts), tp.tracers)
    assert len(terms) == 2 and extra.args is args

