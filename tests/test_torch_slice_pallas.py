"""The flagship's ``kernel="pallas"`` route of the port against the JAX
package on the CPU: velocity_from_tracer built in both packages at (Nt, Nx,
Ny) = (8, 16, 16) with multigrid, the same random state carried across by
``convert.arrays_from_numpy``, then the generic one-pass route of
``make_loss_grad_fn``, the loss-only route with autograd, five Adam steps,
the fallback of ``operator_fused_mg`` without multigrid partials, the 64-bit
rule and the deferred ``ctx.rowwise_terms``.  Tolerances: fp32 terms rtol
1e-5, gradients rtol 1e-4 with atol 1e-6 * max|ref|; fp64 rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.context import Context
from odil_torch.convert import arrays_from_numpy
from odil_torch.models import veltracer as tvt
from odil_torch.optim import Adam
from odil_tpu.models import veltracer as jvt

SIZE = dict(nt=8, nx=16, ny=16)


def _pair(kernel, dtype=np.float32, seed=0, multigrid=True):
    jp, js, _ = jvt.build(kernel=kernel, dtype=dtype, multigrid=multigrid, **SIZE)
    tp, ts, _ = tvt.build(kernel=kernel, dtype=dtype, multigrid=multigrid, device="cpu", **SIZE)
    rng = np.random.default_rng(seed)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(dtype) for a in jp.domain.arrays_from_state(js)]
    return (jp, js), (tp, ts), arrays


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol, atol=atol_frac * max(1.0, float(np.abs(want).max()))
    )


def _check(loss, terms, grads, jl, jterms, jg, rtol=1e-5, grtol=1e-4, gatol=1e-6):
    assert len(terms) == len(jterms) and len(grads) == len(jg)
    np.testing.assert_allclose(np.asarray(loss.detach()), np.asarray(jl), rtol=rtol)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(b), rtol=rtol)
    for a, b in zip(grads, jg):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, grtol, gatol)


@pytest.mark.parametrize("reference", ["jax_onepass", "jax_value_and_grad"])
@pytest.mark.parametrize("kernel,multigrid", [("pallas", True), ("pallas", False), ("pallas_mg", False)],
                         ids=["pallas", "pallas-no_multigrid", "pallas_mg-no_partials"])
def test_onepass_route_matches_jax(kernel, multigrid, reference):
    """The port's one-pass route (``pallas``, and ``pallas_mg`` without
    multigrid partials, which falls back to ``operator_fused``) against the
    JAX package's one-pass route in interpret mode and against
    jax.value_and_grad of its loss."""
    (jp, js), (tp, ts), arrays = _pair(kernel, multigrid=multigrid)
    jx = [jnp.asarray(a) for a in arrays]
    if reference == "jax_onepass":
        jfn = jp.make_loss_grad_fn(js, interpret=True)
        assert jfn is not None
        (jl, (jterms, _)), jg = jax.jit(jfn)(jx, jp.tracers)
    else:
        jloss_fn, _ = jp.make_loss_fn(js)
        (jl, (jterms, _)), jg = jax.value_and_grad(jloss_fn, has_aux=True)(jx, jp.tracers)
    fn = tp.make_loss_grad_fn(ts)
    assert fn is not None
    (loss, (terms, norms)), grads = fn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
    assert len(terms) == 6 and len(norms) == 6
    _check(loss, terms, grads, jl, jterms, jg)


def test_loss_only_route_matches_onepass_route():
    """make_loss_fn + autograd (forward kernel, backward kernel with the sums
    off) against the one-pass route (backward kernel with the sums on)."""
    _, (tp, ts), arrays = _pair("pallas", seed=1)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    loss_fn, _ = tp.make_loss_fn(ts)
    loss, (terms, _) = loss_fn(x, tp.tracers)
    grads = torch.autograd.grad(loss, x)
    (loss2, (terms2, _)), grads2 = tp.make_loss_grad_fn(ts)([a.detach() for a in x], tp.tracers)
    np.testing.assert_allclose(loss.detach().numpy(), loss2.numpy(), rtol=1e-6)
    for a, b in zip(terms, terms2):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-6)
    for a, b in zip(grads, grads2):
        _close(a.numpy(), b.numpy(), 1e-5, 1e-7)


def test_adam_matches_bench_update_rule():
    """Five epochs of the port's Adam on the one-pass route against the
    update of bench.py:116-126 (fp32 slots) driven by the JAX package's
    one-pass route."""
    (jp, js), (tp, ts), arrays = _pair("pallas", seed=3)
    grad_fn = jax.jit(jp.make_loss_grad_fn(js, interpret=True))
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


@pytest.mark.parametrize("kernel", ["pallas", "pallas_mg"])
def test_fp64_takes_the_plain_route(kernel):
    """64-bit: make_loss_grad_fn declines the kernel routes (the JAX
    package's rule, odil_tpu/problem.py:470-472), and make_loss_fn with
    autograd -- the plain versions -- matches JAX's value_and_grad to rtol
    1e-10.  Without partials pallas_mg takes operator_fused."""
    (jp, js), (tp, ts), arrays = _pair(kernel, dtype=np.float64, seed=2, multigrid=kernel == "pallas")
    assert tp.make_loss_grad_fn(ts) is None
    jloss_fn, _ = jp.make_loss_fn(js)
    (jl, (jterms, _)), jg = jax.value_and_grad(jloss_fn, has_aux=True)([jnp.asarray(a) for a in arrays], jp.tracers)
    loss_fn, _ = tp.make_loss_fn(ts)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    loss, (terms, _) = loss_fn(x, tp.tracers)
    _check(loss, terms, torch.autograd.grad(loss, x), jl, jterms, jg, 1e-10, 1e-10, 1e-12)


def test_rowwise_terms_defers_and_records():
    """ctx.rowwise_terms: eager Raw terms marked from_rowwise; in the
    deferred mode placeholders carrying (call, term) and the recorded call."""
    tp, ts, extra = tvt.build(kernel="pallas", device="cpu", **SIZE)
    tp._capture_structure(ts)
    st = tp._fine_state(tp.domain.arrays_from_state(ts))
    ctx = Context(tp.domain, st, extra=extra, tracers=tp.tracers)
    terms = tvt.operator_fused(ctx)
    assert len(terms) == 6 and all(t.from_rowwise and t.value.ndim == 0 for t in terms)
    assert ctx.rowwise_calls == [{"keys": ("u", "vx", "vy"), "hist": 1, "halox": 1, "nterms": 6}]
    ctx = Context(tp.domain, st, extra=extra, tracers=tp.tracers)
    ctx.rowwise_defer = True
    terms = tvt.operator_fused(ctx)
    assert [t.deferred for t in terms] == [(0, k) for k in range(6)] and all(t.value is None for t in terms)
    (rec,) = ctx.rowwise_deferred
    assert rec["keys"] == ("u", "vx", "vy") and rec["nterms"] == 6 and rec["hist"] == 1 and not rec["stream"]
    assert all(f is st.fields[k].array for f, k in zip(rec["fields"], rec["keys"]))


def test_streaming_call_raises_and_declines_onepass():
    """An operator asking for the streaming kernels: make_loss_grad_fn
    declines (as the JAX package does) and the loss, which raised before the
    streaming pair was ported, runs and equals the ordinary route's."""
    tp, ts, _ = tvt.build(kernel="pallas", device="cpu", **SIZE)
    loss_fn, x = tp.make_loss_fn(ts)
    rng = np.random.default_rng(4)
    x = [torch.as_tensor(0.3 * rng.normal(size=tuple(a.shape)), dtype=a.dtype) for a in x]
    want, _ = loss_fn(x, tp.tracers)

    def op(ctx):
        return ctx.rowwise_terms(**tvt._kernel_decl(ctx), stream=True)

    tp.operator = op
    assert tp.make_loss_grad_fn(ts) is None
    got, _ = loss_fn(x, tp.tracers)
    assert float(got) == float(want)


def test_onepass_folds_non_kernel_terms():
    """An operator mixing a kernel call with a squared plain term and a Raw
    term: the one-pass route's terms and gradients against autograd of
    make_loss_fn (the non-kernel cotangents 2v/numel and 1/numel)."""
    tp, ts, _ = tvt.build(kernel="pallas", device="cpu", **SIZE)

    def op(ctx):
        extra_sq = ctx.field("vx") - 0.5 * ctx.field("u", -1, 0, 0)
        return tvt.operator_fused(ctx) + [extra_sq, Context.Raw(torch.sum(ctx.field("vy") ** 3) * 1e-3)]

    tp.operator = op
    rng = np.random.default_rng(6)
    arrays = [(0.3 * rng.normal(size=tuple(a.shape))).astype(np.float32) for a in tp.domain.arrays_from_state(ts)]
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    loss_fn, _ = tp.make_loss_fn(ts)
    loss, (terms, _) = loss_fn(x, tp.tracers)
    grads = torch.autograd.grad(loss, x)
    (loss2, (terms2, _)), grads2 = tp.make_loss_grad_fn(ts)([a.detach() for a in x], tp.tracers)
    assert len(terms2) == 8
    np.testing.assert_allclose(loss2.numpy(), loss.detach().numpy(), rtol=1e-6)
    for a, b in zip(terms2, terms):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-6)
    for a, b in zip(grads2, grads):
        _close(a.numpy(), b.numpy(), 1e-5, 1e-7)
