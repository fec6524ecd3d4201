"""The wave model of the port against the JAX package on the CPU: the fused
row function (hist=2, per-row boundary data of shape (T, 1), 1-D planes) and
its hand adjoint against autograd (fp64, rtol 1e-12), ``operator_fused`` and
``operator`` and the one-pass route against the JAX package's
``make_loss_grad_fn(interpret=True)`` at 16x16 with multigrid (fp64 rtol
1e-10; fp32 terms rtol 1e-5, gradients rtol 1e-4 with atol 1e-6 * max|ref|),
and five Adam steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.context import Context
from odil_torch.convert import arrays_from_numpy
from odil_torch.models import wave as tw
from odil_torch.optim import Adam
from odil_torch.ops import rowwise as trw

SIZE = dict(nt=16, nx=16)


def _pair(kernel, dtype, seed=0, multigrid=True):
    from odil_tpu.models import wave as jw

    jp, js, _ = jw.build(kernel=kernel, dtype=dtype, multigrid=multigrid, **SIZE)
    tp, ts, _ = tw.build(kernel=kernel, dtype=dtype, multigrid=multigrid, device="cpu", **SIZE)
    rng = np.random.default_rng(seed)
    arrays = [(0.1 * rng.normal(size=a.shape)).astype(dtype) for a in jp.domain.arrays_from_state(js)]
    return (jp, js), (tp, ts), arrays


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol_frac * max(1.0, float(np.abs(want).max())))


def _check(loss, terms, grads, jl, jterms, jg, rtol, grtol, gatol):
    assert len(terms) == len(jterms) == 1 and len(grads) == len(jg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=rtol)
    np.testing.assert_allclose(float(terms[0].detach()), float(jterms[0]), rtol=rtol)
    for a, b in zip(grads, jg):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.detach().numpy(), b, grtol, gatol)


def _jax_onepass(jp, js, arrays):
    fn = jp.make_loss_grad_fn(js, interpret=True)
    assert fn is not None
    return jax.jit(fn)([jnp.asarray(a) for a in arrays], jp.tracers)


@pytest.mark.parametrize("shape", [(8, 16), (7, 5), (3, 1), (2, 2), (5, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_hand_adjoint_matches_autograd(shape):
    """_make_row_vjp against autograd of _make_row_fn, fp64: rows t, t-1,
    t-2 (T down to 2, where they wrap onto each other), planes down to one
    cell (both boundary ghosts on it)."""
    T, N = shape
    tp, ts, e = tw.build(nt=T, nx=N, dtype=np.float64, multigrid=False, kernel="pallas", device="cpu")
    model = tw._row_model(Context(tp.domain, ts, extra=e, tracers={"epoch": 0}))
    rng = np.random.default_rng(T * 10 + N)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s))
    fields, data = (mk(T, N),), (mk(T, 1), mk(T, 1))
    consts = (mk(N), mk(N), torch.arange(N, dtype=torch.float64))
    g = torch.tensor([0.7], dtype=torch.float64)
    hand = trw._backward_plain(model, 1, 2, fields, (), data, consts, g, True)
    auto = trw._backward_plain(trw.RowModel(model.row_fn), 1, 2, fields, (), data, consts, g, True)
    assert hand[1] == ()
    _close(hand[0][0].numpy(), auto[0][0].numpy(), 1e-12, 1e-13)
    _close(hand[2].numpy(), auto[2].numpy(), 1e-12, 0.0)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_fp64_loss_and_grads_match_jax(kernel):
    """fp64: make_loss_grad_fn declines (the 64-bit rule); make_loss_fn with
    autograd matches the JAX package's one-pass route (pallas) or
    value_and_grad (xla) to rtol 1e-10."""
    (jp, js), (tp, ts), arrays = _pair(kernel, np.float64, seed=2)
    assert tp.make_loss_grad_fn(ts) is None
    if kernel == "pallas":
        (jl, (jterms, _)), jg = _jax_onepass(jp, js, arrays)
    else:
        jloss_fn, _ = jp.make_loss_fn(js)
        (jl, (jterms, _)), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
            [jnp.asarray(a) for a in arrays], jp.tracers
        )
    loss_fn, _ = tp.make_loss_fn(ts)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    loss, (terms, _) = loss_fn(x, tp.tracers)
    _check(loss, terms, torch.autograd.grad(loss, x), jl, jterms, jg, 1e-10, 1e-10, 1e-12)


@pytest.mark.parametrize("route", ["onepass", "loss_only"])
def test_fp32_routes_match_jax_onepass(route):
    """fp32: the port's one-pass route and its loss-only route against the
    JAX package's one-pass route (the blocked kernels, hist=2) in
    interpret mode."""
    (jp, js), (tp, ts), arrays = _pair("pallas", np.float32, seed=4)
    (jl, (jterms, _)), jg = _jax_onepass(jp, js, arrays)
    if route == "onepass":
        fn = tp.make_loss_grad_fn(ts)
        assert fn is not None
        (loss, (terms, _)), grads = fn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
    else:
        loss_fn, _ = tp.make_loss_fn(ts)
        x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
        loss, (terms, _) = loss_fn(x, tp.tracers)
        grads = torch.autograd.grad(loss, x)
    _check(loss, terms, grads, jl, jterms, jg, 1e-5, 1e-4, 1e-6)


def test_adam_five_steps_match_jax():
    """Five Adam epochs (lr 0.01, fp32) of the port's one-pass route against
    the update rule driven by the JAX package's one-pass route."""
    (jp, js), (tp, ts), arrays = _pair("pallas", np.float32, seed=3)
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


def test_build_rejects_unknown_kernel():
    with pytest.raises(ValueError):
        tw.build(kernel="pallas_mg", device="cpu", **SIZE)
