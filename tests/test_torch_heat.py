"""The heat inverse-conductivity model of the port against the JAX package on
the CPU: the fused row function and its hand adjoint against autograd
(fp64, rtol 1e-12), ``operator_odil_fused`` and ``operator_odil`` and the
one-pass route against the JAX package's ``make_loss_grad_fn(interpret=True)``
(fp64 rtol 1e-10; fp32 terms rtol 1e-5, gradients rtol 1e-4 with atol 1e-6 *
max|ref|), five Adam steps, the stripe of measurements, and the committed
parity data of ``chip_smoke.py``'s heat run.

Regenerate that data file (the JAX package's initial conductivity net at
seed 1000 and its epoch-0 loss at 64^2, fp32) with

    JAX_PLATFORMS=cpu python tests/test_torch_heat.py
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from odil_torch.context import Context  # noqa: E402
from odil_torch.convert import arrays_from_numpy  # noqa: E402
from odil_torch.models import heat as th  # noqa: E402
from odil_torch.optim import Adam  # noqa: E402
from odil_torch.ops import rowwise as trw  # noqa: E402

DATA = os.path.join(ROOT, "odil_torch", "data", "heat_inverse_64.json")
# The converged-lane configuration (tests/test_converged.py:63-82).
LANE = dict(nt=64, nx=64, infer_k=True, imposed="stripe", nimp=200, seed=1000)


def _args(**kw):
    """The build arguments with annealed regularizers (decay periods on)."""
    a = dict(infer_k=True, imposed="random", nimp=40, noise=0.0, seed=1000, kimp=2.0, kxreg=0.3, kxregdecay=5,
             ktreg=0.2, ktregdecay=3, kwreg=0.1, kwregdecay=4, kmax=0.1, keep_frozen=1, keep_init=1, solver="odil")
    a.update(kw)
    return argparse.Namespace(**a)


def _pair(kernel, dtype, seed=0, args=None, nt=16, nx=16, multigrid=True, epoch=7):
    from odil_tpu.models import heat as jh

    args = args or _args()
    jp, js, _ = jh.build(nt=nt, nx=nx, dtype=dtype, multigrid=multigrid, kernel=kernel, args=args)
    tp, ts, _ = th.build(nt=nt, nx=nx, dtype=dtype, multigrid=multigrid, kernel=kernel, device="cpu", args=args)
    rng = np.random.default_rng(seed)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(dtype) for a in jp.domain.arrays_from_state(js)]
    jp.tracers["epoch"] = epoch
    tp.tracers["epoch"] = epoch
    return (jp, js), (tp, ts), arrays


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol_frac * max(1.0, float(np.abs(want).max())))


def _check(loss, terms, grads, jl, jterms, jg, rtol, grtol, gatol):
    assert len(terms) == len(jterms) and len(grads) == len(jg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=rtol)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=rtol, atol=1e-30)
    for a, b in zip(grads, jg):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.detach().numpy(), b, grtol, gatol)


def _jax_onepass(jp, js, arrays):
    fn = jp.make_loss_grad_fn(js, interpret=True)
    assert fn is not None
    return jax.jit(fn)([jnp.asarray(a) for a in arrays], jp.tracers)


# -- Row function and hand adjoint ---------------------------------------------


@pytest.mark.parametrize("shape", [(8, 16), (7, 5), (6, 1), (5, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize(
    "kw",
    [dict(), dict(imposed="none", kxreg=0.0), dict(infer_k=False, ktreg=0.0), dict(kxreg=0.0, ktreg=0.0, kwreg=0.0)],
    ids=["all_terms", "no_imp_no_xreg", "true_k", "fu_imp"],
)
def test_hand_adjoint_matches_autograd(shape, kw):
    """_make_row_vjp (through the conductivity net for the params) against
    autograd of _make_row_fn, fp64, at seeded random rows, data, consts and
    params; periodic planes down to one cell."""
    T, N = shape
    tp, ts, e = th.build(nt=T, nx=N, dtype=np.float64, multigrid=False, kernel="pallas", device="cpu",
                         args=_args(**kw))
    model, names, params = th._row_model(Context(tp.domain, ts, extra=e, tracers={"epoch": 0}))
    rng = np.random.default_rng(T * 10 + N)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s))
    fields = (mk(T, N) + 0.5,)
    params = tuple(mk(*p.shape) for p in params)
    data = (torch.as_tensor((rng.uniform(size=(T, N)) < 0.4).astype(np.float64)), mk(T, N)) if e.imp_size else ()
    consts = (mk(N), mk(N), mk(N), torch.arange(N, dtype=torch.float64), mk(1, 1), mk(1, 1))
    g = torch.as_tensor(rng.uniform(0.5, 1.5, len(names)))
    hand = trw._backward_plain(model, len(names), 1, fields, params, data, consts, g, True)
    auto = trw._backward_plain(trw.RowModel(model.row_fn), len(names), 1, fields, params, data, consts, g, True)
    assert len(hand[1]) == len(params)
    for a, b in zip(list(hand[0]) + list(hand[1]), list(auto[0]) + list(auto[1])):
        _close(a.numpy(), b.numpy(), 1e-12, 1e-13)
    _close(hand[2].numpy(), auto[2].numpy(), 1e-12, 0.0)


def test_row_model_without_hand_adjoint():
    """keep_frozen=0 differentiates k by u: no hand adjoint, no CUDA model
    (autograd on the CPU, NotImplementedError on the card)."""
    tp, ts, e = th.build(nt=8, nx=8, dtype=np.float64, kernel="pallas", device="cpu", args=_args(keep_frozen=0))
    model, _, _ = th._row_model(Context(tp.domain, ts, extra=e, tracers={"epoch": 0}))
    assert model.row_vjp is None and model.cuda_model is None
    with pytest.raises(NotImplementedError):
        trw._cuda_model(model)


# -- Against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_fp64_loss_and_grads_match_jax(kernel):
    """fp64: make_loss_grad_fn declines (the 64-bit rule); make_loss_fn with
    autograd matches the JAX package's one-pass route (pallas) or
    value_and_grad (xla) to rtol 1e-10, annealed terms and wreg included."""
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
    assert len(terms) == 5  # fu, imp, xreg, treg, wreg
    _check(loss, terms, torch.autograd.grad(loss, x), jl, jterms, jg, 1e-10, 1e-10, 1e-12)


@pytest.mark.parametrize("route", ["onepass", "loss_only"])
def test_fp32_routes_match_jax_onepass(route):
    """fp32: the port's one-pass route (backward with the sums on, dparams
    folded through one autograd.grad) and its loss-only route (forward,
    then backward with the sums off) against the JAX package's one-pass
    route in interpret mode."""
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
    the update rule driven by the JAX package's one-pass route; the epoch
    tracer anneals kxreg, ktreg and kwreg on both sides."""
    (jp, js), (tp, ts), arrays = _pair("pallas", np.float32, seed=3, epoch=0)
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


def test_stripe_is_the_jax_mask():
    """pick_imposed("stripe") at 64^2 fp32: the band test on the domain's
    float32 points gives the JAX package's cells bit for bit."""
    from odil_tpu.models import heat as jh

    jp, _, je = jh.build(dtype=np.float32, **LANE)
    tp, _, te = th.build(dtype=np.float32, device="cpu", **LANE)
    np.testing.assert_array_equal(te.imp_indices, je.imp_indices)
    np.testing.assert_array_equal(te.imp_mask.numpy(), np.asarray(je.imp_mask))
    np.testing.assert_array_equal(te.imp_points, je.imp_points)
    assert te.imp_size == je.imp_size == 200


# -- The parity data of chip_smoke.py's heat run -------------------------------


def jax_reference():
    """The JAX package's initial state of the converged lane at 64^2 fp32 --
    its conductivity net after ``runtime.mod.random.set_seed(1000)``, as the
    heat example seeds it (``odil_tpu/util.py:424``) -- and its epoch-0
    loss."""
    import odil_tpu
    from odil_tpu.models import heat as jh

    odil_tpu.runtime.mod.random.set_seed(LANE["seed"])
    jp, js, _ = jh.build(dtype=np.float32, kernel="xla", **LANE)
    loss_fn, arrays = jp.make_loss_fn(js)
    loss, _ = loss_fn(arrays, {"epoch": 0})
    net = js.fields["k_net"]
    return {
        "config": dict(LANE, dtype="float32", multigrid=True, kernel="xla"),
        "weights": [np.asarray(w, dtype=np.float64).tolist() for w in net.weights],
        "biases": [np.asarray(b, dtype=np.float64).tolist() for b in net.biases],
        "epoch0_loss": float(loss),
    }


def test_committed_parity_data_is_current():
    """The committed net is the JAX package's bit for bit; the loss agrees
    within 1e-7 (the test process runs JAX with 64-bit types enabled,
    which moves its fp32 loss in the eighth digit: 44.768577298836455
    against the script's 44.768577575683594)."""
    with open(DATA) as fh:
        got = json.load(fh)
    want = jax_reference()
    assert {k: v for k, v in got.items() if k != "epoch0_loss"} == {k: v for k, v in want.items() if k != "epoch0_loss"}
    np.testing.assert_allclose(got["epoch0_loss"], want["epoch0_loss"], rtol=1e-7)


def test_port_epoch0_loss_with_committed_net():
    """The port's kernel route at the committed net gives the JAX epoch-0
    loss within 1e-5 (the gate chip_smoke.py applies on the card)."""
    with open(DATA) as fh:
        ref = json.load(fh)
    tp, ts, _ = th.build(dtype=np.float32, kernel="pallas", device="cpu", **LANE)
    net = ts.fields["k_net"]
    net.weights = [torch.tensor(w, dtype=torch.float32) for w in ref["weights"]]
    net.biases = [torch.tensor(b, dtype=torch.float32) for b in ref["biases"]]
    (loss, _), _ = tp.make_loss_grad_fn(ts)(tp.domain.arrays_from_state(ts), tp.tracers)
    assert abs(float(loss) - ref["epoch0_loss"]) <= 1e-5 * abs(ref["epoch0_loss"])


if __name__ == "__main__":
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    with open(DATA, "w") as fh:
        json.dump(jax_reference(), fh, indent=1)
        fh.write("\n")
    print(f"wrote {os.path.relpath(DATA, ROOT)}")
