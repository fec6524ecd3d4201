"""The port's on-device L-BFGS (``odil_torch/optim/lbfgs.py``) against
``optax.lbfgs`` with the zoom line search, as the JAX package's
``LbfgsOptimizer`` drives it, on the CPU in fp64.

- A quadratic and the Rosenbrock function: the iterates and losses of the
  first 20 iterations within rtol 1e-10, ``EarlyStopError`` at the same
  iteration with the same ``evals``; a short memory (the ring wraps) and a
  short line search (the safe-step fallback ends it) on Rosenbrock.
- The host syncs: one a line-search step and one a chunk.
- ``make_optimizer("lbfgs")`` and the bound-loss requirement.
"""

import numpy as np
import pytest
import torch

from odil_torch.optim import EarlyStopError, LbfgsOptimizer, make_optimizer
from odil_torch.optim import lbfgs as tlbfgs

RTOL, ITERS = 1e-10, 20


def _problem(name, xp, conv):
    """(loss_fn(arrays, tracers) -> (loss, (terms, norms)), x0)."""
    if name == "quadratic":
        rng = np.random.default_rng(0)
        a = rng.normal(size=(8, 8))
        a = a @ a.T + 0.5 * np.eye(8)
        b = rng.normal(size=8)
        a_, b_ = conv(a), conv(b)

        def fn(arrays, tracers):
            x = arrays[0]
            terms = [0.5 * xp.sum(x * (a_ @ x)) - xp.sum(b_ * x), 0.0 * xp.sum(x)]
            return terms[0] + terms[1], (terms, terms)

        return fn, [np.linspace(-1.0, 1.0, 8)]

    cat = torch.cat if xp is torch else xp.concatenate

    def fn(arrays, tracers):
        z = cat(list(arrays))
        terms = [xp.sum(100 * (z[1:] - z[:-1] ** 2) ** 2), xp.sum((1 - z[:-1]) ** 2)]
        return terms[0] + terms[1], (terms, [xp.sqrt(t) for t in terms])

    x0 = np.full(6, -0.5)
    x0[0] = -1.2
    return fn, [x0[:2], x0[2:]]


def _run(pkg, name, m, maxls, pgtol, epochs, task_epochs=None):
    """The optimizer of `pkg` on the problem: (per-epoch iterates and
    losses, (epochs, evals) of the early stop or None, the optimizer)."""
    if pkg == "jax":
        import jax.numpy as jnp

        from odil_tpu.optim.base import EarlyStopError as Stop
        from odil_tpu.optim.lbfgs import LbfgsOptimizer as Cls

        xp, conv = jnp, jnp.asarray
    else:
        Stop, Cls, xp, conv = EarlyStopError, LbfgsOptimizer, torch, torch.tensor
    fn, x0 = _problem(name, xp, conv)
    opt = Cls(pgtol=pgtol, m=m, maxls=maxls)
    opt.bind(fn, tracers={"epoch": 0}, task_epochs=task_epochs, names=["a", "b"])
    seen = []
    callback = lambda x, e, p: seen.append((e, np.concatenate([np.asarray(a).ravel() for a in x]), float(p["loss"])))
    try:
        opt.run([conv(a) for a in x0], epochs=epochs, callback=callback)
        stop = None
    except Stop as e:
        stop = (e.optinfo.epochs, e.optinfo.evals)
        assert e.optinfo.warnflag == 0 and "CONVERGED" in e.optinfo.task and len(e.optinfo.x) == len(x0)
    return seen, stop, opt


@pytest.mark.parametrize(
    "name,m,maxls,pgtol",
    [("quadratic", 50, 50, 1e-7), ("rosenbrock", 50, 50, 1e-7), ("rosenbrock", 3, 50, 1e-7),
     ("rosenbrock", 50, 3, 1e-7)],
    ids=["quadratic", "rosenbrock", "rosenbrock_m3", "rosenbrock_maxls3"],
)
def test_lbfgs_matches_optax(name, m, maxls, pgtol):
    """Every iteration a task epoch (chunks of 1): the first 20 iterates
    and losses within rtol 1e-10 of optax's; the same early stop."""
    jseen, jstop, jopt = _run("jax", name, m, maxls, pgtol, 120)
    tseen, tstop, topt = _run("torch", name, m, maxls, pgtol, 120)
    assert jstop is not None and tstop == jstop and topt.evals == jopt.evals, (tstop, jstop)
    assert [e for e, _, _ in tseen] == [e for e, _, _ in jseen]
    assert len(tseen) > ITERS
    for (e, xa, la), (_, xb, lb) in zip(tseen[:ITERS], jseen[:ITERS]):
        np.testing.assert_allclose(xa, xb, rtol=RTOL, atol=0, err_msg=f"iterate {e}")
        np.testing.assert_allclose(la, lb, rtol=RTOL, atol=0, err_msg=f"loss {e}")
    assert topt.grad_evals > topt.evals  # the line search evaluates too


def test_lbfgs_chunks_and_host_syncs():
    """Task epochs every 5: the same rows as chunks of 1, and one host sync
    a line-search step plus one a chunk (the value and slope at the iterate
    ride with the first trial step's)."""
    one, _, _ = _run("torch", "rosenbrock", 50, 50, 0.0, 20)
    five, stop, opt = _run("torch", "rosenbrock", 50, 50, 0.0, 20, task_epochs=[5, 10, 15, 20])
    assert stop is None and [e for e, _, _ in five] == [5, 10, 15, 20]
    for e, x, loss in five:
        assert np.array_equal(x, one[e - 1][1]) and loss == one[e - 1][2]
    ls_steps = opt.grad_evals - opt.evals
    assert opt.evals == 20 and opt.host_syncs == ls_steps + 4


@pytest.mark.parametrize("center,calls,steps", [(20.0, [1.0, 2.0], 2), (0.3, [1.0, 0.3], 2)])
def test_zoom_linesearch_on_a_parabola(center, calls, steps):
    """On f(t) = (t - c)^2 from t = 0: with c = 20 the interval search
    doubles the step to 2, where the curvature test holds (|f'| = 0.9
    |f'(0)|); with c = 0.3 the step 1 overshoots (the value rises), and the
    zoom's quadratic step lands on the minimum."""
    seen = []

    def value_slope(t):
        seen.append(t)
        return (t - center) ** 2, 2 * (t - center)

    t, n = tlbfgs.zoom_linesearch(value_slope, center**2, -2 * center, 50)
    assert seen == pytest.approx(calls, rel=1e-14) and n == steps and t == pytest.approx(calls[-1], rel=1e-14)


def test_make_optimizer_returns_lbfgs():
    opt = make_optimizer("lbfgs", dtype=np.float64, m=7, maxls=9, pgtol=None)
    assert isinstance(opt, LbfgsOptimizer) and (opt.m, opt.maxls, opt.pgtol) == (7, 9, 1e-16)
    with pytest.raises(RuntimeError, match="bound device loss"):
        opt.run([torch.zeros(3)], epochs=1)
    # Newton and Gauss-Newton are drivers of util.optimize, not registry
    # entries: the registry refuses them as the JAX package's does.
    for name in ("newton", "gn", "newton_mf"):
        with pytest.raises(ValueError, match="Unknown optimizer"):
            make_optimizer(name)
