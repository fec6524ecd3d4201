"""The port's veltracer row model: the hand-written adjoint against
autograd (torch.func.vjp) of the torch row function, and both against the
JAX package's row function and adjoint, on every special row: it = 0, 1,
T-2 (the imposed-final row), T-1 and a middle row, with a nonzero state
(a zero state cannot tell where the imposed-final row sits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.models import veltracer as tvt
from odil_tpu.backend import ModJax
from odil_tpu.models import veltracer as jvt

T, X, Y = 9, 12, 10
STEP = (1.0 / 8, 1.0 / X, 1.0 / Y)
ROWS = [0, 1, T - 2, T - 1, 4]
FLAGS = [dict(kimp=10.0, kxreg=0.01, ktreg=1.0), dict(kimp=3.0, kxreg=0.0, ktreg=0.0)]


def _state(seed):
    rng = np.random.default_rng(seed)
    rows = [rng.normal(size=(X, Y)) for _ in range(6)]  # (u, uprev, vx, vxp, vy, vyp)
    consts = [rng.normal(size=(X, Y)) for _ in range(2)]
    return rows, consts


def _nested(flat):
    return ((flat[0], flat[1]), (flat[2], flat[3]), (flat[4], flat[5]))


@pytest.mark.parametrize("it", ROWS)
@pytest.mark.parametrize("flags", FLAGS, ids=["all_terms", "no_reg"])
def test_row_vjp_matches_autograd(it, flags):
    rows, consts = _state(10 + it)
    fn = tvt._make_row_fn(*STEP, **flags)
    vjp = tvt._make_row_vjp(*STEP, **flags)
    flat = [torch.as_tensor(r)[None] for r in rows]
    cst = tuple(torch.as_tensor(c) for c in consts)
    itt = torch.full((1, 1, 1), it)
    res, pull = torch.func.vjp(lambda *f: fn(itt, T, _nested(f), (), (), cst), *flat)
    cots = tuple(torch.as_tensor(np.random.default_rng(it).normal(size=(1, X, Y))) for _ in res)
    want = pull(cots)
    got, dpar = vjp(itt, T, _nested(flat), (), (), cst, cots)
    assert dpar == ()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("it", ROWS)
def test_row_fn_and_vjp_match_jax(it):
    flags = FLAGS[0]
    rows, consts = _state(20 + it)
    args = (*STEP, flags["kimp"], flags["kxreg"], flags["ktreg"])
    jfn = jvt._make_row_fn(ModJax(), *args)
    jvjp = jvt._make_row_vjp(ModJax(), *args)
    jrows = _nested([jnp.asarray(r) for r in rows])
    jc = tuple(jnp.asarray(c) for c in consts)
    jres = jfn(jnp.asarray(it), T, jrows, (), (), jc)
    cots = [np.random.default_rng(it).normal(size=(X, Y)) for _ in jres]
    jd, _ = jvjp(jnp.asarray(it), T, jrows, (), (), jc, [jnp.asarray(c) for c in cots])

    flat = [torch.as_tensor(r)[None] for r in rows]
    itt = torch.full((1, 1, 1), it)
    cst = tuple(torch.as_tensor(c) for c in consts)
    res = tvt._make_row_fn(*args)(itt, T, _nested(flat), (), (), cst)
    d, _ = tvt._make_row_vjp(*args)(itt, T, _nested(flat), (), (), cst, [torch.as_tensor(c)[None] for c in cots])
    for a, b in zip(res, jres):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    for a, b in zip(d, jd):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


def test_imposed_final_row_sits_at_T_minus_2():
    rows, consts = _state(3)
    fn = tvt._make_row_fn(*STEP, **FLAGS[0])
    flat = [torch.as_tensor(r)[None] for r in rows]
    cst = tuple(torch.as_tensor(c) for c in consts)
    fimp = {it: fn(torch.full((1, 1, 1), it), T, _nested(flat), (), (), cst)[1] for it in (T - 2, T - 1)}
    assert float(fimp[T - 2].abs().max()) > 0
    assert float(fimp[T - 1].abs().max()) == 0


def test_row_stacks_equal_single_rows():
    """A stack of rows gives, row by row, the single-row results."""
    rng = np.random.default_rng(7)
    stack = [torch.as_tensor(rng.normal(size=(T, X, Y))) for _ in range(6)]
    cst = tuple(torch.as_tensor(rng.normal(size=(X, Y))) for _ in range(2))
    fn = tvt._make_row_fn(*STEP, **FLAGS[0])
    whole = fn(torch.arange(T).view(T, 1, 1), T, _nested(stack), (), (), cst)
    for it in ROWS:
        one = fn(torch.full((1, 1, 1), it), T, _nested([s[it : it + 1] for s in stack]), (), (), cst)
        for a, b in zip(whole, one):
            np.testing.assert_array_equal(a[it].numpy(), b[0].numpy())
