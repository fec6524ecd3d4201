"""The port's MG-fused row kernels (plain versions, on the CPU) against the
JAX package's Pallas kernels in interpret mode (the CUDA kernels are held
to the plain versions in test_torch_gpu.py).

Same numpy inputs through both packages.  Tolerances: fp64 rtol 1e-10; fp32
terms rtol 1e-5 and gradients rtol 1e-4 with atol 1e-6 * max|ref|, as the
JAX package holds its own mg kernels (tests/test_rowwise.py:728-733)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.models import veltracer as tvt
from odil_torch.ops import rowwise_mg as trmg
from odil_tpu.backend import ModJax
from odil_tpu.models import veltracer as jvt
from odil_tpu.ops import rowwise_mg as jrmg
from odil_tpu.transfer import _interp_matrix

T, X, Y = 9, 32, 32
TC, CX, CY = 5, 16, 16
FACTORS0 = (0.7, 1.1, 0.9)
TOL = {np.float64: (1e-10, 1e-10, 1e-10), np.float32: (1e-5, 1e-4, 1e-6)}


def _inputs(dtype, seed=11):
    rng = np.random.default_rng(seed)
    t0s = [0.3 * rng.normal(size=(T, X, Y)).astype(dtype) for _ in range(3)]
    coarse = [0.3 * rng.normal(size=(TC, CX, CY)).astype(dtype) for _ in range(3)]
    consts = [rng.normal(size=(X, Y)).astype(dtype) for _ in range(2)]
    return t0s, coarse, consts


def _jax_row_fn(it, T_, rows, data_rows, params, consts_v):
    """The row function of test_rowwise.py::test_mg_tiled_matches_untiled."""
    (u_r, vx_r, vy_r) = rows
    u0, u1 = consts_v
    ucur, uprev = u_r
    vxc, _ = vx_r
    vyc, vyp = vy_r
    dux = (jnp.roll(uprev, -1, 0) - jnp.roll(uprev, 1, 0)) * 0.5
    duy = (jnp.roll(uprev, -1, 1) - jnp.roll(uprev, 1, 1)) * 0.5
    r1 = (ucur - uprev) + vxc * dux + vyc * duy
    r1 = jnp.where(it == 0, ucur - u0, r1)
    r2 = jnp.where(it == T_ - 1, ucur - u1, 0.0)
    lap = (
        jnp.roll(vxc, -1, 0) - 2 * vxc + jnp.roll(vxc, 1, 0)
        + jnp.roll(vxc, -1, 1) - 2 * vxc + jnp.roll(vxc, 1, 1)
    )
    r3 = 0.1 * lap
    r4 = jnp.where(it == 0, 0.0, vyc - vyp)
    return (r1, r2, r3, r4)


def _torch_row_fn(it, T_, rows, data_rows, params, consts_v):
    """The same row function on row stacks (plane axes last)."""
    (u_r, vx_r, vy_r) = rows
    u0, u1 = consts_v
    ucur, uprev = u_r
    vxc, _ = vx_r
    vyc, vyp = vy_r
    dux = (torch.roll(uprev, -1, -2) - torch.roll(uprev, 1, -2)) * 0.5
    duy = (torch.roll(uprev, -1, -1) - torch.roll(uprev, 1, -1)) * 0.5
    r1 = (ucur - uprev) + vxc * dux + vyc * duy
    r1 = torch.where(it == 0, ucur - u0, r1)
    r2 = torch.where(it == T_ - 1, ucur - u1, 0.0)
    lap = (
        torch.roll(vxc, -1, -2) - 2 * vxc + torch.roll(vxc, 1, -2)
        + torch.roll(vxc, -1, -1) - 2 * vxc + torch.roll(vxc, 1, -1)
    )
    r3 = 0.1 * lap
    r4 = torch.where(it == 0, 0.0, vyc - vyp)
    return (r1, r2, r3, r4)


_STEP = (1.0 / 8, 1.0 / X, 1.0 / Y)
_K = dict(kimp=10.0, kxreg=0.01, ktreg=1.0)


def _row_fns(kind, hand_vjp):
    """(jax row_fn, torch row model, nterms) of the generic or the veltracer model."""
    if kind == "generic":
        return _jax_row_fn, trmg.RowModel(_torch_row_fn), 4
    dt, dx, dy = _STEP
    jfn = jvt._make_row_fn(ModJax(), dt, dx, dy, _K["kimp"], _K["kxreg"], _K["ktreg"])
    vjp = tvt._make_row_vjp(dt, dx, dy, **_K) if hand_vjp else None
    model = trmg.RowModel(tvt._make_row_fn(dt, dx, dy, **_K), vjp)
    return jfn, model, 6


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol_frac * max(1.0, np.abs(want).max()))


CASES = [("generic", False), ("veltracer", True), ("veltracer", False)]


@pytest.mark.parametrize("kind,hand_vjp", CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_loss_and_grads_match_jax(kind, hand_vjp, dtype):
    t0s, coarse, consts = _inputs(dtype)
    jfn, model, nterms = _row_fns(kind, hand_vjp)
    jterms, (jdt0, jdc, _) = jrmg.rowwise_mg_loss_and_grads(
        jfn, t0s=[jnp.asarray(a) for a in t0s], coarse=[jnp.asarray(a) for a in coarse],
        factors0=FACTORS0, consts=[jnp.asarray(a) for a in consts], nterms=nterms, hist=1, interpret=True,
    )
    tt = lambda xs: [torch.as_tensor(a) for a in xs]
    terms, (dt0, dc, dpar) = trmg.rowwise_mg_loss_and_grads(
        model, tt(t0s), tt(coarse), FACTORS0, consts=tt(consts), nterms=nterms, hist=1,
    )
    rt, rg, ag = TOL[dtype]
    assert dpar == () and len(terms) == nterms
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rt)
    for a, b in zip(list(dt0) + list(dc), list(jdt0) + list(jdc)):
        assert a.dtype == torch.float64 if dtype == np.float64 else torch.float32
        _close(a.numpy(), b, rg, ag)


@pytest.mark.parametrize("kind,hand_vjp", CASES[:2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_loss_terms_autograd_match_jax_grad(kind, hand_vjp, dtype):
    """rowwise_loss_terms_mg (forward + autograd through the backward kernel's
    plain version, sums off) against jax.grad of the JAX kernel's loss."""
    t0s, coarse, consts = _inputs(dtype, seed=5)
    jfn, model, nterms = _row_fns(kind, hand_vjp)

    def jloss(t0s_, coarse_):
        terms = jrmg.rowwise_loss_terms_mg(
            jfn, t0s=t0s_, coarse=coarse_, factors0=FACTORS0, consts=[jnp.asarray(a) for a in consts],
            nterms=nterms, hist=1, interpret=True,
        )
        return sum(w * t for w, t in zip((1.0, 0.5, 2.0, 1.0, 0.3, 0.7), terms)), terms

    (jl, jterms), (jg0, jgc) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(a) for a in t0s], [jnp.asarray(a) for a in coarse]
    )
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in t0s + coarse]
    terms = trmg.rowwise_loss_terms_mg(model, leaves[:3], leaves[3:], FACTORS0,
                                       consts=[torch.as_tensor(a) for a in consts], nterms=nterms, hist=1)
    loss = sum(w * t for w, t in zip((1.0, 0.5, 2.0, 1.0, 0.3, 0.7), terms))
    grads = torch.autograd.grad(loss, leaves)
    rt, rg, ag = TOL[dtype]
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rt)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl), rtol=rt)
    for a, b in zip(grads, list(jg0) + list(jgc)):
        _close(a.numpy(), b, rg, ag)


def test_prepare_mg_asserts_shapes():
    t0s, coarse, consts = _inputs(np.float64)
    tt = lambda xs: [torch.as_tensor(a) for a in xs]
    with pytest.raises(AssertionError):
        trmg._prepare_mg(tt(t0s), [c[:-1] for c in tt(coarse)], FACTORS0, 1)
    with pytest.raises(AssertionError):
        trmg._prepare_mg(tt(t0s), [c[:, :-1] for c in tt(coarse)], FACTORS0, 1)
    *_, cells = trmg._prepare_mg(tt(t0s), tt(coarse), FACTORS0, 1)
    assert cells == T * X * Y


def test_recon_rows_matches_jax():
    t0s, coarse, _ = _inputs(np.float64)
    Wx = jnp.asarray(_interp_matrix(CX, "c", np.float64))
    Wy = jnp.asarray(_interp_matrix(CY, "c", np.float64))
    want = jrmg._recon_rows_xla(jnp.asarray(t0s[0]), jnp.asarray(coarse[0]), range(T), Wx, Wy, 0.7)
    tWx, tWy = torch.as_tensor(np.array(Wx)), torch.as_tensor(np.array(Wy))
    got = trmg._recon_rows(torch.as_tensor(t0s[0]), torch.as_tensor(coarse[0]), range(T), tWx, tWy, 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def _reach2_row_fn(it, T_, rows, data_rows, params, consts_v):
    """A row function that reads a field two cells away: past the traced
    kernels' reach, so it has no CUDA counterpart."""
    (u_r, _, _) = rows
    return (u_r[0] - torch.roll(u_r[1], 2, -2),) * 4


def test_cuda_route_refuses_cpu_and_unknown_models():
    """A row model without a CUDA counterpart, or a tensor that is not a
    float32 CUDA tensor, is refused by the CUDA wrappers (no fallback).  A
    user row function that the tracer takes has one (the traced mg walk), so
    its CPU tensors are what is refused."""
    t0s, coarse, consts = _inputs(np.float32)
    tt = lambda xs: tuple(torch.as_tensor(a) for a in xs)
    with pytest.raises(NotImplementedError):
        trmg.forward_mg_cuda(trmg.RowModel(_reach2_row_fn), 4, 1, FACTORS0, tt(t0s), tt(coarse), tt(consts))
    with pytest.raises(TypeError):
        trmg.forward_mg_cuda(trmg.RowModel(_torch_row_fn), 4, 1, FACTORS0, tt(t0s), tt(coarse), tt(consts))
    model = trmg.RowModel(_torch_row_fn, cuda_model="veltracer")
    with pytest.raises(TypeError):
        trmg.forward_mg_cuda(model, 6, 1, FACTORS0, tt(t0s), tt(coarse), tt(consts))

