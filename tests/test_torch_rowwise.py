"""The port's generic row-wise kernels (plain versions and entry points, on
the CPU) against the JAX package's Pallas kernels in interpret mode: the
whole-plane pair ``_forward``/``_backward`` (block_rows=1, T=8) and the
blocked pair ``_forward_blocked``/``_backward_blocked`` (block_rows=3, T=9).
The CUDA kernels are held to the plain versions in test_torch_gpu.py.

Same numpy inputs through both packages.  Row models: the veltracer row
function with all six terms (hand adjoint and autograd) and with the
regularizers off, and a generic row function with params, per-row data,
hist=2 and 1-D planes.  Tolerances: fp64 rtol 1e-10; fp32 terms rtol 1e-5
and gradients rtol 1e-4 with atol 1e-6 * max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.models import veltracer as tvt
from odil_torch.ops import rowwise as trw
from odil_tpu.backend import ModJax
from odil_tpu.models import veltracer as jvt
from odil_tpu.ops import rowwise as jrw

X, Y, N = 16, 12, 16
TOL = {np.float64: (1e-10, 1e-10, 1e-10), np.float32: (1e-5, 1e-4, 1e-6)}
ROUTES = {"whole_plane": (8, 1), "blocked": (9, 3)}  # (T, block_rows)
WEIGHTS = (1.0, 0.5, 2.0, 1.0, 0.3, 0.7)


def _jax_generic(it, T_, rows, data_rows, params, consts):
    """The row function of tests/test_rowwise.py::test_blocked_matches_unblocked."""
    (u_rows, v_rows) = rows
    (m,) = data_rows
    (wv,) = params
    cur, tm, tmm = u_rows
    vcur = v_rows[0]
    r1 = (cur - 2 * tm + tmm) + vcur * (jnp.roll(cur, -1) - jnp.roll(cur, 1)) * wv[0]
    r1 = jnp.where(it <= 1, wv[1] * cur, r1) * m
    r2 = (vcur - v_rows[1]) * wv[2]
    r2 = jnp.where(it == 0, 0.0, r2)
    return (r1, r2)


def _torch_generic(it, T_, rows, data_rows, params, consts):
    """The same row function on row stacks (plane axis last)."""
    (u_rows, v_rows) = rows
    (m,) = data_rows
    (wv,) = params
    cur, tm, tmm = u_rows
    vcur = v_rows[0]
    r1 = (cur - 2 * tm + tmm) + vcur * (torch.roll(cur, -1, -1) - torch.roll(cur, 1, -1)) * wv[0]
    r1 = torch.where(it <= 1, wv[1] * cur, r1) * m
    r2 = (vcur - v_rows[1]) * wv[2]
    r2 = torch.where(it == 0, 0.0, r2)
    return (r1, r2)


FLAGS = {"all_terms": dict(kimp=10.0, kxreg=0.01, ktreg=1.0), "no_reg": dict(kimp=3.0, kxreg=0.0, ktreg=0.0)}


def _case(kind, T, dtype, seed=11):
    """(jax row_fn, torch RowModel, nterms, hist, numpy inputs (fields,
    params, data, consts))."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: (0.3 * rng.normal(size=shape)).astype(dtype)
    if kind == "generic":
        fields = [mk(T, N), mk(T, N)]
        params = [mk(3)]
        data = [rng.integers(0, 2, (T, N)).astype(dtype)]
        return _jax_generic, trw.RowModel(_torch_generic), 2, 2, (fields, params, data, [])
    flags, hand = FLAGS[kind.split("/")[0]], kind.endswith("/hand")
    step = (1.0 / 8, 1.0 / X, 1.0 / Y)
    jfn = jvt._make_row_fn(ModJax(), *step, flags["kimp"], flags["kxreg"], flags["ktreg"])
    model = trw.RowModel(tvt._make_row_fn(*step, **flags), tvt._make_row_vjp(*step, **flags) if hand else None)
    nterms = 2 + (2 if flags["kxreg"] else 0) + (2 if flags["ktreg"] else 0)
    return jfn, model, nterms, 1, ([mk(T, X, Y) for _ in range(3)], [], [], [mk(X, Y), mk(X, Y)])


KINDS = ["all_terms/hand", "all_terms/autograd", "no_reg/hand", "generic"]


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol_frac * max(1.0, np.abs(want).max()))


def _jax(xs):
    return [jnp.asarray(a) for a in xs]


def _torch(xs):
    return tuple(torch.as_tensor(a) for a in xs)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_match_jax_kernels(kind, route, dtype):
    """_forward_plain and _backward_plain (sums on and off) against the JAX
    kernels' sums, one-pass loss+grads and the custom_vjp gradient."""
    T, B = ROUTES[route]
    jfn, model, nterms, hist, (fields, params, data, consts) = _case(kind, T, dtype)
    rt, rg, ag = TOL[dtype]
    cells = float(np.prod(fields[0].shape))
    jargs = dict(params=_jax(params), data=_jax(data), consts=_jax(consts), nterms=nterms, hist=hist,
                 interpret=True, block_rows=B)
    targs = (_torch(fields), _torch(params), _torch(data), _torch(consts))

    jsums = jrw.rowwise_loss_sums(jfn, _jax(fields), **jargs)
    sums = trw._forward_plain(model, nterms, hist, *targs)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=rt)

    jsums1, jdf, jdp = jrw.rowwise_loss_and_grads(jfn, _jax(fields), gscale=1.0 / cells, **jargs)
    g = torch.full((nterms,), 1.0 / cells, dtype=targs[0][0].dtype)
    dfields, dparams, sums1 = trw._backward_plain(model, nterms, hist, *targs, g, with_sums=True)
    np.testing.assert_allclose(sums1.numpy(), np.asarray(jsums1), rtol=rt)
    assert len(dfields) == len(jdf) and len(dparams) == len(jdp)
    for a, b in zip(dfields + dparams, list(jdf) + list(jdp)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, rg, ag)

    def jloss(fs, ps):
        terms = jrw.rowwise_loss_terms(jfn, fs, **dict(jargs, params=ps))
        return sum(w * t for w, t in zip(WEIGHTS, terms))

    jg = jax.grad(jloss, argnums=(0, 1))(_jax(fields), _jax(params))
    gw = torch.tensor(WEIGHTS[:nterms], dtype=targs[0][0].dtype) / cells
    dfields, dparams, none = trw._backward_plain(model, nterms, hist, *targs, gw, with_sums=False)
    assert none is None
    for a, b in zip(dfields + dparams, list(jg[0]) + list(jg[1])):
        _close(a.numpy(), b, rg, ag)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["all_terms/hand", "generic"])
def test_entry_points_match_jax(kind, dtype):
    """rowwise_loss_terms with autograd (the kernel pair through
    _RowwiseSumsq at fp32, the plain route with autograd at fp64) and
    rowwise_loss_and_grads (fp32; None at fp64) against the JAX package."""
    T, B = ROUTES["blocked"]
    jfn, model, nterms, hist, (fields, params, data, consts) = _case(kind, T, dtype, seed=5)
    rt, rg, ag = TOL[dtype]
    jargs = dict(data=_jax(data), consts=_jax(consts), nterms=nterms, hist=hist, interpret=True, block_rows=B)

    def jloss(fs, ps):
        terms = jrw.rowwise_loss_terms(jfn, fs, params=ps, **jargs)
        return sum(w * t for w, t in zip(WEIGHTS, terms)), terms

    (jl, jterms), (jgf, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        _jax(fields), _jax(params)
    )
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in fields + params]
    nf = len(fields)
    terms = trw.rowwise_loss_terms(
        model, leaves[:nf], params=leaves[nf:], data=_torch(data), consts=_torch(consts), nterms=nterms,
        hist=hist, block_rows=B,
    )
    loss = sum(w * t for w, t in zip(WEIGHTS, terms))
    grads = torch.autograd.grad(loss, leaves)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rt)
    for a, b in zip(grads, list(jgf) + list(jgp)):
        _close(a.numpy(), b, rg, ag)

    out = trw.rowwise_loss_and_grads(
        model, _torch(fields), params=_torch(params), data=_torch(data), consts=_torch(consts), nterms=nterms,
        hist=hist,
    )
    if dtype == np.float64:
        assert out is None
        return
    jsums, jdf, jdp = jrw.rowwise_loss_and_grads(jfn, _jax(fields), params=_jax(params), **jargs)
    sums, dfields, dparams = out
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=rt)
    for a, b in zip(tuple(dfields) + tuple(dparams), list(jdf) + list(jdp)):
        _close(a.numpy(), b, rg, ag)


def test_64bit_rule_takes_the_plain_route(monkeypatch):
    """64-bit fields never reach the kernel dispatch (the JAX package's rule,
    odil_tpu/ops/rowwise.py:968-969): rowwise_loss_terms differentiates the
    plain version, rowwise_loss_and_grads and onepass_supported decline.
    32-bit fields go through the dispatch."""
    _, model, nterms, hist, (fields, params, data, consts) = _case("all_terms/hand", 8, np.float64)
    calls = []
    real = trw._forward
    monkeypatch.setattr(trw, "_forward", lambda *a: calls.append(a) or real(*a))
    f64 = _torch(fields)
    terms = trw.rowwise_loss_terms(model, f64, consts=_torch(consts), nterms=nterms, hist=hist)
    assert calls == [] and terms[0].dtype == torch.float64
    assert trw.rowwise_loss_and_grads(model, f64, consts=_torch(consts), nterms=nterms) is None
    assert not trw.onepass_supported(f64, (), (), (), nterms, hist)
    f32 = tuple(f.float() for f in f64)
    assert trw.onepass_supported(f32, (), (), (), nterms, hist)
    trw.rowwise_loss_terms(model, f32, consts=tuple(c.float() for c in _torch(consts)), nterms=nterms, hist=hist)
    assert len(calls) == 1


def test_stream_raises_and_block_rows_changes_nothing():
    """stream=True no longer raises: the streaming pair computes the same
    function, so on the CPU it gives the ordinary route's bits (the plain
    versions; tests/test_torch_stream.py holds it to the JAX package's stream
    kernels).  block_rows changes nothing."""
    _, model, nterms, hist, (fields, _, _, consts) = _case("all_terms/hand", 9, np.float32)
    args = (model, _torch(fields))
    kw = dict(consts=_torch(consts), nterms=nterms, hist=hist)
    base = trw.rowwise_loss_terms(*args, **kw)
    for a, c in zip(trw.rowwise_loss_terms(*args, stream=True, **kw), base):
        assert float(a) == float(c)
    for a, c in zip(trw.rowwise_loss_sums(*args, stream=True, **kw), trw.rowwise_loss_sums(*args, **kw)):
        assert float(a) == float(c)
    for b in (1, 3, 9):
        for a, c in zip(trw.rowwise_loss_terms(*args, block_rows=b, **kw), base):
            assert float(a) == float(c)


def test_cuda_wrappers_refuse_cpu_and_unknown_models():
    """The CUDA wrappers take the veltracer model with its 3 fields and 2
    const planes, or a row function the tracer takes, on float32 CUDA
    tensors: no fallback.  A row function the tracer refuses (a read two
    cells along y) has no CUDA kernel."""
    _, model, nterms, hist, (fields, _, _, consts) = _case("all_terms/hand", 8, np.float32)
    f, c = _torch(fields), _torch(consts)

    def reach2(it, T_, rows, data_rows, params, consts_):
        return tuple(rows[0][0] - torch.roll(rows[0][1], 2, -1) for _ in range(nterms))

    with pytest.raises(NotImplementedError):
        trw.forward_cuda(trw.RowModel(reach2), nterms, hist, f, (), (), c)
    with pytest.raises(TypeError):  # traced, but on CPU tensors
        trw.forward_cuda(model, nterms, hist, f, (), (), c)
    cuda_model = trw.RowModel(model.row_fn, cuda_model="veltracer")
    with pytest.raises(TypeError):
        trw.forward_cuda(cuda_model, nterms, hist, f, (), (), c)
    with pytest.raises(ValueError):
        trw.backward_cuda(cuda_model, nterms, hist, f, (c[0],), (), c, torch.ones(nterms), True)
    with pytest.raises(ValueError):
        trw.forward_cuda(cuda_model, nterms, 2, f, (), (), c)
