"""The port's streaming route (``stream=True``) on the CPU against the JAX
package's streaming Pallas kernels ``_forward_stream``/``_backward_stream``
in interpret mode (off the TPU the JAX package reaches them only with
``interpret=True``, ``odil_tpu/ops/rowwise.py:966-992``).  On the CPU the
port runs the plain versions, which are the streaming kernels' plain
versions too; the CUDA kernels are held to them in test_torch_gpu.py.

Cases: those of tests/test_rowwise.py:355-410 (1-D planes with hist 2,
params and per-row data; 3-D planes with hist 1 and a const), the veltracer
row model at 9x16x16, and the wave and heat operators at 16-32 cells with
``Context.rowwise_terms`` wrapped in both packages to pass ``stream=True``.
Tolerances (fp32): loss rtol 1e-6, gradients rtol 1e-5 with atol
1e-6 * max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odil_torch.context as tctx
from odil_torch.convert import arrays_from_numpy
from odil_torch.models import heat as tht
from odil_torch.models import veltracer as tvt
from odil_torch.models import wave as twv
from odil_torch.ops import rowwise as trw
from odil_tpu import context as jctx
from odil_tpu.backend import ModJax
from odil_tpu.models import heat as jht
from odil_tpu.models import veltracer as jvt
from odil_tpu.models import wave as jwv
from odil_tpu.ops import rowwise as jrw

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-6


def _close(got, want, rtol=GRAD_RTOL, atol_frac=GRAD_ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol_frac * float(np.abs(want).max()))


def _jax_generic(it, T_, rows, data_rows, params, consts):
    """The row function of tests/test_rowwise.py::test_stream_matches_per_row."""
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


def _jax_plane(it, T_, rows, data_rows, params, consts):
    """The row function of tests/test_rowwise.py::test_stream_2d_planes_hist1."""
    ((cur, prev),) = rows
    (c0,) = consts
    r = (cur - prev) + 0.1 * (jnp.roll(cur, -1, 0) - jnp.roll(cur, 1, 1))
    return (jnp.where(it == 0, cur - c0, r),)


def _torch_plane(it, T_, rows, data_rows, params, consts):
    ((cur, prev),) = rows
    (c0,) = consts
    r = (cur - prev) + 0.1 * (torch.roll(cur, -1, -2) - torch.roll(cur, 1, -1))
    return (torch.where(it == 0, cur - c0, r),)


def _case(kind):
    """(jax row_fn, torch row model, nterms, hist, weights, numpy (fields,
    params, data, consts))."""
    if kind == "1d_hist2":
        T, N = 8, 16
        rng = np.random.default_rng(21)
        fields = [rng.normal(size=(T, N)).astype(np.float32) for _ in range(2)]
        data = [np.random.default_rng(22).integers(0, 2, (T, N)).astype(np.float32)]
        params = [(np.random.default_rng(23).normal(size=(3,)) * 0.3).astype(np.float32)]
        return _jax_generic, trw.RowModel(_torch_generic), 2, 2, (1.0, 0.3), (fields, params, data, [])
    if kind == "3d_hist1":
        rng = np.random.default_rng(24)
        fields = [rng.normal(size=(6, 8, 8)).astype(np.float32)]
        return _jax_plane, trw.RowModel(_torch_plane), 1, 1, (1.0,), (fields, [], [], [rng.normal(size=(8, 8)).astype(
            np.float32)])
    T, X, Y = 9, 16, 16
    step, k = (1.0 / 8, 1.0 / X, 1.0 / Y), dict(kimp=10.0, kxreg=0.01, ktreg=1.0)
    rng = np.random.default_rng(25)
    jfn = jvt._make_row_fn(ModJax(), *step, k["kimp"], k["kxreg"], k["ktreg"])
    model = trw.RowModel(tvt._make_row_fn(*step, **k), tvt._make_row_vjp(*step, **k))
    fields = [(0.3 * rng.normal(size=(T, X, Y))).astype(np.float32) for _ in range(3)]
    consts = [rng.normal(size=(X, Y)).astype(np.float32) for _ in range(2)]
    return jfn, model, 6, 1, (1.0, 0.5, 2.0, 1.0, 0.3, 0.7), (fields, [], [], consts)


@pytest.mark.parametrize("kind", ["1d_hist2", "3d_hist1", "veltracer"])
def test_stream_terms_and_grads_match_jax_stream_kernels(kind):
    jfn, model, nterms, hist, w, (fields, params, data, consts) = _case(kind)

    def jloss(fs, ps):
        terms = jrw.rowwise_loss_terms(
            jfn, fs, params=ps, data=[jnp.asarray(d) for d in data], consts=[jnp.asarray(c) for c in consts],
            nterms=nterms, hist=hist, interpret=True, stream=True,
        )
        return sum(a * t for a, t in zip(w, terms)), terms

    (jl, jterms), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(f) for f in fields], [jnp.asarray(p) for p in params]
    )
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in fields + params]
    terms = trw.rowwise_loss_terms(
        model, leaves[: len(fields)], params=leaves[len(fields) :], data=[torch.as_tensor(d) for d in data],
        consts=[torch.as_tensor(c) for c in consts], nterms=nterms, hist=hist, stream=True,
    )
    loss = sum(a * t for a, t in zip(w, terms))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=LOSS_RTOL)
    for a, b in zip(grads, list(jg[0]) + list(jg[1])):
        _close(a.numpy(), b)


def test_stream_sums_match_jax_and_the_ordinary_route():
    """``rowwise_loss_sums(stream=True)`` gives the JAX stream kernel's sums
    and the ordinary route's."""
    jfn, model, nterms, hist, _, (fields, params, data, consts) = _case("1d_hist2")
    kw = dict(params=params, data=data, nterms=nterms, hist=hist)
    js = jrw.rowwise_loss_sums(jfn, [jnp.asarray(f) for f in fields], interpret=True, stream=True,
                               **{k: [jnp.asarray(a) for a in v] if isinstance(v, list) else v for k, v in kw.items()})
    tt = {k: [torch.as_tensor(a) for a in v] if isinstance(v, list) else v for k, v in kw.items()}
    ts = trw.rowwise_loss_sums(model, [torch.as_tensor(f) for f in fields], stream=True, **tt)
    to = trw.rowwise_loss_sums(model, [torch.as_tensor(f) for f in fields], **tt)
    for a, b, c in zip(ts, js, to):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)
        assert float(a) == float(c)


def test_stream_hist0_takes_the_ordinary_route(monkeypatch):
    """stream=True with hist=0 runs the ordinary kernels, as
    ``odil_tpu/ops/rowwise.py:992`` does; hist >= 1 streams."""
    seen = []
    forward = trw._forward
    monkeypatch.setattr(trw, "_forward", lambda *a: seen.append(a[7]) or forward(*a))
    rng = np.random.default_rng(3)
    u = rng.normal(size=(8, 16)).astype(np.float32)

    def jfn(it, T_, rows, data_rows, params, consts):
        return (rows[0][0] - 0.5 * jnp.roll(rows[0][0], 1),)

    def tfn(it, T_, rows, data_rows, params, consts):
        return (rows[0][0] - 0.5 * torch.roll(rows[0][0], 1, -1),)

    (jt,) = jrw.rowwise_loss_terms(jfn, [jnp.asarray(u)], nterms=1, hist=0, interpret=True, stream=True)
    (tt,) = trw.rowwise_loss_terms(trw.RowModel(tfn), [torch.as_tensor(u)], nterms=1, hist=0, stream=True)
    np.testing.assert_allclose(float(tt), float(jt), rtol=LOSS_RTOL)
    trw.rowwise_loss_terms(trw.RowModel(tfn), [torch.as_tensor(u)], nterms=1, hist=1, stream=True)
    assert seen == [False, True]


def _streaming(monkeypatch):
    """Every ``ctx.rowwise_terms`` call of both packages streams (the JAX
    package's in interpret mode, where it reaches the stream kernels)."""
    jorig, torig = jctx.Context.rowwise_terms, tctx.Context.rowwise_terms
    monkeypatch.setattr(jctx.Context, "rowwise_terms",
                        lambda self, *a, **k: jorig(self, *a, **dict(k, stream=True, interpret=True)))
    monkeypatch.setattr(tctx.Context, "rowwise_terms", lambda self, *a, **k: torig(self, *a, **dict(k, stream=True)))


MODELS = {
    "wave": (jwv, twv, dict(nt=16, nx=16)),
    "heat": (jht, tht, dict(nt=16, nx=16, infer_k=True, imposed="random", nimp=20, kxreg=0.01, ktreg=0.01)),
    "heat_lane": (jht, tht, dict(nt=32, nx=32, infer_k=True, imposed="stripe", nimp=50)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_streaming_operator_matches_jax(name, monkeypatch):
    """The wave and heat operators with their kernel calls streaming: the
    loss and its gradients (autograd in the port, jax.grad in the JAX
    package) at a seeded random state; make_loss_grad_fn declines in both
    packages, so training takes autograd of the loss (one stream forward and
    one stream backward a step)."""
    jm, tm, kw = MODELS[name]
    _streaming(monkeypatch)
    jp, js, _ = jm.build(kernel="pallas", dtype=np.float32, **kw)
    tp, ts, _ = tm.build(kernel="pallas", dtype=np.float32, device="cpu", **kw)
    assert jp.make_loss_grad_fn(js) is None and tp.make_loss_grad_fn(ts) is None
    rng = np.random.default_rng(7)
    arrays = [(0.3 * rng.normal(size=np.shape(a))).astype(np.float32) for a in jp.domain.arrays_from_state(js)]
    jloss, _ = jp.make_loss_fn(js)
    (jl, (jterms, _)), jg = jax.value_and_grad(jloss, has_aux=True)([jnp.asarray(a) for a in arrays], jp.tracers)
    tloss, _ = tp.make_loss_fn(ts)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    tl, (tterms, _) = tloss(x, tp.tracers)
    tg = torch.autograd.grad(tl, x)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    for a, b in zip(tterms, jterms):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=LOSS_RTOL)
    for a, b in zip(tg, jg):
        _close(a.numpy(), b)
