"""The port's two-level multigrid fusion (``partial_depth=2``) on the CPU
against the JAX package: the depth-2 partial tuples of
``Problem._flatten_multigrid_batched``, the level-1 rebuilds, the plain
version of the ``lvl2`` backward (``_backward_mg`` with ``lvl2``, in
interpret mode on the JAX side) with the split of its dP1 output, and the
one-pass training step with the veltracer hook ``partial_depth`` set to 2
(as tests/test_rowwise.py:737-800 reaches it), against the JAX package's
forced depth-2 step and the port's own autograd.  The CUDA kernel is held to
the plain version in test_torch_gpu.py.

Tolerances: fp64 rtol 1e-10; fp32 loss rtol 1e-6, gradients rtol 1e-5 with
atol 1e-6 * max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.convert import arrays_from_numpy
from odil_torch.models import veltracer as tvt
from odil_torch.ops import rowwise_mg as trmg
from odil_tpu.backend import ModJax
from odil_tpu.models import veltracer as jvt
from odil_tpu.ops import rowwise_mg as jrmg
from odil_tpu.transfer import _interp_matrix

SIZE = dict(nt=8, nx=16, ny=16)
T, X, Y = 9, 16, 16
F0, F1 = (0.7, 1.1, 0.9), (1.3, 0.6, 0.8)
K = dict(kimp=10.0, kxreg=0.01, ktreg=1.0)


def _close(got, want, rtol, atol_frac=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol_frac * float(np.abs(want).max()))


def _pair(dtype, seed=0, **kw):
    jp, js, _ = jvt.build(kernel="pallas_mg", dtype=dtype, **SIZE, **kw)
    tp, ts, _ = tvt.build(kernel="pallas_mg", dtype=dtype, device="cpu", **SIZE, **kw)
    rng = np.random.default_rng(seed)
    arrays = [(0.1 * rng.normal(size=np.shape(a))).astype(dtype) for a in jp.domain.arrays_from_state(js)]
    return (jp, js), (tp, ts), arrays


def test_partial_tuples_match_jax():
    (jp, js), (tp, ts), arrays = _pair(np.float64)
    jp._capture_structure(js)
    tp._capture_structure(ts)
    jprobe, tprobe = {}, {}
    jp._flatten_multigrid_batched(jp.state_from_arrays([jnp.asarray(a) for a in arrays]), partial_out=jprobe,
                                  partial_depth=2)
    tp._flatten_multigrid_batched(tp.state_from_arrays(arrays_from_numpy(arrays, device="cpu")), partial_out=tprobe,
                                  partial_depth=2)
    assert sorted(jprobe) == sorted(tprobe) == ["u", "vx", "vy"]
    for k in jprobe:
        assert len(tprobe[k]) == len(jprobe[k]) == 5
        t0, f0, t1, f1, P2 = tprobe[k]
        assert (f0, f1) == (jprobe[k][1], jprobe[k][3])
        assert t0.shape[0] == 2 * (t1.shape[0] - 1) + 1 and t1.shape[0] == 2 * (P2.shape[0] - 1) + 1
        for a, b in zip((t0, t1, P2), jprobe[k][0::2]):
            _close(a.numpy(), b, 1e-10)


def _lvl2_inputs(dtype, seed=11):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: (0.3 * rng.normal(size=shape)).astype(dtype)
    t0s = [mk(T, X, Y) for _ in range(3)]
    t1s = [mk(T // 2 + 1, X // 2, Y // 2) for _ in range(3)]
    P2 = [mk(T // 4 + 1, X // 4, Y // 4) for _ in range(3)]
    consts = [rng.normal(size=(X, Y)).astype(dtype) for _ in range(2)]
    return t0s, t1s, P2, consts


def _models():
    step = (1.0 / 8, 1.0 / X, 1.0 / Y)
    jfn = jvt._make_row_fn(ModJax(), *step, K["kimp"], K["kxreg"], K["ktreg"])
    return jfn, trmg.RowModel(tvt._make_row_fn(*step, **K), tvt._make_row_vjp(*step, **K))


def test_recon_rows_match_jax():
    t0s, t1s, P2, _ = _lvl2_inputs(np.float64)
    W = {n: _interp_matrix(n, "c", np.float64) for n in (X // 2, X // 4)}
    jW = {n: jnp.asarray(w) for n, w in W.items()}
    tW = {n: torch.as_tensor(w) for n, w in W.items()}
    jt1, jP2, jt0 = jnp.asarray(t1s[0]), jnp.asarray(P2[0]), jnp.asarray(t0s[0])
    want = jrmg._recon_p1_xla(jt1, jP2, range(T // 2 + 1), jW[X // 4], jW[X // 4], 1.3)
    got = trmg._recon_p1(torch.as_tensor(t1s[0]), torch.as_tensor(P2[0]), range(T // 2 + 1), tW[X // 4], tW[X // 4],
                         1.3)
    _close(got.numpy(), want, 1e-12)
    want = jrmg._recon_rows_xla_2(jt0, jt1, jP2, range(T), jW[X // 2], jW[X // 2], jW[X // 4], jW[X // 4], 0.7, 1.3)
    got = trmg._recon_rows_2(torch.as_tensor(t0s[0]), torch.as_tensor(t1s[0]), torch.as_tensor(P2[0]), range(T),
                             tW[X // 2], tW[X // 2], tW[X // 4], tW[X // 4], 0.7, 1.3)
    _close(got.numpy(), want, 1e-12)


def test_plain_lvl2_backward_and_split_match_jax():
    """The plain lvl2 backward (dt0, dP1 and the sums, per-term weights)
    against the JAX kernel's outputs, and the whole two-level
    ``rowwise_mg_loss_and_grads`` (the kernel, then the split of dP1 into
    dt1 and dP2) against the JAX package's, at fp64."""
    t0s, t1s, P2, consts = _lvl2_inputs(np.float64)
    jfn, model = _models()
    j = lambda xs: tuple(jnp.asarray(a) for a in xs)
    tt = lambda xs: tuple(torch.as_tensor(a) for a in xs)
    W = {n: jnp.asarray(_interp_matrix(n, "c", np.float64)) for n in (X // 2, X // 4)}
    g = np.linspace(0.5, 1.5, 6) / (T * X * Y)
    jdt0, jdP1, _, jsums = jrmg._backward_mg(
        jfn, 6, 1, F0, True, j(t0s), j(P2), W[X // 2], W[X // 2], (), (), j(consts), jnp.asarray(g),
        with_sums=True, lvl2=(j(t1s), F1, W[X // 4], W[X // 4]),
    )
    dt0, dP1, sums = trmg._backward_mg_plain(model, 6, 1, F0, tt(t0s), tt(P2), tt(consts), torch.as_tensor(g), True,
                                             lvl2=(tt(t1s), F1))
    _close(sums.numpy(), jsums, 1e-10)
    for a, b in zip(dt0 + dP1, jdt0 + jdP1):
        _close(a.numpy(), b, 1e-10, 1e-10)

    # The whole step: the JAX kernel with its epilogue's split against the
    # plain version with _split_dp1 (uniform weights 1/cells).
    jterms, (jd0, jd1, jd2, _) = jrmg.rowwise_mg_loss_and_grads(
        jfn, t0s=j(t0s), coarse=j(P2), factors0=F0, consts=j(consts), nterms=6, hist=1, interpret=True, t1s=j(t1s),
        factors1=F1,
    )
    terms, (d0, d1, d2, dpar) = trmg.rowwise_mg_loss_and_grads(model, tt(t0s), tt(P2), F0, consts=tt(consts),
                                                              nterms=6, hist=1, t1s=tt(t1s), factors1=F1)
    assert dpar == ()
    for a, b in zip(terms, jterms):
        _close(a.numpy(), b, 1e-10)
    for a, b in zip(d0 + d1 + d2, jd0 + jd1 + jd2):
        _close(a.numpy(), b, 1e-10, 1e-10)


def test_default_depth_is_one():
    assert tvt._mg_loss_and_grads.partial_depth is tvt._mg_partial_depth
    assert tvt._mg_partial_depth(((9, 16, 16),) * 3, np.float32) == 1
    assert tvt._mg_partial_depth(((65, 256, 256),) * 3, np.float32) == 1


@pytest.mark.parametrize("mg_nlvl", [None, 2], ids=["depth2", "degrades_at_nlvl2"])
def test_onepass_step_at_depth2_matches_jax_and_autograd(mg_nlvl, monkeypatch):
    """The one-pass step with the hook at 2 against the JAX package's forced
    depth-2 step and against autograd of the port's loss; with two levels
    only, both packages fall back to the depth-1 tuples."""
    monkeypatch.setattr(jvt._mg_loss_and_grads, "partial_depth", lambda *a: 2)
    monkeypatch.setattr(tvt._mg_loss_and_grads, "partial_depth", lambda *a: 2)
    (jp, js), (tp, ts), arrays = _pair(np.float32, seed=13, mg_nlvl=mg_nlvl)
    tp._capture_structure(ts)
    probe = {}
    x0 = arrays_from_numpy(arrays, device="cpu")
    tp._flatten_multigrid_batched(tp.state_from_arrays(x0), partial_out=probe, partial_depth=2)
    assert all(len(v) == (3 if mg_nlvl == 2 else 5) for v in probe.values())
    jlg, tlg = jp.make_loss_grad_fn(js), tp.make_loss_grad_fn(ts)
    assert jlg is not None and tlg is not None
    (jl, (jterms, _)), jg = jlg([jnp.asarray(a) for a in arrays], {"epoch": 0})
    (tl, (tterms, _)), tg = tlg(x0, {"epoch": 0})
    loss_fn, _ = tp.make_loss_fn(ts)
    x = [a.clone().requires_grad_(True) for a in x0]
    al, _ = loss_fn(x, {"epoch": 0})
    ag = torch.autograd.grad(al, x)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tl), float(al.detach()), rtol=1e-6)
    for a, b in zip(tterms, jterms):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    for a, b, c in zip(tg, jg, ag):
        _close(a.numpy(), b, 1e-5, 1e-6)
        _close(a.numpy(), c.numpy(), 1e-5, 1e-6)
