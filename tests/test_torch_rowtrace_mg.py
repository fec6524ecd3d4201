"""A user's row function on the multigrid route (``ops/rowwise_mg.py`` with
the traced walk of ``csrc/mg_rows2d.cuh``; the kernels run only on the
card):

- the mg entry points' ``params`` and ``data`` (the JAX package's groups):
  ``rowwise_mg_loss_and_grads`` and ``rowwise_loss_terms_mg`` (autograd
  through ``_SumsqMG``) on a hist-2, two-field function with a [1, 4, 1]
  net's params, a (T, X, Y) mask and a (T, 1, 1) datum, and the local form
  ``rowwise_mg_local_loss_and_grads`` with a ``halo_model`` of the same
  function, heads of two rows and the block's data, against the JAX
  package's entry points in interpret mode on the same numpy inputs (fp64:
  rtol 1e-10) -- the JAX local entry with the wrapped row function of
  ``odil_tpu/halo.py:873-885`` rebuilt here;
- the veltracer's row function bare on the mg route (autograd of the row
  function) against the hand model's plain route (its hand adjoint), at
  depth 1, depth 2 and on a local block (rtol 1e-12);
- the route: traced calls of every form on (stand-in) card tensors reach
  the mg wrappers and ``plain_on_card`` does not move; each refusal names
  its reason (a read at x+2, float64, odd T, odd X, a narrow plane, depth 2
  off multiples of 4, a local block's odd Y, a block's shared memory) and
  a refused call runs ``plain_on_card`` with it;
- the shared memory that ``rowtrace.mg2d_smem`` reckons against
  ``sizeof(mg2d::Smem)`` through g++, and ``g++ -fsyntax-only`` of a whole
  generated mg unit.
"""

import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.models import veltracer as tvt
from odil_torch.ops import rowtrace as rt
from odil_torch.ops import rowwise as trw
from odil_torch.ops import rowwise_mg as trmg
from odil_tpu.ops import rowwise_mg as jrmg
from odil_tpu.transfer import _interp_matrix
from test_torch_rowtrace import _sources
from test_torch_rowtrace2d import STAND_IN, _net2d

RTOL = 1e-10
T, X, Y = 9, 8, 8
F0 = (0.7, 1.1)

# The stand-in's warp shuffles that the mg walk's dP taps use.
MG_STAND_IN = STAND_IN.replace(
    "template <class T> T __shfl_xor_sync(unsigned, T, int);",
    "template <class T> T __shfl_xor_sync(unsigned, T, int);\ntemplate <class T> T __shfl_up_sync(unsigned, T, "
    "unsigned);\ntemplate <class T> T __shfl_down_sync(unsigned, T, unsigned);")


def _net_inputs(seed, T_=T, X_=X, Y_=Y, heads=False):
    """Seeded numpy inputs of the net case: (t0s, coarse, params, data[,
    heads]) with the coarse window of (T_, X_, Y_)'s level-1 partial."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: 0.3 * rng.normal(size=shape)
    t0s = [mk(T_, X_, Y_) + 0.5 for _ in range(2)]
    coarse = [mk((T_ - 1) // 2 + 1, X // 2, Y // 2) for _ in range(2)]
    params = [mk(4, 1) + 0.2, mk(4), mk(1, 4) + 0.3, mk(1)]
    data = [(rng.random((T_, X_, Y_)) > 0.3).astype(np.float64), 1.0 + mk(T_, 1, 1)]
    out = (t0s, coarse, params, data)
    return out + ([mk(2, X_, Y_) for _ in range(2)],) if heads else out


def _tt(xs):
    return [torch.as_tensor(x) for x in xs]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * max(1.0, float(np.abs(want).max())))


def test_mg_entry_points_take_params_and_data_as_jax():
    """rowwise_mg_loss_and_grads (terms, dt0, dcoarse, dparams) and
    rowwise_loss_terms_mg's autograd through the params against the JAX
    package's entry points in interpret mode."""
    t0s, coarse, params, data = _net_inputs(3)
    jfn, tfn = _net2d(jnp), trw.RowModel(_net2d(torch))
    j = lambda xs: [jnp.asarray(x) for x in xs]
    jterms, (jdt0, jdc, jdp) = jrmg.rowwise_mg_loss_and_grads(
        jfn, j(t0s), j(coarse), F0, params=j(params), data=j(data), nterms=2, hist=2, interpret=True)
    terms, (dt0, dc, dp) = trmg.rowwise_mg_loss_and_grads(tfn, _tt(t0s), _tt(coarse), F0, params=_tt(params),
                                                          data=_tt(data), nterms=2, hist=2)
    assert len(dp) == len(params)
    for a, b in zip(list(terms) + list(dt0) + list(dc) + list(dp), list(jterms) + list(jdt0) + list(jdc) + list(jdp)):
        _close(a.numpy(), b)
    # The differentiable loss: the same terms, and autograd through the
    # forward kernel's plain version and the backward one (sums off).
    leaves = [t.requires_grad_(True) for t in _tt(t0s + coarse + params)]
    lterms = trmg.rowwise_loss_terms_mg(tfn, leaves[:2], leaves[2:4], F0, leaves[4:], _tt(data), nterms=2, hist=2)
    loss = lterms[0] + 0.5 * lterms[1]
    grads = torch.autograd.grad(loss, leaves)
    assert len(lterms) == 2
    for a, b in zip(lterms, jterms):
        _close(a.detach().numpy(), b)
    # d(t0 + 0.5 t1)/d leaves from the one-pass entry at weights 1 and 0.5 (the
    # two terms apart: the net's params reach both through u).
    g = torch.tensor([1.0, 0.5], dtype=torch.float64) / t0s[0].size
    wdt0, wdc, wdp, _ = trmg._backward_mg_plain(tfn, 2, 2, F0, _tt(t0s), _tt(coarse), (), g, False, None, _tt(params),
                                               _tt(data))
    for a, b in zip(grads, list(wdt0) + list(wdc) + list(wdp)):
        _close(a.numpy(), b.numpy(), 1e-12)


def test_mg_local_entry_with_params_and_data_matches_jax():
    """The local form on a block with heads of two rows, a halo_model of the
    net case and the block's data, against the JAX local entry with the
    wrapped row function (the mask as the last const)."""
    Tl, Xe, x0, off, Tg, lo = 9, 6, 3, 8, 17, 1
    t0s, coarse, params, data, heads = _net_inputs(7, Tl, Xe, Y, heads=True)
    mask = np.ones((Xe, Y))
    mask[0] = mask[-1] = 0.0
    jrow = _net2d(jnp)

    def wrapped(it, _T, rows, data_rows, pv, cons):
        res = jrow(it + off, Tg, rows, data_rows, pv, cons[:-1])
        m = cons[-1] * ((it >= lo) & (it < Tl)).astype(jnp.float64)
        return tuple(r * m for r in res)

    j = lambda xs: [jnp.asarray(x) for x in xs]
    Wx = _interp_matrix(X // 2, "c", np.float64)[(x0 + np.arange(Xe)) % X]
    Wy = _interp_matrix(Y // 2, "c", np.float64)
    gscale = 1.0 / (Tg * X * Y)
    jsums, (jdt0, jdP, jdh, jdp) = jrmg.rowwise_mg_local_loss_and_grads(
        wrapped, j(t0s), j(coarse), Wx, Wy, F0, j(heads), params=j(params), data=j(data), consts=(mask,), nterms=2,
        hist=2, gscale=gscale, interpret=True)
    model = trw.halo_model(trw.RowModel(_net2d(torch)), torch.as_tensor(mask), off, Tg, lo, Tl)
    sums, (dt0, dP, dh, dp) = trmg.rowwise_mg_local_loss_and_grads(
        model, _tt(t0s), _tt(coarse), F0, _tt(heads), x0=x0, params=_tt(params), data=_tt(data), nterms=2, hist=2,
        gscale=gscale)
    _close(sums.numpy(), jsums)
    for a, b in zip(list(dt0) + list(dP) + list(dh) + list(dp), list(jdt0) + list(jdP) + list(jdh) + list(jdp)):
        _close(a.numpy(), b)


def _velt_models():
    step, k = (1 / 16, 1 / X, 1 / Y), dict(kimp=10.0, kxreg=0.01, ktreg=1.0)
    fn = tvt._make_row_fn(*step, **k)
    hand = trw.RowModel(fn, tvt._make_row_vjp(*step, **k), cuda_model="veltracer",
                        scalars=dict(dt=step[0], dx=step[1], dy=step[2], **k))
    return trw.RowModel(fn), hand


def _flat(x):
    """The tensors of nested tuples, in order."""
    return [t for y in x for t in _flat(y)] if isinstance(x, (tuple, list)) else [x]


def test_bare_veltracer_on_mg_route_matches_hand_model():
    """The veltracer's row function bare (autograd) against the hand model
    (its hand adjoint) on the mg route's plain versions: depth 1, depth 2
    and a local block."""
    bare, hand = _velt_models()
    rng = np.random.default_rng(11)
    mk = lambda *shape: torch.as_tensor(0.3 * rng.normal(size=shape))
    t0s = [mk(T, X, Y) for _ in range(3)]
    t1s = [mk(T // 2 + 1, X // 2, Y // 2) for _ in range(3)]
    P2 = [mk(T // 4 + 1, X // 4, Y // 4) for _ in range(3)]
    consts = [mk(X, Y), mk(X, Y)]
    f0s, f1s = (0.7, 1.1, 0.9), (0.8, 1.2, 0.6)
    outs = []
    for model in (bare, hand):
        depth1 = trmg.rowwise_mg_loss_and_grads(model, t0s, t1s, f0s, consts=consts, nterms=6)
        depth2 = trmg.rowwise_mg_loss_and_grads(model, t0s, P2, f0s, consts=consts, nterms=6, t1s=t1s, factors1=f1s)
        mask = torch.ones(X, Y, dtype=torch.float64)
        mask[0] = 0.0
        hm = trw.halo_model(model, mask, 4, 2 * T - 1, 1, T)
        local = trmg.rowwise_mg_local_loss_and_grads(hm, t0s, t1s, f0s, [t[:1] for t in t0s], x0=-1, consts=consts,
                                                     nterms=6, gscale=0.01)
        outs.append(_flat((depth1, depth2, local)))
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        _close(a.numpy(), b.numpy(), 1e-12)


class _CardLike(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: what the dispatchers read."""

    @property
    def is_cuda(self):
        return True


def _card(ts):
    return tuple(t.as_subclass(_CardLike) for t in ts)


def _record(monkeypatch, names):
    calls = []
    for name in names:
        monkeypatch.setattr(trmg, name, lambda *a, name=name: calls.append(name) or name)
    return calls


def _velt_call(T_=T, X_=X, Y_=Y, dtype=torch.float32, fn=None):
    model = trw.RowModel(fn) if fn is not None else _velt_models()[0]
    t0s = tuple(torch.zeros((T_, X_, Y_), dtype=dtype) for _ in range(3))
    consts = tuple(torch.zeros((X_, Y_), dtype=dtype) for _ in range(2))
    return model, (6, 1, _card(t0s), (), (), _card(consts))


def test_traced_mg_calls_reach_the_mg_wrappers(monkeypatch):
    """The bare veltracer function and the net case (params, data) on card
    tensors: every mg dispatcher reaches its wrapper, plain_on_card does not
    move, and CPU tensors take the plain route."""
    calls = _record(monkeypatch, ["forward_mg_cuda", "backward_mg_cuda", "backward_mg2_cuda", "backward_mg_local_cuda"])
    before = trw.plain_on_card.launches
    model, (nterms, hist, t0s, ps, ds, consts) = _velt_call()
    coarse = _card(torch.zeros((T // 2 + 1, X // 2, Y // 2)) for _ in range(3))
    P2 = _card(torch.zeros((T // 4 + 1, X // 4, Y // 4)) for _ in range(3))
    g = torch.ones(6)
    f0s = (1.0,) * 3
    assert trmg._forward_mg(model, nterms, hist, f0s, t0s, coarse, consts) == "forward_mg_cuda"
    assert trmg._backward_mg(model, nterms, hist, f0s, t0s, coarse, consts, g, True) == "backward_mg_cuda"
    assert trmg._backward_mg2(model, nterms, hist, f0s, f0s, t0s, coarse, P2, consts, g) == "backward_mg2_cuda"
    hm = trw.halo_model(model, torch.ones(X, Y), 0, T, 0, T)
    heads = _card(torch.zeros((1, X, Y)) for _ in range(3))
    assert trmg._backward_mg_local(hm, nterms, hist, f0s, t0s, coarse, heads, 3, consts, g) == "backward_mg_local_cuda"
    t0n, coarse_n, params, data = (_card(_tt(x)) for x in _net_inputs(1))
    t0n, coarse_n, params, data = (tuple(t.float() for t in x) for x in (t0n, coarse_n, params, data))
    net = trw.RowModel(_net2d(torch))
    assert trmg._backward_mg(net, 2, 2, F0, t0n, coarse_n, (), g[:2], True, params, data) == "backward_mg_cuda"
    assert calls == ["forward_mg_cuda", "backward_mg_cuda", "backward_mg2_cuda", "backward_mg_local_cuda",
                     "backward_mg_cuda"]
    assert trw.plain_on_card.launches == before
    plain = tuple(t.as_subclass(torch.Tensor) for t in t0s)
    assert trmg._mg_kernel(model, (6, 1, plain, (), (), consts)) == (False, None, None)


def _reach2(it, T_, rows, data_rows, params, consts):
    (u, up), _, _ = rows
    return (u - torch.roll(up, 2, -2),) * 6


# name -> (the call's arguments of _velt_call, form, the local form's coarse
# columns, a word of the reason).
REFUSALS = {
    "reach_x2": (dict(fn=_reach2), "whole", None, "reach"),
    "float64": (dict(dtype=torch.float64), "whole", None, "float32"),
    "even_T": (dict(T_=8), "whole", None, "odd T"),
    "odd_X": (dict(X_=9), "whole", None, "even X"),
    "narrow": (dict(Y_=2), "whole", None, "even X, Y >= 4"),
    "lvl2_off_4": (dict(X_=10), "lvl2", None, "multiples of 4"),
    "local_odd_Y": (dict(Y_=9), "local", 4, "even Y"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_mg_refusals_name_their_reason(name):
    kw, form, coarse_x, word = REFUSALS[name]
    model, call = _velt_call(**kw)
    kernel, spec, reason = trmg._mg_kernel(model, call, form, coarse_x)
    assert not kernel and spec is None and word in reason, reason


def test_mg_refusal_of_a_block_past_the_shared_memory():
    """A trace whose walk needs more shared memory than a block may take:
    mg2d_smem past SMEM_LIMIT, reason with the bytes."""
    tr = types.SimpleNamespace(nfields=3, hist=2, nterms=2, nparams=0, nstaged=80)
    reason = trmg._mg_refusal(tr, (T, X, Y), "whole")
    assert reason is not None and "shared memory" in reason and str(rt.SMEM_LIMIT) in reason
    assert trmg._mg_refusal(types.SimpleNamespace(nfields=3, hist=1, nterms=6, nparams=0, nstaged=12), (T, X, Y),
                            "whole") is None


def test_refused_mg_call_runs_plain_on_card_with_its_reason():
    model, (nterms, hist, t0s, _, _, consts) = _velt_call(fn=_reach2)
    coarse = _card(torch.zeros((T // 2 + 1, X // 2, Y // 2)) for _ in range(3))
    before, reasons = trw.plain_on_card.launches, dict(trw.plain_on_card.reasons)
    trmg.rowwise_mg_loss_and_grads(model, t0s, coarse, (1.0,) * 3, consts=consts, nterms=nterms, hist=hist)
    new = {r: n - reasons.get(r, 0) for r, n in trw.plain_on_card.reasons.items() if n != reasons.get(r, 0)}
    assert trw.plain_on_card.launches == before + 1
    assert len(new) == 1 and "reach" in next(iter(new))


def _traces():
    """Traces of the smem check: the veltracer bare (3 fields, hist 1, 12
    staged planes) and the net case (2 fields, hist 2, 13 params)."""
    bare = _velt_models()[0]
    _, (nterms, hist, t0s, _, _, consts) = _velt_call()
    velt = trw._traced(bare, nterms, hist, t0s, (), (), consts)[0].trace
    t0n, _, params, data = (tuple(torch.as_tensor(x, dtype=torch.float32) for x in xs) for xs in _net_inputs(1))
    net = trw._traced(trw.RowModel(_net2d(torch)), 2, 2, t0n, params, data, ())[0].trace
    return {"velt": velt, "net": net}


def test_mg2d_smem_matches_the_walks_struct(tmp_path):
    """rowtrace.mg2d_smem against sizeof(mg2d::Smem<M, GRADS, LVL2>) of the
    generated row models, every form, with and without the gradients."""
    traces = _traces()
    includes = _sources(tmp_path)
    (tmp_path / "inc" / "cuda_runtime.h").write_text(MG_STAND_IN)
    parts, prints = [], []
    for i, tr in enumerate(traces.values()):
        parts.append(f"namespace case{i} {{\n{tr.body}\n}}")
        for grads in ("false", "true"):
            for lvl2 in ("false", "true"):
                prints.append(f'  printf("%zu\\n", sizeof(mg2d::Smem<case{i}::TracedRow, {grads}, {lvl2}>));')
    src = "\n".join(["#include <cstdio>", '#include "mg_rows2d.cuh"', '#include "rows1d_traced.cuh"', *parts,
                     "int main() {", *prints, "}"])
    (tmp_path / "smem.cpp").write_text(src)
    build = subprocess.run(["g++", "-std=c++17", "-O0", "-w", *includes, "-o", str(tmp_path / "smem"),
                            str(tmp_path / "smem.cpp")], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    got = [int(v) for v in subprocess.run([str(tmp_path / "smem")], capture_output=True, text=True).stdout.split()]
    want = [rt.mg2d_smem(tr.nfields, tr.hist, tr.nterms, tr.nparams, tr.nstaged, grads, form)
            for tr in traces.values() for grads in (False, True) for form in ("whole", "lvl2")]
    assert got == want
    assert rt.mg2d_smem(3, 1, 6, 0, 12, True, "local") == rt.mg2d_smem(3, 1, 6, 0, 12, True, "whole")


def test_generated_mg_unit_passes_syntax_check(tmp_path):
    """g++ -fsyntax-only of the net case's whole mg unit (every form's
    launcher instantiated), with the stand-in runtime header."""
    tr = _traces()["net"]
    includes = _sources(tmp_path)
    (tmp_path / "inc" / "cuda_runtime.h").write_text(MG_STAND_IN)
    (tmp_path / "unit.cpp").write_text(tr.mg_source)
    out = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-w", *includes, str(tmp_path / "unit.cpp")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    for name in ("odil_mg2d_forward", "odil_mg2d_backward", "odil_mg2d_backward2", "odil_mg2d_backward_local"):
        assert name in tr.mg_source
