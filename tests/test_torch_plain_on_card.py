"""Row models without a CUDA counterpart on the card: the route is chosen
from the model's declaration (``cuda_model``), never from an exception.  A
model that names none runs its plain version on the card's tensors through
``rowwise.plain_on_card`` (its own launch counter); a model that names one
launches that kernel.  On the CPU a tensor subclass that reports
``is_cuda`` stands for a card tensor, and the CUDA wrappers are replaced by
recorders.  Heat with ``keep_init=0`` and with a [1, 8, 1] conductivity net
declares the heat CUDA model with its hand adjoint (every heat
configuration does), and its loss and gradients on the CPU route equal the
JAX package's (fp32 terms rtol 1e-5, gradients rtol 1e-4 with atol 1e-6 *
max|ref|)."""

import argparse
import os
import sys
import types

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
from odil_torch.ops import rowwise as trw  # noqa: E402
from odil_torch.ops import rowwise_mg as trmg  # noqa: E402


class _CardLike(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: what the dispatchers read."""

    @property
    def is_cuda(self):
        return True


def _card(ts):
    return tuple(t.as_subclass(_CardLike) for t in ts)


def _row_fn(it, T, rows, data_rows, params, consts):
    (u, um), (v, vm) = rows
    return (u - um + v * consts[0], (v - vm) * 2.0 + torch.roll(u, 1, -1))


def _record(monkeypatch, module, names):
    calls = []
    for name in names:
        monkeypatch.setattr(module, name, lambda *a, name=name: calls.append(name) or name)
    return calls


@pytest.mark.parametrize("cuda_model", [None, "veltracer", "heat", "wave"])
@pytest.mark.parametrize("on_card", [True, False])
def test_route_follows_the_declaration(cuda_model, on_card):
    model = trw.RowModel(_row_fn, cuda_model=cuda_model)
    tensor = types.SimpleNamespace(is_cuda=on_card)
    assert trw._kernel_route(model, tensor) == (on_card and cuda_model is not None)


def test_model_without_cuda_counterpart_runs_plain_on_card(monkeypatch):
    """Forward, backward and the one-pass call of a user row function on
    card tensors: the plain versions, counted by plain_on_card, no kernel
    wrapper reached; the CPU route's numbers."""
    calls = _record(monkeypatch, trw, ["forward_cuda", "backward_cuda", "forward_stream_cuda", "backward_stream_cuda",
                                       "forward_halo_cuda", "backward_halo_cuda"])
    rng = np.random.default_rng(4)
    mk = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
    fields = (mk(6, 5, 4), mk(6, 5, 4))
    consts = (mk(5, 4),)
    model = trw.RowModel(_row_fn)
    g = torch.tensor([0.3, 0.7])
    before = trw.plain_on_card.launches
    card = trw._forward(model, 2, 1, _card(fields), (), (), consts)
    cpu = trw._forward(model, 2, 1, fields, (), (), consts)
    assert torch.equal(card.as_subclass(torch.Tensor), cpu)
    for stream in (False, True):
        kd, _, ks = trw._backward(model, 2, 1, _card(fields), (), (), consts, g, True, stream)
        pd, _, ps = trw._backward(model, 2, 1, fields, (), (), consts, g, True, stream)
        for a, b in zip(kd + (ks,), pd + (ps,)):
            assert torch.equal(a.as_subclass(torch.Tensor), b)
    sums, _, _ = trw.rowwise_loss_and_grads(model, _card(fields), consts=consts, nterms=2)
    assert trw.plain_on_card.launches == before + 4
    assert calls == []
    assert torch.equal(sums.as_subclass(torch.Tensor), trw.rowwise_loss_and_grads(model, fields, consts=consts,
                                                                                  nterms=2)[0])


def test_model_naming_a_kernel_never_takes_plain_on_card(monkeypatch):
    """A model that names a CUDA counterpart reaches its wrapper on card
    tensors (which raises where the kernel does not take the call); the
    plain route's counter does not move."""
    calls = _record(monkeypatch, trw, ["forward_cuda", "backward_cuda"])
    mg_calls = _record(monkeypatch, trmg, ["forward_mg_cuda", "backward_mg_cuda"])
    fields = _card(tuple(torch.zeros(5, 4, 4) for _ in range(3)))
    model = trw.RowModel(_row_fn, cuda_model="veltracer")
    before = trw.plain_on_card.launches
    assert trw._forward(model, 2, 1, fields, (), (), ()) == "forward_cuda"
    assert trw._backward(model, 2, 1, fields, (), (), (), torch.ones(2), True) == "backward_cuda"
    coarse = _card(tuple(torch.zeros(3, 2, 2) for _ in range(3)))
    assert trmg._forward_mg(model, 2, 1, (1.0,) * 3, fields, coarse, ()) == "forward_mg_cuda"
    assert trmg._backward_mg(model, 2, 1, (1.0,) * 3, fields, coarse, (), torch.ones(2)) == "backward_mg_cuda"
    assert (calls, mg_calls) == (["forward_cuda", "backward_cuda"], ["forward_mg_cuda", "backward_mg_cuda"])
    assert trw.plain_on_card.launches == before
    monkeypatch.undo()
    consts = _card((torch.zeros(4, 4), torch.zeros(4, 4)))
    with pytest.raises(RuntimeError, match="nvcc"):  # a kernel that cannot build raises: no fallback
        trw._forward(model, 6, 1, fields, (), (), consts)
    assert trw.plain_on_card.launches == before


def test_mg_model_without_cuda_counterpart_runs_plain_on_card():
    """The mg dispatchers take the same rule: a user row function on card
    tensors runs the plain mg backward, counted."""
    rng = np.random.default_rng(6)
    t0s = tuple(torch.as_tensor(rng.normal(size=(5, 4, 4))) for _ in range(2))
    coarse = tuple(torch.as_tensor(rng.normal(size=(3, 2, 2))) for _ in range(2))
    consts = (torch.as_tensor(rng.normal(size=(4, 4))),)
    model = trmg.RowModel(_row_fn)
    g = torch.tensor([0.3, 0.7], dtype=torch.float64)
    before = trw.plain_on_card.launches
    k = trmg._backward_mg(model, 2, 1, (0.5, 2.0), _card(t0s), _card(coarse), consts, g, True)
    p = trmg._backward_mg(model, 2, 1, (0.5, 2.0), t0s, coarse, consts, g, True)
    assert trw.plain_on_card.launches == before + 1
    for a, b in zip(k[0] + k[1] + (k[2],), p[0] + p[1] + (p[2],)):
        assert torch.equal(a.as_subclass(torch.Tensor), b)


# -- heat outside its default configuration, against the JAX package -----------


def _args(**kw):
    a = dict(infer_k=True, imposed="random", nimp=20, noise=0.0, seed=1000, kimp=2.0, kxreg=0.3, kxregdecay=5,
             ktreg=0.2, ktregdecay=3, kwreg=0.0, kwregdecay=4, kmax=0.1, keep_frozen=1, keep_init=1, solver="odil")
    a.update(kw)
    return argparse.Namespace(**a)


HEAT_CASES = {"keep_init_0": (dict(keep_init=0), (5, 5)), "net_1_8_1": (dict(), (8,))}


@pytest.mark.parametrize("case", list(HEAT_CASES))
def test_heat_without_cuda_model_matches_jax(case):
    """Heat with keep_init=0 and with a [1, 8, 1] net: the row model names
    the heat kernel and carries the hand adjoint; its one-pass route on the
    CPU against the JAX package's in interpret mode."""
    from odil_tpu.models import heat as jh

    kw, arch = HEAT_CASES[case]
    args = _args(**kw)
    size = dict(nt=8, nx=8, dtype=np.float32, kernel="pallas", arch_k=arch, args=args)
    jp, js, _ = jh.build(**size)
    tp, ts, te = th.build(device="cpu", **size)
    model, _, params = th._row_model(Context(tp.domain, ts, extra=te, tracers={"epoch": 2}))
    assert model.cuda_model == "heat" and model.row_vjp is not None
    assert [tuple(p.shape) for p in params[: len(arch) + 1]] == [
        (o, i) for i, o in zip((1,) + arch, arch + (1,))
    ]
    rng = np.random.default_rng(9)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(np.float32) for a in jp.domain.arrays_from_state(js)]
    jp.tracers["epoch"] = tp.tracers["epoch"] = 2
    fn = jp.make_loss_grad_fn(js, interpret=True)
    (jl, (jterms, _)), jg = jax.jit(fn)([jnp.asarray(a) for a in arrays], jp.tracers)
    tfn = tp.make_loss_grad_fn(ts)
    assert tfn is not None
    (loss, (terms, _)), grads = tfn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert len(terms) == len(jterms) and len(grads) == len(jg)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-30)
    for a, b in zip(grads, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(b).max())))
