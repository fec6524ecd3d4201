"""The kernel-ablation tool's variants of the mg walk.

Counterparts of the variants of ``benchmarks/kernel_ablation.py`` that
change the fused mg kernel (``csrc/rowwise_mg.cu``, the depth-1 whole-plane
backward with the sums): each is a build of that source with the macro
``ODIL_MG_ABLATION`` (``_build.load(name, variant, defines)``), a library
of its own beside the one every path loads.

  trivial-row: the row model's arithmetic left out -- the JAX tool's
      trivial row function (``trivial_row_fn``: the sum of every input plane
      and const, times ``0.1 * (k + 1)`` for each of the six terms) in place
      of the veltracer row, its adjoint exact (the terms are linear);
  no-matmul:   the in-kernel 2-tap prolongation and its transpose left out
      -- as the JAX tool's stubs of ``_up2d``/``_down2d``, a fine row takes
      the t-blended coarse row tiled to the fine shape (cell (x, y) takes
      coarse (x mod CX, y mod CY)) and dP is the t-blended fine cotangent
      sliced to the coarse shape (cells x < CX, y < CY).

Both compute another function than the loss (as the JAX tool's variants
do): each kernel is held to its own plain version here, never to the real
loss.  ``ablated(variant)`` swaps ``rowwise_mg._backward_mg`` for the
variant's dispatcher, so that the one-pass route of ``Problem`` runs it: a
CUDA tensor launches the variant's kernel, a CPU tensor runs its plain
version.
"""

import contextlib

import torch

from . import _build
from . import rowwise_mg as rmg
from .rowwise import RowModel, _backward_plain, _contig

__all__ = ["ABLATIONS", "ablated", "backward_no_matmul_cuda", "backward_trivial_row_cuda", "trivial_row_fn"]

# The values of ODIL_MG_ABLATION in csrc/rowwise_mg.cu.
ABLATIONS = {"trivial-row": 1, "no-matmul": 2}
NTERMS = 6  # the terms of the trivial row


def trivial_row_fn(it, T, rows, data_rows, params, consts):
    """The JAX tool's trivial row function (``kernel_ablation.py:254-261``)
    on row stacks: every input row and const summed in order, times
    ``0.1 * (k + 1)`` for each of the six terms."""
    s = None
    for r in rows:
        for p in r:
            s = p if s is None else s + p
    for c in consts:
        s = s + c
    return tuple(s * (0.1 * (k + 1)) for k in range(NTERMS))


_TRIVIAL = RowModel(trivial_row_fn)  # autograd for the adjoint


def _backward_trivial_row_plain(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums):
    """Plain version of the trivial-row kernel: ``_backward_mg_plain`` with
    the trivial row (``model`` only carries the kernel's scalars)."""
    return rmg._backward_mg_plain(_TRIVIAL, nterms, hist, f0s, t0s, coarse, consts, g, with_sums)


def _blend_rows(P, T):
    """The t-blended coarse rows of fine rows 0..T-1: (1 - w) P[r//2] + w
    P[r//2 + 1], w = 0.5 on odd rows."""
    r = torch.arange(T, device=P.device)
    w = (0.5 * (r % 2).to(P.dtype)).view(-1, 1, 1)
    return (1.0 - w) * P[r // 2] + w * P[torch.clamp(r // 2 + 1, max=P.shape[0] - 1)]


def _tiled_fine(t0, P, f0):
    """f0 * t0 + the blended coarse rows tiled to the fine shape (the JAX
    tool's ``up2d_nomm``)."""
    T, X, Y = t0.shape
    c = _blend_rows(P, T)
    reps = (1, -(-X // c.shape[1]), -(-Y // c.shape[2]))
    return f0 * t0 + c.repeat(reps)[:, :X, :Y]


def _sliced_down(dfine, Tc, CX, CY):
    """The t-blended fine cotangent (``rowwise_mg._down_rows``' blend)
    sliced to the coarse shape (the JAX tool's ``down2d_nomm``)."""
    d = dfine[0::2].clone()
    odd = 0.5 * dfine[1::2]
    d[1:] = odd + d[1:]
    d[:-1] = d[:-1] + odd
    assert d.shape[0] == Tc
    return d[:, :CX, :CY] * 1.0


def _backward_no_matmul_plain(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums):
    """Plain version of the no-matmul kernel: (dt0, dP, sums or None) of the
    row model on the fine rows ``_tiled_fine`` rebuilds, dP sliced."""
    with torch.no_grad():
        fines = [_tiled_fine(t, c, f) for t, c, f in zip(t0s, coarse, f0s)]
    dfines, _, sums = _backward_plain(model, nterms, hist, fines, (), (), consts, g, with_sums)
    Tc, CX, CY = coarse[0].shape
    with torch.no_grad():
        dt0 = tuple(f * d for f, d in zip(f0s, dfines))
        dP = tuple(_sliced_down(d, Tc, CX, CY) for d in dfines)
    return dt0, dP, sums


def _library(variant):
    return rmg._typed(_build.load("rowwise_mg", variant, (("ODIL_MG_ABLATION", ABLATIONS[variant]),)))


def backward_trivial_row_cuda(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums):
    """The trivial-row build of the mg backward: (dt0, dP, sums or None), on
    the current stream.  ``model``: the veltracer model whose kernel scalars
    the launch carries (the trivial row reads none of them)."""
    if nterms != NTERMS:
        raise ValueError(f"the trivial row has {NTERMS} terms, got nterms={nterms}")
    out = rmg._launch_backward(_library("trivial-row"), model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums)
    backward_trivial_row_cuda.launches += 1
    return out


backward_trivial_row_cuda.launches = 0


def backward_no_matmul_cuda(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums):
    """The no-matmul build of the mg backward: (dt0, dP, sums or None), on
    the current stream."""
    out = rmg._launch_backward(_library("no-matmul"), model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums)
    backward_no_matmul_cuda.launches += 1
    return out


backward_no_matmul_cuda.launches = 0

_VARIANTS = {
    "trivial-row": (backward_trivial_row_cuda, _backward_trivial_row_plain),
    "no-matmul": (backward_no_matmul_cuda, _backward_no_matmul_plain),
}


def backward(variant, model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums=False):
    """``rowwise_mg._backward_mg`` of ``variant``: its kernel on CUDA tensors,
    its plain version on CPU tensors."""
    kernel, plain = _VARIANTS[variant]
    if t0s[0].is_cuda:
        return kernel(model, nterms, hist, f0s, _contig(t0s), _contig(coarse), _contig(consts), g, with_sums)
    return plain(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums)


@contextlib.contextmanager
def ablated(variant):
    """Within the block, the mg one-pass route (``rowwise_mg._backward_mg``)
    runs ``variant``."""
    saved = rmg._backward_mg
    rmg._backward_mg = lambda *args, **kw: backward(variant, *args, **kw)
    try:
        yield
    finally:
        rmg._backward_mg = saved
