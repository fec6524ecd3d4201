"""Row-wise residual kernels with the finest multigrid Horner step fused in.

PyTorch/CUDA counterpart of ``odil_tpu/ops/rowwise_mg.py``.  The caller
supplies, per field,

  t0:     the level-0 term array (T, X, Y), T odd (node-located t-axis);
  coarse: the level-1 Horner partial P (Tc, X//2, Y//2), T = 2*(Tc-1)+1;

and the kernels rebuild the fine rows

  fine[r] = factor0 * t0[r] + Wx @ blend_t(P[r//2], P[r//2+1]) @ Wy^T

(blend_t: fine[2j] = c[j], fine[2j+1] = (c[j] + c[j+1]) / 2), evaluate the
residual rows of a row model, and return per-term sums of squares and/or
the cotangents (dt0, dP) by linearity of the reconstruction:

  dt0[i] = factor0 * dfine[i]
  dP[c]  = Wx^T @ (dfine[2c] + .5 dfine[2c-1] + .5 dfine[2c+1]) @ Wy

Each entry point dispatches on the device of its tensors: a CUDA tensor
launches the hand-written kernel of ``csrc/rowwise_mg.cu`` (which exists for
row models that carry a CUDA counterpart, and raises otherwise), a CPU
tensor runs the plain PyTorch version beside it.

Row functions and row models are those of ``ops/rowwise.py`` (whole stacks
of rows, plane axes last); the plain versions here rebuild the fine fields
and run the plain versions there.
"""

import ctypes
import functools

import torch

from ..transfer import _interp_matrix
from . import _build
from .rowwise import (
    _MAXTERMS,
    RowModel,
    _as_model,
    _backward_plain,
    _check_cuda_tensors,
    _check_veltracer_model,
    _contig,
    _forward_plain,
    _raise_on,
    _slab,
    _veltracer_scalars,
)

__all__ = ["RowModel", "rowwise_loss_terms_mg", "rowwise_mg_loss_and_grads"]


# -- Shared setup --------------------------------------------------------------


def _prepare_mg(t0s, coarse, factors0, hist):
    """Shared validation of the mg kernels' inputs (the asserts of the JAX
    package's ``_prepare_mg``).  Returns (t0s, coarse, f0s, cells)."""
    t0s = tuple(t0s)
    coarse = tuple(coarse)
    T = t0s[0].shape[0]
    Tc = coarse[0].shape[0]
    assert t0s[0].ndim == 3, "mg-fused kernel supports 3D (t, x, y) fields"
    assert T % 2 == 1 and T == 2 * (Tc - 1) + 1, (T, Tc)
    X, Y = t0s[0].shape[1:]
    CX, CY = coarse[0].shape[1:]
    assert (CX, CY) == (X // 2, Y // 2), (tuple(t0s[0].shape), tuple(coarse[0].shape))
    assert T > 2 * hist, f"time axis T={T} too short for hist={hist} ring"
    return t0s, coarse, tuple(float(f) for f in factors0), T * X * Y


@functools.lru_cache(maxsize=16)
def _interp_matrices(CX, CY, dtype, device):
    """The dense x/y prolongation matrices (Wx, Wy) the plain versions
    contract with (the kernels apply the same 2-tap stencils directly)."""
    mk = lambda n: torch.as_tensor(_interp_matrix(n, "c"), dtype=dtype, device=device)
    return mk(CX), mk(CY)


def _recon_rows(t0, P, rows, Wx, Wy, f0):
    """Fine rows ``rows`` (a sequence of indices) rebuilt from (t0, P), in
    the operation order of ``odil_tpu/ops/rowwise_mg._recon_rows_xla``."""
    Tc = P.shape[0]
    r = torch.as_tensor(list(rows), device=P.device)
    w = (0.5 * (r % 2).to(P.dtype)).view(-1, 1, 1)
    c = (1.0 - w) * P[r // 2] + w * P[torch.clamp(r // 2 + 1, max=Tc - 1)]
    return f0 * t0[r] + torch.matmul(Wx, torch.matmul(c, Wy.T))


def _down_rows(dfine, Wx, Wy, Tc):
    """dP[c] = Wx^T @ (0.5 dfine[2c-1] + dfine[2c] + 0.5 dfine[2c+1]) @ Wy."""
    d = dfine[0::2].clone()
    odd = 0.5 * dfine[1::2]
    d[1:] = odd + d[1:]
    d[:-1] = d[:-1] + odd
    assert d.shape[0] == Tc
    return torch.matmul(Wx.T, torch.matmul(d, Wy))


# -- Plain PyTorch versions ----------------------------------------------------


def _fines(t0s, coarse, f0s):
    """The fine fields rebuilt from (t0s, coarse), and (Wx, Wy)."""
    T = t0s[0].shape[0]
    Wx, Wy = _interp_matrices(*coarse[0].shape[1:], t0s[0].dtype, t0s[0].device)
    return [_recon_rows(t, c, range(T), Wx, Wy, f) for t, c, f in zip(t0s, coarse, f0s)], Wx, Wy


def _forward_mg_plain(model, nterms, hist, f0s, t0s, coarse, consts):
    """Plain version of the forward kernel: (nterms,) sums of squares."""
    fines, _, _ = _fines(t0s, coarse, f0s)
    return _forward_plain(model, nterms, hist, fines, (), (), consts)


def _backward_mg_plain(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums):
    """Plain version of the backward kernel: gradients of sum_k g[k] * S[k]
    w.r.t. (t0s, coarse), and the sums S when ``with_sums``."""
    with torch.no_grad():
        fines, Wx, Wy = _fines(t0s, coarse, f0s)
    dfines, _, sums = _backward_plain(model, nterms, hist, fines, (), (), consts, g, with_sums)
    with torch.no_grad():
        dt0 = tuple(f * d for f, d in zip(f0s, dfines))
        dP = tuple(_down_rows(d, Wx, Wy, coarse[0].shape[0]) for d in dfines)
    return dt0, dP, sums


# -- CUDA kernels --------------------------------------------------------------

class _MgArgs(ctypes.Structure):
    """Mirror of ``struct MgArgs`` in csrc/rowwise_mg.cu."""

    _fields_ = [
        ("t0", ctypes.c_void_p * 3),
        ("P", ctypes.c_void_p * 3),
        ("u_init", ctypes.c_void_p),
        ("u_final", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("dt0", ctypes.c_void_p * 3),
        ("dP", ctypes.c_void_p * 3),
        ("partials", ctypes.c_void_p),
        ("sums", ctypes.c_void_p),
    ] + [(n, ctypes.c_int) for n in ("T", "X", "Y", "Tc", "CX", "CY", "slab", "nterms", "has_x", "has_t")] + [
        ("f0", ctypes.c_float * 3),
        ("inv_f0", ctypes.c_float * 3),
    ] + [
        (n, ctypes.c_float)
        for n in ("inv_dt", "inv_dx", "inv_dy", "inv_dx2", "inv_dy2", "kimp", "kimp_dx", "kxreg", "kt")
    ]


def _library():
    lib = _build.load("rowwise_mg")
    if not getattr(lib, "_odil_typed", False):
        lib.odil_mg_args_size.argtypes = []
        lib.odil_mg_args_size.restype = ctypes.c_int
        lib.odil_mg_num_blocks.argtypes = [ctypes.c_int] * 4
        lib.odil_mg_num_blocks.restype = ctypes.c_int
        lib.odil_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odil_cuda_error_string.restype = ctypes.c_char_p
        lib.odil_mg_forward.argtypes = [ctypes.POINTER(_MgArgs), ctypes.c_void_p]
        lib.odil_mg_forward.restype = ctypes.c_int
        lib.odil_mg_backward.argtypes = [ctypes.POINTER(_MgArgs), ctypes.c_int, ctypes.c_void_p]
        lib.odil_mg_backward.restype = ctypes.c_int
        size = lib.odil_mg_args_size()
        if size != ctypes.sizeof(_MgArgs):
            raise RuntimeError(f"MgArgs layout mismatch: C {size} vs ctypes {ctypes.sizeof(_MgArgs)} bytes")
        lib._odil_typed = True
    return lib


def _check_cuda_inputs(model, t0s, coarse, consts, hist):
    _check_veltracer_model(model, hist)
    if len(t0s) != 3 or len(consts) != 2:
        raise ValueError("the veltracer CUDA kernel takes 3 fields and 2 const planes")
    T, X, Y = t0s[0].shape
    if T % 2 == 0 or T < 3 or X % 2 or Y % 2 or X < 4 or Y < 4:
        raise ValueError(f"the CUDA mg kernels take odd T >= 3 and even X, Y >= 4, got {(T, X, Y)}")
    _check_cuda_tensors(tuple(t0s) + tuple(coarse) + tuple(consts), "mg")
    want = [(T, X, Y)] * 3 + [(T // 2 + 1, X // 2, Y // 2)] * 3 + [(X, Y)] * 2
    got = [tuple(t.shape) for t in tuple(t0s) + tuple(coarse) + tuple(consts)]
    if got != want:
        raise ValueError(f"the CUDA mg kernels take shapes {want}, got {got}")


def _launch_args(model, f0s, t0s, coarse, consts, g, dt0, dP, partials, sums, nterms):
    T, X, Y = t0s[0].shape
    Tc, CX, CY = coarse[0].shape
    ptr = lambda ts: (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts] if ts else [])
    return _MgArgs(
        t0=ptr(t0s), P=ptr(coarse), u_init=consts[0].data_ptr(), u_final=consts[1].data_ptr(),
        g=g.data_ptr() if g is not None else None, dt0=ptr(dt0), dP=ptr(dP),
        partials=partials.data_ptr(), sums=sums.data_ptr(), T=T, X=X, Y=Y, Tc=Tc, CX=CX, CY=CY, slab=_slab(T),
        f0=(ctypes.c_float * 3)(*f0s), inv_f0=(ctypes.c_float * 3)(*[1.0 / f for f in f0s]),
        **_veltracer_scalars(model, nterms),
    )


def _scratch(lib, t0s):
    T, X, Y = t0s[0].shape
    nblocks = lib.odil_mg_num_blocks(T, X, Y, _slab(T))
    dev = t0s[0].device
    partials = torch.empty((nblocks, _MAXTERMS), dtype=torch.float64, device=dev)
    sums = torch.empty((_MAXTERMS,), dtype=torch.float32, device=dev)
    return partials, sums


def forward_mg_cuda(model, nterms, hist, f0s, t0s, coarse, consts):
    """CUDA forward kernel (replaces ``_forward_mg``): (nterms,) sums of
    squares of the residual rows, on the current stream."""
    _check_cuda_inputs(model, t0s, coarse, consts, hist)
    lib = _library()
    partials, sums = _scratch(lib, t0s)
    args = _launch_args(model, f0s, t0s, coarse, consts, None, None, None, partials, sums, nterms)
    err = lib.odil_mg_forward(ctypes.byref(args), torch.cuda.current_stream(t0s[0].device).cuda_stream)
    _raise_on(lib, err, "odil_mg_forward")
    forward_mg_cuda.launches += 1
    return sums[:nterms]


forward_mg_cuda.launches = 0


def backward_mg_cuda(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums):
    """CUDA backward kernel (replaces ``_backward_mg``): (dt0, dP, sums or
    None) for the loss sum_k g[k] * S[k], on the current stream."""
    _check_cuda_inputs(model, t0s, coarse, consts, hist)
    if any(f == 0.0 for f in f0s):
        raise ValueError("the CUDA mg kernel needs nonzero level-0 factors")
    g = g.to(torch.float32).contiguous()
    if not g.is_cuda or g.numel() < nterms:
        raise ValueError("g must hold nterms weights on the card")
    lib = _library()
    partials, sums = _scratch(lib, t0s)
    dt0 = tuple(torch.empty_like(t) for t in t0s)
    dP = tuple(torch.empty_like(c) for c in coarse)
    args = _launch_args(model, f0s, t0s, coarse, consts, g, dt0, dP, partials, sums, nterms)
    err = lib.odil_mg_backward(
        ctypes.byref(args), int(bool(with_sums)), torch.cuda.current_stream(t0s[0].device).cuda_stream
    )
    _raise_on(lib, err, "odil_mg_backward")
    backward_mg_cuda.launches += 1
    return dt0, dP, (sums[:nterms] if with_sums else None)


backward_mg_cuda.launches = 0


# -- Dispatch ------------------------------------------------------------------


def _forward_mg(model, nterms, hist, f0s, t0s, coarse, consts):
    if t0s[0].is_cuda:
        return forward_mg_cuda(model, nterms, hist, f0s, _contig(t0s), _contig(coarse), _contig(consts))
    return _forward_mg_plain(model, nterms, hist, f0s, t0s, coarse, consts)


def _backward_mg(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums=False):
    if t0s[0].is_cuda:
        return backward_mg_cuda(
            model, nterms, hist, f0s, _contig(t0s), _contig(coarse), _contig(consts), g, with_sums
        )
    return _backward_mg_plain(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums)


class _SumsqMG(torch.autograd.Function):
    """Per-term sums of squares with the finest Horner step fused in; the
    backward runs the backward kernel with the sums off."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        model, nterms, hist, f0s, nf = cfg
        t0s, coarse, consts = tensors[:nf], tensors[nf : 2 * nf], tensors[2 * nf :]
        ctx.cfg = cfg
        ctx.save_for_backward(*tensors)
        return _forward_mg(model, nterms, hist, f0s, t0s, coarse, consts)

    @staticmethod
    def backward(ctx, grad_sums):
        model, nterms, hist, f0s, nf = ctx.cfg
        tensors = ctx.saved_tensors
        t0s, coarse, consts = tensors[:nf], tensors[nf : 2 * nf], tensors[2 * nf :]
        dt0, dP, _ = _backward_mg(model, nterms, hist, f0s, t0s, coarse, consts, grad_sums)
        return (None,) + tuple(dt0) + tuple(dP) + (None,) * len(consts)


# -- Entry points --------------------------------------------------------------


def rowwise_mg_loss_and_grads(row_fn, t0s, coarse, factors0, consts=(), nterms=1, hist=1):
    """One-pass fused loss AND gradients for the training step.

    Returns (terms, (dt0, dcoarse, ())) where terms[k] = mean(residual_k^2)
    and the gradients are of ``sum_k terms[k]``.  Not differentiable (it IS
    the gradient); for a differentiable loss use ``rowwise_loss_terms_mg``."""
    model = _as_model(row_fn)
    t0s, coarse, f0s, cells = _prepare_mg(t0s, coarse, factors0, hist)
    g = torch.full((nterms,), 1.0 / cells, dtype=t0s[0].dtype, device=t0s[0].device)
    dt0, dcoarse, sums = _backward_mg(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums=True)
    return tuple((sums / cells).unbind()), (dt0, dcoarse, ())


def rowwise_loss_terms_mg(row_fn, t0s, coarse, factors0, consts=(), nterms=1, hist=1):
    """Mean-squared loss terms with the finest MG Horner step fused in,
    differentiable with respect to ``t0s`` and ``coarse`` by autograd."""
    model = _as_model(row_fn)
    t0s, coarse, f0s, cells = _prepare_mg(t0s, coarse, factors0, hist)
    cfg = (model, nterms, hist, f0s, len(t0s))
    sums = _SumsqMG.apply(cfg, *t0s, *coarse, *consts)
    return tuple((sums / cells).unbind())
