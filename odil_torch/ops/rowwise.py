"""Fused row-wise residual + loss-reduction kernels over whole fields.

PyTorch/CUDA counterpart of ``odil_tpu/ops/rowwise.py``.  A row function
evaluates the residual rows of a (T, *plane) grid from the rows of the
fields at time offsets 0..hist (periodic in t); the kernels sum the squares
of each term over all rows and, in the backward pass, give the gradients of
``sum_k g[k] * S[k]`` with respect to the fields and the params.

Input groups, as in the JAX package:
  fields: tuple of (T, *plane) tensors -- the unknowns; differentiated; the
          row function receives offsets 0..hist with periodic wrap.
  params: tuple of tensors of any shape; differentiated; the same for every
          row.
  data:   tuple of (T, *plane) tensors read at offset 0 only; not
          differentiated.
  consts: tuple of (*plane) or broadcastable tensors; not differentiated.

Row functions take whole stacks of rows: ``row_fn(it, T, rows, data_rows,
params, consts)`` gets ``it`` as an integer tensor broadcastable against the
rows (shape (R, 1, ..., 1)), ``rows[f][m]`` as the (R, *plane) stack of field
f at rows it - m (periodic in t), ``data_rows[d]`` as the stack of data d at
rows it, and returns the tuple of residual stacks; the plane axes are the
last ones, so 1-D planes need no padding.  ``row_vjp(it, T, rows, data_rows,
params, consts, cots)`` returns (flat row cotangents in (field, m) order,
param cotangents summed over the stack).

Each entry point dispatches on the device of its tensors: a CUDA tensor
launches the hand-written kernel of ``csrc/rowwise.cu`` (which exists for row
models that carry a CUDA counterpart, and raises otherwise), a CPU tensor
runs the plain PyTorch version beside it.  64-bit fields take the plain
version on every device, by the JAX package's own rule (Mosaic cannot lower
64-bit kernels, ``odil_tpu/ops/rowwise.py:968-969``): ``rowwise_loss_terms``
differentiates it by autograd and ``rowwise_loss_and_grads`` returns None.
One CUDA design serves every plane size, so ``block_rows`` and ``halox``
select nothing here; the streaming form (``stream=True``) is not ported.
"""

import ctypes

import torch

from . import _build

__all__ = [
    "RowModel",
    "rowwise_loss_terms",
    "rowwise_loss_sums",
    "rowwise_loss_and_grads",
    "onepass_supported",
]


class RowModel:
    """A residual row function with its adjoint and, optionally, the id and
    scalars of its CUDA counterpart (``csrc/veltracer_row.cuh``), shared by
    the generic kernels here and the multigrid-fused ones of rowwise_mg.py.

    row_fn/row_vjp: the plain torch versions (row_vjp may be None: autograd).
    cuda_model: the name of the CUDA row model ("veltracer") or None.
    scalars: the CUDA model's parameters (dt, dx, dy, kimp, kxreg, ktreg)."""

    def __init__(self, row_fn, row_vjp=None, cuda_model=None, scalars=None):
        self.row_fn = row_fn
        self.row_vjp = row_vjp
        self.cuda_model = cuda_model
        self.scalars = dict(scalars or {})


def _as_model(row_fn):
    return row_fn if isinstance(row_fn, RowModel) else RowModel(row_fn)


def _sumsq_vec(res):
    """(nterms,) per-term sums of squares."""
    return torch.stack([torch.sum(r * r) for r in res])


def _weights_of(gvec, res, nterms):
    """w[k] = 2 * g[k] * res[k]: the cotangents of sum_k g[k] * sum(res[k]^2)."""
    return tuple(2.0 * gvec[k] * res[k] for k in range(nterms))


def _row_stacks(fields, hist):
    """rows[f][m] = field f at rows it - m (periodic in t)."""
    return tuple(tuple(torch.roll(f, m, 0) for m in range(hist + 1)) for f in fields)


def _row_index(field):
    """``it`` for a whole (T, *plane) stack: arange(T) shaped (T, 1, ..., 1)."""
    T = field.shape[0]
    return torch.arange(T, device=field.device).view((T,) + (1,) * (field.ndim - 1))


def _model_vjp(model, nterms, it, T, rows, data, params, consts, g):
    """The residual stacks and (flat row cotangents, param cotangents) of
    sum_k g[k] * sum(res[k]^2): ``model.row_vjp`` where the model has one,
    else autograd of ``model.row_fn``."""
    if model.row_vjp is not None:
        with torch.no_grad():
            res = model.row_fn(it, T, rows, data, params, consts)
            dflat, dparams = model.row_vjp(it, T, rows, data, params, consts, _weights_of(g, res, nterms))
        return tuple(res), list(dflat), list(dparams)
    flat = [r.detach().requires_grad_(True) for fr in rows for r in fr]
    pleaves = [p.detach().requires_grad_(True) for p in params]
    nested = tuple(tuple(flat[f * len(fr) + m] for m in range(len(fr))) for f, fr in enumerate(rows))
    with torch.enable_grad():
        res = model.row_fn(it, T, nested, data, tuple(pleaves), consts)
        w = _weights_of(g, res, nterms)
        live = [(r, c) for r, c in zip(res, w) if r.requires_grad]
        leaves = flat + pleaves
        grads = (
            torch.autograd.grad([r for r, _ in live], leaves, [c for _, c in live], allow_unused=True)
            if live
            else [None] * len(leaves)
        )
    grads = [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, grads)]
    return tuple(r.detach() for r in res), grads[: len(flat)], grads[len(flat) :]


# -- Plain PyTorch versions ----------------------------------------------------


def _forward_plain(model, nterms, hist, fields, params, data, consts):
    """Plain version of the forward kernel: (nterms,) sums of squares over
    all T residual rows, evaluated as one stack (``_vmap_rowwise_terms``,
    ``odil_tpu/ops/rowwise.py:873``).  Differentiable by autograd."""
    T = fields[0].shape[0]
    res = model.row_fn(_row_index(fields[0]), T, _row_stacks(fields, hist), tuple(data), tuple(params), tuple(consts))
    assert len(res) == nterms, (len(res), nterms)
    return _sumsq_vec(res)


def _backward_plain(model, nterms, hist, fields, params, data, consts, g, with_sums):
    """Plain version of the backward kernel: (dfields, dparams, sums or None)
    for the loss sum_k g[k] * S[k].  Field row i collects the cotangent of
    its offset-o sample from residual row (i + o) % T; the params collect
    each residual row's cotangent once; data rows are read at offset 0."""
    T = fields[0].shape[0]
    res, dflat, dparams = _model_vjp(
        model, nterms, _row_index(fields[0]), T, _row_stacks(fields, hist), tuple(data), tuple(params),
        tuple(consts), g,
    )
    assert len(res) == nterms, (len(res), nterms)
    with torch.no_grad():
        dfields = []
        for f in range(len(fields)):
            d = dflat[f * (hist + 1)]
            for m in range(1, hist + 1):
                d = d + torch.roll(dflat[f * (hist + 1) + m], -m, 0)
            dfields.append(d)
        sums = _sumsq_vec(res) if with_sums else None
    return tuple(dfields), tuple(dparams), sums


# -- CUDA kernels --------------------------------------------------------------

_MAXTERMS = 6


def _slab(T):
    """Rows per block of the row kernels: about 16, balanced over T."""
    n = -(-T // 16)
    return -(-T // n)


def _veltracer_scalars(model, nterms):
    """The veltracer CUDA row model's flags and reciprocal steps (the fields
    that ``struct RowArgs`` and ``struct MgArgs`` share)."""
    s = model.scalars
    has_x, has_t = bool(s["kxreg"]), bool(s["ktreg"])
    if nterms != 2 + 2 * has_x + 2 * has_t:
        raise ValueError(f"nterms={nterms} does not match the veltracer flags")
    return dict(
        nterms=nterms, has_x=has_x, has_t=has_t,
        inv_dt=1 / s["dt"], inv_dx=1 / s["dx"], inv_dy=1 / s["dy"], inv_dx2=1 / s["dx"] ** 2,
        inv_dy2=1 / s["dy"] ** 2, kimp=s["kimp"], kimp_dx=s["kimp"] / s["dx"], kxreg=s["kxreg"],
        kt=s["ktreg"] / s["dt"],
    )


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.odil_cuda_error_string(err).decode()})")


def _check_veltracer_model(model, hist):
    if model.cuda_model != "veltracer":
        raise NotImplementedError(f"row model {model.cuda_model!r} has no CUDA kernel; only 'veltracer' does")
    if hist != 1:
        raise ValueError("the veltracer CUDA kernels take hist=1")


def _check_cuda_tensors(ts, what):
    for t in ts:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"the CUDA {what} kernels take contiguous float32 CUDA tensors, got {t.dtype} on {t.device}")


class _RowArgs(ctypes.Structure):
    """Mirror of ``struct RowArgs`` in csrc/rowwise.cu."""

    _fields_ = [
        ("f", ctypes.c_void_p * 3),
        ("u_init", ctypes.c_void_p),
        ("u_final", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("df", ctypes.c_void_p * 3),
        ("partials", ctypes.c_void_p),
        ("sums", ctypes.c_void_p),
    ] + [(n, ctypes.c_int) for n in ("T", "X", "Y", "slab", "nterms", "has_x", "has_t")] + [
        (n, ctypes.c_float)
        for n in ("inv_dt", "inv_dx", "inv_dy", "inv_dx2", "inv_dy2", "kimp", "kimp_dx", "kxreg", "kt")
    ]


def _library():
    lib = _build.load("rowwise")
    if not getattr(lib, "_odil_typed", False):
        lib.odil_rows_args_size.argtypes = []
        lib.odil_rows_args_size.restype = ctypes.c_int
        lib.odil_rows_num_blocks.argtypes = [ctypes.c_int] * 4
        lib.odil_rows_num_blocks.restype = ctypes.c_int
        lib.odil_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odil_cuda_error_string.restype = ctypes.c_char_p
        lib.odil_rows_forward.argtypes = [ctypes.POINTER(_RowArgs), ctypes.c_void_p]
        lib.odil_rows_forward.restype = ctypes.c_int
        lib.odil_rows_backward.argtypes = [ctypes.POINTER(_RowArgs), ctypes.c_int, ctypes.c_void_p]
        lib.odil_rows_backward.restype = ctypes.c_int
        size = lib.odil_rows_args_size()
        if size != ctypes.sizeof(_RowArgs):
            raise RuntimeError(f"RowArgs layout mismatch: C {size} vs ctypes {ctypes.sizeof(_RowArgs)} bytes")
        lib._odil_typed = True
    return lib


def _check_cuda_inputs(model, hist, fields, params, data, consts):
    _check_veltracer_model(model, hist)
    if len(fields) != 3 or len(consts) != 2 or params or data:
        raise ValueError("the veltracer CUDA kernels take 3 fields, 2 const planes, no params and no data")
    _check_cuda_tensors(tuple(fields) + tuple(consts), "row-wise")
    shape = tuple(fields[0].shape)
    if len(shape) != 3 or shape[0] < 2:
        raise ValueError(f"the CUDA row-wise kernels take (T, X, Y) fields with T >= 2, got {shape}")
    want = [shape] * 3 + [shape[1:]] * 2
    got = [tuple(t.shape) for t in tuple(fields) + tuple(consts)]
    if got != want:
        raise ValueError(f"the CUDA row-wise kernels take shapes {want}, got {got}")


def _scratch(lib, fields):
    T, X, Y = fields[0].shape
    dev = fields[0].device
    partials = torch.empty((lib.odil_rows_num_blocks(T, X, Y, _slab(T)), _MAXTERMS), dtype=torch.float64, device=dev)
    return partials, torch.empty((_MAXTERMS,), dtype=torch.float32, device=dev)


def _launch_args(model, nterms, fields, consts, g, dfields, partials, sums):
    T, X, Y = fields[0].shape
    ptr = lambda ts: (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts] if ts else [])
    return _RowArgs(
        f=ptr(fields), u_init=consts[0].data_ptr(), u_final=consts[1].data_ptr(),
        g=g.data_ptr() if g is not None else None, df=ptr(dfields), partials=partials.data_ptr(),
        sums=sums.data_ptr(), T=T, X=X, Y=Y, slab=_slab(T), **_veltracer_scalars(model, nterms),
    )


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_cuda(model, nterms, hist, fields, params, data, consts):
    """CUDA forward kernel (replaces ``_forward``, ``_forward_blocked`` and
    the non-padded ``_forward_tiled``): (nterms,) sums of squares of the
    residual rows, on the current stream."""
    _check_cuda_inputs(model, hist, fields, params, data, consts)
    lib = _library()
    partials, sums = _scratch(lib, fields)
    args = _launch_args(model, nterms, fields, consts, None, None, partials, sums)
    _raise_on(lib, lib.odil_rows_forward(ctypes.byref(args), _stream(fields[0])), "odil_rows_forward")
    forward_cuda.launches += 1
    return sums[:nterms]


forward_cuda.launches = 0


def backward_cuda(model, nterms, hist, fields, params, data, consts, g, with_sums):
    """CUDA backward kernel (replaces ``_backward``, ``_backward_blocked`` and
    the non-padded ``_backward_tiled``): (dfields, (), sums or None) for the
    loss sum_k g[k] * S[k], on the current stream."""
    _check_cuda_inputs(model, hist, fields, params, data, consts)
    g = g.to(torch.float32).contiguous()
    if not g.is_cuda or g.numel() < nterms:
        raise ValueError("g must hold nterms weights on the card")
    lib = _library()
    partials, sums = _scratch(lib, fields)
    dfields = tuple(torch.empty_like(f) for f in fields)
    args = _launch_args(model, nterms, fields, consts, g, dfields, partials, sums)
    err = lib.odil_rows_backward(ctypes.byref(args), int(bool(with_sums)), _stream(fields[0]))
    _raise_on(lib, err, "odil_rows_backward")
    backward_cuda.launches += 1
    return dfields, (), (sums[:nterms] if with_sums else None)


backward_cuda.launches = 0


# -- Dispatch ------------------------------------------------------------------


def _contig(ts):
    return tuple(t.contiguous() for t in ts)


def _forward(model, nterms, hist, fields, params, data, consts):
    if fields[0].is_cuda:
        return forward_cuda(model, nterms, hist, _contig(fields), params, data, _contig(consts))
    return _forward_plain(model, nterms, hist, fields, params, data, consts)


def _backward(model, nterms, hist, fields, params, data, consts, g, with_sums=False):
    if fields[0].is_cuda:
        return backward_cuda(model, nterms, hist, _contig(fields), params, data, _contig(consts), g, with_sums)
    return _backward_plain(model, nterms, hist, fields, params, data, consts, g, with_sums)


class _RowwiseSumsq(torch.autograd.Function):
    """Per-term sums of squares (the forward kernel); the backward runs the
    backward kernel with the sums off.  data and consts get no gradient
    (``rowwise_sumsq``'s custom_vjp, ``odil_tpu/ops/rowwise.py:852-870``)."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        model, nterms, hist, nf, np_, nd = cfg
        fields, params = tensors[:nf], tensors[nf : nf + np_]
        data, consts = tensors[nf + np_ : nf + np_ + nd], tensors[nf + np_ + nd :]
        ctx.cfg = cfg
        ctx.save_for_backward(*tensors)
        return _forward(model, nterms, hist, fields, params, data, consts)

    @staticmethod
    def backward(ctx, grad_sums):
        model, nterms, hist, nf, np_, nd = ctx.cfg
        tensors = ctx.saved_tensors
        fields, params = tensors[:nf], tensors[nf : nf + np_]
        data, consts = tensors[nf + np_ : nf + np_ + nd], tensors[nf + np_ + nd :]
        dfields, dparams, _ = _backward(model, nterms, hist, fields, params, data, consts, grad_sums)
        return (None,) + tuple(dfields) + tuple(dparams) + (None,) * (len(data) + len(consts))


# -- Entry points --------------------------------------------------------------


def _wide(fields):
    """64-bit fields: the plain route, by the JAX package's rule."""
    return fields[0].element_size() > 4


def _refuse_stream(stream):
    if stream:
        raise NotImplementedError(
            "stream=True: the streaming kernels (_forward_stream/_backward_stream) are not ported yet (ROADMAP §2)"
        )


def rowwise_loss_terms(
    row_fn, fields, params=(), data=(), consts=(), nterms=1, hist=1, block_rows=None, stream=False, halox=None,
    _sums=False,
):
    """Per-term mean-squared losses ``[mean(residual_k**2)]`` over the full
    (T, *plane) grid through the row-wise kernels, differentiable with
    respect to ``fields`` and ``params`` by autograd (the backward kernel with
    the sums off).  ``block_rows`` and ``halox`` are accepted for the JAX
    package's signature: one CUDA design serves every block size and plane
    width, so they change nothing.  64-bit fields take the plain version,
    differentiated by autograd.  ``stream=True`` raises (not ported)."""
    _refuse_stream(stream)
    model = _as_model(row_fn)
    fields, params, data, consts = tuple(fields), tuple(params), tuple(data), tuple(consts)
    denom = 1.0 if _sums else float(fields[0].numel())
    if _wide(fields):
        sums = _forward_plain(model, nterms, hist, fields, params, data, consts)
    else:
        cfg = (model, nterms, hist, len(fields), len(params), len(data))
        sums = _RowwiseSumsq.apply(cfg, *fields, *params, *data, *consts)
    return [sums[k] / denom for k in range(nterms)]


def rowwise_loss_sums(
    row_fn, fields, params=(), data=(), consts=(), nterms=1, hist=1, block_rows=None, stream=False, halox=None
):
    """``rowwise_loss_terms`` returning per-term SUMS of squares instead of
    means."""
    return rowwise_loss_terms(
        row_fn, fields, params=params, data=data, consts=consts, nterms=nterms, hist=hist,
        block_rows=block_rows, stream=stream, halox=halox, _sums=True,
    )


def onepass_supported(fields, params, data, consts, nterms, hist, halox=None):
    """Whether ``rowwise_loss_and_grads`` runs for these inputs: fields of at
    most 32 bits (the build-time gate of Problem's one-pass route)."""
    return not _wide(tuple(fields))


def rowwise_loss_and_grads(
    row_fn, fields, params=(), data=(), consts=(), nterms=1, hist=1, block_rows=None, gscale=None, halox=None
):
    """One-pass fused loss sums AND gradients: the backward kernel with the
    sums on gives the per-term sums of squares and the cotangents of
    ``sum_k gscale * S_k`` (gscale defaults to 1/(T*plane), the mean
    composition every Problem loss uses) -- the training step runs no
    forward kernel.

    Returns (sums, dfields, dparams), or None for 64-bit fields (the JAX
    package's rule), where callers differentiate the usual loss instead.
    data/consts are not differentiated.  ``block_rows`` and ``halox`` change
    nothing (see ``rowwise_loss_terms``).  Not itself differentiable."""
    model = _as_model(row_fn)
    fields, params, data, consts = tuple(fields), tuple(params), tuple(data), tuple(consts)
    if _wide(fields):
        return None
    if gscale is None:
        gscale = 1.0 / fields[0].numel()
    g = torch.full((nterms,), gscale, dtype=fields[0].dtype, device=fields[0].device)
    dfields, dparams, sums = _backward(model, nterms, hist, fields, params, data, consts, g, with_sums=True)
    return sums, dfields, dparams
