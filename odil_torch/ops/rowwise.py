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

Each entry point dispatches on the device of its tensors and on the row
model's declaration: a CUDA tensor of a model that names a CUDA counterpart
(``cuda_model``: veltracer on (T, X, Y) planes, heat and wave on (T, N)
planes) launches the hand-written kernel of ``csrc/rowwise.cu`` (heat with
another conductivity net than [1, 5, 5, 1], or with keep_init or
keep_frozen off: of ``csrc/heat_net.cu``, built for the net's widths), and
raises where that kernel does not take the call.  A model that names none
(``cuda_model is None``: a user row function) on float32 (T, N) planes is
traced (``ops/rowtrace.py``, ``_traced``): its row function becomes a row
model of ``csrc/rows1d.cuh`` with a generated adjoint, built at first use
into a library of its own, and the call launches the same kernels and
counters as heat and wave -- the counterpart of the TPU kernels' tracing of
the row function and their in-kernel ``jax.vjp``.  A trace that is refused
(a reach past x±1, more than 48 params, an operation outside the traced
set; 2-D planes, 64-bit tensors and a per-shard model are not traced) runs
the plain PyTorch version on the card's tensors (``plain_on_card``, its own
launch counter and the reasons, ``plain_on_card.reasons``) -- autograd of
the row function over the row stacks where the model has no ``row_vjp``.  A
CPU tensor runs the plain version.  The route is decided before any build;
no exception selects one, and a failed build or launch raises.  64-bit fields take the plain
version on every device, by the JAX package's own rule (Mosaic cannot lower
64-bit kernels, ``odil_tpu/ops/rowwise.py:968-969``): ``rowwise_loss_terms``
differentiates it by autograd and ``rowwise_loss_and_grads`` returns None.
One CUDA design serves every plane size, so ``block_rows`` and ``halox``
select nothing here.

``stream=True`` with ``hist >= 1`` (``odil_tpu/ops/rowwise.py:992``) takes
the streaming pair (``_forward_stream``/``_backward_stream``).  The TPU
streams (each field row read once, a ring of ``hist`` rows carried across a
sequential grid) to keep VMEM small; a Hopper block's shared memory does not
grow with the rows it covers, and one walk of all T rows cannot fill 132
SMs.  So on the card the streaming pair is the slabbed launch, with slabs
sized to whole waves of the resident blocks (``_wave_slab``, ``_tile_rows``):
each field row is read once per slab, the ``hist`` rows above a slab once
more (``hist/slab`` of the bytes).  ``forward_stream_cuda``/
``backward_stream_cuda`` launch it with launch counters of their own, so
that a run shows which route it took; 1-D planes stay 1-D.  The pair
computes the slabbed pair's function, so its plain versions are
``_forward_plain``/``_backward_plain``.  With ``hist=0`` a streaming call
takes the ordinary kernels, as in the JAX package.

Per-shard (halo) evaluation (``halo.py``): ``halo_model`` wraps a row model
for one shard's halo-extended block -- global row offset, the global T, a 0/1
plane mask zeroing halo columns and a range of the block's own rows -- as the
JAX package's ``_HaloContext.rowwise_terms`` wraps its row function
(``odil_tpu/halo.py:873-885``).  On the card a wrapped veltracer model
launches the masked kernels of ``csrc/rowwise.cu`` (``odil_rows_halo_*``:
``forward_halo_cuda``/``backward_halo_cuda``), the port of the TPU's x-tiled
pair on an edge-padded extent (``_forward_tiled``/``_backward_tiled`` with
``xpad``, ``odil_tpu/ops/rowwise_tiled.py:157-177``).  The CUDA grid is a
ceiling division over its 16x32 tiles with every cell guarded, so it runs on
the unpadded extended extent (130 = 128 + 2 x-rows for the flagship's
``x:2`` shards) and the mask alone does what ``_apply_xpad`` does there:
``xpad_masked`` is accepted and changes nothing.  A wrapped heat or wave
model launches the halo layer of the 1-D tile kernel (``csrc/rows1d.cuh``,
``odil_rows1d_halo_*``: ``forward_halo_rows1d_cuda``/
``backward_halo_rows1d_cuda``), the port of the blocked pair that the JAX
package runs on its wrapped row function for 1-D planes
(``odil_tpu/halo.py:924-936``, whose x-padded form needs 3-D grids).
"""

import collections
import ctypes
import functools

import torch

from . import _build, rowtrace

__all__ = [
    "RowModel",
    "halo_model",
    "rowwise_loss_terms",
    "rowwise_loss_sums",
    "rowwise_loss_and_grads",
    "onepass_supported",
    "plain_on_card",
]


class RowModel:
    """A residual row function with its adjoint and, optionally, the name
    and scalars of its CUDA counterpart, shared by the generic kernels here
    and (veltracer) the multigrid-fused ones of rowwise_mg.py.

    row_fn/row_vjp: the plain torch versions (row_vjp may be None: autograd).
    cuda_model: the name of the CUDA row model or None: "veltracer"
        (``csrc/veltracer_row.cuh``), "heat" (``csrc/heat_row.cuh``) or
        "wave" (``csrc/wave_row.cuh``); each packs its own kernel arguments
        (``_CUDA_MODELS``).
    scalars: the CUDA model's parameters (steps, weights, flags)."""

    def __init__(self, row_fn, row_vjp=None, cuda_model=None, scalars=None):
        self.row_fn = row_fn
        self.row_vjp = row_vjp
        self.cuda_model = cuda_model
        self.scalars = dict(scalars or {})
        self.halo = None  # (mask, off, T, r_lo, r_hi) of a per-shard model (halo_model)


def _as_model(row_fn):
    return row_fn if isinstance(row_fn, RowModel) else RowModel(row_fn)


def halo_model(row_fn, mask, off, T, r_lo, r_hi):
    """``row_fn`` wrapped for one shard's halo-extended block (the wrapped
    row function of ``odil_tpu/halo.py:873-885``): row ``it`` of the block is
    global row ``it + off`` of a grid of ``T`` rows, and every residual is
    multiplied by ``mask`` (a 0/1 plane, zero on halo columns) and by
    ``r_lo <= it < r_hi`` (the block's own rows: halo rows and a ghost node
    owned by the left shard are out).  The adjoint scales the cotangents by
    the same mask.  The result carries ``halo = (mask, off, T, r_lo, r_hi)``
    for the masked CUDA kernels."""
    inner = _as_model(row_fn)

    def row_mask(it):
        return mask * ((it >= r_lo) & (it < r_hi)).to(mask.dtype)

    def wrapped(it, _T, rows, data_rows, params, consts):
        res = inner.row_fn(it + off, T, rows, data_rows, params, consts)
        m = row_mask(it)
        return tuple(r * m for r in res)

    wrapped_vjp = None
    if inner.row_vjp is not None:

        def wrapped_vjp(it, _T, rows, data_rows, params, consts, cots):
            m = row_mask(it)
            return inner.row_vjp(it + off, T, rows, data_rows, params, consts, tuple(c * m for c in cots))

    model = RowModel(wrapped, wrapped_vjp, cuda_model=inner.cuda_model, scalars=inner.scalars)
    model.halo = (mask, int(off), int(T), int(r_lo), int(r_hi))
    model.inner = inner
    return model


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

_MAXTERMS = 6  # the veltracer row model's terms (MAXTERMS of csrc/veltracer_row.cuh)


@functools.lru_cache(maxsize=64)
def _wave_slab(T, tiles, resident, lead):
    """Rows per block of a row walk over T rows and ``tiles`` tiles a slab:
    the slab that runs the launch in the fewest row-times, counting whole
    waves of the ``resident`` blocks the card holds at once and the ``lead``
    rows a block reads (or rebuilds) before its first."""
    best = None
    for nz in range(1, T + 1):
        slab = -(-T // nz)
        if -(-T // slab) != nz:
            continue
        cost = -(-nz * tiles // resident) * (slab + lead)
        if best is None or cost < best[0]:
            best = (cost, slab)
    return best[1]


@functools.lru_cache(maxsize=64)
def _tile_rows(T, N, hist, grads, resident, tile, max_slab, threads, batches=None):
    """(slab, blocks) of a 1-D tile launch (``csrc/rows1d.cuh``) over (T, N):
    tiles of ``slab`` rows by ``tile`` cells, at most ``max_slab`` rows, taken
    by ``blocks`` blocks of ``threads`` threads in rounds.  The slab runs the
    launch in the fewest passes of a block's threads over its residual window
    (``slab + hist`` rows of ``tile + 2`` cells with the gradients, ``slab``
    rows of ``tile`` without), counting whole waves of the ``resident``
    blocks; among equals the fewest tiles (the least recompute).  With
    ``batches`` (the wide heat nets, ``csrc/heat_wide.cuh``: (threads, the
    weight of a face's net, passes a param batch)) a tile costs its rounds
    instead: its window's faces (``tile + 3`` a row with the gradients,
    ``tile + 1`` without) a face a thread, each round the weight of a net
    (2 with its tangent), and with the gradients its owned rows' faces
    (``tile + 1`` a row) in param batches, each twice a net (the net again
    and its adjoint)."""
    tiles_x = -(-N // tile)
    rows, width = (hist, tile + 2) if grads else (0, tile)
    best = None
    for nz in range(1, T + 1):
        slab = -(-T // nz)
        if slab > max_slab or -(-T // slab) != nz:
            continue
        tiles = nz * tiles_x
        if batches:
            nthreads, weight, passes = batches
            per = weight * -(-(slab + rows) * (width + 1) // nthreads)
            per += 2 * -(-slab * (tile + 1) // passes) if grads else 0
        else:
            per = -(-(slab + rows) * width // threads)
        cost = (-(-tiles // resident) * per, tiles)
        if best is None or cost < best[0]:
            best = (cost, slab, tiles)
    _, slab, tiles = best
    return slab, min(tiles, resident)


_TICKETS = {}


def _ticket(dev, stream):
    """The ticket counter of the kernels' sums on the stream (a raw handle)
    of dev: an int32 that every launch leaves at 0, one per stream, since
    launches on one stream run one after another."""
    key = (dev, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _TICKETS[key]


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
        raise NotImplementedError(f"row model {model.cuda_model!r} has no CUDA mg kernel; only 'veltracer' does")
    if hist != 1:
        raise ValueError("the veltracer CUDA kernels take hist=1")


def _check_cuda_tensors(ts, what):
    for t in ts:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"the CUDA {what} kernels take contiguous float32 CUDA tensors, got {t.dtype} on {t.device}")


def _check_shapes(got, want, what):
    got = [tuple(t.shape) for t in got]
    if got != [tuple(w) for w in want]:
        raise ValueError(f"the CUDA {what} row kernels take shapes {want}, got {got}")


def _ptrs(ts, n):
    return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])


class _RowArgs(ctypes.Structure):
    """Mirror of ``struct RowArgs`` in csrc/rowwise.cu (the veltracer model)."""

    _fields_ = [
        ("f", ctypes.c_void_p * 3),
        ("u_init", ctypes.c_void_p),
        ("u_final", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("df", ctypes.c_void_p * 3),
        ("partials", ctypes.c_void_p),
        ("sums", ctypes.c_void_p),
        ("ticket", ctypes.c_void_p),
    ] + [(n, ctypes.c_int) for n in ("T", "X", "Y", "slab", "nterms", "has_x", "has_t")] + [
        (n, ctypes.c_float)
        for n in ("inv_dt", "inv_dx", "inv_dy", "inv_dx2", "inv_dy2", "kimp", "kimp_dx", "kxreg", "kt")
    ]


_MAXF, _MAXD, _MAXC, _MAXP, _NSCALARS = 2, 2, 6, 8, 8


class _Rows1DArgs(ctypes.Structure):
    """Mirror of ``struct Rows1DArgs`` in csrc/rows1d.cuh (the row models on
    1-D planes: heat, wave)."""

    _fields_ = [
        ("f", ctypes.c_void_p * _MAXF),
        ("data", ctypes.c_void_p * _MAXD),
        ("consts", ctypes.c_void_p * _MAXC),
        ("params", ctypes.c_void_p * _MAXP),
        ("g", ctypes.c_void_p),
        ("df", ctypes.c_void_p * _MAXF),
        ("dparams", ctypes.c_void_p),
        ("partials", ctypes.c_void_p),
        ("sums", ctypes.c_void_p),
        ("ticket", ctypes.c_void_p),
        ("data_stride", ctypes.c_int * _MAXD),
        ("param_size", ctypes.c_int * _MAXP),
    ] + [(n, ctypes.c_int) for n in ("T", "N", "slab", "blocks", "nterms", "nparams", "stride", "flags")] + [
        ("s", ctypes.c_float * _NSCALARS)
    ]


class _Rows1DHaloArgs(ctypes.Structure):
    """Mirror of ``struct Rows1DHaloArgs`` in csrc/rows1d.cuh (the masked
    per-shard 1-D kernels): Rows1DArgs plus the halo layer."""

    _fields_ = [("base", _Rows1DArgs), ("mask", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("off", "r_lo", "r_hi")
    ]


class _RowHaloArgs(ctypes.Structure):
    """Mirror of ``struct RowHaloArgs`` in csrc/rowwise.cu (the masked
    per-shard kernels): RowArgs plus the halo layer."""

    _fields_ = [("base", _RowArgs), ("mask", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("off", "Tg", "r_lo", "r_hi")
    ]


class _Launch:
    """What one launch of a row kernel needs: the argument struct, the
    outputs it writes (dfields, dparams views, sums) and the tensors the
    struct points to, kept alive until the launch is enqueued."""

    def __init__(self, args, dfields, dparams, sums, keep):
        self.args, self.dfields, self.dparams, self.sums, self.keep = args, dfields, dparams, sums, keep


class _VeltracerCuda:
    """The veltracer row model on (T, X, Y) planes: 3 fields, 2 const planes
    (u_init, u_final), no params, no data, hist=1 (``csrc/veltracer_row.cuh``)."""

    def library(self, model):
        return _library()

    def names(self, model, stream):
        """The (forward, backward) entry points for this model: the streaming
        pair launches the slabbed ones."""
        if model.halo is not None:
            if stream:
                raise NotImplementedError("the masked per-shard kernels have no streaming form")
            return "odil_rows_halo_forward", "odil_rows_halo_backward"
        return "odil_rows_forward", "odil_rows_backward"

    def launch_shape(self, lib, model, T, shape, grads, sums):
        """(slab, tiles, blocks, resident blocks) of a launch over T rows of
        (X, Y) planes: a block a tile (the masked form the same)."""
        X, Y = shape
        slab = _wave_slab(T, lib.odil_rows_num_blocks(T, X, Y, T), lib._odil_resident, 1)
        blocks = lib.odil_rows_num_blocks(T, X, Y, slab)
        return slab, blocks, blocks, lib._odil_resident

    def check(self, model, nterms, hist, fields, params, data, consts):
        _check_veltracer_model(model, hist)
        if len(fields) != 3 or len(consts) != 2 or params or data:
            raise ValueError("the veltracer CUDA kernels take 3 fields, 2 const planes, no params and no data")
        halo = (model.halo[0],) if model.halo is not None else ()
        _check_cuda_tensors(tuple(fields) + tuple(consts) + halo, "row-wise")
        shape = tuple(fields[0].shape)
        if len(shape) != 3 or shape[0] < 2:
            raise ValueError(f"the CUDA row-wise kernels take (T, X, Y) fields with T >= 2, got {shape}")
        _check_shapes(tuple(fields) + tuple(consts) + halo, [shape] * 3 + [shape[1:]] * (2 + len(halo)), "veltracer")

    def pack(self, lib, model, nterms, fields, params, data, consts, g, grads, sums, cs):
        T, X, Y = fields[0].shape
        dev = fields[0].device
        slab, _, nblocks, _ = self.launch_shape(lib, model, T, (X, Y), grads, sums)
        partials = torch.empty((nblocks, _MAXTERMS), dtype=torch.float64, device=dev)
        out = torch.empty((_MAXTERMS,), dtype=torch.float32, device=dev)
        dfields = tuple(torch.empty_like(f) for f in fields) if grads else ()
        args = _RowArgs(
            f=_ptrs(fields, 3), u_init=consts[0].data_ptr(), u_final=consts[1].data_ptr(),
            g=g.data_ptr() if g is not None else None, df=_ptrs(dfields, 3) if grads else (ctypes.c_void_p * 3)(),
            partials=partials.data_ptr(), sums=out.data_ptr(), ticket=_ticket(dev, cs).data_ptr(), T=T, X=X, Y=Y,
            slab=slab, **_veltracer_scalars(model, nterms),
        )
        if model.halo is not None:
            mask, off, Tg, r_lo, r_hi = model.halo
            args = _RowHaloArgs(base=args, mask=mask.data_ptr(), off=off, Tg=Tg, r_lo=r_lo, r_hi=r_hi)
        return _Launch(args, dfields, (), out, (partials,))


class _Rows1DCuda:
    """A row model on 1-D planes (T, N) of ``csrc/rows1d.cuh``: its id in
    the C interface, its hist, field/data/const counts and its own packing
    of flags and scalars (``flags_scalars``)."""

    def names(self, model, stream):
        """The (forward, backward) entry points: the streaming pair launches
        the slabbed ones, a per-shard model the masked ones."""
        if model.halo is not None:
            if stream:
                raise NotImplementedError("the masked per-shard kernels have no streaming form")
            return "odil_rows1d_halo_forward", "odil_rows1d_halo_backward"
        return "odil_rows1d_forward", "odil_rows1d_backward"

    def launch_shape(self, lib, model, T, shape, grads, sums):
        """(slab, tiles, blocks, resident blocks) of a tile launch over (T, N)."""
        (N,) = shape
        # The kernel's mode: 1 the sums, 2 the gradients, 3 both; 4 the masked form.
        mode = int(bool(sums)) | 2 * int(bool(grads)) | 4 * int(model.halo is not None)
        resident = lib._odil_rows1d_resident[(self.model_id, mode)]
        tile, max_slab, threads = lib._odil_rows1d_tile
        batches = self.batches(lib, model, grads) if self.batches else None
        slab, blocks = _tile_rows(T, N, self.hist, bool(grads), resident, tile, max_slab, threads, batches)
        return slab, -(-T // slab) * -(-N // tile), blocks, resident

    def __init__(self, model_id, hist, nfields, ndata, consts, flags_scalars, check_params, library=None,
                 batches=None):
        self.model_id, self.hist, self.nfields, self.ndata = model_id, hist, nfields, ndata
        self.consts = consts  # the const shapes, "N" standing for the plane
        self.flags_scalars = flags_scalars
        self.check_params = check_params
        self._library = library
        self.batches = batches  # (lib, model, grads) -> the wide form's batches (_tile_rows), or None

    def library(self, model):
        """The library of this model's kernels, where it has the same id."""
        return self._library(model) if self._library is not None else _library()

    def check(self, model, nterms, hist, fields, params, data, consts):
        if hist != self.hist:
            raise ValueError(f"the {model.cuda_model} CUDA row kernels take hist={self.hist}, got {hist}")
        if len(fields) != self.nfields or len(consts) != len(self.consts) or len(data) not in self.ndata:
            raise ValueError(
                f"the {model.cuda_model} CUDA row kernels take {self.nfields} fields, data {self.ndata} and "
                f"{len(self.consts)} consts, got {len(fields)}, {len(data)}, {len(consts)}"
            )
        halo = (model.halo[0],) if model.halo is not None else ()
        _check_cuda_tensors(tuple(fields) + tuple(params) + tuple(data) + tuple(consts) + halo, "row-wise")
        shape = tuple(fields[0].shape)
        if len(shape) != 2 or shape[0] < 2:
            raise ValueError(f"the CUDA 1-D row kernels take (T, N) fields with T >= 2, got {shape}")
        T, N = shape
        _check_shapes(tuple(fields) + halo, [shape] * len(fields) + [(N,)] * len(halo), model.cuda_model)
        for d in data:
            if tuple(d.shape) not in ((T, N), (T, 1)):
                raise ValueError(f"the CUDA 1-D row kernels take data of shape (T, N) or (T, 1), got {tuple(d.shape)}")
        _check_shapes(consts, [tuple(N if n == "N" else n for n in c) for c in self.consts], model.cuda_model)
        self.check_params(model, nterms, params)

    def pack(self, lib, model, nterms, fields, params, data, consts, g, grads, sums, cs):
        T, N = fields[0].shape
        dev = fields[0].device
        nparams = sum(p.numel() for p in params)
        stride = nterms + nparams
        slab, _, blocks, _ = self.launch_shape(lib, model, T, (N,), grads, sums)
        partials = torch.empty((max(stride, 1), blocks), dtype=torch.float64, device=dev)
        out = torch.empty((max(stride, 1),), dtype=torch.float32, device=dev)  # sums, then dparams
        dfields = tuple(torch.empty_like(f) for f in fields) if grads else ()
        dparams, pos = [], nterms
        for p in params:
            dparams.append(out[pos : pos + p.numel()].view(p.shape))
            pos += p.numel()
        flags, scalars = self.flags_scalars(model, nterms, N)
        args = _Rows1DArgs(
            f=_ptrs(fields, _MAXF), data=_ptrs(data, _MAXD), consts=_ptrs(consts, _MAXC), params=_ptrs(params, _MAXP),
            g=g.data_ptr() if g is not None else None, df=_ptrs(dfields, _MAXF), dparams=out.data_ptr() + 4 * nterms,
            partials=partials.data_ptr(), sums=out.data_ptr(), ticket=_ticket(dev, cs).data_ptr(),
            data_stride=(ctypes.c_int * _MAXD)(*[d.shape[1] for d in data]),
            param_size=(ctypes.c_int * _MAXP)(*[p.numel() for p in params]), T=T, N=N, slab=slab, blocks=blocks,
            nterms=nterms, nparams=nparams, stride=stride, flags=flags,
            s=(ctypes.c_float * _NSCALARS)(*(list(scalars) + [0.0] * (_NSCALARS - len(scalars)))),
        )
        if model.halo is not None:
            mask, off, _, r_lo, r_hi = model.halo
            args = _Rows1DHaloArgs(base=args, mask=mask.data_ptr(), off=off, r_lo=r_lo, r_hi=r_hi)
        return _Launch(args, dfields, tuple(dparams), out, (partials,) + params)


# The heat CUDA model's conductivity nets [1, w1, ..., wL, 1] (tanh hidden
# layers): the default [1, 5, 5, 1] with keep_init and keep_frozen on is built
# into rowwise.cu (``HeatRow``, its register-resident param cotangents); every
# other configuration into a library of csrc/heat_net.cu for its hidden
# widths, built at first use (``_heat_net_library``).  The limit: 1 to 3
# hidden layers of 1 to 32 units (at most 2209 params).
_HEAT_DEFAULT_WIDTHS = (5, 5)
_HEAT_MAX_HIDDEN, _HEAT_MAX_WIDTH = 3, 32
_HEAT_LIMIT = (f"the heat CUDA row model takes conductivity nets [1, w1, ..., wL, 1] with 1 <= L <= "
               f"{_HEAT_MAX_HIDDEN} hidden layers of 1 to {_HEAT_MAX_WIDTH} units")


@functools.lru_cache(maxsize=None)
def _heat_net(layers):
    """(hidden widths, param shapes) of a conductivity net's (out, in) layer
    shapes from 1 input to 1 output, or None where the shapes are no such
    chain or the net is beyond the kernels' limit (cached: the heat row
    model is built anew every epoch)."""
    layers = tuple(tuple(int(n) for n in shape) for shape in layers)
    if not layers or layers[0][1] != 1 or layers[-1][0] != 1:
        return None
    if any(a[0] != b[1] for a, b in zip(layers, layers[1:])):
        return None
    widths = tuple(no for no, _ in layers[:-1])
    if not 1 <= len(widths) <= _HEAT_MAX_HIDDEN or not all(1 <= w <= _HEAT_MAX_WIDTH for w in widths):
        return None
    return widths, layers + tuple((n,) for n, _ in layers)


def _heat_flags_scalars(model, nterms, N):
    s = model.scalars
    has_imp, has_x, has_t, infer_k, keep_init, keep_frozen = (
        bool(s[k]) for k in ("has_imp", "has_x", "has_t", "infer_k", "keep_init", "keep_frozen"))
    if nterms != 1 + has_imp + has_x + has_t:
        raise ValueError(f"nterms={nterms} does not match the heat flags")
    flags = has_imp | has_x << 1 | has_t << 2 | infer_k << 3 | keep_init << 4 | keep_frozen << 5
    dt, dx = s["dt"], s["dx"]
    return flags, (1 / dt, 1 / dx, 1 / (2 * dx), s["imp_weight"], s["kmax"])


def _heat_check_params(model, nterms, params):
    s = model.scalars
    if not s["infer_k"]:
        if params:
            raise NotImplementedError(f"the heat CUDA row model without infer_k takes no params, got "
                                      f"{[tuple(p.shape) for p in params]}")
        return
    net = _heat_net(s["layers"])
    if net is None:
        raise NotImplementedError(f"{_HEAT_LIMIT}, got layers {[tuple(shape) for shape in s['layers']]}")
    if tuple(tuple(p.shape) for p in params) != net[1]:
        raise NotImplementedError(f"the heat CUDA row model takes the params {net[1]} of its net, got "
                                  f"{[tuple(p.shape) for p in params]}")


def _heat_library(model):
    """The library of the heat model's kernels: rowwise.cu for the default
    net with keep_init and keep_frozen on (or the true conductivity with
    both on), else heat_net.cu built for the net's hidden widths (the
    default widths without infer_k)."""
    s = model.scalars
    widths = _heat_net(s["layers"])[0] if s["infer_k"] else _HEAT_DEFAULT_WIDTHS
    if widths == _HEAT_DEFAULT_WIDTHS and s["keep_init"] and s["keep_frozen"]:
        return _library()
    return _heat_net_library(widths)


def _heat_batches(lib, model, grads):
    """The rounds of a wide heat net's kernels (csrc/heat_wide.cuh), as
    ``_tile_rows`` takes them: the threads of its face phase (a face a
    thread), the weight of a face's net there (2 with its tangent: with the
    gradients and keep_frozen off), and the passes a batch of its param
    phase; None for the register form."""
    rows = getattr(lib, "_odil_wide_rows", 0)
    if not rows:
        return None
    return lib._odil_rows1d_tile[2], 1 + bool(grads and not model.scalars["keep_frozen"]), rows


def heat_net_source(widths):
    """(source, variant, defines) of the heat kernels' library for a net of
    hidden ``widths`` (``_build.compile_source``'s arguments): one macro a
    hidden layer, 0 where the net has fewer (nvcc splits a macro's value at
    its commas)."""
    widths = tuple(int(w) for w in widths)
    slots = widths + (0,) * (_HEAT_MAX_HIDDEN - len(widths))
    return "heat_net", "w" + "x".join(map(str, widths)), tuple((f"ODIL_HEAT_W{i + 1}", w) for i, w in enumerate(slots))


def _wave_flags_scalars(model, nterms, N):
    s = model.scalars
    if nterms != 1:
        raise ValueError(f"nterms={nterms}: the wave row model has one term")
    dt, dx = s["dt"], s["dx"]
    return 0, (1 / dt, 1 / dx**2, s["kimp"], 0.5 * dt)


def _wave_check_params(model, nterms, params):
    if params:
        raise ValueError("the wave CUDA row model takes no params")


_CUDA_MODELS = {
    "veltracer": _VeltracerCuda(),
    "heat": _Rows1DCuda(0, 1, 1, (0, 2), ("N", "N", "N", "N", (1, 1), (1, 1)), _heat_flags_scalars,
                        _heat_check_params, _heat_library, _heat_batches),
    "wave": _Rows1DCuda(1, 2, 1, (2,), ("N", "N", "N"), _wave_flags_scalars, _wave_check_params),
}


def _cuda_model(model, call=None):
    """The CUDA counterpart of a model: its built-in one by name, or for a
    user row function (``cuda_model is None``) the traced one of the call
    ``(nterms, hist, fields, params, data, consts)``."""
    if model.cuda_model is None and call is not None:
        spec, reason = _traced(model, *call)
        if spec is None:
            raise NotImplementedError(f"the row function has no traced CUDA row model: {reason}")
        return spec
    spec = _CUDA_MODELS.get(model.cuda_model)
    if spec is None:
        raise NotImplementedError(
            f"row model {model.cuda_model!r} has no CUDA kernel; these do: {sorted(_CUDA_MODELS)}"
        )
    return spec


def _type_rows1d(lib, halo=True):
    """Declares the rows1d entry points of a library (rowwise.cu,
    heat_net.cu, or a traced row function's without the masked ones: halo
    False) and checks its argument structs' layout."""
    forms = (("odil_rows1d", _Rows1DArgs, "odil_rows1d_args_size"),) + (
        (("odil_rows1d_halo", _Rows1DHaloArgs, "odil_rows1d_halo_args_size"),) if halo else ())
    for _, _, name in forms:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    for name, n in (("odil_rows1d_tile", 1), ("odil_rows1d_resident_blocks", 2)):
        getattr(lib, name).argtypes = [ctypes.c_int] * n
        getattr(lib, name).restype = ctypes.c_int
    lib.odil_cuda_error_string.argtypes = [ctypes.c_int]
    lib.odil_cuda_error_string.restype = ctypes.c_char_p
    for pre, struct, _ in forms:
        getattr(lib, pre + "_forward").argtypes = [ctypes.c_int, ctypes.POINTER(struct), ctypes.c_void_p]
        getattr(lib, pre + "_backward").argtypes = [ctypes.c_int, ctypes.POINTER(struct), ctypes.c_int, ctypes.c_void_p]
        getattr(lib, pre + "_forward").restype = ctypes.c_int
        getattr(lib, pre + "_backward").restype = ctypes.c_int
    for _, struct, name in forms:
        size = getattr(lib, name)()
        if size != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} layout mismatch: C {size} vs ctypes {ctypes.sizeof(struct)} bytes")
    lib._odil_rows1d_tile = tuple(int(lib.odil_rows1d_tile(a)) for a in range(3))


def _rows1d_resident(lib, model_ids, modes=(1, 2, 3, 5, 6, 7)):
    """{(model id, mode): blocks the card holds at once} of a library's 1-D
    row models, every mode (1-3 and the masked 5-7)."""
    return {(i, mode): max(int(lib.odil_rows1d_resident_blocks(i, mode)), 1) for i in model_ids for mode in modes}


def _library():
    lib = _build.load("rowwise")
    if not getattr(lib, "_odil_typed", False):
        for name in ("odil_rows_args_size", "odil_rows_halo_args_size", "odil_rows_resident_blocks"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.odil_rows_num_blocks.argtypes = [ctypes.c_int] * 4
        lib.odil_rows_num_blocks.restype = ctypes.c_int
        lib.odil_rows_tile.argtypes = [ctypes.c_int]
        lib.odil_rows_tile.restype = ctypes.c_int
        lib.odil_empty_launch.argtypes = [ctypes.c_void_p]
        lib.odil_empty_launch.restype = ctypes.c_int
        for pre, struct in (("odil_rows", _RowArgs), ("odil_rows_halo", _RowHaloArgs)):
            getattr(lib, pre + "_forward").argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
            getattr(lib, pre + "_backward").argtypes = [ctypes.POINTER(struct), ctypes.c_int, ctypes.c_void_p]
            getattr(lib, pre + "_forward").restype = ctypes.c_int
            getattr(lib, pre + "_backward").restype = ctypes.c_int
        for name, struct in (("odil_rows_args_size", _RowArgs), ("odil_rows_halo_args_size", _RowHaloArgs)):
            size = getattr(lib, name)()
            if size != ctypes.sizeof(struct):
                raise RuntimeError(f"{struct.__name__} layout mismatch: C {size} vs ctypes {ctypes.sizeof(struct)} bytes")
        _type_rows1d(lib)
        # Read once: the launch shapes' searches take them (cached by shape).
        lib._odil_resident = max(int(lib.odil_rows_resident_blocks()), 1)
        lib._odil_rows1d_resident = _rows1d_resident(
            lib, [spec.model_id for spec in _CUDA_MODELS.values() if isinstance(spec, _Rows1DCuda)])
        lib._odil_wide_rows = 0  # no wide form (read on every heat launch: a missing name is a symbol lookup)
        lib._odil_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _heat_net_library(widths):
    """The heat kernels' library for a conductivity net of hidden ``widths``
    (csrc/heat_net.cu, built at first use; its one row model has heat's id
    in rowwise.cu, 0)."""
    name, variant, defines = heat_net_source(widths)
    lib = _build.load(name, variant, defines)
    _type_rows1d(lib)
    lib.odil_heat_net_params.argtypes = []
    lib.odil_heat_net_params.restype = ctypes.c_int
    lib.odil_heat_wide_rows.argtypes = []
    lib.odil_heat_wide_rows.restype = ctypes.c_int
    dims = (1,) + tuple(widths) + (1,)
    nparams = sum(a * b + b for a, b in zip(dims, dims[1:]))
    if lib.odil_heat_net_params() != nparams:
        raise RuntimeError(f"{name} {variant}: {lib.odil_heat_net_params()} params, expected {nparams}")
    lib._odil_rows1d_resident = _rows1d_resident(lib, [_CUDA_MODELS["heat"].model_id])
    lib._odil_wide_rows = int(lib.odil_heat_wide_rows())
    return lib


# -- Traced row functions (ops/rowtrace.py) ------------------------------------


def _traced(model, nterms, hist, fields, params, data, consts):
    """(the traced CUDA counterpart, None) of a user row function's call,
    or (None, the reason it has none): float32 tensors, (T, N) planes with
    T >= 2, data of shape (T, N) or (T, 1), consts of one element or of
    the plane's shape ((N,) or (1, N)), no per-shard layer and a trace that
    ``rowtrace`` takes.  Cached by the row function's
    ``rowtrace.fingerprint`` and the call's structure (a function without
    one is traced at every call); nothing is built here."""
    if model.halo is not None:
        return None, "a per-shard (halo) row model: the traced kernels have no masked form yet"
    ndim = fields[0].ndim
    if ndim != 2:
        return None, f"{ndim - 1}-D planes: the traced kernels take 1-D planes (T, N)"
    wide = [t.dtype for t in tuple(fields) + tuple(params) + tuple(data) + tuple(consts) if t.dtype != torch.float32]
    if wide:
        return None, f"tensors of dtype {wide[0]}: the traced kernels take float32"
    T, N = fields[0].shape
    shapes = [tuple(t.shape) for t in fields]
    if T < 2 or shapes != [(T, N)] * len(fields):
        return None, f"fields of shapes {shapes}: the traced kernels take (T, N) fields with T >= 2"
    for d in data:
        if tuple(d.shape) not in ((T, N), (T, 1)):
            return None, f"data of shape {tuple(d.shape)}: the traced kernels take (T, N) or (T, 1)"
    for c in consts:
        if c.numel() != 1 and tuple(c.shape) not in ((N,), (1, N)):
            return None, f"a const of shape {tuple(c.shape)}: the traced kernels take one element or (N,) or (1, N)"
    data_kinds = tuple(d.shape[-1] == N for d in data)
    const_kinds = tuple((c.numel() != 1, c.ndim) for c in consts)
    key = (rowtrace.fingerprint(model.row_fn), nterms, hist, len(fields), data_kinds, const_kinds,
           tuple(tuple(p.shape) for p in params))
    out = _TRACES.get(key) if key[0] is not None else None
    if out is None:
        try:
            out = (_traced_spec(rowtrace.trace(model.row_fn, nterms, hist, len(fields), data_kinds, const_kinds,
                                               key[6])), None)
        except rowtrace.Refused as e:
            out = (None, str(e))
        if key[0] is not None:
            if len(_TRACES) >= 256:
                _TRACES.clear()
            _TRACES[key] = out
    return out


# {(rowtrace.fingerprint of a row function, a call's structure): _traced's
# result}: a row function made anew every epoch with the same code and
# values is traced once.
_TRACES = {}


def _traced_spec(trace):
    """The 1-D row model of a trace: model id 0 of its own library."""
    consts = tuple((1,) * (ndim - 1) + ("N",) if plane else (1,) * ndim for plane, ndim in trace.consts)

    def check_params(model, nterms, params):
        if tuple(tuple(p.shape) for p in params) != trace.param_shapes:
            raise ValueError(f"the traced row model takes params {trace.param_shapes}, got "
                             f"{[tuple(p.shape) for p in params]}")

    spec = _Rows1DCuda(0, trace.hist, trace.nfields, (len(trace.data),), consts, lambda model, nterms, N: (0, ()),
                       check_params, lambda model: _traced_library(trace.source))
    spec.trace = trace
    return spec


@functools.lru_cache(maxsize=None)
def _traced_library(source):
    """The library of a traced row model's kernels (``rowtrace.Trace.source``,
    built at first use; one library per source)."""
    lib = _build.load_generated("rows1d_traced", source)
    _type_rows1d(lib, halo=False)
    lib._odil_rows1d_resident = _rows1d_resident(lib, [0], modes=(1, 2, 3))
    return lib


def _cuda_stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _call(lib, spec, name, launch, *extra):
    head = (spec.model_id,) if isinstance(spec, _Rows1DCuda) else ()
    fn = getattr(lib, name)
    _raise_on(lib, fn(*head, ctypes.byref(launch.args), *extra), name)


def _launch_forward(model, nterms, hist, fields, params, data, consts, stream=False):
    spec = _cuda_model(model, (nterms, hist, fields, params, data, consts))
    spec.check(model, nterms, hist, fields, params, data, consts)
    lib = spec.library(model)
    name = spec.names(model, stream)[0]
    cs = _cuda_stream(fields[0])
    launch = spec.pack(lib, model, nterms, fields, params, data, consts, None, False, True, cs)
    _call(lib, spec, name, launch, cs)
    return launch.sums[:nterms]


def _launch_backward(model, nterms, hist, fields, params, data, consts, g, with_sums, stream=False):
    spec = _cuda_model(model, (nterms, hist, fields, params, data, consts))
    spec.check(model, nterms, hist, fields, params, data, consts)
    g = g.to(torch.float32).contiguous()
    if not g.is_cuda or g.numel() < nterms:
        raise ValueError("g must hold nterms weights on the card")
    lib = spec.library(model)
    name = spec.names(model, stream)[1]
    cs = _cuda_stream(fields[0])
    launch = spec.pack(lib, model, nterms, fields, params, data, consts, g, True, with_sums, cs)
    _call(lib, spec, name, launch, int(bool(with_sums)), cs)
    return launch.dfields, launch.dparams, (launch.sums[:nterms] if with_sums else None)


def launch_shape(model, fields, grads, sums):
    """(slab, tiles, blocks, resident blocks) of the row kernel's launch on
    ``fields`` (a CUDA model's), the streaming pair's too."""
    spec = _cuda_model(model)
    T, *plane = fields[0].shape
    return spec.launch_shape(spec.library(model), model, T, tuple(plane), grads, sums)


def row_tile():
    """The veltracer row kernel's tile (``odil_rows_tile`` of
    ``csrc/rowwise.cu``): its rows, columns and threads, the dynamic shared
    memory of a plain and a masked launch (bytes), and the backward+sums
    blocks an SM holds, plain and masked."""
    lib = _library()
    keys = ("rows", "cols", "threads", "smem", "smem_masked", "per_sm", "per_sm_masked")
    return {k: int(lib.odil_rows_tile(i)) for i, k in enumerate(keys)}


def forward_cuda(model, nterms, hist, fields, params, data, consts):
    """CUDA forward kernel (replaces ``_forward``, ``_forward_blocked`` and
    the non-padded ``_forward_tiled``): (nterms,) sums of squares of the
    residual rows, on the current stream."""
    sums = _launch_forward(model, nterms, hist, fields, params, data, consts)
    forward_cuda.launches += 1
    return sums


forward_cuda.launches = 0


def backward_cuda(model, nterms, hist, fields, params, data, consts, g, with_sums):
    """CUDA backward kernel (replaces ``_backward``, ``_backward_blocked`` and
    the non-padded ``_backward_tiled``): (dfields, dparams, sums or None) for
    the loss sum_k g[k] * S[k], on the current stream."""
    out = _launch_backward(model, nterms, hist, fields, params, data, consts, g, with_sums)
    backward_cuda.launches += 1
    return out


backward_cuda.launches = 0


def forward_stream_cuda(model, nterms, hist, fields, params, data, consts):
    """CUDA streaming forward kernel (replaces ``_forward_stream``): the
    forward kernel's launch, wave-sized slabs (see the module docstring),
    counted apart."""
    sums = _launch_forward(model, nterms, hist, fields, params, data, consts, stream=True)
    forward_stream_cuda.launches += 1
    return sums


forward_stream_cuda.launches = 0


def backward_stream_cuda(model, nterms, hist, fields, params, data, consts, g, with_sums):
    """CUDA streaming backward kernel (replaces ``_backward_stream``): the
    backward kernel's launch, wave-sized slabs (see the module docstring),
    counted apart; each slab recomputes the ``hist`` residual rows past its
    end, as the TPU's tail programs do for the wrapped targets."""
    out = _launch_backward(model, nterms, hist, fields, params, data, consts, g, with_sums, stream=True)
    backward_stream_cuda.launches += 1
    return out


backward_stream_cuda.launches = 0


def forward_halo_cuda(model, nterms, hist, fields, params, data, consts):
    """CUDA masked per-shard forward kernel (replaces ``_forward_tiled`` with
    ``xpad``, ``odil_tpu/ops/rowwise_tiled.py:187``): (nterms,) sums of
    squares of the masked residual rows of a ``halo_model``."""
    sums = _launch_forward(model, nterms, hist, fields, params, data, consts)
    forward_halo_cuda.launches += 1
    return sums


forward_halo_cuda.launches = 0


def backward_halo_cuda(model, nterms, hist, fields, params, data, consts, g, with_sums):
    """CUDA masked per-shard backward kernel (replaces ``_backward_tiled``
    with ``xpad``, ``odil_tpu/ops/rowwise_tiled.py:283``): (dfields, dparams,
    sums or None) of a ``halo_model``."""
    out = _launch_backward(model, nterms, hist, fields, params, data, consts, g, with_sums)
    backward_halo_cuda.launches += 1
    return out


backward_halo_cuda.launches = 0


def forward_halo_rows1d_cuda(model, nterms, hist, fields, params, data, consts):
    """CUDA masked per-shard forward kernel of the 1-D row models (replaces
    ``_forward_blocked`` on the wrapped row function of
    ``odil_tpu/halo.py:873-885``, ``odil_tpu/ops/rowwise.py:322``): (nterms,)
    sums of squares of the masked residual rows of a ``halo_model``."""
    sums = _launch_forward(model, nterms, hist, fields, params, data, consts)
    forward_halo_rows1d_cuda.launches += 1
    return sums


forward_halo_rows1d_cuda.launches = 0


def backward_halo_rows1d_cuda(model, nterms, hist, fields, params, data, consts, g, with_sums):
    """CUDA masked per-shard backward kernel of the 1-D row models (replaces
    ``_backward_blocked`` on the wrapped row function,
    ``odil_tpu/ops/rowwise.py:396``): (dfields, dparams, sums or None) of a
    ``halo_model``."""
    out = _launch_backward(model, nterms, hist, fields, params, data, consts, g, with_sums)
    backward_halo_rows1d_cuda.launches += 1
    return out


backward_halo_rows1d_cuda.launches = 0


def _halo_kernels(model):
    """The (forward, backward) per-shard wrappers of a wrapped model's CUDA
    counterpart."""
    if isinstance(_CUDA_MODELS.get(model.cuda_model), _Rows1DCuda):
        return forward_halo_rows1d_cuda, backward_halo_rows1d_cuda
    return forward_halo_cuda, backward_halo_cuda


# -- Dispatch ------------------------------------------------------------------


def _contig(ts):
    return tuple(t.contiguous() for t in ts)


def plain_on_card(plain, *args, reason=None):
    """``plain(*args)`` on the card's tensors: the route of a row model that
    has no CUDA counterpart (``cuda_model is None`` and no trace: its
    ``reason``).  Plain torch, not a kernel; its launch counter shows which
    calls took it, ``plain_on_card.reasons`` why."""
    plain_on_card.launches += 1
    if reason is not None:
        plain_on_card.reasons[reason] += 1
    return plain(*args)


plain_on_card.launches = 0
plain_on_card.reasons = collections.Counter()


def _kernel_route(model, tensor, call=None):
    """Whether a call on ``tensor`` launches a CUDA kernel: a CUDA tensor of a
    model that names a CUDA counterpart, or of a user row function whose
    call ``(nterms, hist, fields, params, data, consts)`` is traced
    (``_traced``).  Decided before any build."""
    if not tensor.is_cuda:
        return False
    if model.cuda_model is not None:
        return True
    return call is not None and _traced(model, *call)[0] is not None


def _plain(plain, tensor, *args, reason=None):
    """The plain version ``plain(*args)``, through ``plain_on_card`` on the
    card (with the ``reason`` it has no kernel)."""
    return plain_on_card(plain, *args, reason=reason) if tensor.is_cuda else plain(*args)


def _reason(model, call):
    """Why a call on the card takes the plain route (a user row function's
    refused trace), or None."""
    return _traced(model, *call)[1] if model.cuda_model is None and call[2][0].is_cuda else None


def _forward(model, nterms, hist, fields, params, data, consts, stream=False):
    call = (nterms, hist, fields, params, data, consts)
    if _kernel_route(model, fields[0], call):
        kernel = _halo_kernels(model)[0] if model.halo is not None else forward_stream_cuda if stream else forward_cuda
        return kernel(model, nterms, hist, _contig(fields), _contig(params), _contig(data), _contig(consts))
    return _plain(_forward_plain, fields[0], model, *call, reason=_reason(model, call))


def _backward(model, nterms, hist, fields, params, data, consts, g, with_sums=False, stream=False):
    call = (nterms, hist, fields, params, data, consts)
    if _kernel_route(model, fields[0], call):
        kernel = _halo_kernels(model)[1] if model.halo is not None else backward_stream_cuda if stream else backward_cuda
        return kernel(
            model, nterms, hist, _contig(fields), _contig(params), _contig(data), _contig(consts), g, with_sums
        )
    return _plain(_backward_plain, fields[0], model, *call, g, with_sums, reason=_reason(model, call))


class _RowwiseSumsq(torch.autograd.Function):
    """Per-term sums of squares (the forward kernel, or the streaming one);
    the backward runs the matching backward kernel with the sums off.  data
    and consts get no gradient (the custom_vjps of ``rowwise_sumsq`` and
    ``rowwise_sumsq_stream``, ``odil_tpu/ops/rowwise.py:827-870``)."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        model, nterms, hist, nf, np_, nd, stream = cfg
        fields, params = tensors[:nf], tensors[nf : nf + np_]
        data, consts = tensors[nf + np_ : nf + np_ + nd], tensors[nf + np_ + nd :]
        ctx.cfg = cfg
        ctx.save_for_backward(*tensors)
        return _forward(model, nterms, hist, fields, params, data, consts, stream)

    @staticmethod
    def backward(ctx, grad_sums):
        model, nterms, hist, nf, np_, nd, stream = ctx.cfg
        tensors = ctx.saved_tensors
        fields, params = tensors[:nf], tensors[nf : nf + np_]
        data, consts = tensors[nf + np_ : nf + np_ + nd], tensors[nf + np_ + nd :]
        dfields, dparams, _ = _backward(model, nterms, hist, fields, params, data, consts, grad_sums, False, stream)
        return (None,) + tuple(dfields) + tuple(dparams) + (None,) * (len(data) + len(consts))


# -- Entry points --------------------------------------------------------------


def _wide(fields):
    """64-bit fields: the plain route, by the JAX package's rule."""
    return fields[0].element_size() > 4


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
    differentiated by autograd.  ``stream=True`` with ``hist >= 1`` takes the
    streaming pair."""
    model = _as_model(row_fn)
    fields, params, data, consts = tuple(fields), tuple(params), tuple(data), tuple(consts)
    denom = 1.0 if _sums else float(fields[0].numel())
    if _wide(fields):
        sums = _forward_plain(model, nterms, hist, fields, params, data, consts)
    else:
        cfg = (model, nterms, hist, len(fields), len(params), len(data), bool(stream and hist >= 1))
        sums = _RowwiseSumsq.apply(cfg, *fields, *params, *data, *consts)
    return [sums[k] / denom for k in range(nterms)]


def rowwise_loss_sums(
    row_fn, fields, params=(), data=(), consts=(), nterms=1, hist=1, block_rows=None, stream=False, halox=None,
    xpad_masked=False,
):
    """``rowwise_loss_terms`` returning per-term SUMS of squares instead of
    means: the per-shard form of ``halo.py`` sums them over the shards and
    divides by the global count.  ``xpad_masked`` changes nothing (see the
    module docstring)."""
    return rowwise_loss_terms(
        row_fn, fields, params=params, data=data, consts=consts, nterms=nterms, hist=hist,
        block_rows=block_rows, stream=stream, halox=halox, _sums=True,
    )


def onepass_supported(fields, params, data, consts, nterms, hist, halox=None, xpad_masked=False):
    """Whether ``rowwise_loss_and_grads`` runs for these inputs: fields of at
    most 32 bits (the build-time gate of Problem's one-pass route)."""
    return not _wide(tuple(fields))


def rowwise_loss_and_grads(
    row_fn, fields, params=(), data=(), consts=(), nterms=1, hist=1, block_rows=None, gscale=None, halox=None,
    xpad_masked=False,
):
    """One-pass fused loss sums AND gradients: the backward kernel with the
    sums on gives the per-term sums of squares and the cotangents of
    ``sum_k gscale * S_k`` (gscale defaults to 1/(T*plane), the mean
    composition every Problem loss uses) -- the training step runs no
    forward kernel.

    Returns (sums, dfields, dparams), or None for 64-bit fields (the JAX
    package's rule), where callers differentiate the usual loss instead.
    data/consts are not differentiated.  ``block_rows``, ``halox`` and
    ``xpad_masked`` change nothing (see ``rowwise_loss_terms`` and the module
    docstring).  Not itself differentiable."""
    if _wide(tuple(fields)):
        return None
    return _loss_and_grads(row_fn, fields, params, data, consts, nterms, hist, gscale)


def _loss_and_grads(row_fn, fields, params=(), data=(), consts=(), nterms=1, hist=1, gscale=None):
    """``rowwise_loss_and_grads`` in any dtype: 64-bit CPU tensors run the
    plain version (the halo path's counterpart of the JAX package's
    interpret mode on the CPU mesh); on the card the kernels take float32."""
    model = _as_model(row_fn)
    fields, params, data, consts = tuple(fields), tuple(params), tuple(data), tuple(consts)
    if gscale is None:
        gscale = 1.0 / fields[0].numel()
    g = torch.full((nterms,), gscale, dtype=fields[0].dtype, device=fields[0].device)
    dfields, dparams, sums = _backward(model, nterms, hist, fields, params, data, consts, g, with_sums=True)
    return sums, dfields, dparams
