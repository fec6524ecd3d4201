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

Two-level fusion (``t1s``/``factors1`` of ``rowwise_mg_loss_and_grads``,
the ``lvl2`` form of the JAX package's ``_backward_mg``): ``coarse`` is then
the level-2 partial P2 (Tc2, X//4, Y//4), and the level-1 rows

  P1[c] = factor1 * t1[c] + W1x @ blend_t(P2[c//2], P2[c//2+1]) @ W1y^T

are rebuilt inside the kernel as well.  The kernel's coarse cotangent is
then dP1, split by linearity into dt1 = factor1 * dP1 and dP2 (the same
transposed t-blend and prolongation one level down): ``_split_dp1`` in the
plain version, ``mg_coarse_grad_kernel`` run once more on the card.

Each entry point dispatches on the device of its tensors and on the row
model's declaration, by the rule of ``ops/rowwise.py``: a CUDA tensor of a
model that names a CUDA counterpart launches the hand-written kernel of
``csrc/rowwise_mg.cu`` (veltracer; another named model raises), one of a
model that names none runs the plain PyTorch version on the card
(``rowwise.plain_on_card``), a CPU tensor runs the plain version.

Local-block form (``rowwise_mg_local_loss_and_grads``, the ``--halo``
per-shard route of ``halo.py``; the JAX package's ``_backward_mg`` with
``wraps_in``/``emit_dwraps``, ``odil_tpu/ops/rowwise_mg.py:350-365``, and its
beyond-VMEM twin ``rowwise_mg_local_tiled``): one shard's level-0 block
(Tl, Xe, Y), x-halo-extended, the time window of the level-1 partial
(Tcw, X//2, Y//2) with window row 0 at global row g0/2, and the ``hist``
fine rows that precede the block (``heads``) in place of its own periodic
wrap.  Local column c is global column (x0 + c) mod X, whose 2-tap
prolongation it takes.  The cotangents of the heads leave as ``dheads``.
The row model is a ``rowwise.halo_model`` over the block's rows.  On the
card one kernel serves every block size (the TPU's VMEM gate has no
counterpart): ``backward_mg_local_cuda``.

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
    _kernel_route,
    _plain,
    _raise_on,
    _ticket,
    _veltracer_scalars,
    _wave_slab,
    halo_model,
)

__all__ = ["RowModel", "rowwise_loss_terms_mg", "rowwise_mg_loss_and_grads", "rowwise_mg_local_loss_and_grads"]


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


def _recon_p1(t1, P2, rows, W1x, W1y, f1):
    """Level-1 rows ``rows`` rebuilt from (t1, P2), in the operation order of
    ``odil_tpu/ops/rowwise_mg._recon_p1_xla``."""
    return _recon_rows(t1, P2, rows, W1x, W1y, f1)


def _recon_rows_2(t0, t1, P2, rows, Wx, Wy, W1x, W1y, f0, f1):
    """Fine rows rebuilt from (t0, t1, P2) through the level-1 rows (levels
    2 -> 1 -> 0), in the operation order of ``_recon_rows_xla_2``."""
    P1 = _recon_p1(t1, P2, range(t1.shape[0]), W1x, W1y, f1)
    return _recon_rows(t0, P1, rows, Wx, Wy, f0)


def _split_dp1(dP1s, f1s, W1x, W1y):
    """(dt1, dP2) from the level-1 cotangent by linearity of the level-1
    rebuild: dt1 = f1 * dP1, dP2 = the transposed t-blend of W1x^T @ dP1 @ W1y
    (the epilogue of ``odil_tpu/ops/rowwise_mg.rowwise_mg_loss_and_grads``,
    :947-959, in its operation order)."""
    dt1 = tuple(f * d for f, d in zip(f1s, dP1s))
    dP2 = []
    for d in dP1s:
        dd = torch.einsum("xa,txy,yb->tab", W1x, d, W1y)
        ev, odd = dd[0::2], dd[1::2]
        zeros = torch.zeros((1,) + tuple(dd.shape[1:]), dtype=dd.dtype, device=dd.device)
        dP2.append(ev + 0.5 * torch.cat([zeros, odd], 0) + 0.5 * torch.cat([odd, zeros], 0))
    return dt1, tuple(dP2)


def _down_rows(dfine, Wx, Wy, Tc):
    """dP[c] = Wx^T @ (0.5 dfine[2c-1] + dfine[2c] + 0.5 dfine[2c+1]) @ Wy."""
    d = dfine[0::2].clone()
    odd = 0.5 * dfine[1::2]
    d[1:] = odd + d[1:]
    d[:-1] = d[:-1] + odd
    assert d.shape[0] == Tc
    return torch.matmul(Wx.T, torch.matmul(d, Wy))


# -- Plain PyTorch versions ----------------------------------------------------


def _fines(t0s, coarse, f0s, lvl2=None):
    """The fine fields rebuilt from (t0s, coarse) -- or at two levels from
    (t0s, t1s, P2 = coarse) with lvl2 = (t1s, f1s) -- and (Wx, Wy)."""
    T = t0s[0].shape[0]
    if lvl2 is None:
        Wx, Wy = _interp_matrices(*coarse[0].shape[1:], t0s[0].dtype, t0s[0].device)
        return [_recon_rows(t, c, range(T), Wx, Wy, f) for t, c, f in zip(t0s, coarse, f0s)], Wx, Wy
    t1s, f1s = lvl2
    Wx, Wy = _interp_matrices(*t1s[0].shape[1:], t0s[0].dtype, t0s[0].device)
    W1x, W1y = _interp_matrices(*coarse[0].shape[1:], t0s[0].dtype, t0s[0].device)
    fines = [
        _recon_rows_2(t0, t1, P2, range(T), Wx, Wy, W1x, W1y, f0, f1)
        for t0, t1, P2, f0, f1 in zip(t0s, t1s, coarse, f0s, f1s)
    ]
    return fines, Wx, Wy


def _forward_mg_plain(model, nterms, hist, f0s, t0s, coarse, consts):
    """Plain version of the forward kernel: (nterms,) sums of squares."""
    fines, _, _ = _fines(t0s, coarse, f0s)
    return _forward_plain(model, nterms, hist, fines, (), (), consts)


def _backward_mg_plain(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums, lvl2=None):
    """Plain version of the backward kernel: gradients of sum_k g[k] * S[k]
    w.r.t. (t0s, coarse), and the sums S when ``with_sums``.  With lvl2 =
    (t1s, f1s), ``coarse`` is the level-2 partial and the coarse cotangent
    returned is the level-1 one, dP1 (the TPU kernel's ``dc`` output)."""
    with torch.no_grad():
        fines, Wx, Wy = _fines(t0s, coarse, f0s, lvl2)
    dfines, _, sums = _backward_plain(model, nterms, hist, fines, (), (), consts, g, with_sums)
    Tc = (fines[0].shape[0] - 1) // 2 + 1
    with torch.no_grad():
        dt0 = tuple(f * d for f, d in zip(f0s, dfines))
        dP = tuple(_down_rows(d, Wx, Wy, Tc) for d in dfines)
    return dt0, dP, sums


def _local_wx(CX, Xe, x0, dtype, device):
    """The (Xe, CX) rows of the x prolongation matrix at the block's global
    columns (x0 + c) mod 2*CX (the JAX caller's gathered ``Wxl``)."""
    Wx, _ = _interp_matrices(CX, CX, dtype, device)
    return Wx[(x0 + torch.arange(Xe, device=device)) % (2 * CX)]


def _stacked_model(model, hist):
    """The halo model over the stack [heads; block]: row q of the stack is
    block row q - hist, and the heads' own residual rows are out."""
    mask, off, T, r_lo, r_hi = model.halo
    return halo_model(model.inner, mask, off - hist, T, max(r_lo, 0) + hist, r_hi + hist)


def _backward_mg_local_plain(model, nterms, hist, f0s, t0s, coarse, heads, x0, consts, g):
    """Plain version of the local-block backward kernel: (dt0, dP, dheads,
    sums) of sum_k g[k] * S[k] over the block's masked residual rows."""
    Tl, Xe, _ = t0s[0].shape
    Tcw, CX, CY = coarse[0].shape
    with torch.no_grad():
        Wx = _local_wx(CX, Xe, x0, t0s[0].dtype, t0s[0].device)
        _, Wy = _interp_matrices(CY, CY, t0s[0].dtype, t0s[0].device)
        rows = [torch.cat([h, _recon_rows(t, c, range(Tl), Wx, Wy, f)]) for t, c, h, f in zip(t0s, coarse, heads, f0s)]
    d, _, sums = _backward_plain(_stacked_model(model, hist), nterms, hist, rows, (), (), consts, g, True)
    with torch.no_grad():
        dt0 = tuple(f * x[hist:] for f, x in zip(f0s, d))
        dP = tuple(_down_rows(x[hist:], Wx, Wy, Tcw) for x in d)
        dheads = tuple(x[:hist].clone() for x in d)
    return dt0, dP, dheads, sums


# -- Plain version of the kernels' dP route -------------------------------------
#
# The CUDA walk forms dP inside itself: each block (a TILE_X x TILE_Y tile of
# one slab of walked rows) applies the transposed t-blend and x/y taps of its
# own cells into a coarse window of DWA x DWB cells per coarse row it
# reaches, and a gather adds the at most 2 x 2 x 2 windows that hold each
# coarse cell.  These functions are that route in plain torch, with the
# kernel's tile, slab and window index maps (csrc/rowwise_mg.cu: dp_rows,
# init_dp_taps, flush_dp, mg_dp_gather_kernel).

_TILE_X, _TILE_Y = 16, 32  # the mg walk's tile (ODIL_TILE_X of csrc/rowwise_mg.cu, TILE_Y)


def _taps(x, n):
    """The two coarse taps ((index, weight), (index, weight)) of fine index x
    along an axis of n coarse cells (``taps`` of csrc/rowwise_mg.cu)."""
    i = x // 2
    if x % 2 == 0:
        return ((0, 1.25), (1, -0.25)) if i == 0 else ((i - 1, 0.25), (i, 0.75))
    return ((n - 1, 1.25), (n - 2, -0.25)) if i == n - 1 else ((i, 0.75), (i + 1, 0.25))


def _window_taps(first, shift, count, period, n, tile, dtype, device):
    """(ntiles, tile, tile // 2 + 2) transposed-tap matrices of the tiles
    along one axis, and each tile's unwrapped coarse index of window index 0.
    Tile b covers local indices b * tile - shift + i (owned where in [0,
    count)), at unwrapped global index first + local (periodic in
    ``period``); its window starts at unwrapped coarse index
    (first - shift + b * tile) // 2 - 1."""
    nt = -(-(count + shift) // tile)
    M = torch.zeros((nt, tile, tile // 2 + 2), dtype=dtype)
    base = []
    for b in range(nt):
        g0 = first - shift + b * tile
        u0 = g0 // 2 - 1
        base.append(u0)
        for i in range(tile):
            loc, gx = b * tile - shift + i, g0 + i
            if not 0 <= loc < count:
                continue
            gm = gx % period
            for a, w in _taps(gm, n):
                M[b, i, a + (gx - gm) // period * n - u0] += w
    return M.to(device), base


def _dp_slab_rows(z, slab, walked, local, Tc):
    """(l0, l1, c_lo, c_hi): slab z's dP rows [l0, l1) and the coarse rows
    they reach (``dp_rows`` of the kernel)."""
    ts, te = z * slab, min(z * slab + slab, walked)
    l0, l1 = max(ts - local, 0), te - local
    return l0, l1, l0 >> 1, min(Tc - 1, l1 >> 1)


def _dp_partials(dfine, Tc, slab, x0=0, Xg=None, local=False):
    """The blocks' dP partials of one field, (nslabs, slab // 2 + 2, ntiles_x,
    ntiles_y, DWA, DWB) as the kernel lays them out: dfine (L, X, Y) is the
    fine cotangent before the level-0 factor (L dP rows; a local block's
    stack walks L + 1 rows, the head first), x0 the global column of local
    column 0 and Xg the global X (a local block), slab the walked rows a
    block takes."""
    L, X, Y = dfine.shape
    Xg = X if Xg is None else Xg
    local = int(bool(local))
    dtype, dev = dfine.dtype, dfine.device
    shift = x0 & 1 if local else 0
    Mx, _ = _window_taps(x0, shift, X, Xg, Xg // 2, _TILE_X, dtype, dev)
    My, _ = _window_taps(0, 0, Y, Y, Y // 2, _TILE_Y, dtype, dev)
    nbx, nby = Mx.shape[0], My.shape[0]
    walked = L + local
    nz = -(-walked // slab)
    pad = torch.zeros((L, nbx * _TILE_X, nby * _TILE_Y), dtype=dtype, device=dev)
    pad[:, shift : shift + X, :Y] = dfine
    tiles = pad.view(L, nbx, _TILE_X, nby, _TILE_Y)
    out = torch.zeros((nz, slab // 2 + 2, nbx, nby, Mx.shape[2], My.shape[2]), dtype=dtype, device=dev)
    for z in range(nz):
        l0, l1, c_lo, c_hi = _dp_slab_rows(z, slab, walked, local, Tc)
        rows = torch.arange(l0, l1, device=dev)
        cs = torch.arange(c_lo, c_hi + 1, device=dev)
        dist = (rows.view(1, -1) - 2 * cs.view(-1, 1)).abs()
        wt = torch.where(dist == 0, 1.0, torch.where(dist == 1, 0.5, 0.0)).to(dtype)
        blend = torch.einsum("kl,lxiyj->kxiyj", wt, tiles[l0:l1])
        out[z, : c_hi - c_lo + 1] = torch.einsum("kxiyj,xia,yjb->kxyab", blend, Mx, My)
    return out


def _dp_gather(part, Tc, CX, CY, X, slab, L, x0=0, local=False):
    """dP (Tc, CX, CY) of one field from its blocks' partials: each window
    added where it lies, in the order slab, x tile, y tile (the cells no
    window holds stay 0)."""
    nz, _, nbx, nby, DWA, DWB = part.shape
    local = int(bool(local))
    shift = x0 & 1 if local else 0
    u_base = [(x0 - shift + b * _TILE_X) // 2 - 1 for b in range(nbx)]
    v_base = [b * _TILE_Y // 2 - 1 for b in range(nby)]
    out = torch.zeros((Tc, CX, CY), dtype=part.dtype, device=part.device)
    for z in range(nz):
        _, _, c_lo, c_hi = _dp_slab_rows(z, slab, L + local, local, Tc)
        for bx in range(nbx):
            a = torch.tensor([(u_base[bx] + w) % CX for w in range(DWA)], device=part.device)
            for by in range(nby):
                bs = [v_base[by] + w for w in range(DWB)]
                keep = [w for w, b in enumerate(bs) if 0 <= b < CY]
                win = part[z, : c_hi - c_lo + 1, bx, by][:, :, keep]
                rows = out[c_lo : c_hi + 1]
                rows[:, :, [bs[w] for w in keep]] = rows[:, :, [bs[w] for w in keep]].index_add(1, a, win)
    return out


def _dp_fused_plain(dfine, Tc, slab, x0=0, Xg=None, local=False):
    """dP of one field by the kernel's route: ``_dp_gather`` of
    ``_dp_partials``.  It equals ``_down_rows`` of the same cotangent up to
    the order of the float sums."""
    L, X, Y = dfine.shape
    Xg = X if Xg is None else Xg
    part = _dp_partials(dfine, Tc, slab, x0, Xg, local)
    return _dp_gather(part, Tc, Xg // 2, Y // 2, X, slab, L, x0, local)


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
        ("dp_part", ctypes.c_void_p),
        ("ticket", ctypes.c_void_p),
    ] + [(n, ctypes.c_int) for n in ("T", "X", "Y", "Tc", "CX", "CY", "slab", "nterms", "has_x", "has_t")] + [
        ("f0", ctypes.c_float * 3),
    ] + [
        (n, ctypes.c_float)
        for n in ("inv_dt", "inv_dx", "inv_dy", "inv_dx2", "inv_dy2", "kimp", "kimp_dx", "kxreg", "kt")
    ]


class _Mg2Args(ctypes.Structure):
    """Mirror of ``struct Mg2Args`` in csrc/rowwise_mg.cu (the two-level
    kernel's arguments)."""

    _fields_ = [("base", _MgArgs), ("t1", ctypes.c_void_p * 3), ("dP2", ctypes.c_void_p * 3)] + [
        (n, ctypes.c_int) for n in ("Tc2", "CX2", "CY2")
    ] + [("f1", ctypes.c_float * 3)]


class _MgLocalArgs(ctypes.Structure):
    """Mirror of ``struct MgLocalArgs`` in csrc/rowwise_mg.cu (the
    local-block kernel's arguments): MgArgs over the block (T = Tl, X = Xe,
    Tc = Tcw) plus the heads, their cotangents and the halo layer."""

    _fields_ = [("base", _MgArgs), ("heads", ctypes.c_void_p * 3), ("dheads", ctypes.c_void_p * 3),
                ("mask", ctypes.c_void_p)] + [(n, ctypes.c_int) for n in ("x0", "Xg", "off", "Tg", "r_lo", "r_hi")]


def _library():
    return _typed(_build.load("rowwise_mg"))


def _typed(lib):
    """A library built from csrc/rowwise_mg.cu with its entry points typed,
    its argument structs and tile checked against the mirrors here, and the
    blocks the card holds at once (``_odil_resident``), once."""
    if not getattr(lib, "_odil_typed", False):
        lib.odil_mg_num_blocks.argtypes = [ctypes.c_int] * 4
        lib.odil_mg_num_blocks.restype = ctypes.c_int
        lib.odil_mg_dp_floats.argtypes = [ctypes.c_int] * 4
        lib.odil_mg_dp_floats.restype = ctypes.c_longlong
        lib.odil_mg_resident_blocks.argtypes = []
        lib.odil_mg_resident_blocks.restype = ctypes.c_int
        lib.odil_mg_tile.argtypes = [ctypes.c_int]
        lib.odil_mg_tile.restype = ctypes.c_int
        lib.odil_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odil_cuda_error_string.restype = ctypes.c_char_p
        lib.odil_mg_forward.argtypes = [ctypes.POINTER(_MgArgs), ctypes.c_void_p]
        lib.odil_mg_forward.restype = ctypes.c_int
        for name, struct in (
            ("odil_mg_backward", _MgArgs), ("odil_mg_backward2", _Mg2Args), ("odil_mg_backward_local", _MgLocalArgs)
        ):
            getattr(lib, name).argtypes = [ctypes.POINTER(struct), ctypes.c_int, ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int
        for name, struct in (
            ("odil_mg_args_size", _MgArgs), ("odil_mg2_args_size", _Mg2Args), ("odil_mg_local_args_size", _MgLocalArgs)
        ):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
            size = getattr(lib, name)()
            if size != ctypes.sizeof(struct):
                raise RuntimeError(f"{struct.__name__} layout mismatch: C {size} vs ctypes {ctypes.sizeof(struct)} bytes")
        tile = (lib.odil_mg_tile(0), lib.odil_mg_tile(1))
        if tile != (_TILE_X, _TILE_Y):
            raise RuntimeError(f"the mg walk's tile is {tile} in C and {(_TILE_X, _TILE_Y)} in _dp_partials")
        lib._odil_resident = max(int(lib.odil_mg_resident_blocks()), 1)
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


@functools.lru_cache(maxsize=64)
def _mg_slab(T, X, Y, resident):
    """Rows per block of the mg walk over T walked rows and X, Y columns
    (``rowwise._wave_slab``): whole waves of the ``resident`` blocks the card
    holds at once (``odil_mg_resident_blocks``), counting the two rows a
    block rebuilds before its first."""
    return _wave_slab(T, -(-X // _TILE_X) * -(-Y // _TILE_Y), resident, 2)


def _launch_args(model, f0s, t0s, coarse, consts, g, dt0, dP, scratch, nterms, slab, lvl2=None):
    """The kernel's argument struct; with lvl2 = (t1s, f1s, dP2) the
    two-level kernel's (``_Mg2Args``), whose ``coarse`` is P2 and ``dP``
    receives dP1.  slab, scratch: ``_launch_plan``'s."""
    T, X, Y = t0s[0].shape
    ptr = lambda ts: (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts] if ts else [])
    Tc, CX, CY = (coarse if lvl2 is None else lvl2[0])[0].shape
    partials, sums, dp_part, ticket = scratch
    args = _MgArgs(
        t0=ptr(t0s), P=ptr(coarse), u_init=consts[0].data_ptr(), u_final=consts[1].data_ptr(),
        g=g.data_ptr() if g is not None else None, dt0=ptr(dt0), dP=ptr(dP),
        partials=partials.data_ptr(), sums=sums.data_ptr(), dp_part=dp_part.data_ptr(), ticket=ticket.data_ptr(),
        T=T, X=X, Y=Y, Tc=Tc, CX=CX, CY=CY, slab=slab, f0=(ctypes.c_float * 3)(*f0s),
        **_veltracer_scalars(model, nterms),
    )
    if lvl2 is None:
        return args
    t1s, f1s, dP2 = lvl2
    Tc2, CX2, CY2 = coarse[0].shape
    return _Mg2Args(base=args, t1=ptr(t1s), dP2=ptr(dP2), Tc2=Tc2, CX2=CX2, CY2=CY2, f1=(ctypes.c_float * 3)(*f1s))


def _launch_plan(lib, T, X, Y, dev, grads=True):
    """(slab, scratch, stream) of a launch over T walked rows and X
    columns on the current stream of dev: the slab (``_mg_slab``), the
    (partials, sums, dP partials, ticket) buffers (``odil_mg_num_blocks``)
    and the stream's raw handle."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    slab = _mg_slab(T, X, Y, lib._odil_resident)
    partials = torch.empty((lib.odil_mg_num_blocks(T, X, Y, slab), _MAXTERMS), dtype=torch.float64, device=dev)
    sums = torch.empty((_MAXTERMS,), dtype=torch.float32, device=dev)
    dp_part = torch.empty((lib.odil_mg_dp_floats(T, X, Y, slab) if grads else 1,), dtype=torch.float32, device=dev)
    return slab, (partials, sums, dp_part, _ticket(dev, stream)), stream


def forward_mg_cuda(model, nterms, hist, f0s, t0s, coarse, consts):
    """CUDA forward kernel (replaces ``_forward_mg``): (nterms,) sums of
    squares of the residual rows, on the current stream."""
    _check_cuda_inputs(model, t0s, coarse, consts, hist)
    lib = _library()
    T, X, Y = t0s[0].shape
    slab, scratch, stream = _launch_plan(lib, T, X, Y, t0s[0].device, grads=False)
    args = _launch_args(model, f0s, t0s, coarse, consts, None, None, None, scratch, nterms, slab)
    err = lib.odil_mg_forward(ctypes.byref(args), stream)
    _raise_on(lib, err, "odil_mg_forward")
    forward_mg_cuda.launches += 1
    return scratch[1][:nterms]


forward_mg_cuda.launches = 0


def backward_mg_cuda(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums):
    """CUDA backward kernel (replaces ``_backward_mg``): (dt0, dP, sums or
    None) for the loss sum_k g[k] * S[k], on the current stream."""
    out = _launch_backward(_library(), model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums)
    backward_mg_cuda.launches += 1
    backward_mg_cuda.launches_with_sums += bool(with_sums)
    return out


backward_mg_cuda.launches = 0
backward_mg_cuda.launches_with_sums = 0  # the launches that also formed the sums


def _launch_backward(lib, model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums):
    """The backward walk of ``lib`` (the library of every path, or an
    ablation build of ``ops/mg_ablation.py``) on checked inputs."""
    _check_cuda_inputs(model, t0s, coarse, consts, hist)
    if any(f == 0.0 for f in f0s):
        raise ValueError("the CUDA mg kernel needs nonzero level-0 factors")
    g = g.to(torch.float32).contiguous()
    if not g.is_cuda or g.numel() < nterms:
        raise ValueError("g must hold nterms weights on the card")
    T, X, Y = t0s[0].shape
    slab, scratch, stream = _launch_plan(lib, T, X, Y, t0s[0].device)
    dt0 = tuple(torch.empty_like(t) for t in t0s)
    dP = tuple(torch.empty_like(c) for c in coarse)
    args = _launch_args(model, f0s, t0s, coarse, consts, g, dt0, dP, scratch, nterms, slab)
    err = lib.odil_mg_backward(ctypes.byref(args), int(bool(with_sums)), stream)
    _raise_on(lib, err, "odil_mg_backward")
    return dt0, dP, (scratch[1][:nterms] if with_sums else None)


def _check_cuda_inputs2(model, t0s, t1s, P2, consts, hist):
    _check_veltracer_model(model, hist)
    if len(t0s) != 3 or len(t1s) != 3 or len(P2) != 3 or len(consts) != 2:
        raise ValueError("the veltracer CUDA kernel takes 3 fields and 2 const planes")
    T, X, Y = t0s[0].shape
    if T % 4 != 1 or T < 5 or X % 4 or Y % 4 or X < 8 or Y < 8:
        raise ValueError(f"the two-level CUDA mg kernel takes T = 4k+1 >= 5 and X, Y divisible by 4 and >= 8, "
                         f"got {(T, X, Y)}")
    _check_cuda_tensors(tuple(t0s) + tuple(t1s) + tuple(P2) + tuple(consts), "mg")
    Tc = T // 2 + 1
    want = [(T, X, Y)] * 3 + [(Tc, X // 2, Y // 2)] * 3 + [(Tc // 2 + 1, X // 4, Y // 4)] * 3 + [(X, Y)] * 2
    got = [tuple(t.shape) for t in tuple(t0s) + tuple(t1s) + tuple(P2) + tuple(consts)]
    if got != want:
        raise ValueError(f"the two-level CUDA mg kernel takes shapes {want}, got {got}")


def backward_mg2_cuda(model, nterms, hist, f0s, f1s, t0s, t1s, P2, consts, g, with_sums):
    """CUDA two-level backward kernel (replaces ``_backward_mg`` with
    ``lvl2``, and the split of its dP1 output): (dt0, dt1, dP2, sums or None)
    for the loss sum_k g[k] * S[k], on the current stream."""
    _check_cuda_inputs2(model, t0s, t1s, P2, consts, hist)
    if any(f == 0.0 for f in f0s):
        raise ValueError("the CUDA mg kernel needs nonzero level-0 factors")
    g = g.to(torch.float32).contiguous()
    if not g.is_cuda or g.numel() < nterms:
        raise ValueError("g must hold nterms weights on the card")
    lib = _library()
    T, X, Y = t0s[0].shape
    slab, scratch, stream = _launch_plan(lib, T, X, Y, t0s[0].device)
    dt0 = tuple(torch.empty_like(t) for t in t0s)
    dP1 = tuple(torch.empty_like(t) for t in t1s)
    dP2 = tuple(torch.empty_like(c) for c in P2)
    args = _launch_args(model, f0s, t0s, P2, consts, g, dt0, dP1, scratch, nterms, slab, lvl2=(t1s, f1s, dP2))
    err = lib.odil_mg_backward2(ctypes.byref(args), int(bool(with_sums)), stream)
    _raise_on(lib, err, "odil_mg_backward2")
    backward_mg2_cuda.launches += 1
    dt1 = tuple(f * d for f, d in zip(f1s, dP1))
    return dt0, dt1, dP2, (scratch[1][:nterms] if with_sums else None)


backward_mg2_cuda.launches = 0


def _check_local_inputs(model, t0s, coarse, heads, consts, hist):
    _check_veltracer_model(model, hist)
    if model.halo is None:
        raise ValueError("the local-block mg kernel takes a halo_model")
    if len(t0s) != 3 or len(coarse) != 3 or len(heads) != 3 or len(consts) != 2:
        raise ValueError("the veltracer CUDA kernel takes 3 fields, 3 heads and 2 const planes")
    Tl, Xe, Y = t0s[0].shape
    Tcw, CX, CY = coarse[0].shape
    if Tl % 2 == 0 or Tl < 3 or Xe < 4 or Xe > 2 * CX or Y % 2 or Y < 4 or CY != Y // 2:
        raise ValueError(f"the local-block mg kernel takes odd Tl >= 3, 4 <= Xe <= X and even Y >= 4, got "
                         f"{(Tl, Xe, Y)} with coarse {(Tcw, CX, CY)}")
    mask = model.halo[0]
    _check_cuda_tensors(tuple(t0s) + tuple(coarse) + tuple(heads) + tuple(consts) + (mask,), "mg")
    want = [(Tl, Xe, Y)] * 3 + [((Tl - 1) // 2 + 1, CX, CY)] * 3 + [(hist, Xe, Y)] * 3 + [(Xe, Y)] * 3
    got = [tuple(t.shape) for t in tuple(t0s) + tuple(coarse) + tuple(heads) + tuple(consts) + (mask,)]
    if got != want:
        raise ValueError(f"the local-block mg kernel takes shapes {want}, got {got}")


def backward_mg_local_cuda(model, nterms, hist, f0s, t0s, coarse, heads, x0, consts, g):
    """CUDA local-block backward kernel with the sums (replaces
    ``_backward_mg`` with ``wraps_in``/``emit_dwraps``, and serves
    ``rowwise_mg_local_tiled._loss_and_grads_local_tiled``): (dt0, dP,
    dheads, sums) for the loss sum_k g[k] * S[k] of a ``halo_model``, on the
    current stream."""
    _check_local_inputs(model, t0s, coarse, heads, consts, hist)
    if any(f == 0.0 for f in f0s):
        raise ValueError("the CUDA mg kernel needs nonzero level-0 factors")
    g = g.to(torch.float32).contiguous()
    if not g.is_cuda or g.numel() < nterms:
        raise ValueError("g must hold nterms weights on the card")
    lib = _library()
    Tl, Xe, Y = t0s[0].shape
    dev = t0s[0].device
    # Xe + (x0 & 1): the kernel's tiles start at even global columns (one
    # more column when x0 is odd).
    slab, scratch, stream = _launch_plan(lib, Tl + hist, Xe + (int(x0) & 1), Y, dev)
    dt0 = tuple(torch.empty_like(t) for t in t0s)
    dP = tuple(torch.empty_like(c) for c in coarse)
    dheads = tuple(torch.empty_like(h) for h in heads)
    base = _launch_args(model, f0s, t0s, coarse, consts, g, dt0, dP, scratch, nterms, slab)
    mask, off, Tg, r_lo, r_hi = model.halo
    ptr = lambda ts: (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])
    args = _MgLocalArgs(base=base, heads=ptr(heads), dheads=ptr(dheads), mask=mask.data_ptr(), x0=int(x0),
                        Xg=2 * coarse[0].shape[1], off=off, Tg=Tg, r_lo=max(r_lo, 0), r_hi=r_hi)
    err = lib.odil_mg_backward_local(ctypes.byref(args), 1, stream)
    _raise_on(lib, err, "odil_mg_backward_local")
    backward_mg_local_cuda.launches += 1
    return dt0, dP, dheads, scratch[1][:nterms]


backward_mg_local_cuda.launches = 0


# -- Dispatch ------------------------------------------------------------------


def _forward_mg(model, nterms, hist, f0s, t0s, coarse, consts):
    if _kernel_route(model, t0s[0]):
        return forward_mg_cuda(model, nterms, hist, f0s, _contig(t0s), _contig(coarse), _contig(consts))
    return _plain(_forward_mg_plain, t0s[0], model, nterms, hist, f0s, t0s, coarse, consts)


def _backward_mg(model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums=False):
    if _kernel_route(model, t0s[0]):
        return backward_mg_cuda(
            model, nterms, hist, f0s, _contig(t0s), _contig(coarse), _contig(consts), g, with_sums
        )
    return _plain(_backward_mg_plain, t0s[0], model, nterms, hist, f0s, t0s, coarse, consts, g, with_sums)


def _backward_mg2(model, nterms, hist, f0s, f1s, t0s, t1s, P2, consts, g, with_sums=False):
    """(dt0, dt1, dP2, sums or None) of the two-level fusion."""
    if _kernel_route(model, t0s[0]):
        return backward_mg2_cuda(
            model, nterms, hist, f0s, f1s, _contig(t0s), _contig(t1s), _contig(P2), _contig(consts), g, with_sums
        )
    dt0, dP1, sums = _plain(_backward_mg_plain, t0s[0], model, nterms, hist, f0s, t0s, P2, consts, g, with_sums,
                            (t1s, f1s))
    with torch.no_grad():
        W1x, W1y = _interp_matrices(*P2[0].shape[1:], P2[0].dtype, P2[0].device)
        dt1, dP2 = _split_dp1(dP1, f1s, W1x, W1y)
    return dt0, dt1, dP2, sums


def _backward_mg_local(model, nterms, hist, f0s, t0s, coarse, heads, x0, consts, g):
    if _kernel_route(model, t0s[0]):
        return backward_mg_local_cuda(
            model, nterms, hist, f0s, _contig(t0s), _contig(coarse), _contig(heads), x0, _contig(consts), g
        )
    return _plain(_backward_mg_local_plain, t0s[0], model, nterms, hist, f0s, t0s, coarse, heads, x0, consts, g)


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


def rowwise_mg_loss_and_grads(row_fn, t0s, coarse, factors0, consts=(), nterms=1, hist=1, t1s=None, factors1=None):
    """One-pass fused loss AND gradients for the training step.

    Returns (terms, (dt0, dcoarse, ())) where terms[k] = mean(residual_k^2)
    and the gradients are of ``sum_k terms[k]``.  Not differentiable (it IS
    the gradient); for a differentiable loss use ``rowwise_loss_terms_mg``.

    t1s/factors1 (with ``coarse`` the level-2 partial P2) switch on the
    two-level fusion: returns (terms, (dt0, dt1, dP2, ()))."""
    model = _as_model(row_fn)
    if t1s is not None:
        t0s, t1s, P2 = tuple(t0s), tuple(t1s), tuple(coarse)
        T, X, Y = t0s[0].shape
        Tc1, CX1, CY1 = t1s[0].shape
        Tc2, CX2, CY2 = P2[0].shape
        assert T == 2 * (Tc1 - 1) + 1 and Tc1 == 2 * (Tc2 - 1) + 1, (T, Tc1, Tc2)
        assert (CX1, CY1) == (X // 2, Y // 2) and (CX2, CY2) == (CX1 // 2, CY1 // 2)
        assert T > 2 * hist
        f0s, f1s, cells = tuple(float(f) for f in factors0), tuple(float(f) for f in factors1), T * X * Y
        g = torch.full((nterms,), 1.0 / cells, dtype=t0s[0].dtype, device=t0s[0].device)
        dt0, dt1, dP2, sums = _backward_mg2(model, nterms, hist, f0s, f1s, t0s, t1s, P2, consts, g, with_sums=True)
        return tuple((sums / cells).unbind()), (dt0, dt1, dP2, ())
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


def rowwise_mg_local_loss_and_grads(row_fn, t0s, coarse, factors0, heads, x0=0, consts=(), nterms=1, hist=1,
                                    gscale=1.0):
    """One-pass fused loss sums AND gradients on ONE shard's local block --
    the ``--halo`` form of ``rowwise_mg_loss_and_grads`` (``halo.py`` builds
    the localization around it; ``odil_tpu/ops/rowwise_mg.py:965``).

    row_fn: a ``rowwise.halo_model`` whose rows are the block's (global row
            offset, global T, plane mask, the block's own rows).
    t0s:    per-field level-0 term blocks (Tl, Xe, Y), Tl odd.
    coarse: per-field time windows of the level-1 partial, (Tcw, X//2, Y//2),
            Tcw = (Tl-1)//2 + 1, window row 0 at global row g0/2 (g0 even).
    heads:  per-field (hist, Xe, Y) fine rows preceding local row 0.
    x0:     the global column of local column 0 (periodic in X); the JAX
            package passes the gathered rows ``Wx`` of the prolongation
            matrix instead, and ``Wy`` whole -- both follow from x0 and the
            coarse shape.
    gscale: the 1/cells_global loss weight.

    Returns ``(sums, (dt0, dcoarse, dheads, dparams))``: local per-term sums
    of squares (sum them over the shards) and the cotangents of the local
    inputs."""
    model = _as_model(row_fn)
    t0s, coarse, heads = tuple(t0s), tuple(coarse), tuple(heads)
    Tl = t0s[0].shape[0]
    Tcw = coarse[0].shape[0]
    assert t0s[0].ndim == 3, "mg-fused kernel supports 3D (t, x, y) fields"
    assert Tl % 2 == 1 and Tcw == (Tl - 1) // 2 + 1, (Tl, Tcw)
    assert Tl > 2 * hist and hist >= 1, (Tl, hist)
    for h in heads:
        assert tuple(h.shape) == (hist,) + tuple(t0s[0].shape[1:]), (tuple(h.shape),)
    f0s = tuple(float(f) for f in factors0)
    g = torch.full((nterms,), gscale, dtype=t0s[0].dtype, device=t0s[0].device)
    dt0, dP, dheads, sums = _backward_mg_local(model, nterms, hist, f0s, t0s, coarse, heads, x0, tuple(consts), g)
    return sums, (dt0, dP, dheads, ())
