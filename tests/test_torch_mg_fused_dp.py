"""The mg backward's dP route as the CUDA walk forms it -- per-block windows
of the transposed t-blend and x/y taps, and their fixed-order gather --
in its plain version (``rowwise_mg._dp_partials``/``_dp_gather``), against
the plain backward's ``_down_rows`` and against the JAX package's
``_backward_mg`` in interpret mode.  The shapes take two slabs, two x tiles
and two y tiles, so that every kind of shared coarse cell occurs.

Tolerances: fp64, the same cotangent summed in another order (rtol 1e-12
against the port's plain backward, 1e-10 against the JAX package)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.models import veltracer as tvt
from odil_torch.ops import rowwise as trw
from odil_torch.ops import rowwise_mg as trmg
from odil_tpu.backend import ModJax
from odil_tpu.models import veltracer as jvt
from odil_tpu.ops import rowwise_mg as jrmg
from odil_tpu.transfer import _interp_matrix

K = dict(kimp=10.0, kxreg=0.01, ktreg=1.0)
F0, F1 = (0.7, 1.1, 0.9), (1.3, 0.6, 0.8)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * max(1.0, float(np.abs(want).max())))


def _models(step):
    jfn = jvt._make_row_fn(ModJax(), *step, K["kimp"], K["kxreg"], K["ktreg"])
    dt, dx, dy = step
    model = trw.RowModel(tvt._make_row_fn(*step, **K), tvt._make_row_vjp(*step, **K), cuda_model="veltracer",
                         scalars=dict(dt=dt, dx=dx, dy=dy, **K))
    return jfn, model


def _inputs(rng, *shapes):
    return [tuple(0.3 * rng.normal(size=s) for _ in range(3)) for s in shapes]


@pytest.mark.parametrize("depth", [1, 2])
def test_fused_dp_whole_plane(depth):
    """A whole plane (17, 32, 40): two slabs of 9 rows, 2 x 2 tiles; at depth
    2 the route forms dP1, the level-1 cotangent."""
    T, X, Y = 17, 32, 40
    Tc = T // 2 + 1
    rng = np.random.default_rng(depth)
    t0s, coarse = _inputs(rng, (T, X, Y), (Tc, X // 2, Y // 2) if depth == 1 else (Tc // 2 + 1, X // 4, Y // 4))
    t1s = _inputs(rng, (Tc, X // 2, Y // 2))[0] if depth == 2 else None
    consts = tuple(rng.normal(size=(X, Y)) for _ in range(2))
    g = np.linspace(0.5, 1.5, 6) / (T * X * Y)
    jfn, model = _models((1.0 / 16, 1.0 / X, 1.0 / Y))
    tt = lambda xs: tuple(torch.as_tensor(a) for a in xs)
    lvl2 = (tt(t1s), F1) if depth == 2 else None
    fines, _, _ = trmg._fines(tt(t0s), tt(coarse), F0, lvl2)
    dfines, _, _ = trw._backward_plain(model, 6, 1, fines, (), (), tt(consts), torch.as_tensor(g), False)
    slab = 9  # two slabs of the 17 rows
    fused = [trmg._dp_fused_plain(d, Tc, slab) for d in dfines]
    assert trmg._dp_partials(dfines[0], Tc, slab).shape[:4] == (2, 6, 2, 2)
    _, dP, _, _ = trmg._backward_mg_plain(model, 6, 1, F0, tt(t0s), tt(coarse), tt(consts), torch.as_tensor(g), False,
                                          lvl2=lvl2)
    for a, b in zip(fused, dP):
        _close(a.numpy(), b.numpy(), 1e-12)
    j = lambda xs: tuple(jnp.asarray(a) for a in xs)
    W = lambda n: jnp.asarray(_interp_matrix(n, "c", np.float64))
    jlvl2 = (j(t1s), F1, W(X // 4), W(Y // 4)) if depth == 2 else None
    _, jdP, _ = jrmg._backward_mg(jfn, 6, 1, F0, True, j(t0s), j(coarse), W(X // 2), W(Y // 2), (), (), j(consts),
                                  jnp.asarray(g), with_sums=False, lvl2=jlvl2)
    for a, b in zip(fused, jdP):
        _close(a.numpy(), b, 1e-10)


def test_fused_dp_local_block_odd_x0():
    """A t:2,x:2 shard's local block with odd x0 = 15 (its tiles start one
    column before the block, at even global columns): (17, 18, 40) of a
    global (33, 32, 40), two slabs of the stack [heads; block]; the window
    of the coarse plane it reaches, the rest 0."""
    Tl, Xe, Y, X, x0, g0, Tg = 17, 18, 40, 32, 15, 16, 33
    rng = np.random.default_rng(7)
    t0s, coarse, heads = _inputs(rng, (Tl, Xe, Y), ((Tl - 1) // 2 + 1, X // 2, Y // 2), (1, Xe, Y))
    consts = tuple(rng.normal(size=(Xe, Y)) for _ in range(2))
    mask = np.ones((Xe, Y))
    mask[:1] = mask[Xe - 1 :] = 0
    step = (1 / 32, 1 / X, 1 / Y)
    jrow, model = _models(step)
    cells = Tg * X * Y
    tt = lambda xs: tuple(torch.as_tensor(a) for a in xs)
    hm = trw.halo_model(model, torch.as_tensor(mask), g0, Tg, 1, Tl)
    g = torch.full((6,), 1.0 / cells, dtype=torch.float64)
    Tcw = coarse[0].shape[0]
    Wx = trmg._local_wx(X // 2, Xe, x0, torch.float64, "cpu")
    _, Wy = trmg._interp_matrices(Y // 2, Y // 2, torch.float64, "cpu")
    rows = [torch.cat([h, trmg._recon_rows(t, c, range(Tl), Wx, Wy, f)]) for t, c, h, f in
            zip(tt(t0s), tt(coarse), tt(heads), F0)]
    d, _, _ = trw._backward_plain(trmg._stacked_model(hm, 1), 6, 1, rows, (), (), tt(consts), g, True)
    slab = 9  # two slabs of the Tl + 1 rows of the stack
    fused = [trmg._dp_fused_plain(x[1:], Tcw, slab, x0, X, local=True) for x in d]
    assert trmg._dp_partials(d[0][1:], Tcw, slab, x0, X, local=True).shape[:4] == (2, 6, 2, 2)
    _, dP, _, _, _ = trmg._backward_mg_local_plain(hm, 6, 1, F0, tt(t0s), tt(coarse), tt(heads), x0, tt(consts), g)
    for a, b in zip(fused, dP):
        _close(a.numpy(), b.numpy(), 1e-12)

    def wrapped(it, _T, rows_, data_rows, pv, cons):
        pm, mt = cons[2], cons[3]
        res = jrow(it + mt[0, 0], Tg, rows_, data_rows, pv, cons[:2])
        m = pm * ((it != 0) | (mt[0, 1] > 0)).astype(pm.dtype)
        return tuple(r * m for r in res)

    meta = np.array([[g0, 0]], dtype=np.int32)
    jWx = _interp_matrix(X // 2, "c", np.float64)[(x0 + np.arange(Xe)) % X]
    _, (_, jdP, _, _) = jrmg.rowwise_mg_local_loss_and_grads(
        wrapped, t0s, coarse, jWx, _interp_matrix(Y // 2, "c", np.float64), F0, heads,
        consts=tuple(consts) + (mask, meta), nterms=6, hist=1, gscale=1.0 / cells, interpret=True,
    )
    for a, b in zip(fused, jdP):
        _close(a.numpy(), b, 1e-10)


@pytest.mark.parametrize("shape, resident, slab", [
    ((65, 256, 256), 396, 22), ((65, 512, 512), 396, 22), ((34, 130, 256), 396, 7), ((9, 16, 16), 4, 3),
])
def test_mg_slab_fills_whole_waves(shape, resident, slab):
    """The walk's slab (``_mg_slab``) runs the launch in the fewest
    row-times: the flagship's 8 x 16 tiles in 3 slabs of 22 rows are 384
    blocks, one wave of an H100's 396 resident blocks (3 an SM).  Every
    launch asks for it, so the choice is cached."""
    assert trmg._mg_slab(*shape, resident) == slab
    hits = trmg._mg_slab.cache_info().hits
    assert trmg._mg_slab(*shape, resident) == slab
    assert trmg._mg_slab.cache_info().hits == hits + 1
