"""The 1-D tile kernels' plain side on the CPU (``csrc/rows1d.cuh`` runs only
on the card):

- heat's face form (``models/heat.py::_make_row_vjp(faces=True)``: one
  network pass and one param adjoint a face, the two cells' conductivity
  cotangents added left then right, the wall faces per cell) against the JAX
  package's heat row function through ``jax.vjp``, fp64 (rtol 1e-10) and fp32
  (rtol 1e-4, atol 1e-6 * max|ref|);
- the wall faces and the faces whose two temperatures differ keep one pass
  a cell (fp64, rtol 1e-12 against the per-cell adjoint);
- the tile search (``ops/rowwise.py::_tile_rows``) and the veltracer slab
  search (``_wave_slab``): every cell covered once, whole waves, the least
  cost among the candidates;
- a plain model of the kernel's fixed order of the sums (each thread's cells
  and faces, the warps' shuffle tree, the warps in order, the last block's
  pass over the blocks) against ``_backward_plain``'s sums and param
  cotangents to fp64 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.context import Context
from odil_torch.models import heat as th
from odil_torch.models import wave as tw
from odil_torch.ops import rowwise as trw

# The heat configurations of tests/test_torch_gpu.py (HEAT_CASES).
HEAT_CASES = {
    "heat": dict(infer_k=True, imposed="random", nimp=40, kxreg=0.3, ktreg=0.2),
    "heat_lane": dict(infer_k=True, imposed="stripe", nimp=200),
    "heat_true_k": dict(infer_k=False, ktreg=0.5),
}
# The kernel's tile (csrc/rows1d.cuh: TILE, MAX_SLAB, NTHREADS).
TILE, MAX_SLAB, THREADS = 32, 30, 256


class _Captured(Exception):
    pass


def _jax_row(name, T, N, dtype):
    """The JAX package's heat row function with its params, data and consts
    at (T, N), captured from its ``operator_odil_fused``."""
    from odil_tpu import context as jctx
    from odil_tpu.models import heat as jh

    jp, js, _ = jh.build(nt=T, nx=N, dtype=dtype, multigrid=False, kernel="pallas", **HEAT_CASES[name])

    def capture(self, row_fn, keys, params=(), data=(), consts=(), nterms=1, **kw):
        raise _Captured(row_fn, params, data, consts, nterms)

    orig = jctx.Context.rowwise_terms
    jctx.Context.rowwise_terms = capture
    try:
        jp.make_loss_fn(js)[0](jp.domain.arrays_from_state(js), jp.tracers)
    except _Captured as c:
        return c.args
    finally:
        jctx.Context.rowwise_terms = orig
    raise AssertionError("the JAX heat operator made no row-wise call")


def _inputs(name, T, N, dtype, seed=5):
    """Seeded random fields and params, the JAX build's data and consts (the
    measured temperatures and the annealed weights drawn anew), as numpy."""
    row_fn, params, data, consts, nterms = _jax_row(name, T, N, dtype)
    rng = np.random.default_rng(seed + T * 7 + N)
    field = (0.3 * rng.normal(size=(T, N)) + 0.5).astype(dtype)
    params = [(3 * 0.3 * rng.normal(size=np.shape(p))).astype(dtype) for p in params]
    data = [np.asarray(d) for d in data]
    if data:
        data[1] = (0.3 * rng.normal(size=(T, N))).astype(dtype)
    consts = [np.asarray(c) for c in consts]
    consts[4] = np.full((1, 1), 0.7, dtype)
    consts[5] = np.full((1, 1), 1.3, dtype)
    weights = rng.uniform(0.5, 1.5, nterms).astype(dtype)
    return row_fn, field, params, data, consts, weights


def _torch_row_model(name, T, N, dtype, faces):
    p, s, e = th.build(nt=T, nx=N, dtype=dtype, multigrid=False, kernel="pallas", device="cpu", **HEAT_CASES[name])
    model, names, params = th._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
    a = e.args
    dt, dx = map(float, p.domain.step())
    imp_weight = model.scalars["imp_weight"]
    flags = (bool(e.imp_size), bool(a.kxreg), bool(a.ktreg), bool(a.infer_k), True, True)
    vjp = th._make_row_vjp(dt, dx, N, float(a.kmax), imp_weight, flags, model.scalars["layers"], faces=faces)
    return model, vjp, len(names)


def _stacks(field, T):
    """(it, rows) of the port's stacks: rows t and t-1 of the field."""
    it = torch.arange(T).view(T, 1)
    return it, ((field, torch.roll(field, 1, 0)),)


SHAPES = [(7, 5), (5, 1), (2, 3), (33, 257), (64, 64)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["fp64", "fp32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(HEAT_CASES))
def test_face_form_matches_jax_vjp(name, shape, dtype):
    """The face form's row cotangents and param cotangents against jax.vjp of
    the JAX package's heat row function (vmapped over the rows) with the
    weighted terms' cotangents."""
    T, N = shape
    row_fn, field, params, data, consts, w = _inputs(name, T, N, dtype)

    def rows_fn(cur, prev, ps):
        f = lambda it, c, p, *d: row_fn(it, T, ((c, p),), d, ps, tuple(jnp.asarray(x) for x in consts))
        return jax.vmap(f)(jnp.arange(T), cur, prev, *[jnp.asarray(d) for d in data])

    jcur = jnp.asarray(field)
    res, pull = jax.vjp(rows_fn, jcur, jnp.roll(jcur, 1, 0), [jnp.asarray(p) for p in params])
    cots = tuple(2 * w[k] * r for k, r in enumerate(res))
    jd_cur, jd_prev, jdp = pull(cots)

    model, vjp, nterms = _torch_row_model(name, T, N, dtype, faces=True)
    assert nterms == len(res)
    tt = lambda xs: tuple(torch.as_tensor(np.array(x)) for x in xs)
    it, rows = _stacks(torch.as_tensor(field), T)
    (d_cur, d_prev), dparams = vjp(it, T, rows, tt(data), tt(params), tt(consts), tt(cots))
    assert len(dparams) == len(params)
    rtol, atol = (1e-10, 0.0) if dtype == np.float64 else (1e-4, 1e-6)
    for got, want in zip([d_cur, d_prev] + list(dparams), [jd_cur, jd_prev] + list(jdp)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol * float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["consistent", "row0_disagrees", "one_cell"])
def test_wall_faces_are_per_cell(case):
    """The seam's wall faces never share a pass; where the two cells' initial
    temperatures disagree (random consts) row 0's faces keep one pass a
    cell; the face form then gives the per-cell adjoint's param cotangents
    (fp64, rtol 1e-12)."""
    T, N = (9, 1) if case == "one_cell" else (9, 12)
    model, per_cell, nterms = _torch_row_model("heat", T, N, np.float64, faces=False)
    _, faces, _ = _torch_row_model("heat", T, N, np.float64, faces=True)
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s))
    field = mk(T, N) + 0.5
    params = tuple(mk(*p) for p in ((5, 1), (5, 5), (1, 5), (5,), (5,), (1,)))
    u0 = mk(N)
    consts = [u0, torch.roll(u0, 1, 0), torch.roll(u0, -1, 0), torch.arange(N, dtype=torch.float64), mk(1, 1),
              mk(1, 1)]
    if case == "row0_disagrees":
        consts[1], consts[2] = mk(N), mk(N)
    data = ((mk(T, N) > 0).double(), mk(T, N))
    it, rows = _stacks(field, T)
    res = model.row_fn(it, T, rows, data, params, tuple(consts))
    cots = tuple(2 * float(k + 1) * r for k, r in enumerate(res))
    (c1, p1), d1 = per_cell(it, T, rows, data, params, tuple(consts), cots)
    (c2, p2), d2 = faces(it, T, rows, data, params, tuple(consts), cots)
    assert torch.equal(c1, c2) and torch.equal(p1, p2)
    for a, b in zip(d1, d2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=1e-12 * float(a.abs().max()))
    # The face temperatures as the kernel's face phase sees them.
    cur = [field, torch.roll(field, 1, -1), torch.roll(field, -1, -1)]
    first = it == 0
    prev = [torch.where(first, 2 * z - c, p) for c, p, z in zip(cur, [torch.roll(field, 1, 0), torch.roll(
        torch.roll(field, 1, 0), 1, -1), torch.roll(torch.roll(field, 1, 0), -1, -1)], consts[:3])]
    ix = consts[3]
    for row in (cur, prev):
        row[1] = torch.where(ix == 0, (row[2] - 6 * row[0]) / 3, row[1])
        row[2] = torch.where(ix == N - 1, (row[1] - 6 * row[0]) / 3, row[2])
    s0, s1, s2 = (c + p for c, p in zip(cur, prev))
    shared = th._shared_faces((s2 + s0) * 0.25, (s0 + s1) * 0.25)
    assert not bool(shared[:, N - 1].any())  # the seam
    if case == "consistent":
        assert bool(shared[:, : N - 1].all())
    if case == "row0_disagrees":
        assert not bool(shared[0].any()) and bool(shared[1:, : N - 1].all())


# -- The tile and slab searches ------------------------------------------------


def _tiles(T, N, slab, blocks):
    """{block: [(t0, x0), ...]}: the tiles each block takes, in order, as the
    kernel numbers them (x fastest) and deals them (b, b + blocks, ...)."""
    ntx, nty = -(-N // TILE), -(-T // slab)
    out = {b: [] for b in range(blocks)}
    for tile in range(ntx * nty):
        out[tile % blocks].append(((tile // ntx) * slab, (tile % ntx) * TILE))
    return out


def _cost(T, N, hist, grads, resident, slab):
    tiles = -(-N // TILE) * -(-T // slab)
    rows, width = (hist, TILE + 2) if grads else (0, TILE)
    return (-(-tiles // resident) * -(-(slab + rows) * width // THREADS), tiles)


@pytest.mark.parametrize("T, N, hist, grads, resident", [
    (64, 64, 1, True, 264), (1024, 1024, 1, True, 264), (1024, 1024, 2, True, 528), (64, 64, 2, False, 660),
    (1024, 1024, 1, False, 396), (2, 3, 2, True, 528), (2, 1, 1, True, 264), (5, 1, 1, False, 396),
    (65, 97, 2, True, 4), (3, 300, 1, True, 4), (33, 257, 1, True, 7),
])
def test_tile_rows_cover_every_cell_once(T, N, hist, grads, resident):
    """_tile_rows: slabs of at most MAX_SLAB rows that cover each cell of
    (T, N) exactly once over the blocks' rounds, no more blocks than the
    card holds (whole waves), and no candidate slab with a lower cost."""
    slab, blocks = trw._tile_rows(T, N, hist, grads, resident, TILE, MAX_SLAB, THREADS)
    assert 1 <= slab <= min(T, MAX_SLAB)
    ntiles = -(-N // TILE) * -(-T // slab)
    assert blocks == min(ntiles, resident)
    seen = np.zeros((T, N), dtype=int)
    for tiles in _tiles(T, N, slab, blocks).values():
        for t0, x0 in tiles:
            seen[t0 : t0 + slab, x0 : x0 + TILE] += 1
    assert (seen == 1).all()
    best = _cost(T, N, hist, grads, resident, slab)
    for cand in {-(-T // nz) for nz in range(1, T + 1)}:  # the balanced slabs
        assert cand > MAX_SLAB or _cost(T, N, hist, grads, resident, cand) >= best
    hits = trw._tile_rows.cache_info().hits
    trw._tile_rows(T, N, hist, grads, resident, TILE, MAX_SLAB, THREADS)
    assert trw._tile_rows.cache_info().hits == hits + 1


@pytest.mark.parametrize("T, tiles, resident, lead, slab", [
    (65, 256, 660, 1, 13), (65, 16, 660, 1, 2), (65, 1024, 660, 1, 13), (34, 136, 660, 1, 9), (65, 128, 396, 2, 22),
])
def test_wave_slab_fills_whole_waves(T, tiles, resident, lead, slab):
    """_wave_slab (the veltracer row kernels; the mg walk with two lead rows):
    the flagship's 256^2 launch stays on 13 rows (1280 blocks, two waves of
    an H100's 660), 64^3 takes 2-row slabs (528 blocks, one wave); the slabs
    cover T and no other slab count runs in fewer row-times."""
    assert trw._wave_slab(T, tiles, resident, lead) == slab
    nz = -(-T // slab)
    assert (nz - 1) * slab < T <= nz * slab
    cost = lambda s: -(-(-(-T // s)) * tiles // resident) * (s + lead)
    assert all(cost(-(-T // n)) >= cost(slab) for n in range(1, T + 1))


# -- The fixed order of the sums -----------------------------------------------


def _warp_tree(vals):
    """The sums of 32 lanes' values as the shuffle rounds form them: lane l
    adds lane l ^ o for o = 16, 8, 4, 2, 1."""
    v = list(vals)
    for o in (16, 8, 4, 2, 1):
        v = [v[lane] + v[lane ^ o] for lane in range(32)]
    return v[0]


def _block_sum(per_thread):
    """(K,) sums of a block's (THREADS, K) values: each warp's tree, then the
    warps in order."""
    warps = [np.array([_warp_tree(per_thread[w * 32 : (w + 1) * 32, k]) for k in range(per_thread.shape[1])])
             for w in range(THREADS // 32)]
    out = warps[0]
    for w in warps[1:]:
        out = out + w
    return out


def _param_terms(net_cache, g, layer_shapes, kmax):
    """(46, *g.shape): each element's param cotangent of g * k (the summands
    of models/heat.py::_make_net's param_vjp, weights then biases)."""
    hs, s, params = net_cache
    ws = params[:3]
    grads = [g * kmax * (s * (1 - s))]
    dws, dbs = [None] * 3, [None] * 3
    for li in (2, 1, 0):
        no, ni = layer_shapes[li]
        dws[li] = [grads[o] * hs[li][i] for o in range(no) for i in range(ni)]
        dbs[li] = [grads[o] for o in range(no)]
        if li:
            gin = [sum(ws[li][o, i] * grads[o] for o in range(no)) for i in range(ni)]
            grads = [gi * (1 - h * h) for gi, h in zip(gin, hs[li])]
    return torch.stack([x * torch.ones_like(g) for x in sum(dws, []) + sum(dbs, [])])


@pytest.mark.parametrize("name, T, N, slab, blocks", [
    ("heat", 9, 70, 4, 3), ("heat", 7, 5, 3, 1), ("heat_lane", 33, 40, 8, 5), ("wave", 9, 70, 4, 3),
    ("wave", 2, 3, 2, 1),
])
def test_sums_in_the_kernels_order(name, T, N, slab, blocks):
    """A plain model of the kernel's order (fp64): the residual cells by
    thread as the cell phase deals them, the faces by thread as the face
    adjoint deals them (the two cells' cotangents left then right where they
    share the face's temperature), each block's sums by the warps' shuffle
    tree then the warps in order, the last block's pass over the blocks;
    against _backward_plain's sums and param cotangents."""
    hist = 2 if name == "wave" else 1
    rng = np.random.default_rng(11)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s))
    if name == "wave":
        p, st, e = tw.build(nt=T, nx=N, dtype=np.float64, multigrid=False, kernel="pallas", device="cpu")
        model, nparams = tw._row_model(Context(p.domain, st, extra=e, tracers=p.tracers)), 0
        fields, params, data = (mk(T, N),), (), (mk(T, 1), mk(T, 1))
        consts = (mk(N), mk(N), torch.arange(N, dtype=torch.float64))
        nterms = 1
    else:
        p, st, e = th.build(nt=T, nx=N, dtype=np.float64, multigrid=False, kernel="pallas", device="cpu",
                            **HEAT_CASES[name])
        model, names, params = th._row_model(Context(p.domain, st, extra=e, tracers=p.tracers))
        nterms, nparams = len(names), 46
        fields = (mk(T, N) + 0.5,)
        params = tuple(mk(*q.shape) for q in params)
        data = (e.imp_mask, mk(T, N)) if e.imp_size else ()
        u0 = mk(N)
        consts = (u0, torch.roll(u0, 1, 0), torch.roll(u0, -1, 0), torch.arange(N, dtype=torch.float64), mk(1, 1),
                  mk(1, 1))
    g = torch.linspace(0.5, 1.5, nterms, dtype=torch.float64) / (T * N)
    _, want_dp, want_sums = trw._backward_plain(model, nterms, hist, fields, params, data, consts, g, True)

    # Per cell: the squared terms; per cell and face side, the param summands.
    it, rows = torch.arange(T).view(T, 1), trw._row_stacks(fields, hist)
    res = model.row_fn(it, T, rows, data, params, consts)
    sq = torch.stack([r * r * torch.ones(T, N, dtype=torch.float64) for r in res])  # (nterms, T, N)
    if nparams:
        s = model.scalars
        dt, dx, kmax, layers = s["dt"], s["dx"], s["kmax"], s["layers"]
        net_forward = th._make_net(layers, kmax)[0]
        cur, prev = rows[0]
        ix = consts[3]
        c = [cur, torch.roll(cur, 1, -1), torch.roll(cur, -1, -1)]
        q = [torch.where(it == 0, 2 * z - a, b) for a, b, z in zip(c, [prev, torch.roll(prev, 1, -1), torch.roll(
            prev, -1, -1)], consts[:3])]
        for row in (c, q):
            row[1] = torch.where(ix == 0, (row[2] - 6 * row[0]) / 3, row[1])
            row[2] = torch.where(ix == N - 1, (row[1] - 6 * row[0]) / 3, row[2])
        s0, s1, s2 = (a + b for a, b in zip(c, q))
        u_right, u_left = (s2 + s0) * 0.25, (s0 + s1) * 0.25
        w0 = 2 * g[0] * res[0]
        g_left, g_right = w0 * (s0 - s1) / (2 * dx) / dx, -w0 * (s2 - s0) / (2 * dx) / dx  # of km, kp
        shared = th._shared_faces(u_right, u_left)
        at_right = _param_terms(net_forward(u_right, params)[1], torch.ones_like(u_right), layers, kmax)
        at_left = _param_terms(net_forward(u_left, params)[1], torch.ones_like(u_left), layers, kmax)

    K = nterms + nparams
    partials = []
    for b, tiles in _tiles(T, N, slab, blocks).items():
        acc = np.zeros((THREADS, K))
        for t0, x0 in tiles:
            nown = min(slab, T - t0)
            # The cell phase: window cell i of residual row r, by idx.
            for idx in range((nown + hist) * (TILE + 2)):
                r, i = divmod(idx, TILE + 2)
                if 1 <= i <= TILE and x0 + i - 1 < N and r < nown:
                    acc[idx % THREADS, :nterms] += sq[:, t0 + r, x0 + i - 1].numpy()
            # The face adjoint: face j between window cells j-1 and j.
            for idx in range(nown * (TILE + 1)) if nparams else ():
                r, j = idx // (TILE + 1), 1 + idx % (TILE + 1)
                t, xa, xb = t0 + r, x0 + j - 2, x0 + j - 1
                gl = float(g_right[t, xa % N]) if j - 1 >= 1 and xa < N else 0.0
                gr = float(g_left[t, xb % N]) if j <= TILE and xb < N else 0.0
                if gl == 0.0 and gr == 0.0:
                    continue
                if bool(shared[t, xa % N]):
                    acc[idx % THREADS, nterms:] += (gl + gr) * at_right[:, t, xa % N].numpy()
                else:
                    acc[idx % THREADS, nterms:] += gl * at_right[:, t, xa % N].numpy()
                    acc[idx % THREADS, nterms:] += gr * at_left[:, t, xb % N].numpy()
        partials.append(_block_sum(acc))
    last = np.zeros((THREADS, K))
    for b, part in enumerate(partials):
        last[b % THREADS] += part
    got = _block_sum(last)
    np.testing.assert_allclose(got[:nterms], want_sums.numpy(), rtol=1e-12)
    if nparams:
        want = torch.cat([d.reshape(-1) for d in want_dp]).numpy()
        np.testing.assert_allclose(got[nterms:], want, rtol=1e-10, atol=1e-12 * float(np.abs(want).max()))
