"""Plain models of the veltracer row kernel's maps (``rows_kernel`` of
``odil_torch/csrc/rowwise.cu``), on the CPU:

- the tile map: 16 x 32 tiles on 8 x 32 threads, two cells a thread (rows
  r and r + 8), cover every cell of (T, X, Y) exactly once, also where a
  tile owns only part of its rows and on planes narrower than a tile; each
  tile's staged rows and columns (the 16-byte copies of the owned columns
  where the tile row allows them, 4-byte copies through the index tables
  else) hold the periodic halo its cells read;
- the ring of rows: every iteration finds rows t-1, t and t+1 in their
  slots after its wait, and the slot it refills holds a row no later
  iteration reads;
- the slab search (``ops/rowwise.py::_wave_slab``) against a brute force
  over its cost at the new tile counts;
- the last block's batched pass over the partials adds them in the order of
  the pass per term, bit for bit in fp64.

The tile constants are read from the kernel's source, so the models follow
it.
"""

import os
import re

import numpy as np
import pytest

from odil_torch.ops import rowwise as trw

_SRC = os.path.join(os.path.dirname(trw.__file__), os.pardir, "csrc")


def _constants():
    """The row kernel's tile (the #defines of rowwise.cu before its include
    of veltracer_row.cuh) and ring (NSLOT, AHEAD)."""
    with open(os.path.join(_SRC, "rowwise.cu")) as fh:
        text = fh.read()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", text).group(1))
    nslot = int(re.search(r"constexpr int NSLOT = (\d+);", text).group(1))
    assert re.search(r"constexpr int AHEAD = NSLOT - 2;", text)
    return define("ODIL_TILE_X"), 32, define("ODIL_THREAD_ROWS"), define("ODIL_PLANE_YOFF"), nslot, nslot - 2


TILE_X, TILE_Y, THREAD_ROWS, YOFF, NSLOT, AHEAD = _constants()
HALO = 2
HX, HYS, HY = TILE_X + 2 * HALO, TILE_Y + 2 * HALO, TILE_Y + 2 * YOFF


def test_the_tile_is_two_cells_a_thread():
    assert (TILE_X, THREAD_ROWS, TILE_Y // 4 * 4, YOFF % 4, HY % 4) == (16, 8, TILE_Y, 0, 0)
    assert NSLOT >= 5 and AHEAD >= 3  # rows t-1, t, t+1 and two in flight


def _owned(T, X, Y, slab):
    """How often the kernel's grid owns each cell of (T, X, Y): blocks
    (blockIdx.x: y tiles, .y: x tiles, .z: slabs) of TILE_Y x THREAD_ROWS
    threads, each owning x = x0 + threadIdx.y + c * THREAD_ROWS for c <
    TILE_X / THREAD_ROWS at y = y0 + threadIdx.x, rows ts .. te-1, where x <
    X and y < Y."""
    seen = np.zeros((T, X, Y), dtype=int)
    for bz in range(-(-T // slab)):
        ts, te = bz * slab, min(bz * slab + slab, T)
        for by in range(-(-X // TILE_X)):
            for bx in range(-(-Y // TILE_Y)):
                for ty in range(THREAD_ROWS):
                    for c in range(TILE_X // THREAD_ROWS):
                        x = by * TILE_X + ty + c * THREAD_ROWS
                        ys = np.arange(bx * TILE_Y, bx * TILE_Y + TILE_Y)
                        ys = ys[ys < Y]
                        if x < X:
                            seen[ts:te, x, ys] += 1
    return seen


def _staged(X, Y, x0, y0, aligned=True):
    """The plane cells (x, y) that issue_row stages at each (tile row,
    plane column) of a tile at (x0, y0), -1 where it stages nothing: the 8
    16-byte copies of the owned columns and 4 single copies of the halo
    columns where the tile lies inside the plane's columns and Y % 4 == 0,
    else HYS single copies through the index tables."""
    xi = [(x0 + h - HALO) % X for h in range(HX)]
    yi = [(y0 + h - HALO) % Y for h in range(HYS)]
    out = np.full((HX, HY, 2), -1)
    vec = y0 + TILE_Y <= Y and Y % 4 == 0 and aligned
    for hx in range(HX):
        if vec:
            for c in range(TILE_Y // 4):
                for k in range(4):
                    out[hx, YOFF + 4 * c + k] = (xi[hx], y0 + 4 * c + k)
            for c in range(2 * HALO):
                hy = c if c < HALO else c + TILE_Y
                out[hx, hy + YOFF - HALO] = (xi[hx], yi[hy])
        else:
            for hy in range(HYS):
                out[hx, hy + YOFF - HALO] = (xi[hx], yi[hy])
    return out, vec


@pytest.mark.parametrize("X", [4, 9, 16, 18, 130, 256])
@pytest.mark.parametrize("Y", [4, 36, 256])
def test_tiles_own_every_cell_once_and_stage_its_halo(X, Y):
    T = 5
    for slab in (1, 2, T):
        assert (_owned(T, X, Y, slab) == 1).all()
    for x0 in range(0, X, TILE_X):
        for y0 in range(0, Y, TILE_Y):
            staged, vec = _staged(X, Y, x0, y0)
            assert vec == (y0 + TILE_Y <= Y and Y % 4 == 0)
            # The planes' columns YOFF - HALO .. YOFF + TILE_Y + HALO - 1 hold
            # the periodic halo of the tile; the pad columns stay unread.
            for hx in range(HX):
                for j in range(HY):
                    want = ((x0 + hx - HALO) % X, (y0 + j - YOFF) % Y)
                    if YOFF - HALO <= j < YOFF + TILE_Y + HALO:
                        assert tuple(staged[hx, j]) == want, (hx, j)
                    else:
                        assert tuple(staged[hx, j]) == (-1, -1)
            # Every cell a thread owns reads its 5-point cross and the ring-1
            # cross around it (HALO = 2) from the staged columns and rows.
            for tx in range(TILE_Y):
                for r in range(TILE_X):
                    i, j = r + HALO, tx + YOFF
                    for di in range(-HALO, HALO + 1):
                        for dj in range(-HALO, HALO + 1):
                            if abs(di) + abs(dj) <= HALO:
                                assert tuple(staged[i + di, j + dj]) == ((x0 + r + di) % X, (y0 + tx + dj) % Y)


def test_misaligned_fields_take_the_single_copies():
    staged, vec = _staged(256, 256, 0, 0, aligned=False)
    assert not vec
    assert tuple(staged[HALO, YOFF]) == (0, 0)


@pytest.mark.parametrize("grads", [True, False])
@pytest.mark.parametrize("T, slab", [(65, 22), (34, 7), (2, 2), (5, 1), (9, 4)])
def test_the_ring_holds_each_rows_rows(T, slab, grads):
    """The prologue commits rows ts-1 .. ts-1+AHEAD (a group each) and
    iteration t commits row t + AHEAD into slot (t - ts + AHEAD + 1) % NSLOT
    after its wait and barrier; a group past the slab's last row is empty.
    After the wait (AHEAD - 2 groups pending with the gradients, AHEAD - 1
    without) rows t-1, t (and t+1) have landed in slots (t - ts) % NSLOT,
    (t - ts + 1) % NSLOT (and (t - ts + 2) % NSLOT), and the slot refilled
    held a row that no later iteration reads."""
    ahead = 1 if grads else 0
    for ts in range(0, T, slab):
        te = min(ts + slab, T)
        last = te - 1 + ahead
        slots, groups = [None] * NSLOT, []
        for q in range(AHEAD + 1):
            r = ts - 1 + q
            groups.append((q, r if r <= last else None))
        for t in range(ts, te):
            pending = AHEAD - 2 if grads else AHEAD - 1
            for slot, r in groups[: len(groups) - pending]:
                if r is not None:
                    slots[slot] = r
            groups = groups[len(groups) - pending :]
            need = [t - 1, t] + ([t + 1] if grads else [])
            for k, r in enumerate(need):
                assert slots[(t - ts + k) % NSLOT] == r
            refill = (t - ts + AHEAD + 1) % NSLOT
            assert slots[refill] is None or slots[refill] < t - 1
            slots[refill] = None
            r = t + AHEAD
            groups.append((refill, r if r <= last else None))
        assert all(r is None for _, r in groups)  # nothing in flight at the end


def _brute_slab(T, tiles, resident, lead):
    """The least row-times over every slab of 1..T rows."""
    cost = lambda s: -(-(-(-T // s)) * tiles // resident) * (s + lead)
    return min(cost(s) for s in range(1, T + 1)), cost


@pytest.mark.parametrize("name, T, X, Y, resident, slab", [
    ("256^2", 65, 256, 256, 396, 22), ("shard", 34, 130, 256, 396, 7), ("512^2", 65, 512, 512, 396, None),
    ("64^3", 65, 64, 64, 396, None),
])
def test_wave_slab_at_the_new_tile_counts(name, T, X, Y, resident, slab):
    """_wave_slab at the 16 x 32 tiles' counts and 3 blocks an SM of an
    H100's 132: 3 slabs of 22 rows (384 blocks, one wave) at 256^2, 5 of 7
    (360 blocks) at the flagship's t:2,x:2 shard; no slab of 1..T rows runs
    in fewer row-times."""
    tiles = -(-X // TILE_X) * -(-Y // TILE_Y)
    got = trw._wave_slab(T, tiles, resident, 1)
    best, cost = _brute_slab(T, tiles, resident, 1)
    assert cost(got) == best
    if slab is not None:
        assert got == slab
    nz = -(-T // got)
    assert (nz - 1) * got < T <= nz * got


def _tree(v):
    """lane 0's value after __shfl_down_sync rounds o = 16, 8, 4, 2, 1 (a
    lane past the warp keeps its own value)."""
    v = list(v)
    for o in (16, 8, 4, 2, 1):
        v = [v[lane] + (v[lane + o] if lane + o < 32 else v[lane]) for lane in range(32)]
    return v[0]


def _last_block(parts, nterms, threads, batched):
    """The last block's sums of parts (nblocks, MAXTERMS) in fp64: each
    thread adds the rows tid, tid + threads, ... -- term by term in one pass
    over a row each (batched) or one pass per term -- then each warp's
    shuffle tree and the warps in order."""
    nblocks = parts.shape[0]
    acc = np.zeros((threads, nterms))
    if batched:
        for tid in range(threads):
            for b in range(tid, nblocks, threads):
                for k in range(nterms):
                    acc[tid, k] += parts[b, k]
    else:
        for k in range(nterms):
            for tid in range(threads):
                v = 0.0
                for b in range(tid, nblocks, threads):
                    v += parts[b, k]
                acc[tid, k] = v
    out = []
    for k in range(nterms):
        warps = [_tree(acc[w * 32 : (w + 1) * 32, k]) for w in range(threads // 32)]
        total = warps[0]
        for w in warps[1:]:
            total += w
        out.append(total)
    return np.array(out)


@pytest.mark.parametrize("nblocks, nterms", [(384, 6), (360, 6), (1000, 4), (5, 2)])
def test_batched_tail_keeps_the_order_of_a_pass_per_term(nblocks, nterms):
    rng = np.random.default_rng(nblocks)
    parts = rng.normal(size=(nblocks, 6)) * 10.0 ** rng.integers(-8, 8, size=(nblocks, 6))
    a = _last_block(parts, nterms, 256, True)
    b = _last_block(parts, nterms, 256, False)
    assert a.tobytes() == b.tobytes()
    np.testing.assert_allclose(a, parts[:, :nterms].sum(0), rtol=1e-9, atol=1e-9 * np.abs(parts).max())
