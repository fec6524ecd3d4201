"""A user's row function on 2-D planes, and the masked per-shard form on
1-D and 2-D planes, through the traced kernels' bodies (``ops/rowtrace.py``;
the kernels run only on the card):

- the generated row models (``Trace.body``) compiled as host code with g++
  (``-O0``, one build for every case) in a harness that evaluates the body
  at every cell of a seeded grid as ``rows2d_kernel`` (``rows1d_kernel``)
  does -- the forward's terms, and with the adjoint the terms, the samples'
  cotangents D and the param cotangents -- and gathers each field cell's
  cotangent from the D of residual rows t .. t+hist at the 3 x 3 (3) cells
  around it; on a masked launch it hands the model the global row, the
  global row count and the block's data rows, and scales the weights and
  the terms by the plane mask and the row mask, as the kernels' halo layer
  does.  Held against the port's plain version in fp64 (autograd of the row
  function; ``halo_model``'s for the masked cases) and against the JAX
  package on the same numpy inputs: its kernels in interpret mode
  (``rowwise_loss_and_grads``, block_rows 1), or for the veltracer's
  function its XLA route, and for the masked cases the JAX wrapped row
  function of ``odil_tpu/halo.py:873-885`` (fp32: sums rtol 1e-5;
  gradients rtol 1e-4 with atol 1e-6 * max|ref|).  The cases: the port's
  veltracer row function bare (kimp, kxreg and ktreg on; on a narrow (3, 5)
  plane too), the 2-D row functions of tests/test_rowwise.py written for
  the port's row stacks (``:116``, ``:332``, ``:389``, the hist-2 ``:454``),
  a hist-2 case with params and (T, X, Y) and (T, 1, 1) data, and the
  masked forms at two row offsets;
- the shared memory that ``rowtrace`` reckons for a block against the
  struct's ``sizeof``;
- the refusals on 2-D planes (a read at y+2, 4 fields, hist 3, a block over
  227 KB): each names its reason, starts no build and takes
  ``plain_on_card``;
- the route: traced 2-D calls and masked calls on (stand-in) card tensors
  reach the CUDA wrappers, the masked 2-D ones ``forward_halo_cuda``/
  ``backward_halo_cuda`` and the masked 1-D ones the 1-D wrappers;
- ``g++ -fsyntax-only`` on one whole generated rows2d unit.
"""

import pathlib
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.models import veltracer as tvt
from odil_torch.ops import _build
from odil_torch.ops import rowtrace as rt
from odil_torch.ops import rowwise as trw
from odil_tpu.models import veltracer as jvt
from odil_tpu.ops import rowwise as jrw
from test_torch_rowtrace import CUDA_STAND_IN, _heat_case, _sources, _wave_case

RTOL_SUMS, RTOL_GRADS, ATOL_GRADS = 1e-5, 1e-4, 1e-6
T2, X2, Y2 = 6, 8, 8  # the 2-D grid of the cases
DT, DX, DY = 0.1, 0.2, 0.25

# The stand-in's dim3 with the constructor the launchers' grids use.
STAND_IN = CUDA_STAND_IN.replace(
    "struct dim3 { unsigned x, y, z; };",
    "struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };")

# Evaluates a row model at every cell of a grid, as the tile kernels do:
# the input file holds the grid's shape, the masked launch's layer (mask,
# off, Tg, r_lo, r_hi), the fields, data, consts, params and g2; the output
# the forward's sums, the backward's sums, the field cotangents (gathered:
# field row i at a cell takes D[m][f][q..] of residual row i + m at the cell
# q - 1 before it along each axis, the used entries only) and the param
# cotangents, in fp64.
HARNESS_RUN = r"""
template <class M, class A_> struct Layout;
template <class M> struct Layout<M, rows1d::Rows1DHaloArgs> {
  static constexpr int R = 1, E = (M::HIST + 1) * M::NF * 3;
  static bool used(int e) { return (M::DUSED >> e) & 1u; }
};
template <class M> struct Layout<M, rows2d::Rows2DHaloArgs> {
  static constexpr int R = 2, E = (M::HIST + 1) * M::NF * 9;
  static bool used(int e) { return M::used(e); }
};

template <class Args> void set_layer(Args& A, int T, int X, int Y, const float* mask, int off, int Tg, int lo, int hi);
template <> void set_layer(rows1d::Rows1DHaloArgs& A, int T, int X, int, const float* mask, int off, int Tg, int lo,
                           int hi) {
  A.T = T; A.N = X; A.mask = mask; A.off = off; A.flags = Tg; A.r_lo = lo; A.r_hi = hi;
}
template <> void set_layer(rows2d::Rows2DHaloArgs& A, int T, int X, int Y, const float* mask, int off, int Tg, int lo,
                           int hi) {
  A.T = T; A.X = X; A.Y = Y; A.mask = mask; A.off = off; A.Tg = Tg; A.r_lo = lo; A.r_hi = hi;
}

// The model's eval at one cell: the 1-D interface (v[m][f][q]) or the 2-D
// one (v[m][f][qx][qy]), both as flat arrays of the used layout.
template <class M, bool G>
void eval_at(const rows1d::Rows1DHaloArgs& A, bool masked, const float* P, int it, int x, int, const float* v,
             const float* g2, float* res, float* D, float* pacc) {
  typename M::Face face{};
  float gk[2];
  if (masked)
    M::template eval<G>(A, P, it, x, *(const float(*)[M::HIST + 1][M::NF][3])v, face, face, g2, res,
                        *(float(*)[M::HIST + 1][M::NF][3])D, gk, pacc, true);
  else
    M::template eval<G>(static_cast<const rows1d::Rows1DArgs&>(A), P, it, x,
                        *(const float(*)[M::HIST + 1][M::NF][3])v, face, face, g2, res,
                        *(float(*)[M::HIST + 1][M::NF][3])D, gk, pacc, true);
}
template <class M, bool G>
void eval_at(const rows2d::Rows2DHaloArgs& A, bool masked, const float* P, int it, int x, int y, const float* v,
             const float* g2, float* res, float* D, float* pacc) {
  if (masked)
    M::template eval<G>(A, P, it, x, y, *(const float(*)[M::HIST + 1][M::NF][3][3])v, g2, res,
                        *(float(*)[M::HIST + 1][M::NF][3][3])D, pacc, true);
  else
    M::template eval<G>(static_cast<const rows2d::Rows2DArgs&>(A), P, it, x, y,
                        *(const float(*)[M::HIST + 1][M::NF][3][3])v, g2, res, *(float(*)[M::HIST + 1][M::NF][3][3])D,
                        pacc, true);
}

template <class M, class Args>
int run(const char* in_path, const char* out_path) {
  using L = Layout<M, Args>;
  constexpr int H = M::HIST, NF = M::NF, NT = M::MAXT, NP = M::NP > 0 ? M::NP : 1, E = L::E, R = L::R;
  FILE* in = fopen(in_path, "rb");
  int hdr[10];
  if (fread(hdr, 4, 10, in) != 10) return 2;
  const int T = hdr[0], X = hdr[1], Y = hdr[2], nd = hdr[3], nc = hdr[4], masked = hdr[5];
  auto floats = [&](size_t n) { std::vector<float> v(n); if (n && fread(v.data(), 4, n, in) != n) v.clear(); return v; };
  const size_t plane = (size_t)X * Y;
  std::vector<float> mask = floats(plane), fields = floats((size_t)NF * T * plane);
  std::vector<std::vector<float>> data, consts;
  Args A{};
  set_layer(A, T, X, Y, mask.data(), hdr[6], hdr[7], hdr[8], hdr[9]);
  for (int d = 0; d < nd; ++d) {
    int stride;
    if (fread(&stride, 4, 1, in) != 1) return 2;
    data.push_back(floats((size_t)T * stride));
    A.data_stride[d] = stride;
  }
  for (int c = 0; c < nc; ++c) {
    int n;
    if (fread(&n, 4, 1, in) != 1) return 2;
    consts.push_back(floats(n));
  }
  std::vector<float> P = floats(M::NP), g2 = floats(NT);
  fclose(in);
  for (int d = 0; d < nd; ++d) A.data[d] = data[d].data();
  for (int c = 0; c < nc; ++c) A.consts[c] = consts[c].data();
  auto wrap = [](int v, int n) { return ((v % n) + n) % n; };
  auto cell = [&](int x, int y) { return (size_t)wrap(x, X) * Y + wrap(y, Y); };
  std::vector<double> sums_f(NT), sums(NT), df((size_t)NF * T * plane), dp(NP);
  std::vector<float> Dall((size_t)T * plane * E);
  for (int t = 0; t < T; ++t) {
    const int it = masked ? t + A.off : t;
    const bool in_rows = t >= hdr[8] && t < hdr[9];
    for (int x = 0; x < X; ++x) {
      for (int y = 0; y < Y; ++y) {
        float v[E], D[E] = {}, res[NT], res_f[NT], pacc[NP] = {}, g2m[NT];
        for (int m = 0; m <= H; ++m)
          for (int f = 0; f < NF; ++f)
            for (int q = 0; q < (R == 1 ? 3 : 9); ++q) {
              const int qx = R == 1 ? q : q / 3, qy = R == 1 ? 1 : q % 3;
              v[(m * NF + f) * (R == 1 ? 3 : 9) + q] =
                  fields[((size_t)f * T + wrap(t - m, T)) * plane + cell(x + qx - 1, y + qy - 1)];
            }
        const float mk = masked ? (in_rows ? mask[cell(x, y)] : 0.0f) : 1.0f;
        for (int k = 0; k < NT; ++k) g2m[k] = g2[k] * mk;
        eval_at<M, false>(A, masked, P.data(), it, x, y, v, g2m, res_f, D, pacc);
        eval_at<M, true>(A, masked, P.data(), it, x, y, v, g2m, res, D, pacc);
        for (int k = 0; k < NT; ++k) {
          sums_f[k] += (double)(res_f[k] * mk) * (res_f[k] * mk);
          sums[k] += (double)(res[k] * mk) * (res[k] * mk);
        }
        for (int e = 0; e < E; ++e) Dall[((size_t)t * plane + cell(x, y)) * E + e] = L::used(e) ? D[e] : 0.0f;
        for (int p = 0; p < M::NP; ++p) dp[p] += pacc[p];
      }
    }
  }
  for (int f = 0; f < NF; ++f)
    for (int i = 0; i < T; ++i)
      for (int x = 0; x < X; ++x)
        for (int y = 0; y < Y; ++y) {
          double a = 0.0;
          for (int m = 0; m <= H; ++m)
            for (int q = 0; q < (R == 1 ? 3 : 9); ++q) {
              const int qx = R == 1 ? q : q / 3, qy = R == 1 ? 1 : q % 3;
              const int e = (m * NF + f) * (R == 1 ? 3 : 9) + q;
              if (L::used(e)) a += Dall[((size_t)wrap(i + m, T) * plane + cell(x - qx + 1, y - qy + 1)) * E + e];
            }
          df[((size_t)f * T + i) * plane + (size_t)x * Y + y] = a;
        }
  FILE* out = fopen(out_path, "wb");
  fwrite(sums_f.data(), 8, NT, out);
  fwrite(sums.data(), 8, NT, out);
  fwrite(df.data(), 8, df.size(), out);
  fwrite(dp.data(), 8, M::NP, out);
  const int smem[2] = {(int)rows2d_smem<M>(false), (int)rows2d_smem<M>(true)};
  fwrite(smem, 4, 2, out);
  fclose(out);
  return 0;
}
"""

# sizeof(rows2d::Smem) of a 2-D model, 0 for a 1-D one.
SMEM_OF = r"""
template <class M, class = void> struct Is2D : std::false_type {};
template <class M> struct Is2D<M, std::void_t<decltype(M::DUSED_LO)>> : std::true_type {};
template <class M> size_t rows2d_smem(bool grads) {
  if constexpr (Is2D<M>::value) return grads ? sizeof(rows2d::Smem<M, true>) : sizeof(rows2d::Smem<M, false>);
  else return 0;
}
"""


# -- The cases: torch row functions (row stacks, the plane axes last) and the
# JAX package's (rows of one plane) -------------------------------------------


def _velt(np_, kimp=10.0, kxreg=0.01, ktreg=1.0):
    if np_ is jnp:
        return jvt._make_row_fn(jnp, DT, DX, DY, kimp, kxreg, ktreg)
    return tvt._make_row_fn(DT, DX, DY, kimp, kxreg, ktreg)


def _roll(np_):
    """roll along plane axis 0 (x) or 1 (y) of a row (JAX) or a row stack."""
    if np_ is jnp:
        return lambda a, s, axis: jnp.roll(a, s, axis)
    return lambda a, s, axis: torch.roll(a, s, axis - 2)


def _planes(np_):
    roll = _roll(np_)

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:116-125
        ((cur, prev),) = rows
        return ((cur - prev) + 0.1 * (roll(cur, -1, 0) - roll(cur, 1, 0)),)

    return row_fn


def _blocked(np_):
    roll, where = _roll(np_), (jnp.where if np_ is jnp else torch.where)

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:332-341
        ((cur, prev),) = rows
        r = (cur - prev) + 0.1 * (roll(cur, -1, 0) - roll(cur, 1, 1))
        return (where(it == 0, 0.0, r),)

    return row_fn


def _stream(np_):
    roll, where = _roll(np_), (jnp.where if np_ is jnp else torch.where)

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:389-400
        ((cur, prev),) = rows
        (c0,) = consts
        r = (cur - prev) + 0.1 * (roll(cur, -1, 0) - roll(cur, 1, 1))
        return (where(it == 0, cur - c0, r),)

    return row_fn


def _hist2(np_):
    roll, where = _roll(np_), (jnp.where if np_ is jnp else torch.where)

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:454-458
        ((cur, prev, prev2),) = rows
        r = cur - 2 * prev + prev2 + 0.1 * (roll(cur, -1, 0) - roll(cur, 1, 1))
        return (where(it <= 1, cur, r),)

    return row_fn


def _net2d(np_):
    """hist 2, two fields, a [1, 4, 1] tanh net of the field as a
    coefficient (its weights as params, read element by element on the
    torch side), a (T, X, Y) data mask, a (T, 1, 1) data row and the global
    row count."""
    roll, where = _roll(np_), (jnp.where if np_ is jnp else torch.where)

    def net(x, params):
        W1, b1, W2, b2 = params
        if np_ is jnp:
            h = jnp.tanh(jnp.einsum("...i,oi->...o", x[..., None], W1) + b1)
            return (jnp.einsum("...i,oi->...o", h, W2) + b2)[..., 0]
        h = [torch.tanh(W1[o, 0] * x + b1[o]) for o in range(4)]
        return sum(W2[0, i] * h[i] for i in range(4)) + b2[0]

    def row_fn(it, T_, rows, data_rows, params, consts):
        (u, um, umm), (v, vm, _) = rows
        mask, amp = data_rows
        k = net(um, params)
        lap = roll(u, -1, 0) - 2 * u + roll(u, 1, 0) + roll(u, 1, 1) - 2 * u + roll(u, -1, 1)
        r1 = (u - 2 * um + umm) - k * lap + v * (roll(um, 1, 1) - roll(um, -1, 0)) * amp
        r2 = where(it == T_ - 1, v - vm, (v - roll(vm, 1, 0)) * 0.5)
        return (r1 * mask, r2)

    return row_fn


# name -> (functions of np_, nterms, hist, nfields, params, data (True: a
# plane, False: (T, 1, 1)), consts (number of (X, Y) planes), plane shape,
# the JAX route).
CASES = {
    "veltracer": (_velt, 6, 1, 3, (), (), 2, (X2, Y2), "xla"),
    "veltracer_narrow": (_velt, 6, 1, 3, (), (), 2, (3, 5), "xla"),
    "planes": (_planes, 1, 1, 1, (), (), 0, (X2, Y2), "interpret"),
    "blocked": (_blocked, 1, 1, 1, (), (), 0, (X2, Y2), "interpret"),
    "stream": (_stream, 1, 1, 1, (), (), 1, (X2, Y2), "interpret"),
    "hist2": (_hist2, 1, 2, 1, (), (), 0, (X2, Y2), "interpret"),
    "net_hist2": (_net2d, 2, 2, 2, ((4, 1), (4,), (1, 4), (1,)), (True, False), 0, (X2, Y2), "interpret"),
}

# The masked (per-shard) cases: (a CASES or a 1-D case, the layer's (off,
# Tg, r_lo, r_hi)), the plane mask zero on the first and the last x row.
MASKED = {
    "veltracer_off_m1": ("veltracer", (-1, T2 + 3, 1, T2 - 1)),
    "veltracer_off_3": ("veltracer", (3, T2 + 3, 2, T2 - 1)),
    "net_hist2_off_2": ("net_hist2", (2, T2 + 2, 1, T2)),
    "heat1d_off_m1": ("heat1d", (-1, 12, 1, 8)),
    "wave1d_off_4": ("wave1d", (4, 15, 2, 9)),
}


def _inputs(case, seed):
    """(row fns (torch, jax), nterms, hist, (fields, params, data, consts),
    the plane, the JAX route) of a 2-D case: seeded numpy inputs."""
    make, nterms, hist, nfields, pshapes, data, nconsts, plane, route = CASES[case]
    rng = np.random.default_rng(seed)
    mk = lambda *shape: (0.3 * rng.normal(size=shape)).astype(np.float32)
    fields = [mk(T2, *plane) for _ in range(nfields)]
    params = [mk(*s) for s in pshapes]
    data = [rng.integers(0, 2, (T2,) + plane).astype(np.float32) if p else mk(T2, 1, 1) for p in data]
    consts = [mk(*plane) for _ in range(nconsts)]
    return make(torch), make(jnp), nterms, hist, (fields, params, data, consts), plane, route


def _case_1d(which):
    """A 1-D case of tests/test_torch_rowtrace.py: heat with keep_init=0
    (the JAX package's XLA route) or wave (interpret mode)."""
    row_fn, jfn, nterms, hist, inputs = _heat_case(True, 0, 1) if which == "heat1d" else _wave_case()
    return row_fn, jfn, nterms, hist, inputs, (inputs[0][0].shape[1],), "xla" if which == "heat1d" else "interpret"


def _kinds(inputs, plane):
    fields, params, data, consts = inputs
    return (tuple(tuple(np.shape(d)[1:]) == tuple(plane) for d in data),
            tuple((np.size(c) != 1, np.ndim(c)) for c in consts), [tuple(np.shape(p)) for p in params])


def _trace(row_fn, nterms, hist, inputs, plane):
    data_k, const_k, pshapes = _kinds(inputs, plane)
    return rt.trace(row_fn, nterms, hist, len(inputs[0]), data_k, const_k, pshapes, len(plane))


def _mask(plane):
    m = np.ones(plane, np.float32)
    m[0] = m[-1] = 0.0
    return m


def _write(path, inputs, plane, g2, layer=None):
    fields, params, data, consts = inputs
    T = fields[0].shape[0]
    X, Y = (plane + (1,))[:2]
    off, Tg, lo, hi = layer or (0, T, 0, T)
    with open(path, "wb") as fh:
        fh.write(np.array([T, X, Y, len(data), len(consts), layer is not None, off, Tg, lo, hi], np.int32).tobytes())
        fh.write(_mask(plane).tobytes())
        fh.write(np.concatenate([f.ravel() for f in fields]).astype(np.float32).tobytes())
        for d in data:
            fh.write(np.array([np.size(d) // T], np.int32).tobytes() + np.asarray(d, np.float32).tobytes())
        for c in consts:
            fh.write(np.array([np.size(c)], np.int32).tobytes() + np.asarray(c, np.float32).tobytes())
        if params:
            fh.write(np.concatenate([np.ravel(p) for p in params]).astype(np.float32).tobytes())
        fh.write(np.asarray(g2, np.float32).tobytes())


def _split(raw, trace, shape):
    nt, nf = trace.nterms, trace.nfields
    n = int(np.prod(shape))
    sums_f, sums, df = raw[:nt], raw[nt:2 * nt], raw[2 * nt:2 * nt + nf * n].reshape((nf,) + shape)
    flat, pos, dps = raw[2 * nt + nf * n:], 0, []
    for s in trace.param_shapes:
        k = int(np.prod(s))
        dps.append(flat[pos:pos + k].reshape(s))
        pos += k
    return sums_f, sums, list(df) + dps


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """{case: (trace, inputs, g, weighted results, uniform-weight results,
    row fns, nterms, hist, plane, route, layer, smem)}: every case's body
    in one g++ build, each run on its inputs with weights g and with the
    JAX one-pass kernel's uniform weight."""
    root = tmp_path_factory.mktemp("rowtrace2d")
    includes = _sources(root)
    (root / "inc" / "cuda_runtime.h").write_text(STAND_IN)
    runs = {}
    for name in list(CASES) + list(MASKED):
        base, layer = MASKED.get(name, (name, None))
        if base in CASES:
            fn, jfn, nterms, hist, inputs, plane, route = _inputs(base, seed=len(runs) + 3)
        else:
            fn, jfn, nterms, hist, inputs, plane, route = _case_1d(base)
        runs[name] = (fn, jfn, nterms, hist, inputs, plane, route, layer)
    parts, dispatch, cases = [], [], {}
    traces = {}
    for i, (name, (fn, jfn, nterms, hist, inputs, plane, route, layer)) in enumerate(runs.items()):
        trace = _trace(fn, nterms, hist, inputs, plane)
        args = "rows2d::Rows2DHaloArgs" if len(plane) == 2 else "rows1d::Rows1DHaloArgs"
        parts.append(f"namespace case{i} {{\n{trace.body}\n}}")
        dispatch.append(f"    case {i}: return run<case{i}::TracedRow, {args}>(argv[2], argv[3]);")
        cells = inputs[0][0].size
        g = np.full(nterms, 1.0 / cells, np.float32) * np.linspace(1.0, 2.0, nterms, dtype=np.float32)
        _write(root / f"in{i}.bin", inputs, plane, 2 * g, layer)
        _write(root / f"in{i}_jax.bin", inputs, plane, np.full(nterms, 2.0 / cells, np.float32), layer)
        traces[name] = (i, trace, g)
    src = "\n".join([
        "#include <cstdio>", "#include <cstdlib>", "#include <type_traits>", "#include <vector>",
        '#include "rows1d.cuh"', '#include "rows2d.cuh"', '#include "rows1d_traced.cuh"', *parts, SMEM_OF,
        HARNESS_RUN, "int main(int argc, char** argv) {", "  switch (atoi(argv[1])) {", *dispatch,
        "    default: return 3;", "  }", "}",
    ])
    (root / "harness.cpp").write_text(src)
    build = subprocess.run(["g++", "-std=c++17", "-O0", "-w", *includes, "-o", str(root / "harness"),
                            str(root / "harness.cpp")], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    for name, (i, trace, g) in traces.items():
        fn, jfn, nterms, hist, inputs, plane, route, layer = runs[name]
        shape = inputs[0][0].shape
        results = []
        for tag in ("", "_jax"):
            run = subprocess.run([str(root / "harness"), str(i), str(root / f"in{i}{tag}.bin"),
                                  str(root / f"out{i}{tag}.bin")], capture_output=True, text=True)
            assert run.returncode == 0, (name, run.returncode, run.stderr)
            raw = np.fromfile(root / f"out{i}{tag}.bin", np.uint8)
            smem = tuple(int(v) for v in raw[-8:].view(np.int32))
            results.append(_split(raw[:-8].view(np.float64), trace, shape))
        cases[name] = (trace, inputs, g, *results, fn, jfn, nterms, hist, plane, route, layer, smem)
    return cases


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _wrapped(jfn, plane, layer):
    """The JAX package's per-shard wrapping of a row function
    (odil_tpu/halo.py:873-885) with the layer (off, Tg, r_lo, r_hi): global
    row and row count, the plane mask and the own rows; the mask rides as
    the last const."""
    off, Tg, lo, hi = layer

    def wrapped(it, _T, rows, data_rows, pv, cons):
        res = jfn(it + off, Tg, rows, data_rows, pv, cons[:-1])
        m = cons[-1] * ((it >= lo) & (it < hi)).astype(jnp.float32)
        return tuple(r * m for r in res)

    return wrapped


def _jax_reference(jfn, inputs, nterms, hist, plane, route, layer):
    """(sums, field and param cotangents) of the JAX package at the uniform
    weight 1/cells: its one-pass kernel in interpret mode, or its XLA
    route."""
    fields, params, data, consts = inputs
    jf, jp, jd, jc = ([jnp.asarray(x) for x in xs] for xs in (fields, params, data, consts))
    fn = jfn
    if layer is not None:
        fn = _wrapped(jfn, plane, layer)
        jc = jc + [jnp.asarray(_mask(plane))]
    cells = fields[0].size
    if route == "xla":
        def loss(f, p):
            terms = jrw.rowwise_loss_terms(fn, f, p, jd, jc, nterms=nterms, hist=hist, _sums=True)
            return sum(terms) / cells, jnp.stack(terms)

        (_, jsums), (jdf, jdp) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(jf, jp)
    else:
        jsums, jdf, jdp = jrw.rowwise_loss_and_grads(fn, jf, params=jp, data=jd, consts=jc, nterms=nterms,
                                                     hist=hist, interpret=True, gscale=1.0 / cells, block_rows=1)
    return np.asarray(jsums), [np.asarray(x) for x in list(jdf) + list(jdp)]


@pytest.mark.parametrize("case", list(CASES) + list(MASKED))
def test_traced_body_matches_plain_and_jax(harness, case):
    """The g++-built body, evaluated and gathered as the kernels do: its
    forward sums, backward sums, field and param cotangents against the
    port's plain version in fp64 (``halo_model``'s for a masked case) and
    the JAX package (interpret mode or, for the veltracer and heat, its XLA
    route; the wrapped row function for a masked case)."""
    (trace, inputs, g, weighted, uniform, fn, jfn, nterms, hist, plane, route, layer, _) = harness[case]
    fields, params, data, consts = inputs
    tt = lambda xs: tuple(torch.as_tensor(np.array(x), dtype=torch.float64) for x in xs)
    model = trw.RowModel(fn)
    if layer is not None:
        off, Tg, lo, hi = layer
        model = trw.halo_model(model, torch.as_tensor(_mask(plane), dtype=torch.float64), off, Tg, lo, hi)
    pdf, pdp, psums = trw._backward_plain(model, nterms, hist, tt(fields), tt(params), tt(data), tt(consts),
                                          torch.as_tensor(g, dtype=torch.float64), True)
    sums_f, sums, grads = weighted
    for got in (sums_f, sums):
        _close(got, psums.numpy(), RTOL_SUMS, 0.0)
    assert len(grads) == len(pdf) + len(pdp)
    for got, want in zip(grads, list(pdf) + list(pdp)):
        _close(got, want.numpy(), RTOL_GRADS, ATOL_GRADS)
    jsums, jgrads = _jax_reference(jfn, inputs, nterms, hist, plane, route, layer)
    sums_f, sums, grads = uniform
    for got in (sums_f, sums):
        _close(got, jsums, RTOL_SUMS, 0.0)
    for got, want in zip(grads, jgrads):
        _close(got, want, RTOL_GRADS, ATOL_GRADS)


def test_traced_2d_bodies_read_what_the_functions_read(harness):
    """The veltracer's trace: 3 fields, hist 1, 6 terms, no params; its
    staged cotangents are u's previous row and vx and vy at the four cross
    offsets (12 planes); two blocks an SM; the shared memory that rowtrace
    reckons for a block is the struct's sizeof, as for every 2-D case; the
    function's operations as the generator counts them."""
    velt = harness["veltracer"][0]
    assert (velt.rank, velt.nfields, velt.hist, velt.nterms, velt.nparams) == (2, 3, 1, 6, 0)
    assert rt._staged(velt.dused) == 12
    assert velt.blocks_per_sm == 2 and 60_000 < velt.smem[1] < 100_000
    for name, (trace, *_, smem) in harness.items():
        if trace.rank == 2:
            assert trace.smem == smem, name
    assert harness["net_hist2"][0].nparams == 13
    assert velt.ops_backward > velt.ops_forward > 0


# -- refusals, routes and the syntax check ---------------------------------------


class _CardLike(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: what the dispatchers read."""

    @property
    def is_cuda(self):
        return True


def _card(ts):
    return tuple(t.as_subclass(_CardLike) for t in ts)


def _reach_y2(it, T_, rows, data_rows, params, consts):
    ((cur, prev),) = rows
    return (cur - prev + torch.roll(cur, -2, -1),)


def _four_fields(it, T_, rows, data_rows, params, consts):
    return (sum(r[0] - r[1] for r in rows),)


def _hist3(it, T_, rows, data_rows, params, consts):
    ((cur, p1, p2, p3),) = rows
    return (cur - p1 + p2 - p3,)


def _big_block(it, T_, rows, data_rows, params, consts):
    """3 fields at hist 2 read at every offset of the 3 x 3 cells: 72 staged
    cotangent planes."""
    out = 0.0
    for f in rows:
        for m in f:
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    out = out + torch.tanh(torch.roll(m, (dx, dy), (-2, -1)))
    return (out,)


# name -> (row fn, fields, hist, the reason)
REFUSALS = {
    "reach_y2": (_reach_y2, 1, 1, "y\\+2"),
    "four_fields": (_four_fields, 4, 1, "4 fields"),
    "hist_3": (_hist3, 1, 3, "3 rows back"),
    "block_over_227kb": (_big_block, 3, 2, "bytes of shared memory"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refused_2d_row_functions_take_plain_on_card(monkeypatch, case):
    """A refused 2-D row function names its reason, starts no build and
    runs the plain version on the card, counted with its reason; the same
    numbers as the CPU route."""
    fn, nfields, hist, reason = REFUSALS[case]
    monkeypatch.setattr(_build, "compile_generated", lambda *a, **k: pytest.fail("a refused trace started a build"))
    rng = np.random.default_rng(5)
    fields = tuple(torch.as_tensor(rng.normal(size=(5, 4, 6)), dtype=torch.float32) for _ in range(nfields))
    model = trw.RowModel(fn)
    call = (1, hist, _card(fields), (), (), ())
    assert not trw._kernel_route(model, call[2][0], call)
    spec, why = trw._traced(model, *call)
    assert spec is None and re.search(reason, why), why
    before, reasons = trw.plain_on_card.launches, trw.plain_on_card.reasons[why]
    kd, _, ks = trw._backward(model, *call, torch.ones(1), True)
    pd, _, ps = trw._backward(model, 1, hist, fields, (), (), (), torch.ones(1), True)
    for a, b in zip(kd + (ks,), pd + (ps,)):
        assert torch.equal(a.as_subclass(torch.Tensor), b)
    assert trw.plain_on_card.launches == before + 1
    assert trw.plain_on_card.reasons[why] == reasons + 1


def _record(monkeypatch, names):
    calls = []
    for name in names:
        monkeypatch.setattr(trw, name, lambda *a, name=name: calls.append(name) or name)
    return calls


def test_traced_calls_route_to_the_kernels(monkeypatch, tmp_path):
    """A traced 2-D row function on (stand-in) card tensors reaches the
    CUDA wrappers (the streaming ones with stream=True); wrapped for a shard
    it reaches the masked 2-D wrappers, a traced 1-D one wrapped for a shard
    the masked 1-D wrappers; no plain_on_card; without nvcc the build raises
    (no fallback)."""
    rng = np.random.default_rng(7)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    fields, consts = tuple(mk(6, 8, 8) for _ in range(3)), (mk(8, 8), mk(8, 8))
    user = trw.RowModel(_velt(torch))
    names = ["forward_cuda", "backward_cuda", "forward_stream_cuda", "backward_stream_cuda", "forward_halo_cuda",
             "backward_halo_cuda", "forward_halo_rows1d_cuda", "backward_halo_rows1d_cuda"]
    calls = _record(monkeypatch, names)
    before = trw.plain_on_card.launches
    g = torch.ones(6)
    call = (6, 1, _card(fields), (), (), _card(consts))
    trw._forward(user, *call)
    trw._backward(user, *call, g, True)
    trw._forward(user, *call, stream=True)
    trw._backward(user, *call, g, False, stream=True)
    shard = trw.halo_model(user, _card((torch.ones(8, 8),))[0], -1, 9, 1, 5)
    trw._forward(shard, *call)
    trw._backward(shard, *call, g, True)
    heat_fn, _, nterms, hist, (f1, p1, d1, c1) = _heat_case(True, 0, 1)
    t1 = lambda xs: _card(tuple(torch.as_tensor(np.asarray(x)) for x in xs))
    shard1 = trw.halo_model(trw.RowModel(heat_fn), torch.ones(f1[0].shape[1]), 3, 20, 1, 6)
    call1 = (nterms, hist, t1(f1), t1(p1), t1(d1), t1(c1))
    trw._forward(shard1, *call1)
    trw._backward(shard1, *call1, torch.ones(nterms), True)
    assert calls == names
    assert trw.plain_on_card.launches == before
    spec = trw._traced(user, *call)[0]
    assert isinstance(spec, trw._Rows2DCuda) and spec is trw._traced(shard, *call)[0]
    assert isinstance(trw._traced(shard1, *call1)[0], trw._Rows1DCuda)
    monkeypatch.undo()
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    trw._traced_library.cache_clear()
    _build.load_generated.cache_clear()
    for model in (user, shard):
        with pytest.raises(RuntimeError, match="nvcc"):
            trw._forward(model, *call)
    assert trw.plain_on_card.launches == before
    trw._traced_library.cache_clear()
    _build.load_generated.cache_clear()


def _last_axis(it, T_, rows, data_rows, params, consts):
    ((cur, prev),) = rows
    return ((cur - prev) + 0.1 * (torch.roll(cur, -1, -1) - torch.roll(cur, 1, -1)),)


def test_1d_and_2d_traces_of_one_function_differ():
    """One row function traced on 1-D and on 2-D planes: two traces (the
    plane's rank is in the cache key), each with its own kernels' struct."""
    one = trw._traced(trw.RowModel(_last_axis), 1, 1, _card((torch.ones(5, 8),)), (), (), ())[0]
    two = trw._traced(trw.RowModel(_last_axis), 1, 1, _card((torch.ones(5, 8, 8),)), (), (), ())[0]
    assert isinstance(one, trw._Rows1DCuda) and "rows1d::Rows1DArgs" in one.trace.source
    assert isinstance(two, trw._Rows2DCuda) and "rows2d::Rows2DArgs" in two.trace.source
    assert one.trace.rank == 1 and two.trace.rank == 2


def test_generated_2d_unit_passes_syntax_check(tmp_path):
    """g++ -fsyntax-only on a whole generated rows2d unit (the hist-2 case
    with params and data): the row model, rows2d_kernel instantiated for it
    in every mode and the entry points, the launches' <<<...>>> removed."""
    fn, _, nterms, hist, inputs, plane, _ = _inputs("net_hist2", seed=1)
    trace = _trace(fn, nterms, hist, inputs, plane)
    includes = _sources(tmp_path)
    (tmp_path / "inc" / "cuda_runtime.h").write_text(STAND_IN)
    (tmp_path / "src" / "traced2d.cu").write_text(trace.source)
    out = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-w", *includes, "-x", "c++",
                          str(tmp_path / "src" / "traced2d.cu")], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
