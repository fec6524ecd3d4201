"""A user's row function on 1-D planes through the traced kernels' body
(``ops/rowtrace.py``; the kernels run only on the card):

- the generated row model (``Trace.body``) compiled as host code with g++ in
  a harness that evaluates it at every cell of a seeded (T, N) grid, as
  ``rows1d_kernel`` does (the forward's terms, and with the adjoint the
  terms, the samples' cotangents D scattered to the field rows as the
  kernel gathers them, and the param cotangents), one g++ run for every
  case; held against the port's plain version (autograd on the CPU) and
  against the JAX package's kernels in interpret mode on the same numpy
  inputs (fp32: sums rtol 1e-5; gradients rtol 1e-4 with atol 1e-6 *
  max|ref|).  The cases: the 1-D row functions of tests/test_rowwise.py
  written for the port's row stacks, heat's row function with both keep
  flags on, with each off and with infer_k off, and wave's.
  The heat cases with a keep flag off are held against the JAX package's
  XLA route (its plain reference off the TPU, ``rowwise_loss_terms``)
  instead of interpret mode, whose trace of the net takes ~5 s a case;
- the refusals (a field read at x+2, 2-D planes, 49 params, a Python branch
  on a value, a captured tensor, shapes the kernels do not take): each
  names its reason, starts no build and takes ``plain_on_card``;
- the operation count: an expression computed at two shifts (a net at
  both faces) counts once;
- the route: a traced row function on (stand-in) card tensors reaches the
  CUDA wrappers, and a build without nvcc raises;
- the digest: the same structure gives the same source, another literal
  another source; and ``g++ -fsyntax-only`` on one whole generated ``.cu``.
"""

import argparse
import pathlib
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch.context import Context
from odil_torch.models import heat as th
from odil_torch.models import wave as tw
from odil_torch.ops import _build
from odil_torch.ops import rowtrace as rt
from odil_torch.ops import rowwise as trw
from odil_tpu.ops import rowwise as jrw

CSRC = pathlib.Path(trw.__file__).resolve().parent.parent / "csrc"
T, N = 9, 16
RTOL_SUMS, RTOL_GRADS, ATOL_GRADS = 1e-5, 1e-4, 1e-6
G_JAX = 1.0 / (T * N)  # the JAX one-pass kernel's weight of every term

# What rows1d.cuh and the generated bodies take from the CUDA runtime, as
# host code (the harness) or declarations (the syntax check, whose launches
# are removed).
CUDA_STAND_IN = """#pragma once
#include <math.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
using std::max;
using std::min;
struct dim3 { unsigned x, y, z; };
extern dim3 threadIdx, blockIdx, gridDim, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess, cudaErrorInvalidValue, cudaFuncAttributeMaxDynamicSharedMemorySize,
       cudaDevAttrMultiProcessorCount };
void __syncthreads();
int __syncthreads_or(int);
unsigned __ballot_sync(unsigned, int);
int __popc(unsigned);
template <class T> T __shfl_xor_sync(unsigned, T, int);
unsigned atomicAdd(unsigned*, unsigned);
void __threadfence();
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T*);
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
size_t __cvta_generic_to_shared(const void*);
const char* cudaGetErrorString(cudaError_t);
cudaError_t cudaGetLastError();
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, int, int);
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int);
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t);
"""

# Evaluates a row model at every cell of a (T, N) grid, as rows1d_kernel:
# the input file holds T, N, the fields, data, consts, params and g2; the
# output the forward's sums, the backward's sums, the field cotangents (D
# scattered: field row t - m at x + q - 1 of residual cell (t, x) takes
# D[m][f][q], the DUSED entries only) and the param cotangents, in fp64.
HARNESS_RUN = r"""
template <class M>
int run(const char* in_path, const char* out_path) {
  constexpr int H = M::HIST, NF = M::NF, NT = M::MAXT, NP = M::NP > 0 ? M::NP : 1;
  FILE* in = fopen(in_path, "rb");
  int hdr[4];
  if (fread(hdr, 4, 4, in) != 4) return 2;
  const int T = hdr[0], N = hdr[1], nd = hdr[2], nc = hdr[3];
  auto floats = [&](size_t n) { std::vector<float> v(n); if (n && fread(v.data(), 4, n, in) != n) v.clear(); return v; };
  std::vector<float> fields = floats((size_t)NF * T * N);
  std::vector<std::vector<float>> data, consts;
  rows1d::Rows1DArgs A{};
  A.T = T;
  A.N = N;
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
  std::vector<double> sums_f(NT), sums(NT), df((size_t)NF * T * N), dp(NP);
  auto at = [&](int f, int t, int x) { return ((size_t)f * T + ((t % T) + T) % T) * N + ((x % N) + N) % N; };
  for (int t = 0; t < T; ++t) {
    for (int x = 0; x < N; ++x) {
      float v[H + 1][NF][3], res[NT], res_f[NT], D[H + 1][NF][3] = {}, gk[2], pacc[NP] = {};
      for (int m = 0; m <= H; ++m)
        for (int f = 0; f < NF; ++f)
          for (int q = 0; q < 3; ++q) v[m][f][q] = fields[at(f, t - m, x + q - 1)];
      typename M::Face face{};
      M::template eval<false>(A, P.data(), t, x, v, face, face, g2.data(), res_f, D, gk, pacc, true);
      M::template eval<true>(A, P.data(), t, x, v, face, face, g2.data(), res, D, gk, pacc, true);
      for (int k = 0; k < NT; ++k) {
        sums_f[k] += (double)res_f[k] * res_f[k];
        sums[k] += (double)res[k] * res[k];
      }
      for (int m = 0; m <= H; ++m)
        for (int f = 0; f < NF; ++f)
          for (int q = 0; q < 3; ++q)
            if ((M::DUSED >> ((m * NF + f) * 3 + q)) & 1u) df[at(f, t - m, x + q - 1)] += D[m][f][q];
      for (int p = 0; p < M::NP; ++p) dp[p] += pacc[p];
    }
  }
  FILE* out = fopen(out_path, "wb");
  fwrite(sums_f.data(), 8, NT, out);
  fwrite(sums.data(), 8, NT, out);
  fwrite(df.data(), 8, df.size(), out);
  fwrite(dp.data(), 8, M::NP, out);
  fclose(out);
  return 0;
}
"""


# -- The row functions of tests/test_rowwise.py, JAX (rows of one plane) and
# torch (row stacks, the plane axis last) ------------------------------------

DX, DT = 0.2, 0.1


def _diffusion(np_):
    roll = (lambda a, s: jnp.roll(a, s)) if np_ is jnp else (lambda a, s: torch.roll(a, s, -1))
    where = jnp.where if np_ is jnp else torch.where

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:22-28
        (u_rows,) = rows
        cur, prev = u_rows
        lap = (roll(cur, -1) - 2 * cur + roll(cur, 1)) / DX**2
        r = (cur - prev) / DT - lap
        return (where(it == 0, 0.0, r),)

    return row_fn


def _advection(np_):
    roll = (lambda a, s: jnp.roll(a, s)) if np_ is jnp else (lambda a, s: torch.roll(a, s, -1))
    where = jnp.where if np_ is jnp else torch.where

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:47-56
        (u_rows, v_rows) = rows
        (c0,) = consts
        ucur, uprev = u_rows
        vcur, _ = v_rows
        adv = vcur * (roll(ucur, -1) - roll(ucur, 1)) * 0.5
        r1 = (ucur - uprev) + adv
        r1 = where(it == 0, ucur - c0, r1)
        r2 = vcur - roll(vcur, 1)
        return (r1, r2)

    return row_fn


def _hist2_wave(np_):
    roll = (lambda a, s: jnp.roll(a, s)) if np_ is jnp else (lambda a, s: torch.roll(a, s, -1))
    where = jnp.where if np_ is jnp else torch.where

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:87-94
        (u_rows,) = rows
        cur, tm, tmm = u_rows
        u_tt = (cur - 2 * tm + tmm) / DT**2
        u_xx = (roll(tm, -1) - 2 * tm + roll(tm, 1)) / DX**2
        return (where(it <= 1, 0.0, u_tt - u_xx),)

    return row_fn


def _net_params(np_):
    """tests/test_rowwise.py:186-191: a [1, 4, 1] tanh net as the
    conductivity, its weights as params; the port's form reads them element
    by element."""
    roll = (lambda a, s: jnp.roll(a, s)) if np_ is jnp else (lambda a, s: torch.roll(a, s, -1))

    def net(x, params):
        W1, b1, W2, b2 = params
        if np_ is jnp:
            h = jnp.tanh(jnp.einsum("...i,oi->...o", x[..., None], W1) + b1)
            return (jnp.einsum("...i,oi->...o", h, W2) + b2)[..., 0]
        h = [torch.tanh(W1[o, 0] * x + b1[o]) for o in range(4)]
        return sum(W2[0, i] * h[i] for i in range(4)) + b2[0]

    def row_fn(it, T_, rows, data_rows, params, consts):
        ((cur, prev),) = rows
        (m,) = data_rows
        k = net(cur, params)
        r = (cur - prev) - k * (roll(cur, -1) - 2 * cur + roll(cur, 1))
        return (r * m,)

    return row_fn


def _vmap_fallback(np_):
    roll = (lambda a, s: jnp.roll(a, s)) if np_ is jnp else (lambda a, s: torch.roll(a, s, -1))
    where = jnp.where if np_ is jnp else torch.where

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:275-281
        (u_rows, v_rows) = rows
        ucur, uprev = u_rows
        vcur, _ = v_rows
        r1 = (ucur - uprev) + vcur * (roll(ucur, -1) - roll(ucur, 1)) * 0.5
        return (where(it == 0, 0.0, r1),)

    return row_fn


def _blocked(np_):
    roll = (lambda a, s: jnp.roll(a, s)) if np_ is jnp else (lambda a, s: torch.roll(a, s, -1))
    where = jnp.where if np_ is jnp else torch.where

    def row_fn(it, T_, rows, data_rows, params, consts):  # tests/test_rowwise.py:304-314
        (u_rows, v_rows) = rows
        (m,) = data_rows
        (wv,) = params
        cur, tm, tmm = u_rows
        vcur = v_rows[0]
        r1 = (cur - 2 * tm + tmm) + vcur * (roll(cur, -1) - roll(cur, 1)) * wv[0]
        r1 = where(it <= 1, wv[1] * cur, r1) * m
        r2 = (vcur - v_rows[1]) * wv[2]
        r2 = where(it == 0, 0.0, r2)
        return (r1, r2)

    return row_fn


def _generic_case(make, nterms, hist, nfields, params=(), data=0, consts=0, seed=3):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: (0.3 * rng.normal(size=shape)).astype(np.float32)
    inputs = ([mk(T, N) for _ in range(nfields)], [mk(*s) for s in params],
              [rng.integers(0, 2, (T, N)).astype(np.float32) for _ in range(data)], [mk(N) for _ in range(consts)])
    return make(torch), make(jnp), nterms, hist, inputs


# -- heat and wave, captured from the JAX package's operators -------------------


class _Captured(Exception):
    pass


def _jax_row(jbuild):
    """(row_fn, params, data, consts, nterms) of the JAX package's fused
    operator, captured from its ``ctx.rowwise_terms`` call."""
    from odil_tpu import context as jctx

    jp, js, _ = jbuild()

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
    raise AssertionError("the JAX operator made no row-wise call")


def _heat_args(infer_k, keep_init, keep_frozen):
    return argparse.Namespace(
        infer_k=infer_k, imposed="random", nimp=40, noise=0.0, seed=1000, kimp=2.0, kxreg=0.3, kxregdecay=0,
        ktreg=0.2, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1, keep_frozen=keep_frozen, keep_init=keep_init,
        solver="odil")


def _heat_case(infer_k, keep_init, keep_frozen, seed=5):
    """heat's row function (the port's and the JAX package's) with seeded
    fields, net noise, measurements and annealed weights."""
    from odil_tpu.models import heat as jh

    kw = dict(nt=T, nx=N, dtype=np.float32, multigrid=False, kernel="pallas",
              args=_heat_args(infer_k, keep_init, keep_frozen))
    jfn, jparams, jdata, jconsts, nterms = _jax_row(lambda: jh.build(**kw))
    p, s, e = th.build(device="cpu", **kw)
    model, names, _ = th._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
    assert len(names) == nterms
    rng = np.random.default_rng(seed)
    fields = [(0.3 * rng.normal(size=(T, N)) + 0.5).astype(np.float32)]
    params = [(np.asarray(q) + 0.3 * rng.normal(size=np.shape(q))).astype(np.float32) for q in jparams]
    data = [np.asarray(d) for d in jdata]
    if data:
        data[1] = (0.3 * rng.normal(size=(T, N))).astype(np.float32)
    consts = [np.asarray(c) for c in jconsts]
    consts[4], consts[5] = np.full((1, 1), 0.7, np.float32), np.full((1, 1), 1.3, np.float32)
    return model.row_fn, jfn, nterms, 1, (fields, params, data, consts)


def _wave_case(seed=6):
    from odil_tpu.models import wave as jw

    kw = dict(nt=T, nx=N, dtype=np.float32, multigrid=False, kernel="pallas")
    jfn, _, jdata, jconsts, nterms = _jax_row(lambda: jw.build(**kw))
    p, s, e = tw.build(device="cpu", **kw)
    model = tw._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
    rng = np.random.default_rng(seed)
    data = [(0.3 * rng.normal(size=np.shape(d))).astype(np.float32) for d in jdata]
    consts = [np.asarray(c).astype(np.float32) for c in jconsts]
    return model.row_fn, jfn, nterms, 2, ([(0.3 * rng.normal(size=(T, N))).astype(np.float32)], [], data, consts)


# The cases held against the JAX package's XLA route, not interpret mode.
JAX_XLA = {"heat_keep_init_0", "heat_keep_frozen_0"}

CASES = {
    "diffusion": lambda: _generic_case(_diffusion, 1, 1, 1),
    "advection": lambda: _generic_case(_advection, 2, 1, 2, consts=1),
    "hist2_wave": lambda: _generic_case(_hist2_wave, 1, 2, 1),
    "net_params": lambda: _generic_case(_net_params, 1, 1, 1, params=[(4, 1), (4,), (1, 4), (1,)], data=1),
    "vmap_fallback": lambda: _generic_case(_vmap_fallback, 1, 1, 2),
    "blocked": lambda: _generic_case(_blocked, 2, 2, 2, params=[(3,)], data=1),
    "heat": lambda: _heat_case(True, 1, 1),
    "heat_keep_init_0": lambda: _heat_case(True, 0, 1),
    "heat_keep_frozen_0": lambda: _heat_case(True, 1, 0),
    "heat_true_k": lambda: _heat_case(False, 1, 1),
    "wave": _wave_case,
}


def _kinds(data, consts):
    """The trace's data and const kinds of numpy inputs, as rowwise.py
    forms them."""
    return (tuple(d.shape[1] == N for d in data),
            tuple((np.size(c) != 1, np.ndim(c)) for c in consts))


def _trace(row_fn, nterms, hist, inputs):
    fields, params, data, consts = inputs
    return rt.trace(row_fn, nterms, hist, len(fields), *_kinds(data, consts), [np.shape(p) for p in params])


def _sources(root):
    """The stand-in cuda_runtime.h under root/inc and a copy of csrc under
    root/src, the launches' <<<...>>> removed (g++ does not parse them)."""
    (root / "inc").mkdir()
    (root / "inc" / "cuda_runtime.h").write_text(CUDA_STAND_IN)
    shutil.copytree(CSRC, root / "src", ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    for path in (root / "src").iterdir():
        path.write_text(re.sub(r"<<<[^;]*?>>>", "", path.read_text()))
    return ["-I" + str(root / "inc"), "-I" + str(root / "src")]


def _write_inputs(path, trace, inputs, g2):
    fields, params, data, consts = inputs
    with open(path, "wb") as fh:
        fh.write(np.array([T, N, len(data), len(consts)], np.int32).tobytes())
        fh.write(np.concatenate([f.ravel() for f in fields]).astype(np.float32).tobytes())
        for d in data:
            fh.write(np.array([d.shape[1]], np.int32).tobytes() + d.astype(np.float32).tobytes())
        for c in consts:
            fh.write(np.array([np.size(c)], np.int32).tobytes() + np.asarray(c, np.float32).tobytes())
        if params:
            fh.write(np.concatenate([np.ravel(p) for p in params]).astype(np.float32).tobytes())
        fh.write(np.asarray(g2, np.float32).tobytes())


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """{case: (trace, inputs, g, (forward sums, sums, dfields, dparams))}: every
    case's body in one g++ build, each run on its inputs."""
    root = tmp_path_factory.mktemp("rowtrace")
    includes = _sources(root)
    cases, parts = {}, []
    for i, (name, make) in enumerate(CASES.items()):
        row_fn, jfn, nterms, hist, inputs = make()
        trace = _trace(row_fn, nterms, hist, inputs)
        g = np.full(nterms, 1.0 / (T * N), np.float32) * np.linspace(1.0, 2.0, nterms, dtype=np.float32)
        cases[name] = [trace, inputs, g, row_fn, jfn, nterms, hist]
        parts.append(f"namespace case{i} {{\n{trace.body}\n}}")
        _write_inputs(root / f"in{i}.bin", trace, inputs, 2 * g)
        _write_inputs(root / f"in{i}_jax.bin", trace, inputs, np.full(nterms, 2 * G_JAX, np.float32))
    dispatch = "\n".join(f"    case {i}: return run<case{i}::TracedRow>(argv[2], argv[3]);" for i in range(len(CASES)))
    src = "\n".join([
        "#include <cstdio>", "#include <cstdlib>", "#include <vector>", '#include "rows1d.cuh"',
        '#include "rows1d_traced.cuh"', *parts, HARNESS_RUN,
        "int main(int argc, char** argv) {", "  switch (atoi(argv[1])) {", dispatch, "    default: return 3;", "  }",
        "}",
    ])
    (root / "harness.cpp").write_text(src)
    build = subprocess.run(["g++", "-std=c++17", "-O0", "-w", *includes, "-o", str(root / "harness"),
                            str(root / "harness.cpp")], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    out = {}
    for i, (name, (trace, inputs, g, *rest)) in enumerate(cases.items()):
        results = []
        for tag in ("", "_jax"):
            run = subprocess.run([str(root / "harness"), str(i), str(root / f"in{i}{tag}.bin"),
                                  str(root / f"out{i}{tag}.bin")], capture_output=True, text=True)
            assert run.returncode == 0, (name, run.returncode, run.stderr)
            raw = np.fromfile(root / f"out{i}{tag}.bin", np.float64)
            nt, nf = trace.nterms, trace.nfields
            sums_f, sums, tail = raw[:nt], raw[nt:2 * nt], raw[2 * nt:]
            dps = _split_params(tail[nf * T * N:], trace.param_shapes)
            results.append((sums_f, sums, list(tail[: nf * T * N].reshape(nf, T, N)) + dps))
        out[name] = (trace, inputs, g, *results, *rest)
    return out


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _split_params(flat, shapes):
    out, pos = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(flat[pos:pos + n].reshape(s))
        pos += n
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_traced_body_matches_plain_and_jax(harness, case):
    """The g++-built body's forward sums, backward sums, field and param
    cotangents against the port's plain version (autograd of the row
    function, CPU fp32) and the JAX package's one-pass kernel in interpret
    mode."""
    trace, (fields, params, data, consts), g, weighted, uniform, row_fn, jfn, nterms, hist = harness[case]
    tt = lambda xs: tuple(torch.as_tensor(np.array(x)) for x in xs)
    pdf, pdp, psums = trw._backward_plain(trw.RowModel(row_fn), nterms, hist, tt(fields), tt(params), tt(data),
                                          tt(consts), torch.as_tensor(g), True)
    sums_f, sums, grads = weighted
    for got in (sums_f, sums):
        _close(got, psums.numpy(), RTOL_SUMS, 0.0)
    assert len(grads) == len(pdf) + len(pdp)
    for got, want in zip(grads, list(pdf) + list(pdp)):
        _close(got, want.numpy(), RTOL_GRADS, ATOL_GRADS)
    # The JAX package, one weight for every term: its one-pass kernel in
    # interpret mode, the blocked pair (block_rows 3) for "blocked", the
    # whole-plane one (block_rows 1: it compiles in half the time) for the
    # others; for JAX_XLA its XLA route.
    jf, jp, jd, jc = ([jnp.asarray(x) for x in xs] for xs in (fields, params, data, consts))
    if case in JAX_XLA:
        def loss(f, p):
            terms = jrw.rowwise_loss_terms(jfn, f, p, jd, jc, nterms=nterms, hist=hist, _sums=True)
            return G_JAX * sum(terms), jnp.stack(terms)

        (_, jsums), (jdf, jdp) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(jf, jp)
    else:
        jsums, jdf, jdp = jrw.rowwise_loss_and_grads(jfn, jf, params=jp, data=jd, consts=jc, nterms=nterms,
                                                     hist=hist, interpret=True, gscale=G_JAX,
                                                     block_rows=3 if case == "blocked" else 1)
    sums_f, sums, grads = uniform
    for got in (sums_f, sums):
        _close(got, np.asarray(jsums), RTOL_SUMS, 0.0)
    for got, want in zip(grads, list(jdf) + list(jdp)):
        _close(got, np.asarray(want), RTOL_GRADS, ATOL_GRADS)


def test_traced_bodies_cover_the_cases(harness):
    """Each case's trace: its fields, rows back and params as the call's;
    heat's net reads its 46 params, wave's body only the samples its
    stencil takes."""
    heat, wave = harness["heat"][0], harness["wave"][0]
    assert heat.nparams == 46 and heat.nfields == 1 and heat.hist == 1
    assert harness["heat_true_k"][0].nparams == 0
    # wave: row t at x, row t-1 at x-1, x, x+1, row t-2 at x (wave_row.cuh's DUSED)
    assert wave.dused == (1 << 1 | 1 << 3 | 1 << 4 | 1 << 5 | 1 << 7)
    assert heat.ops_backward > heat.ops_forward > 0


# -- refusals, routes and the digest ---------------------------------------------


class _CardLike(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: what the dispatchers read."""

    @property
    def is_cuda(self):
        return True


def _card(ts):
    return tuple(t.as_subclass(_CardLike) for t in ts)


def _reach2(it, T_, rows, data_rows, params, consts):
    ((cur, prev),) = rows
    return (cur - prev + torch.roll(cur, 2, -1),)


def _branch(it, T_, rows, data_rows, params, consts):
    ((cur, prev),) = rows
    return (cur - prev if cur > 0 else prev,)


def _many_params(it, T_, rows, data_rows, params, consts):
    ((cur, prev),) = rows
    return (cur - prev * params[0][48],)


def _plain_diffusion(it, T_, rows, data_rows, params, consts):
    return _diffusion(torch)(it, T_, rows, data_rows, params, consts)


_SCALE = torch.full((1,), 0.5)


def _captured(it, T_, rows, data_rows, params, consts):
    ((cur, prev),) = rows
    return ((cur - prev) * _SCALE,)


REFUSALS = {
    "reach_2": (_reach2, (9, 16), (), "x-2"),
    "plane_2d": (_plain_diffusion, (9, 4, 4), (), "2-D planes"),
    "params_49": (_many_params, (9, 16), ((49,),), "49 param elements"),
    "python_branch": (_branch, (9, 16), (), "Python branch"),
    "captured_tensor": (_captured, (9, 16), (), "Tensor of shape \\(1,\\) captured"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refused_row_functions_take_plain_on_card(monkeypatch, case):
    """Each refusal names its reason, starts no build, and the call runs the
    plain version on the card, counted with its reason; the same numbers as
    the CPU route."""
    fn, shape, pshapes, reason = REFUSALS[case]
    monkeypatch.setattr(_build, "compile_generated", lambda *a, **k: pytest.fail("a refused trace started a build"))
    rng = np.random.default_rng(1)
    fields = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32),)
    params = tuple(torch.as_tensor(rng.normal(size=s), dtype=torch.float32) for s in pshapes)
    model = trw.RowModel(fn)
    call = (1, 1, _card(fields), _card(params), (), ())
    if case == "python_branch":  # its plain version branches on a whole tensor too
        spec, why = trw._traced(model, *call)
        assert spec is None and re.search(reason, why), why
        assert not trw._kernel_route(model, call[2][0], call)
        return
    assert not trw._kernel_route(model, call[2][0], call)
    spec, why = trw._traced(model, *call)
    assert spec is None and re.search(reason, why), why
    before, reasons = trw.plain_on_card.launches, trw.plain_on_card.reasons[why]
    card = trw._forward(model, *call)
    assert torch.equal(card.as_subclass(torch.Tensor), trw._forward(model, 1, 1, fields, params, (), ()))
    kd, kp, ks = trw._backward(model, *call, torch.ones(1), True)
    pd, pp, ps = trw._backward(model, 1, 1, fields, params, (), (), torch.ones(1), True)
    for a, b in zip(kd + kp + (ks,), pd + pp + (ps,)):
        assert torch.equal(a.as_subclass(torch.Tensor), b)
    assert trw.plain_on_card.launches == before + 2
    assert trw.plain_on_card.reasons[why] == reasons + 2


def _with_data_const(it, T_, rows, data_rows, params, consts):
    ((cur, prev),) = rows
    return ((cur - prev) * data_rows[0] + consts[0],)


# (fields' shape, data's shape, const's shape, the reason): shapes that the
# kernels' checks do not take.
SHAPE_REFUSALS = {
    "one_row": ((1, 16), (1, 16), (16,), "T >= 2"),
    "data_1xN": ((9, 16), (1, 16), (16,), "data of shape \\(1, 16\\)"),
    "const_3": ((9, 16), (9, 16), (3,), "const of shape \\(3,\\)"),
}


@pytest.mark.parametrize("case", list(SHAPE_REFUSALS))
def test_shapes_outside_the_kernels_are_refused(monkeypatch, case):
    """A call whose shapes the 1-D kernels do not take is refused by the
    route, before any build, with its reason."""
    fshape, dshape, cshape, reason = SHAPE_REFUSALS[case]
    monkeypatch.setattr(_build, "compile_generated", lambda *a, **k: pytest.fail("a refused call started a build"))
    call = (1, 1, _card((torch.ones(fshape),)), (), _card((torch.ones(dshape),)), _card((torch.ones(cshape),)))
    model = trw.RowModel(_with_data_const)
    spec, why = trw._traced(model, *call)
    assert spec is None and re.search(reason, why), why
    assert not trw._kernel_route(model, call[2][0], call)


def test_row_function_without_fingerprint_is_traced_at_every_call(monkeypatch):
    """A row function that closes over an object has no fingerprint: it is
    traced at every call, so a changed attribute reaches the kernel's
    source (no stale literal)."""
    box = type("Box", (), {})()
    box.scale = 0.5

    def row_fn(it, T_, rows, data_rows, params, consts):
        ((cur, prev),) = rows
        return ((cur - prev) * box.scale,)

    assert rt.fingerprint(row_fn) is None
    fields = _card((torch.ones(9, 16),))
    model = trw.RowModel(row_fn)
    first, again = (trw._traced(model, 1, 1, fields, (), (), ())[0] for _ in range(2))
    assert first is not again and first.trace.source == again.trace.source
    box.scale = 0.25
    assert trw._traced(model, 1, 1, fields, (), (), ())[0].trace.source != first.trace.source


def _record(monkeypatch, names):
    calls = []
    for name in names:
        monkeypatch.setattr(trw, name, lambda *a, name=name: calls.append((name, a[0])) or name)
    return calls


def test_traced_row_function_routes_to_the_kernels(monkeypatch, tmp_path):
    """A user row function on (stand-in) card float32 tensors of 1-D planes
    reaches the CUDA wrappers, the streaming ones with stream=True; the
    plain route's counter does not move; without nvcc the build raises (no
    fallback); 64-bit fields and CPU tensors keep the plain routes."""
    rng = np.random.default_rng(2)
    fields = (torch.as_tensor(rng.normal(size=(9, 16)), dtype=torch.float32),)
    model = trw.RowModel(_plain_diffusion)
    calls = _record(monkeypatch, ["forward_cuda", "backward_cuda", "forward_stream_cuda", "backward_stream_cuda"])
    before = trw.plain_on_card.launches
    g = torch.ones(1)
    trw._forward(model, 1, 1, _card(fields), (), (), ())
    trw._backward(model, 1, 1, _card(fields), (), (), (), g, True)
    trw._forward(model, 1, 1, _card(fields), (), (), (), stream=True)
    trw._backward(model, 1, 1, _card(fields), (), (), (), g, False, stream=True)
    assert [c for c, _ in calls] == ["forward_cuda", "backward_cuda", "forward_stream_cuda", "backward_stream_cuda"]
    assert trw.plain_on_card.launches == before
    assert isinstance(trw._traced(model, 1, 1, _card(fields), (), (), ())[0], trw._Rows1DCuda)
    assert trw._traced(model, 1, 1, _card(tuple(f.double() for f in fields)), (), (), ())[0] is None
    assert not trw._kernel_route(model, fields[0], (1, 1, fields, (), (), ()))
    monkeypatch.undo()
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        trw._forward(model, 1, 1, _card(fields), (), (), ())
    assert trw.plain_on_card.launches == before


def test_digest_follows_the_structure_and_the_literals():
    """The same row function structure traced twice gives the same source
    (one build serves it); another literal (dt) gives another source and
    another library name."""
    shapes = ((5, 1), (5, 5), (1, 5))
    pshapes = shapes + ((5,), (5,), (1,))
    flags = (True, False, False, True, False, True)
    kinds = ((True, True), ((True, 1),) * 4 + ((False, 2),) * 2)
    make = lambda dt: th._make_row_fn(dt, 0.2, 16, 0.1, 3.0, flags, shapes)
    a, b, c = (rt.trace(make(dt), 2, 1, 1, *kinds, pshapes) for dt in (0.1, 0.1, 0.1 + 1e-7))
    assert a.source == b.source and a.source != c.source
    assert _build.generated_digest(a.source) == _build.generated_digest(b.source) != _build.generated_digest(c.source)


def test_generated_unit_passes_syntax_check(tmp_path):
    """g++ -fsyntax-only on a whole generated .cu (heat's row function with
    its net): the row model, rows1d_kernel instantiated for it and the
    entry points, the launches' <<<...>>> removed."""
    row_fn, _, nterms, hist, inputs = _heat_case(True, 0, 1)
    trace = _trace(row_fn, nterms, hist, inputs)
    includes = _sources(tmp_path)
    (tmp_path / "src" / "traced.cu").write_text(trace.source)
    out = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-w", *includes, "-x", "c++",
                          str(tmp_path / "src" / "traced.cu")], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]


def test_remade_row_function_is_traced_once(monkeypatch):
    """A row function made anew with the same code and values (heat's
    operator remakes its row model every epoch) has one fingerprint and is
    traced once; another literal, another fingerprint; a function that
    closes over a tensor has none and is traced at every call."""
    shapes = ((5, 1), (5, 5), (1, 5))
    flags = (True, False, False, True, False, True)
    make = lambda dt: th._make_row_fn(dt, 0.2, 16, 0.1, 3.0, flags, shapes)
    assert rt.fingerprint(make(0.1)) == rt.fingerprint(make(0.1)) != rt.fingerprint(make(0.1 + 1e-7))
    scale = torch.ones(1)
    assert rt.fingerprint(lambda it, T_, rows, d, p, c: (rows[0][0] * scale,)) is None
    calls = []
    trace = rt.trace
    monkeypatch.setattr(rt, "trace", lambda *a: calls.append(a[0]) or trace(*a))
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    fields, data = (mk(9, 16),), (mk(9, 16), mk(9, 16))
    params = tuple(mk(*s) for s in shapes + ((5,), (5,), (1,)))
    consts = (mk(16),) * 4 + (mk(1, 1),) * 2
    specs = [trw._traced(trw.RowModel(make(dt)), 2, 1, _card(fields), params, data, consts)[0]
             for dt in (0.25, 0.25, 0.5)]
    assert len(calls) == 2 and specs[0] is specs[1] is not specs[2]


def test_operation_count_takes_a_shifted_expression_once():
    """A net evaluated at both faces of a cell (the face x+1/2 is the right
    neighbour's x-1/2, its sum's operands in the other order) counts once
    in the function's operations: the two-face function's forward counts
    as many as the one-face one's, though its body runs the net twice."""
    def net(a):
        return torch.tanh(0.3 * a + 0.1) * 0.7 + torch.sigmoid(a)

    def two_faces(it, T_, rows, data_rows, params, consts):
        ((cur, prev),) = rows
        return (net(cur + torch.roll(cur, 1, -1)) - net(cur + torch.roll(cur, -1, -1)),)

    def one_face(it, T_, rows, data_rows, params, consts):
        ((cur, prev),) = rows
        return (net(cur + torch.roll(cur, 1, -1)) - cur,)

    two, one = (rt.trace(fn, 1, 1, 1, (), (), ()) for fn in (two_faces, one_face))
    assert two.ops_forward == one.ops_forward == 10
    assert two.body.count("tanhf") == 2 and one.body.count("tanhf") == 1
    # and its adjoint once: the counts differ by the sums of cotangents only
    assert abs(two.ops_backward - one.ops_backward) <= 2
