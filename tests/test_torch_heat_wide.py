"""The host side of the heat row kernels' wide form (conductivity nets of
more than 48 params, ``csrc/heat_wide.cuh``; the kernels run only on the
card):

- the layout's checks at build time: ``csrc/heat_net.cu`` for each net
  through g++ (syntax only: a stand-in ``cuda_runtime.h`` of declarations,
  the launches' ``<<<...>>>`` removed), where the static_asserts of
  ``heat_wide.cuh`` hold every flat param owned by exactly one slot of one
  job of its own layer's param products and the weights, sums and records
  within their budget; and a copy whose jobs own a param twice, which the
  build refuses;
- the tile search with the wide form's batches (``_tile_rows(...,
  batches)``): every cell covered once, whole waves, no candidate slab of a
  lower cost; ``_heat_batches`` from a library's batch rows and the model's
  keep_frozen;
- the build of a net's library: its defines and its name;
- the one-pass route (the kernels' plain version) of a net whose widths are
  no multiple of 4, keep_frozen off, against the JAX package's loss and
  jax.grad on its XLA route (fp32: terms rtol 1e-5, gradients rtol 1e-4
  with atol 1e-6 * max|ref|).
"""

import argparse
import pathlib
import re
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from odil_torch.convert import arrays_from_numpy
from odil_torch.models import heat as th
from odil_torch.ops import rowwise as trw

# The kernels' tile (csrc/rows1d.cuh: TILE, NTHREADS) and the wide form's
# slab limit (csrc/heat_row.cuh: WIDE_SLAB).
TILE, THREADS, WIDE_SLAB = 32, 256, 14
NETS = [(32, 32), (16, 16, 16), (31, 7, 13), (32, 32, 32), (4, 4, 4), (9,), (5, 5), (3, 4), (1, 1, 1), (32,)]
CSRC = pathlib.Path(trw.__file__).resolve().parent.parent / "csrc"
# What the kernels' sources take from the CUDA runtime, declared for g++.
CUDA_STAND_IN = """#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
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
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
float4 make_float4(float, float, float, float);
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess, cudaErrorInvalidValue, cudaFuncAttributeMaxDynamicSharedMemorySize,
       cudaDevAttrMultiProcessorCount };
void __syncthreads();
int __syncthreads_or(int);
int __syncthreads_count(int);
void __syncwarp(unsigned = 0);
template <class T> T __shfl_xor_sync(unsigned, T, int);
template <class T> T __shfl_down_sync(unsigned, T, int);
template <class T> T __shfl_up_sync(unsigned, T, int);
template <class T> T __shfl_sync(unsigned, T, int);
unsigned __ballot_sync(unsigned, int);
int __popc(unsigned);
unsigned atomicAdd(unsigned*, unsigned);
void __threadfence();
template <class T> T __ldg(const T*);
template <class T> T __ldcg(const T*);
template <class T> void __stcg(T*, T);
unsigned __float_as_uint(float);
float __uint_as_float(unsigned);
float __fdividef(float, float);
float __expf(float);
size_t __cvta_generic_to_shared(const void*);
const char* cudaGetErrorString(cudaError_t);
cudaError_t cudaGetLastError();
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, int, int);
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int);
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t);
"""
# The mutation: every job's second column of inputs the same as its first.
DOUBLE_OWNER = ("i = job / ob(l) + ib(l) * ji;", "i = job / ob(l);")


def _sources(root, edit=None):
    """A copy of csrc under root, the launches' ``<<<...>>>`` removed (and
    ``edit``, (old, new), made in heat_wide.cuh), with the stand-in."""
    (root / "inc").mkdir(parents=True)
    (root / "inc" / "cuda_runtime.h").write_text(CUDA_STAND_IN)
    shutil.copytree(CSRC, root / "src", ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    for path in (root / "src").iterdir():
        text = re.sub(r"<<<[^;]*?>>>", "", path.read_text())
        if edit and path.name == "heat_wide.cuh":
            assert text.count(edit[0]) == 1
            text = text.replace(*edit)
        path.write_text(text)
    return root


def _gxx(root, widths):
    slots = tuple(widths) + (0,) * (3 - len(widths))
    defines = [f"-DODIL_HEAT_W{i + 1}={w}" for i, w in enumerate(slots)]
    return subprocess.Popen(["g++", "-std=c++17", "-fsyntax-only", "-w", "-I" + str(root / "inc"), "-x", "c++",
                             *defines, str(root / "src" / "heat_net.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def syntax_builds(tmp_path_factory):
    """{widths or "double owner": (g++'s exit code, its output)}: every
    build started at once."""
    root = _sources(tmp_path_factory.mktemp("csrc"))
    bad = _sources(tmp_path_factory.mktemp("csrc_double_owner"), DOUBLE_OWNER)
    procs = {w: _gxx(root, w) for w in NETS}
    procs["double owner"] = _gxx(bad, (31, 7, 13))
    return {k: (p.wait(), p.stdout.read()) for k, p in procs.items()}


@pytest.mark.parametrize("widths", NETS, ids=lambda w: "w" + "x".join(map(str, w)))
def test_wide_layout_owns_every_param_once(syntax_builds, widths):
    """heat_net.cu builds for the net: heat_wide.cuh's static_asserts hold
    each flat param in one slot of one job of its own layer and the
    weights, sums and records within the budget (two blocks an SM up to 16
    units a layer)."""
    rc, out = syntax_builds[widths]
    assert rc == 0, out


def test_wide_layout_check_refuses_a_double_owner(syntax_builds):
    """The same build with jobs that own a param twice fails at the
    ownership assert: the check is live."""
    rc, out = syntax_builds["double owner"]
    assert rc != 0 and "own each param once" in out, out


def _batch_cost(T, N, resident, slab, batches):
    tiles = -(-T // slab) * -(-N // TILE)
    threads, weight, passes = batches
    per = weight * -(-(slab + 1) * (TILE + 3) // threads) + 2 * -(-slab * (TILE + 1) // passes)
    return (-(-tiles // resident) * per, tiles)


@pytest.mark.parametrize("T, N, resident, batches", [
    (1024, 1024, 264, (256, 2, 128)), (1024, 1024, 132, (256, 2, 256)), (64, 64, 132, (256, 2, 256)),
    (64, 64, 264, (256, 1, 128)), (257, 1024, 264, (256, 2, 128)), (256, 256, 132, (256, 2, 256)),
    (7, 5, 4, (256, 2, 64)), (2, 3, 2, (256, 1, 128)), (33, 257, 7, (256, 2, 128)),
])
def test_wide_tile_rows_cover_every_cell_once(T, N, resident, batches):
    """The wide form's tile search: slabs of at most WIDE_SLAB rows that
    cover each cell once, no more blocks than the card holds, and no
    balanced slab that runs the launch's batches in fewer rounds."""
    slab, blocks = trw._tile_rows(T, N, 1, True, resident, TILE, WIDE_SLAB, THREADS, batches)
    assert 1 <= slab <= min(T, WIDE_SLAB)
    ntiles = -(-N // TILE) * -(-T // slab)
    assert blocks == min(ntiles, resident)
    seen = np.zeros((T, N), dtype=int)
    for tile in range(ntiles):
        t0, x0 = tile // -(-N // TILE) * slab, tile % -(-N // TILE) * TILE
        seen[t0 : t0 + slab, x0 : x0 + TILE] += 1
    assert (seen == 1).all()
    best = _batch_cost(T, N, resident, slab, batches)
    for cand in {-(-T // nz) for nz in range(1, T + 1)}:
        assert cand > WIDE_SLAB or _batch_cost(T, N, resident, cand, batches) >= best


def test_heat_batches_follow_the_library_and_keep_frozen():
    """A face a thread in the face phase (a net of twice the weight with the
    tangent: the gradients with keep_frozen off), the library's batch of
    records in the param phase; none from a library without the wide form."""
    lib = types.SimpleNamespace(_odil_wide_rows=128, _odil_rows1d_tile=(TILE, WIDE_SLAB, THREADS))
    model = lambda kf: types.SimpleNamespace(scalars=dict(keep_frozen=kf))
    assert trw._heat_batches(lib, model(False), True) == (256, 2, 128)
    assert trw._heat_batches(lib, model(False), False) == (256, 1, 128)
    assert trw._heat_batches(lib, model(True), True) == (256, 1, 128)
    assert trw._heat_batches(types.SimpleNamespace(), model(False), True) is None


def test_heat_net_source_names_every_net():
    """One library a net: its hidden widths in the name, a macro a hidden
    layer, 0 past the last."""
    assert trw.heat_net_source((31, 7, 13)) == (
        "heat_net", "w31x7x13", (("ODIL_HEAT_W1", 31), ("ODIL_HEAT_W2", 7), ("ODIL_HEAT_W3", 13)))
    assert trw.heat_net_source((32, 32)) == (
        "heat_net", "w32x32", (("ODIL_HEAT_W1", 32), ("ODIL_HEAT_W2", 32), ("ODIL_HEAT_W3", 0)))


def test_uneven_wide_net_matches_jax():
    """The one-pass route of a [1, 13, 7, 1] net with keep_frozen off
    (132 params: the wide form on the card; here its plain version, which
    the card holds the kernels to) against the JAX package's loss and
    jax.grad on its XLA route, fp32 at 8x8."""
    from odil_tpu.models import heat as jh

    args = argparse.Namespace(infer_k=True, imposed="random", nimp=40, noise=0.0, seed=1000, kimp=2.0, kxreg=0.3,
                              kxregdecay=5, ktreg=0.2, ktregdecay=3, kwreg=0.1, kwregdecay=4, kmax=0.1, keep_frozen=0,
                              keep_init=1, solver="odil")
    size = dict(nt=8, nx=8, dtype=np.float32, arch_k=(13, 7), args=args)
    jp, js, _ = jh.build(kernel="xla", **size)
    tp, ts, _ = th.build(kernel="pallas", device="cpu", **size)
    rng = np.random.default_rng(19)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(np.float32) for a in jp.domain.arrays_from_state(js)]
    jp.tracers["epoch"] = tp.tracers["epoch"] = 2
    loss_fn = jp.make_loss_fn(js)[0]
    (jl, (jterms, _)), jg = jax.jit(jax.value_and_grad(lambda x: loss_fn(x, jp.tracers), has_aux=True))(
        [jnp.asarray(a) for a in arrays])
    fn = tp.make_loss_grad_fn(ts)
    assert fn is not None
    (loss, (terms, _)), grads = fn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-30)
    assert len(grads) == len(jg)
    for a, b in zip(grads, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(b).max())))
