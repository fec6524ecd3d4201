// Row-wise residual kernels for Hopper (sm_90a) over the fine fields, one
// instantiation per row model: velocity-from-tracer on (T, X, Y) planes
// (veltracer_row.cuh, the kernel below), and heat and wave on (T, N) planes
// (heat_row.cuh, wave_row.cuh through the generic 1-D kernel of rows1d.cuh,
// exported at the end as odil_rows1d_*).
//
// Replaces the TPU kernels of odil_tpu/ops/rowwise.py that the flagship's
// `--kernel pallas` route takes:
//   _forward          (:132, pallas_call at :174), whole plane, one row a program;
//   _backward         (:185, pallas_call at :292), with and without the sums;
//   _forward_blocked  (:322, pallas_call at :385), B rows a program;
//   _backward_blocked (:396, pallas_call at :549);
// and, for planes beyond the TPU's VMEM (512^2 and up), the non-padded form of
// the x-tiled pair of odil_tpu/ops/rowwise_tiled.py:
//   _forward_tiled  (:187, pallas_call at :272);
//   _backward_tiled (:283, pallas_call at :447).
// The TPU needs four shapes of one function because a plane lives whole in
// VMEM or not; a Hopper block never holds a whole plane, so one tiled design
// serves every plane size and every B.
//
// The streaming pair of odil_tpu/ops/rowwise.py (each field row read from HBM
// once, a ring of `hist` rows carried across the sequential grid, the wrap
// rows resident, `hist` residual rows recomputed at the tail for the wrapped
// targets):
//   _forward_stream  (:616, pallas_call at :676);
//   _backward_stream (:690, pallas_call at :811);
// is what these kernels do when one slab spans all T rows: the block walks
// every row of its tile once, reads the wrap rows at the start and
// recomputes the wrapped targets past the end.  The odil_rows*_stream_*
// entry points launch the same kernel bodies that way, one block per plane
// tile (the 1-D kernel on a narrower tile, rows1d.cuh); the rows that the
// slabbed launch reads twice at slab edges are read once.
//
// What the veltracer instantiation computes.  Three fields f = u, vx, vy on a (T, X, Y) grid, any
// T >= 2, X, Y >= 1 (periodic in t, x and y).  Residual row t reads rows t and
// t-1 (row 0 reads row T-1).  The forward pass gives the per-term sums of
// squares S[k] over all T rows; the backward pass gives d(sum_k g[k] S[k]) /
// d(fields) and, with the sums on, S (the training step's one-pass
// loss+grad).  Field row i collects the cotangents of residual rows i and
// i+1 (mod T), as the TPU kernels' `(i + o) % T` does.
//
// Design (the gather design of rowwise_mg.cu without the multigrid rebuild):
//   * A block owns a TILE_X x TILE_Y tile of a slab of `slab` rows and walks
//     its rows with a 3-row ring of fine rows (halo 2, periodic through
//     full-modulo index tables, so planes narrower than a tile wrap more than
//     once) in shared memory.  Each row's global loads are started into
//     registers one row ahead.  The rows at the slab edges are read twice.
//   * The thread owning cell (t, x, y) gathers its whole cotangent (the "cur"
//     adjoint of residual row t plus the "prev" adjoint of row t+1): no
//     atomics.
//   * Sums: fp64 partial sums per block, reduced by a second kernel in a
//     fixed order -- the same bits run to run.
//
// The masked per-shard pair (odil_rows_halo_*; rows_kernel<MODE, true>) is
// the port of the x-tiled pair on an edge-padded extent, the form the halo
// path (odil_tpu/halo.py:894-899, xpad_masked) runs per device shard:
//   _forward_tiled  with xpad (:187, pallas_call at :272; _apply_xpad :157-177);
//   _backward_tiled with xpad (:283, pallas_call at :447).
// The block is one shard's halo-extended piece of the grid (its own periodic
// wrap lands only in masked rows and columns), each residual is multiplied by
// the 0/1 plane mask and the row mask of its row, and the row conditions use
// global rows (RowHaloArgs: the row offset, the global T, the own rows).  The
// TPU pads the extended x extent (130 = 128 + 2 for the flagship's x:2
// shards) up to its tile; here the grid is a ceiling division over the 8x32
// tiles and every cell is guarded (`own`), so the kernel runs on the
// unpadded extent and the mask alone does what the padding's mask does.
//
// Bound on the H100 (3.35 TB/s HBM): at (65,256,256) x3 fp32 the backward
// must read the fields (51.1 MB) and the two const planes (0.5 MB) and write
// dfields (51.1 MB), ~30.7 us; the forward reads ~51.6 MB, ~15.4 us.  The
// arithmetic (about 150 fp32 operations per cell) is far below the memory
// time, so both are bound by bytes.  The heat and wave instantiations and
// their bounds are described in rows1d.cuh, heat_row.cuh and wave_row.cuh:
// heat (two network passes per cell) is bound by arithmetic, wave by bytes.

#include <type_traits>

#include "veltracer_row.cuh"
#include "heat_row.cuh"
#include "wave_row.cuh"

// Mirrored by odil_torch/ops/rowwise.py::_RowArgs (ctypes); the Python side
// checks sizeof through odil_rows_args_size().
struct RowArgs {
  const float* f[NF];   // the fine fields (T, X, Y)
  const float* u_init;  // (X, Y)
  const float* u_final;
  const float* g;       // (nterms,) loss weights, on the device
  float* df[NF];
  double* partials;     // (nblocks, MAXTERMS)
  float* sums;          // (MAXTERMS,)
  int T, X, Y, slab, nterms;
  int has_x, has_t;
  // Reciprocals of the steps (1/dt, 1/dx, ..., 1/dy^2): the residuals
  // multiply by them.
  float inv_dt, inv_dx, inv_dy, inv_dx2, inv_dy2;
  float kimp, kimp_dx, kxreg, kt;  // kimp_dx = kimp/dx, kt = ktreg/dt
};

// The masked per-shard launch (odil_rows_halo_*): RowArgs over the shard's
// halo-extended block plus the halo layer.  Mirrored by
// odil_torch/ops/rowwise.py::_RowHaloArgs (checked through
// odil_rows_halo_args_size()).
struct RowHaloArgs : RowArgs {
  const float* mask;  // (X, Y) 0/1 plane: zero on halo columns
  int off;            // global row of local row 0 (may be negative)
  int Tg;             // the global row count
  int r_lo, r_hi;     // the block's own residual rows [r_lo, r_hi)
};

namespace {

constexpr int NPOS = (HX * HY + NTHREADS - 1) / NTHREADS;

// One fine row of the tile plus its halo, all fields, held in registers so
// that the loads are in flight while the block works on the row before.
struct RowLoads {
  float v[NPOS][NF];
};

// Starts the loads of fine row r (periodic in t; -1 <= r <= T).  xi/yi: the
// plane index of each tile row and column.
__device__ __forceinline__ void fetch_row(RowLoads& L, const int* xi, const int* yi, const RowArgs& A, int r) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int rr = r < 0 ? r + A.T : (r >= A.T ? r - A.T : r);
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
      const int hx = idx / HY, hy = idx % HY;
      const size_t o = ((size_t)rr * A.X + xi[hx]) * A.Y + yi[hy];
#pragma unroll
      for (int f = 0; f < NF; ++f) L.v[k][f] = __ldg(A.f[f] + o);
    }
  }
}

// Stores the fetched row into F[0..NF).  Every thread of the block calls it;
// it ends with a barrier.
__device__ __forceinline__ void store_row(Plane* F, const RowLoads& L) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
      const int hx = idx / HY, hy = idx % HY;
#pragma unroll
      for (int f = 0; f < NF; ++f) F[f][hx][hy] = L.v[k][f];
    }
  }
  __syncthreads();
}

// The halo layer of residual rows t and it1 (local rows) and the global row
// of local row 0: none for a plain launch, the mask tile, the own rows and
// the offset for a masked one.
__device__ __forceinline__ NoHalo row_layer(const RowArgs&, const NoMask&, int, int) { return {}; }
__device__ __forceinline__ HaloRow row_layer(const RowHaloArgs& A, const MaskTile& MT, int t, int it1) {
  return {&MT.M, (t >= A.r_lo && t < A.r_hi) ? 1.0f : 0.0f, (it1 >= A.r_lo && it1 < A.r_hi) ? 1.0f : 0.0f, A.Tg};
}
__device__ __forceinline__ int row_off(const RowArgs&) { return 0; }
__device__ __forceinline__ int row_off(const RowHaloArgs& A) { return A.off; }

// MASKED: the masked per-shard form (RowHaloArgs: global rows for the row
// conditions, masked residuals); the code of the plain instantiation is
// unchanged by it.
template <int MODE, bool MASKED = false>
__global__ void __launch_bounds__(NTHREADS)
    rows_kernel(const typename std::conditional<MASKED, RowHaloArgs, RowArgs>::type A) {
  __shared__ float F[3][NF][HX][HY];  // ring of fine rows; slot of row r is (r - ts + 1) % 3
  __shared__ float U0[HX][HY];
  __shared__ Ring1 R;
  __shared__ double red[NTHREADS];
  __shared__ int xi[HX], yi[HY];
  __shared__ typename std::conditional<MASKED, MaskTile, NoMask>::type MT;

  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;
  const int x = x0 + threadIdx.y, y = y0 + threadIdx.x;
  const int i = threadIdx.y + HALO, j = threadIdx.x + HALO;
  const int T = A.T;
  const int ts = blockIdx.z * A.slab, te = min(ts + A.slab, T);
  const bool own = x < A.X && y < A.Y;
  const int off = row_off(A);
  constexpr bool grads = (MODE & MODE_GRADS) != 0;
  constexpr bool sums = (MODE & MODE_SUMS) != 0;

  for (int idx = tid; idx < HX + HY; idx += NTHREADS) {
    if (idx < HX) xi[idx] = pmod(x0 + idx - HALO, A.X);
    else yi[idx - HX] = pmod(y0 + idx - HX - HALO, A.Y);
  }
  __syncthreads();
  for (int idx = tid; idx < HX * HY; idx += NTHREADS) {
    const int hx = idx / HY, hy = idx % HY;
    U0[hx][hy] = __ldg(A.u_init + (size_t)xi[hx] * A.Y + yi[hy]);
    if constexpr (MASKED) MT.M[hx][hy] = __ldg(A.mask + (size_t)xi[hx] * A.Y + yi[hy]);
  }
  float g2[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) g2[k] = (grads && k < A.nterms) ? 2.0f * __ldg(A.g + k) : 0.0f;
  float s[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) s[k] = 0.0f;

  RowLoads L;
  fetch_row(L, xi, yi, A, ts - 1);
  store_row(F[0], L);
  if (grads) {
    fetch_row(L, xi, yi, A, ts);
    store_row(F[1], L);
  }
  // The row each iteration adds to the ring: t+1 for the gradients, t else.
  const int ahead = grads ? 1 : 0;
  fetch_row(L, xi, yi, A, ts + ahead);
  for (int t = ts; t < te; ++t) {
    const int sm = (t - ts) % 3, sc = (t - ts + 1) % 3, sp = (t - ts + 2) % 3;
    store_row(F[grads ? sp : sc], L);
    if (t + 1 < te) fetch_row(L, xi, yi, A, t + 1 + ahead);  // in flight during this row's work
    const RowPlanes P{F[sm][0], F[sc][0], F[sp][0], F[sm][1], F[sc][1], F[sp][1], F[sm][2], F[sc][2], F[sp][2], U0};
    const int it1 = t + 1 < T ? t + 1 : 0;  // residual row t+1 (row 0 after T-1)
    const auto H = row_layer(A, MT, t, it1);

    if (grads) stage_ring1(A, P, it1 + off, g2, R, H);
    if (own) {
      const float u1 = __ldg(A.u_final + (size_t)x * A.Y + y);
      float d[NF];
      cell_terms<grads, sums>(A, P, R, t + off, it1 + off, i, j, u1, g2, s, d, H);
      if (grads) {
        const size_t cell = ((size_t)t * A.X + x) * A.Y + y;
#pragma unroll
        for (int f = 0; f < NF; ++f) A.df[f][cell] = d[f];
      }
    }
    __syncthreads();
  }

  if (sums) write_partials(A, s, red);
}

dim3 rows_grid(const RowArgs& A) {
  return dim3((A.Y + TILE_Y - 1) / TILE_Y, (A.X + TILE_X - 1) / TILE_X, (A.T + A.slab - 1) / A.slab);
}

}  // namespace

extern "C" {

int odil_rows_args_size() { return (int)sizeof(RowArgs); }

int odil_rows_num_blocks(int T, int X, int Y, int slab) {
  return ((Y + TILE_Y - 1) / TILE_Y) * ((X + TILE_X - 1) / TILE_X) * ((T + slab - 1) / slab);
}

const char* odil_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Loss-only pass (_forward): per-term sums of squares into A->sums.
int odil_rows_forward(const RowArgs* a, void* stream) {
  const RowArgs A = *a;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = rows_grid(A);
  rows_kernel<MODE_SUMS><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_sums_kernel<RowArgs><<<1, NTHREADS, 0, s>>>(A, (int)(grid.x * grid.y * grid.z));
  return (int)cudaGetLastError();
}

// Gradient pass (_backward): dfields, plus the sums when with_sums.
int odil_rows_backward(const RowArgs* a, int with_sums, void* stream) {
  const RowArgs A = *a;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = rows_grid(A);
  if (with_sums) rows_kernel<MODE_SUMS | MODE_GRADS><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  else rows_kernel<MODE_GRADS><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_sums) return (int)err;
  reduce_sums_kernel<RowArgs><<<1, NTHREADS, 0, s>>>(A, (int)(grid.x * grid.y * grid.z));
  return (int)cudaGetLastError();
}

// The streaming pair (_forward_stream, _backward_stream): the same passes
// with one slab of all T rows (A->slab must be A->T).
int odil_rows_stream_forward(const RowArgs* a, void* stream) {
  if (a->slab != a->T) return (int)cudaErrorInvalidValue;
  return odil_rows_forward(a, stream);
}

int odil_rows_stream_backward(const RowArgs* a, int with_sums, void* stream) {
  if (a->slab != a->T) return (int)cudaErrorInvalidValue;
  return odil_rows_backward(a, with_sums, stream);
}

// The masked per-shard pair (_forward_tiled / _backward_tiled with xpad).
int odil_rows_halo_args_size() { return (int)sizeof(RowHaloArgs); }

int odil_rows_halo_forward(const RowHaloArgs* a, void* stream) {
  const RowHaloArgs A = *a;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = rows_grid(A);
  rows_kernel<MODE_SUMS, true><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_sums_kernel<RowArgs><<<1, NTHREADS, 0, s>>>(A, (int)(grid.x * grid.y * grid.z));
  return (int)cudaGetLastError();
}

int odil_rows_halo_backward(const RowHaloArgs* a, int with_sums, void* stream) {
  const RowHaloArgs A = *a;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = rows_grid(A);
  if (with_sums) rows_kernel<MODE_SUMS | MODE_GRADS, true><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  else rows_kernel<MODE_GRADS, true><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_sums) return (int)err;
  reduce_sums_kernel<RowArgs><<<1, NTHREADS, 0, s>>>(A, (int)(grid.x * grid.y * grid.z));
  return (int)cudaGetLastError();
}

// The 1-D row models, by id: 0 heat, 1 wave (odil_torch/ops/rowwise.py);
// `stream` selects the streaming launch (A->slab must then be A->T).
int odil_rows1d_args_size() { return (int)sizeof(rows1d::Rows1DArgs); }

int odil_rows1d_num_blocks(int T, int N, int slab, int stream) {
  const int tw = rows1d::tile_of(stream != 0);
  return ((N + tw - 1) / tw) * (stream ? 1 : (T + slab - 1) / slab);
}

static int rows1d_forward(int model, const rows1d::Rows1DArgs* a, bool stream, void* cs) {
  cudaStream_t s = (cudaStream_t)cs;
  if (stream && a->slab != a->T) return (int)cudaErrorInvalidValue;
  switch (model) {
    case 0: return rows1d::forward<rows1d::HeatRow>(*a, stream, s);
    case 1: return rows1d::forward<rows1d::WaveRow>(*a, stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

static int rows1d_backward(int model, const rows1d::Rows1DArgs* a, int with_sums, bool stream, void* cs) {
  cudaStream_t s = (cudaStream_t)cs;
  if (stream && a->slab != a->T) return (int)cudaErrorInvalidValue;
  switch (model) {
    case 0: return rows1d::backward<rows1d::HeatRow>(*a, with_sums, stream, s);
    case 1: return rows1d::backward<rows1d::WaveRow>(*a, with_sums, stream, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int odil_rows1d_forward(int model, const rows1d::Rows1DArgs* a, void* stream) {
  return rows1d_forward(model, a, false, stream);
}

int odil_rows1d_backward(int model, const rows1d::Rows1DArgs* a, int with_sums, void* stream) {
  return rows1d_backward(model, a, with_sums, false, stream);
}

int odil_rows1d_stream_forward(int model, const rows1d::Rows1DArgs* a, void* stream) {
  return rows1d_forward(model, a, true, stream);
}

int odil_rows1d_stream_backward(int model, const rows1d::Rows1DArgs* a, int with_sums, void* stream) {
  return rows1d_backward(model, a, with_sums, true, stream);
}

}  // extern "C"
