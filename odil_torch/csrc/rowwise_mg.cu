// Multigrid-fused row-wise residual kernels for Hopper (sm_90a), specialised
// to the velocity-from-tracer row model.
//
// Replaces the TPU kernels of odil_tpu/ops/rowwise_mg.py:
//   _backward_mg (:350, pallas_call at :766), with and without the sums;
//   _forward_mg  (:257, pallas_call at :336).
//
// What they compute.  Three fields f = u, vx, vy live on a (T, X, Y) grid
// (t node-located, T odd; x, y cell-located and periodic in the residual).
// Each field is given as its level-0 multigrid term t0 (T, X, Y) and the
// level-1 Horner partial P (Tc, X/2, Y/2), and the fine field is rebuilt as
//   fine[r] = f0 * t0[r] + Wx . blend_t(P[r/2], P[r/2+1]) . Wy^T
// with the exact 2-tap prolongation stencils: along x and y the weights
// (1,3)/4 and (3,1)/4 with linear-extrapolation ghosts at the edges, along t
// the node midpoints.  Residual row t reads fine rows t and t-1 (periodic in
// t: row 0 reads row T-1).  The forward pass sums the squares of the six
// residual terms; the backward pass emits dt0 = f0 * dfine and
// dP = down2d(blend_t^T(dfine)) for the loss sum_k g[k] * S[k], and with
// the sums on it also returns S (the training step's one-pass loss+grad).
//
// How the TPU design is restated.  The Pallas kernels walk t sequentially on
// one core and carry fine rows, cotangents and coarse-row accumulators from
// one grid step to the next in VMEM rings.  Hopper blocks run concurrently
// and in no order, and a 256^2 fp32 plane (256 KiB) does not fit a block's
// 227 KB of shared memory.  So:
//   * Gather, not scatter: the thread that owns fine cell (t, x, y) computes
//     its whole cotangent -- the "cur" adjoint of residual row t plus the
//     "prev" adjoint of residual row t+1 (row 0's prev is row T-1).  The
//     residual values that neighbouring cells share (the advection weights
//     of row t+1, the Laplacian terms of row t) are computed once per row on
//     the tile plus a ring of one cell into shared memory.  No atomics.
//   * Tiles: a block owns TILE_X x TILE_Y cells of a slab of `slab` rows and
//     walks its rows with a 3-row ring of rebuilt fine rows (halo 2, periodic
//     wrap) in shared memory; rows at the slab edges are rebuilt twice.  Each
//     row is rebuilt from a window of t-blended coarse values staged in
//     shared memory (two loads per coarse value instead of eight per fine
//     value), and its global loads are issued into registers one row ahead,
//     so that they are in flight while the block works on the row before.
//   * Sums: each block writes its partial sums (fp64) to a buffer that a
//     second kernel reduces in a fixed order -- deterministic run to run.
//   * dP: a third kernel reads dt0 back and applies the transposed t-blend and
//     x/y prolongation per coarse cell (a tile staged in shared memory).
//     That extra full-size read is the first thing a later design removes.
//   * The row model's residuals, their adjoint, the ring-1 staging and the
//     partial-sum reduction are device code of veltracer_row.cuh, shared with
//     the generic row kernels of rowwise.cu.
//
// Bound on the H100 (3.35 TB/s HBM): at the flagship shapes (65,256,256) x3
// the backward must read t0 (51.1 MB) and P (6.5 MB) and write dt0 and dP
// (57.6 MB): ~115 MB, ~35 us.  The forward reads half of that, ~17 us.  The
// arithmetic (a few hundred fp32 operations per cell) is far below the
// memory time, so both are bound by bytes.

#include "veltracer_row.cuh"

namespace {

constexpr int CT = 16;            // coarse tile of the dP kernel
constexpr int FW = 2 * CT + 4;    // fine window covering a coarse tile's taps

}  // namespace

// Mirrored by odil_torch/ops/rowwise_mg.py::_MgArgs (ctypes); the Python side
// checks sizeof through odil_mg_args_size().
struct MgArgs {
  const float* t0[NF];
  const float* P[NF];
  const float* u_init;
  const float* u_final;
  const float* g;     // (nterms,) loss weights, on the device
  float* dt0[NF];
  float* dP[NF];
  double* partials;   // (nblocks, MAXTERMS)
  float* sums;        // (MAXTERMS,)
  int T, X, Y, Tc, CX, CY, slab, nterms;
  int has_x, has_t;
  float f0[NF];
  float inv_f0[NF];
  // Reciprocals of the steps (1/dt, 1/dx, ..., 1/dy^2): the residuals
  // multiply by them.  For the usual power-of-two steps that is exactly the
  // JAX package's division.
  float inv_dt, inv_dx, inv_dy, inv_dx2, inv_dy2;
  float kimp, kimp_dx, kxreg, kt;  // kimp_dx = kimp/dx, kt = ktreg/dt
};

namespace {

// The two coarse taps (index, weight) of fine index x along a cell axis with
// n coarse cells: fine[2i] = (c[i-1] + 3c[i])/4, fine[2i+1] = (3c[i] + c[i+1])/4,
// linear-extrapolation ghosts at both ends (transfer._interp_axis).
__device__ __forceinline__ void taps(int x, int n, int& a0, float& w0, int& a1, float& w1) {
  const int i = x >> 1;
  if ((x & 1) == 0) {
    if (i == 0) { a0 = 0; w0 = 1.25f; a1 = 1; w1 = -0.25f; }
    else { a0 = i - 1; w0 = 0.25f; a1 = i; w1 = 0.75f; }
  } else {
    if (i == n - 1) { a0 = n - 1; w0 = 1.25f; a1 = n - 2; w1 = -0.25f; }
    else { a0 = i; w0 = 0.75f; a1 = i + 1; w1 = 0.25f; }
  }
}

// Weight of coarse index a in fine index x (the prolongation matrix entry).
__device__ __forceinline__ float tap_weight(int x, int a, int n) {
  int a0, a1;
  float w0, w1;
  taps(x, n, a0, w0, a1, w1);
  return (a0 == a ? w0 : 0.0f) + (a1 == a ? w1 : 0.0f);
}

// The blended coarse window a tile's fine rows read: coarse x indices
// ax0 .. ax0+WX-1 and y indices by0 .. by0+WY-1 (periodic), with
// ax0 = x0/2 - 2, by0 = y0/2 - 2.  Every coarse tap of the tile's fine cells,
// halo and edge extrapolation included, lies in it.
constexpr int WX = TILE_X / 2 + 4, WY = TILE_Y / 2 + 4;

struct RowStage {
  float CB[NF][WX][WY];  // blend_t of P's two coarse rows over the window
  int ta[HX][2];         // x taps of each tile row: window indices and weights
  float tw[HX][2];
  int tb[HY][2];
  float sw[HY][2];
  int xi[HX], yi[HY];    // plane x and y of each tile row and column (periodic)
};

// Window index of coarse index a (0 <= a < n) for a window starting at a0.
__device__ __forceinline__ int win(int a, int a0, int n) { return pmod(a - a0, n); }

// The plane indices of the tile's fine rows and columns and their taps, as
// window indices (once per block).
__device__ void init_taps(RowStage& S, const MgArgs& A, int x0, int y0) {
  const int ax0 = (x0 >> 1) - 2, by0 = (y0 >> 1) - 2;
  for (int idx = threadIdx.y * TILE_Y + threadIdx.x; idx < HX + HY; idx += NTHREADS) {
    int a0, a1;
    float w0, w1;
    if (idx < HX) {
      S.xi[idx] = pmod(x0 + idx - HALO, A.X);
      taps(S.xi[idx], A.CX, a0, w0, a1, w1);
      S.ta[idx][0] = win(a0, ax0, A.CX);
      S.ta[idx][1] = win(a1, ax0, A.CX);
      S.tw[idx][0] = w0;
      S.tw[idx][1] = w1;
    } else {
      const int k = idx - HX;
      S.yi[k] = pmod(y0 + k - HALO, A.Y);
      taps(S.yi[k], A.CY, a0, w0, a1, w1);
      S.tb[k][0] = win(a0, by0, A.CY);
      S.tb[k][1] = win(a1, by0, A.CY);
      S.sw[k][0] = w0;
      S.sw[k][1] = w1;
    }
  }
}

// The global loads of one fine row, held in registers so that they are in
// flight while the block works on the previous row: this thread's share of
// the coarse window (two coarse rows) and of the tile's t0 values.
constexpr int NCB = (NF * WX * WY + NTHREADS - 1) / NTHREADS;
constexpr int NPOS = (HX * HY + NTHREADS - 1) / NTHREADS;

struct RowLoads {
  int rr;
  float p0[NCB], p1[NCB];
  float t0[NPOS][NF];
};

// Issues the loads of fine row r (periodic in t).
__device__ __forceinline__ void fetch_row(RowLoads& L, const RowStage& S, const MgArgs& A, int r, int x0, int y0) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int rr = r < 0 ? r + A.T : (r >= A.T ? r - A.T : r);
  L.rr = rr;
  const int c0 = rr >> 1;
  const int c1 = min(c0 + 1, A.Tc - 1);
  const int ax0 = (x0 >> 1) - 2, by0 = (y0 >> 1) - 2;
  const size_t cplane = (size_t)A.CX * A.CY;
#pragma unroll
  for (int k = 0; k < NCB; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < NF * WX * WY) {
      const int f = idx / (WX * WY), la = (idx / WY) % WX, lb = idx % WY;
      const int a = pmod(ax0 + la, A.CX), b = pmod(by0 + lb, A.CY);
      const size_t o = (size_t)a * A.CY + b;
      L.p0[k] = __ldg(A.P[f] + c0 * cplane + o);
      L.p1[k] = __ldg(A.P[f] + c1 * cplane + o);
    }
  }
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
      const int hx = idx / HY, hy = idx % HY;
      const size_t fine = ((size_t)rr * A.X + S.xi[hx]) * A.Y + S.yi[hy];
#pragma unroll
      for (int f = 0; f < NF; ++f) L.t0[k][f] = __ldg(A.t0[f] + fine);
    }
  }
}

// Rebuilds the fetched fine row of every field for the block's tile plus a
// halo of HALO cells (periodic in x and y) into F[0..NF):
// fine = f0 * t0[r] + Wx . blend_t(P[r/2], P[r/2+1]) . Wy^T, with the
// blended coarse window staged in shared memory first.  Contains barriers,
// so every thread of the block must call it; it ends with one.
__device__ void build_row(Plane* F, RowStage& S, const MgArgs& A, const RowLoads& L) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const float w = (L.rr & 1) ? 0.5f : 0.0f;
#pragma unroll
  for (int k = 0; k < NCB; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < NF * WX * WY) (&S.CB[0][0][0])[idx] = (1.0f - w) * L.p0[k] + w * L.p1[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
      const int hx = idx / HY, hy = idx % HY;
      const int a0 = S.ta[hx][0], a1 = S.ta[hx][1], b0 = S.tb[hy][0], b1 = S.tb[hy][1];
      const float wa0 = S.tw[hx][0], wa1 = S.tw[hx][1], wb0 = S.sw[hy][0], wb1 = S.sw[hy][1];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float in0 = S.CB[f][a0][b0] * wb0 + S.CB[f][a0][b1] * wb1;
        const float in1 = S.CB[f][a1][b0] * wb0 + S.CB[f][a1][b1] * wb1;
        F[f][hx][hy] = A.f0[f] * L.t0[k][f] + (wa0 * in0 + wa1 * in1);
      }
    }
  }
  __syncthreads();
}

// At least 4 blocks per SM: without the bound the compiler spends 75
// registers on the backward+sums form (3 blocks per SM) and the kernel runs
// 8% slower than with 64.
template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 4) mg_rows_kernel(const MgArgs A) {
  __shared__ float F[3][NF][HX][HY];  // ring of fine rows; slot of row r is (r - ts + 1) % 3
  __shared__ float U0[HX][HY];
  __shared__ Ring1 R;
  __shared__ double red[NTHREADS];
  __shared__ RowStage S;

  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;
  const int x = x0 + threadIdx.y, y = y0 + threadIdx.x;
  const int i = threadIdx.y + HALO, j = threadIdx.x + HALO;
  const int T = A.T;
  const int ts = blockIdx.z * A.slab, te = min(ts + A.slab, T);
  const bool own = x < A.X && y < A.Y;
  constexpr bool grads = (MODE & MODE_GRADS) != 0;
  constexpr bool sums = (MODE & MODE_SUMS) != 0;

  for (int idx = tid; idx < HX * HY; idx += NTHREADS) {
    const int hx = idx / HY, hy = idx % HY;
    U0[hx][hy] = __ldg(A.u_init + (size_t)pmod(x0 + hx - HALO, A.X) * A.Y + pmod(y0 + hy - HALO, A.Y));
  }
  float g2[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) g2[k] = (grads && k < A.nterms) ? 2.0f * __ldg(A.g + k) : 0.0f;
  float s[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) s[k] = 0.0f;

  init_taps(S, A, x0, y0);
  __syncthreads();
  RowLoads L;
  fetch_row(L, S, A, ts - 1, x0, y0);
  build_row(F[0], S, A, L);
  if (grads) {
    fetch_row(L, S, A, ts, x0, y0);
    build_row(F[1], S, A, L);
  }
  // The row each iteration adds to the ring: t+1 for the gradients, t else.
  const int ahead = grads ? 1 : 0;
  fetch_row(L, S, A, ts + ahead, x0, y0);
  for (int t = ts; t < te; ++t) {
    const int sm = (t - ts) % 3, sc = (t - ts + 1) % 3, sp = (t - ts + 2) % 3;
    build_row(F[grads ? sp : sc], S, A, L);
    if (t + 1 < te) fetch_row(L, S, A, t + 1 + ahead, x0, y0);  // in flight during this row's work
    const RowPlanes P{F[sm][0], F[sc][0], F[sp][0], F[sm][1], F[sc][1], F[sp][1], F[sm][2], F[sc][2], F[sp][2], U0};
    const int it1 = t + 1 < T ? t + 1 : 0;  // residual row t+1 (row 0 after T-1)

    if (grads) stage_ring1(A, P, it1, g2, R);
    if (own) {
      const float u1 = __ldg(A.u_final + (size_t)x * A.Y + y);
      float d[NF];
      cell_terms<grads, sums>(A, P, R, t, it1, i, j, u1, g2, s, d);
      if (grads) {
        const size_t cell = ((size_t)t * A.X + x) * A.Y + y;
        A.dt0[0][cell] = A.f0[0] * d[0];
        A.dt0[1][cell] = A.f0[1] * d[1];
        A.dt0[2][cell] = A.f0[2] * d[2];
      }
    }
    __syncthreads();
  }

  if (sums) write_partials(A, s, red);
}

// dP[f][c] = Wx^T (0.5 d[2c-1] + d[2c] + 0.5 d[2c+1]) Wy with d = dt0[f] / f0[f]:
// the transposed t-blend and x/y prolongation, gathered per coarse cell.
__global__ void __launch_bounds__(CT * CT) mg_coarse_grad_kernel(const MgArgs A) {
  __shared__ float S1[FW][FW + 1];
  __shared__ float S2[FW][CT + 1];
  const int f = blockIdx.z % NF, c = blockIdx.z / NF;
  const int a0 = blockIdx.y * CT, b0 = blockIdx.x * CT;
  const int xs = 2 * a0 - 2, ys = 2 * b0 - 2;
  const int tid = threadIdx.y * CT + threadIdx.x;
  const float* d = A.dt0[f];
  const float inv = A.inv_f0[f];
  const size_t plane = (size_t)A.X * A.Y;

  for (int idx = tid; idx < FW * FW; idx += CT * CT) {
    const int i = idx / FW, j = idx % FW;
    const int x = xs + i, y = ys + j;
    float v = 0.0f;
    if (x >= 0 && x < A.X && y >= 0 && y < A.Y) {
      const size_t o = (size_t)x * A.Y + y;
      const int r = 2 * c;
      v = (c >= 1 ? 0.5f * (d[(size_t)(r - 1) * plane + o] * inv) : 0.0f) + d[(size_t)r * plane + o] * inv;
      if (r + 1 < A.T) v = v + 0.5f * (d[(size_t)(r + 1) * plane + o] * inv);
    }
    S1[i][j] = v;
  }
  __syncthreads();
  for (int idx = tid; idx < FW * CT; idx += CT * CT) {
    const int i = idx / CT, bb = idx % CT;
    const int b = b0 + bb;
    float acc = 0.0f;
    if (b < A.CY) {
      for (int y = max(2 * b - 2, 0); y <= min(2 * b + 3, A.Y - 1); ++y) acc += tap_weight(y, b, A.CY) * S1[i][y - ys];
    }
    S2[i][bb] = acc;
  }
  __syncthreads();
  const int a = a0 + threadIdx.y, b = b0 + threadIdx.x;
  if (a < A.CX && b < A.CY) {
    float acc = 0.0f;
    for (int x = max(2 * a - 2, 0); x <= min(2 * a + 3, A.X - 1); ++x) acc += tap_weight(x, a, A.CX) * S2[x - xs][threadIdx.x];
    A.dP[f][((size_t)c * A.CX + a) * A.CY + b] = acc;
  }
}

dim3 rows_grid(const MgArgs& A) {
  return dim3((A.Y + TILE_Y - 1) / TILE_Y, (A.X + TILE_X - 1) / TILE_X, (A.T + A.slab - 1) / A.slab);
}

}  // namespace

extern "C" {

int odil_mg_args_size() { return (int)sizeof(MgArgs); }

int odil_mg_num_blocks(int T, int X, int Y, int slab) {
  return ((Y + TILE_Y - 1) / TILE_Y) * ((X + TILE_X - 1) / TILE_X) * ((T + slab - 1) / slab);
}

const char* odil_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Loss-only pass (_forward_mg): per-term sums of squares into A->sums.
int odil_mg_forward(const MgArgs* a, void* stream) {
  const MgArgs A = *a;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = rows_grid(A);
  mg_rows_kernel<MODE_SUMS><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_sums_kernel<MgArgs><<<1, NTHREADS, 0, s>>>(A, (int)(grid.x * grid.y * grid.z));
  return (int)cudaGetLastError();
}

// Gradient pass (_backward_mg): dt0 and dP, plus the sums when with_sums.
int odil_mg_backward(const MgArgs* a, int with_sums, void* stream) {
  const MgArgs A = *a;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = rows_grid(A);
  if (with_sums) mg_rows_kernel<MODE_SUMS | MODE_GRADS><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  else mg_rows_kernel<MODE_GRADS><<<grid, dim3(TILE_Y, TILE_X), 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (with_sums) {
    reduce_sums_kernel<MgArgs><<<1, NTHREADS, 0, s>>>(A, (int)(grid.x * grid.y * grid.z));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 cgrid((A.CY + CT - 1) / CT, (A.CX + CT - 1) / CT, A.Tc * NF);
  mg_coarse_grad_kernel<<<cgrid, dim3(CT, CT), 0, s>>>(A);
  return (int)cudaGetLastError();
}

}  // extern "C"
