// The generic row-wise kernels over 1-D planes (T, N), for any row model
// that provides the device interface below (heat_row.cuh, wave_row.cuh).
// Included by rowwise.cu, which exports the launchers.
//
// What they compute.  NF fields on a (T, N) grid, any T >= 2 and N >= 1,
// periodic in t and x.  Residual row t reads rows t, t-1, ..., t-HIST of the
// fields at x-1, x, x+1 (the row model overwrites the wrapped samples at the
// ends where it imposes boundaries), data rows at t, const planes and the
// params.  The forward pass gives the per-term sums of squares S[k] over all
// T rows; the backward pass gives d(sum_k g[k] S[k]) / d(fields, params) and,
// with the sums on, S.  Field row i collects the cotangents of residual rows
// i, i+1, ..., i+HIST (mod T), as the TPU kernels' `(i + o) % T` does.
//
// Design.  A block owns a tile of TILE cells of a slab of `slab` rows and
// walks its rows with a ring of HIST+1 field rows (the tile plus two cells on
// each side) in shared memory.  For every residual row the model gives, at
// each cell of the tile plus one on each side, the cotangents D[m][f][s] of
// its weighted terms with respect to its samples (field f, row it-m, cell
// x+s-1); a ring of the last HIST+1 residual rows' D is kept, and the thread
// owning cell (t, x) gathers its cotangent from them: no atomics.  The slab
// recomputes HIST residual rows past its end.  The params live in shared
// memory; each thread sums its cells' param cotangents in registers, and the
// sums and param cotangents leave each block as fp64 partials that a second
// kernel reduces in a fixed order (one block per column), so the bits repeat
// run to run.
//
// Row model interface (struct M):
//   static constexpr int NF, HIST, MAXT, NP;  // fields, rows back, terms, params
//   template <bool GRADS> __device__ static void eval(
//       const Rows1DArgs& A, const float* P, int it, int x,
//       const float (&v)[HIST + 1][NF][3], const float* g2, bool own,
//       float* res, float (&D)[HIST + 1][NF][3], float* pacc);
// eval writes the terms of residual row `it` at cell x into res[0..nterms);
// with GRADS, D gets the cotangents of sum_k g2[k]/2 res[k]^2 with respect to
// v, and, when `own`, the param cotangents are added to pacc[0..NP).

#pragma once

#include <cuda_runtime.h>

namespace rows1d {

constexpr int MAXF = 2, MAXD = 2, MAXC = 6, NSCALARS = 8;

// Mirrored by odil_torch/ops/rowwise.py::_Rows1DArgs (ctypes); the Python side
// checks sizeof through odil_rows1d_args_size().
struct Rows1DArgs {
  const float* f[MAXF];       // the fields (T, N)
  const float* data[MAXD];    // (T, N) or (T, 1), read at row it
  const float* consts[MAXC];  // planes (N) or scalars (1, 1)
  const float* params;        // all params, flat, in order
  const float* g;             // (nterms,) loss weights, on the device
  float* df[MAXF];
  float* dparams;             // (nparams,)
  double* partials;           // (nblocks, stride): the sums, then the param cotangents
  float* sums;                // (nterms,)
  int data_stride[MAXD];      // N or 1
  int T, N, slab, nterms, nparams, stride, flags;
  float s[NSCALARS];          // the row model's scalars
};

constexpr int TILE = 256;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int FW = TILE + 4;  // field cells of a row: the tile and two on each side
constexpr int RW = TILE + 2;  // residual cells: the tile and one on each side

enum { MODE_SUMS = 1, MODE_GRADS = 2 };

__device__ __forceinline__ int pmod(int v, int n) { return ((v % n) + n) % n; }

// Data d at row it and cell x: (T, N) data, or (T, 1) data read at every x.
__device__ __forceinline__ float data_at(const Rows1DArgs& A, int d, int it, int x) {
  const int st = A.data_stride[d];
  return __ldg(A.data[d] + (size_t)it * st + (st == 1 ? 0 : x));
}

// a[k] for a runtime k, through compile-time indices (keeps a in registers).
template <int N>
__device__ __forceinline__ float pick(const float* a, int k) {
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) v = j == k ? a[j] : v;
  return v;
}

template <class M, int MODE>
__global__ void __launch_bounds__(NTHREADS) rows1d_kernel(const Rows1DArgs A) {
  constexpr int H = M::HIST, NF = M::NF, NT = M::MAXT;
  constexpr int NP = M::NP > 0 ? M::NP : 1;
  constexpr bool grads = (MODE & MODE_GRADS) != 0;
  constexpr bool sums = (MODE & MODE_SUMS) != 0;
  __shared__ float F[H + 1][NF][FW];                  // field row q in slot q mod (H+1)
  __shared__ float D[grads ? H + 1 : 1][H + 1][NF][3][RW];  // residual row r in slot r mod (H+1)
  __shared__ float P[NP];
  __shared__ int xi[FW];
  __shared__ double red[NWARPS][NT + NP];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TILE;
  const int T = A.T, N = A.N;
  const int ts = blockIdx.y * A.slab, te = min(ts + A.slab, T);

  for (int i = tid; i < FW; i += NTHREADS) xi[i] = pmod(x0 - 2 + i, N);
  for (int k = tid; k < A.nparams; k += NTHREADS) P[k] = __ldg(A.params + k);
  float g2[NT], s[NT], pacc[NP];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    g2[k] = (grads && k < A.nterms) ? 2.0f * __ldg(A.g + k) : 0.0f;
    s[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) pacc[k] = 0.0f;
  __syncthreads();

  // Field row q (periodic in t) into its ring slot.
  auto load = [&](int q) {
    const int slot = pmod(q, H + 1);
    const size_t row = (size_t)pmod(q, T) * N;
    for (int i = tid; i < FW; i += NTHREADS) {
#pragma unroll
      for (int f = 0; f < NF; ++f) F[slot][f][i] = __ldg(A.f[f] + row + xi[i]);
    }
  };

  for (int q = ts - H; q < ts; ++q) load(q);
  // Residual rows ts..te-1, and with the gradients HIST more for the gather.
  const int r_end = grads ? te + H : te;
  for (int r = ts; r < r_end; ++r) {
    load(r);
    __syncthreads();
    const int it = r < T ? r : r - T;
    const bool row_own = r < te;
    for (int i = tid; i < RW; i += NTHREADS) {
      const bool own = i >= 1 && i <= TILE && x0 + i - 1 < N;
      if (!grads && !own) continue;
      float v[H + 1][NF][3];
#pragma unroll
      for (int m = 0; m <= H; ++m) {
        const int slot = pmod(r - m, H + 1);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
#pragma unroll
          for (int q = 0; q < 3; ++q) v[m][f][q] = F[slot][f][i + q];
        }
      }
      float res[NT], Dl[H + 1][NF][3];
      M::template eval<grads>(A, P, it, xi[i + 1], v, g2, own && row_own, res, Dl, pacc);
      if (sums && own && row_own) {
#pragma unroll
        for (int k = 0; k < NT; ++k) s[k] += k < A.nterms ? res[k] * res[k] : 0.0f;
      }
      if (grads) {
        const int slot = pmod(r, H + 1);
#pragma unroll
        for (int m = 0; m <= H; ++m) {
#pragma unroll
          for (int f = 0; f < NF; ++f) {
#pragma unroll
            for (int q = 0; q < 3; ++q) D[slot][m][f][q][i] = Dl[m][f][q];
          }
        }
      }
    }
    __syncthreads();
    // Field row t = r - HIST has the D of all the residual rows that read it.
    const int t = r - H;
    const int x = x0 + tid;
    if (grads && t >= ts && tid < TILE && x < N) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m <= H; ++m) {
          const int slot = pmod(t + m, H + 1);
#pragma unroll
          for (int q = 0; q < 3; ++q) acc += D[slot][m][f][q][tid + 2 - q];
        }
        A.df[f][(size_t)t * N + x] = acc;
      }
    }
  }

  // Block sums of the terms and the param cotangents in fp64: warp
  // shuffles, then the warps in order.
  if (sums || (grads && M::NP > 0)) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int k = 0; k < NT + NP; ++k) {
      double v = k < NT ? (sums ? (double)s[k] : 0.0) : (grads ? (double)pacc[k - NT] : 0.0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    const int blk = blockIdx.x + gridDim.x * blockIdx.y;
    for (int k = tid; k < A.stride; k += NTHREADS) {
      const int kk = k < A.nterms ? k : NT + (k - A.nterms);
      double acc = 0.0;
      for (int w = 0; w < NWARPS; ++w) acc += red[w][kk];
      A.partials[(size_t)blk * A.stride + k] = acc;
    }
  }
}

// Fixed-order reduction of the per-block partials, one block for each
// column k0 + blockIdx.x: the sums go to A.sums, the param cotangents to
// A.dparams.
__global__ void __launch_bounds__(NTHREADS) rows1d_reduce_kernel(const Rows1DArgs A, int nblocks, int k0) {
  __shared__ double red[NTHREADS];
  const int tid = threadIdx.x, k = k0 + blockIdx.x;
  double acc = 0.0;
  for (int b = tid; b < nblocks; b += NTHREADS) acc += A.partials[(size_t)b * A.stride + k];
  red[tid] = acc;
  __syncthreads();
  for (int w = NTHREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    if (k < A.nterms) A.sums[k] = (float)red[0];
    else A.dparams[k - A.nterms] = (float)red[0];
  }
}

inline dim3 grid_of(const Rows1DArgs& A) { return dim3((A.N + TILE - 1) / TILE, (A.T + A.slab - 1) / A.slab); }

template <class M>
int forward(const Rows1DArgs& A, cudaStream_t s) {
  const dim3 grid = grid_of(A);
  rows1d_kernel<M, MODE_SUMS><<<grid, NTHREADS, 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows1d_reduce_kernel<<<A.nterms, NTHREADS, 0, s>>>(A, (int)(grid.x * grid.y), 0);
  return (int)cudaGetLastError();
}

template <class M>
int backward(const Rows1DArgs& A, int with_sums, cudaStream_t s) {
  const dim3 grid = grid_of(A);
  if (with_sums) rows1d_kernel<M, MODE_SUMS | MODE_GRADS><<<grid, NTHREADS, 0, s>>>(A);
  else rows1d_kernel<M, MODE_GRADS><<<grid, NTHREADS, 0, s>>>(A);
  cudaError_t err = cudaGetLastError();
  const int k0 = with_sums ? 0 : A.nterms;
  if (err != cudaSuccess || k0 == A.stride) return (int)err;
  rows1d_reduce_kernel<<<A.stride - k0, NTHREADS, 0, s>>>(A, (int)(grid.x * grid.y), k0);
  return (int)cudaGetLastError();
}

}  // namespace rows1d
