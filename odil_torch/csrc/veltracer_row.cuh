// The velocity-from-tracer residual rows and their adjoint as device code,
// shared by the row kernels of rowwise.cu (fine fields read as they are) and
// rowwise_mg.cu (fine rows rebuilt from the multigrid partial).
//
// The row model is odil_torch/models/veltracer.py::_make_row_fn with its hand
// adjoint _make_row_vjp: residual row t reads fine rows t and t-1 (periodic in
// t) of the fields u, vx, vy at a 5-point cross (periodic in x and y) and gives
// six terms -- upwind advection of u with frozen-velocity switches, the
// imposed-final row at it == T-2, the Laplacians of vx and vy (kxreg != 0) and
// their time differences (ktreg != 0).
//
// A block owns a TILE_X x TILE_Y tile of cells and keeps the fine rows it reads
// in shared-memory planes with a halo of HALO cells.  The gradient is gathered,
// not scattered: the thread owning cell (t, x, y) sums the "cur" adjoint of
// residual row t and the "prev" adjoint of residual row t+1.  The residual
// values that neighbouring owned cells share are staged once per row over the
// tile plus a ring of one cell (Ring1).
//
// The functions take the kernel's argument struct as a template parameter:
// both argument structs carry T, has_x, has_t and the scalars inv_dt, inv_dx,
// inv_dy, inv_dx2, inv_dy2, kimp, kimp_dx, kxreg, kt, plus nterms, partials and
// sums for the partial-sum reduction.
//
// The halo layer (a Layer of type HaloRow; NoHalo leaves the code as it was):
// a per-shard launch (odil_torch/halo.py) runs on one shard's halo-extended
// block.  The caller passes GLOBAL row indices for the row conditions (the
// initial rows 0 and 1, the imposed-final row T-2 of the global T) and every
// residual is multiplied by the 0/1 plane mask (zero on halo columns) and the
// row mask of its residual row (zero on halo rows and on a ghost node the
// left shard owns), as the wrapped row function of odil_tpu/halo.py:873-885
// does; the adjoint then sees masked weights.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NF = 3;  // fields u, vx, vy
constexpr int TILE_X = 8;
constexpr int TILE_Y = 32;
constexpr int HALO = 2;
constexpr int HX = TILE_X + 2 * HALO;
constexpr int HY = TILE_Y + 2 * HALO;
constexpr int NTHREADS = TILE_X * TILE_Y;
constexpr int MAXTERMS = 6;

enum { MODE_SUMS = 1, MODE_GRADS = 2 };

// Any v wrapped into [0, n): the periodic halo of a tile, which reaches
// TILE + HALO cells past the tile's origin and so past 2n on planes narrower
// than a tile.
__device__ __forceinline__ int pmod(int v, int n) { return ((v % n) + n) % n; }

typedef float Plane[HX][HY];

// The halo layer of a per-shard launch (see the head of this file).
struct NoHalo {
  static constexpr bool on = false;
};

struct HaloRow {
  static constexpr bool on = true;
  const Plane* M;  // the 0/1 plane mask over the tile and its halo (shared memory)
  float mt, mt1;   // 1 if residual row t (t+1) is one of the block's own rows, else 0
  int T;           // the global row count
};

// The mask tile of a per-shard launch, or nothing.
struct MaskTile {
  Plane M;
};
struct NoMask {};

template <class Args, class Layer>
__device__ __forceinline__ int rows_T(const Args& A, const Layer& H) {
  if constexpr (Layer::on) return H.T;
  else return A.T;
}

__device__ __forceinline__ float upwind(float um, float uc, float up, float v) {
  return v > 0.0f ? uc - um : (v < 0.0f ? up - uc : (up - um) * 0.5f);
}

// Transposes of the upwind switch (frozen velocity: the masks carry no
// gradient), as in models/veltracer._make_row_vjp.adv_adjoint.
__device__ __forceinline__ float guc(float v) { return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f); }
__device__ __forceinline__ float gum(float v) { return v > 0.0f ? -1.0f : (v < 0.0f ? 0.0f : -0.5f); }
__device__ __forceinline__ float gup(float v) { return v > 0.0f ? 0.0f : (v < 0.0f ? 1.0f : 0.5f); }

struct Fu {
  float res, dux, duy;
};

// Advection residual of row `it` at tile position (i, j): Uc/Vx/Vy are row it,
// Up is row it-1 (periodic).
template <class Args>
__device__ __forceinline__ Fu fu_at(const Args& A, int it, const Plane& Uc, const Plane& Up,
                                    const Plane& Vx, const Plane& Vy, const Plane& U0, int i, int j) {
  const float uprev = Up[i][j];
  const float vx = Vx[i][j], vy = Vy[i][j];
  const float dux = upwind(Up[i - 1][j], uprev, Up[i + 1][j], vx);
  const float duy = upwind(Up[i][j - 1], uprev, Up[i][j + 1], vy);
  const float u0 = U0[i][j];
  const float um = (it == 1) ? u0 : uprev;
  float r = (Uc[i][j] - um) * A.inv_dt + vx * dux * A.inv_dx + vy * duy * A.inv_dy;
  if (it == 0) r = (Uc[i][j] - u0) * A.inv_dx;
  return {r, dux, duy};
}

template <class Args>
__device__ __forceinline__ float lap(const Args& A, const Plane& Q, int i, int j) {
  const float q = Q[i][j];
  return (Q[i + 1][j] - 2.0f * q + Q[i - 1][j]) * A.inv_dx2 + (Q[i][j + 1] - 2.0f * q + Q[i][j - 1]) * A.inv_dy2;
}

// Ring-1 region around the tile: the residual-row quantities that several
// owned cells read are computed once per row into shared memory.
constexpr int RX = TILE_X + 2, RY = TILE_Y + 2;

struct Ring1 {
  float B0n[RX][RY];  // b0 of residual row t+1
  float CXn[RX][RY];  // b0 * vx / dx of residual row t+1
  float CYn[RX][RY];  // b0 * vy / dy of residual row t+1
  float LXc[RX][RY];  // Laplacian terms (res2, res3) of residual row t
  float LYc[RX][RY];
};

// The planes of the three fine rows t-1 (m), t (c) and t+1 (n) that residual
// rows t and t+1 read, and the initial tracer plane.
struct RowPlanes {
  const Plane &Um, &Uc, &Un, &VXm, &VXc, &VXn, &VYm, &VYc, &VYn, &U0;
};

// Stages the ring-1 quantities of residual row t+1 (`it1`, row 0 after T-1)
// and the Laplacian terms of row t.  Every thread of the block calls it; it
// ends with a barrier.  With the halo layer the staged residuals are masked.
template <class Args, class Layer = NoHalo>
__device__ __forceinline__ void stage_ring1(const Args& A, const RowPlanes& P, int it1, const float* g2, Ring1& R,
                                            const Layer& H = Layer()) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  for (int idx = tid; idx < RX * RY; idx += NTHREADS) {
    const int ri = idx / RY, rj = idx % RY;
    const int qi = ri + HALO - 1, qj = rj + HALO - 1;
    // Residual row t+1 reads row t as its previous row.
    const Fu n = fu_at(A, it1, P.Un, P.Uc, P.VXn, P.VYn, P.U0, qi, qj);
    float res = n.res;
    if constexpr (Layer::on) res = res * ((*H.M)[qi][qj] * H.mt1);
    const float bq = it1 == 0 ? 0.0f : g2[0] * res;
    R.B0n[ri][rj] = bq;
    R.CXn[ri][rj] = bq * P.VXn[qi][qj] * A.inv_dx;
    R.CYn[ri][rj] = bq * P.VYn[qi][qj] * A.inv_dy;
    if (A.has_x) {
      if constexpr (Layer::on) {
        const float m = (*H.M)[qi][qj] * H.mt;
        R.LXc[ri][rj] = (lap(A, P.VXc, qi, qj) * A.kxreg) * m;
        R.LYc[ri][rj] = (lap(A, P.VYc, qi, qj) * A.kxreg) * m;
      } else {
        R.LXc[ri][rj] = lap(A, P.VXc, qi, qj) * A.kxreg;
        R.LYc[ri][rj] = lap(A, P.VYc, qi, qj) * A.kxreg;
      }
    }
  }
  __syncthreads();
}

// Residual row t at the owned cell (i, j) of the tile (u1: the final tracer
// value there).  With SUMS, adds the squares of its terms to s; with GRADS,
// writes to d[f] the cell's cotangent of sum_k g[k] S[k] for field f: the "cur"
// adjoint of residual row t plus the "prev" adjoint of residual row t+1, from
// the ring-1 values that stage_ring1 left in R.  g2[k] = 2 g[k].  With the
// halo layer, t and it1 are global rows and the residuals are masked.
template <bool GRADS, bool SUMS, class Args, class Layer = NoHalo>
__device__ __forceinline__ void cell_terms(const Args& A, const RowPlanes& P, const Ring1& R, int t, int it1, int i,
                                           int j, float u1, const float* g2, float* s, float* d,
                                           const Layer& H = Layer()) {
  const int T = rows_T(A, H);
  const int ix = 2, it_ = 2 + (A.has_x ? 2 : 0);  // term positions
  const int ri = i - HALO + 1, rj = j - HALO + 1;  // position in the ring-1 arrays
  const Plane &Uc = P.Uc, &VXm = P.VXm, &VXc = P.VXc, &VXn = P.VXn, &VYm = P.VYm, &VYc = P.VYc, &VYn = P.VYn;

  const Fu c = fu_at(A, t, Uc, P.Um, VXc, VYc, P.U0, i, j);
  float res0 = c.res;
  float res1 = (t == T - 2 ? (Uc[i][j] - u1) * A.inv_dx : 0.0f) * A.kimp;
  float res2 = 0.0f, res3 = 0.0f, res4 = 0.0f, res5 = 0.0f;
  if (A.has_x) {
    res2 = GRADS ? R.LXc[ri][rj] : lap(A, VXc, i, j) * A.kxreg;
    res3 = GRADS ? R.LYc[ri][rj] : lap(A, VYc, i, j) * A.kxreg;
  }
  if (A.has_t) {
    res4 = t == 0 ? 0.0f : (VXc[i][j] - VXm[i][j]) * A.kt;
    res5 = t == 0 ? 0.0f : (VYc[i][j] - VYm[i][j]) * A.kt;
  }
  if constexpr (Layer::on) {
    // The staged Laplacian terms (GRADS) are masked already.
    const float m = (*H.M)[i][j] * H.mt;
    res0 = res0 * m;
    res1 = res1 * m;
    if (!GRADS) {
      res2 = res2 * m;
      res3 = res3 * m;
    }
    res4 = res4 * m;
    res5 = res5 * m;
  }
  if (SUMS) {
    s[0] += res0 * res0;
    s[1] += res1 * res1;
    if (A.has_x) {
      s[ix] += res2 * res2;
      s[ix + 1] += res3 * res3;
    }
    if (A.has_t) {
      s[it_] += res4 * res4;
      s[it_ + 1] += res5 * res5;
    }
  }

  if (GRADS) {
    // "cur" adjoint of residual row t (targets row t).
    const float w0 = g2[0] * res0, w1 = g2[1] * res1;
    float du = (t == 0 ? w0 * A.inv_dx : w0 * A.inv_dt) + (t == T - 2 ? w1 * A.kimp_dx : 0.0f);
    const float b0 = t == 0 ? 0.0f : w0;
    float dvx = b0 * c.dux * A.inv_dx;
    float dvy = b0 * c.duy * A.inv_dy;
    if (A.has_x) {
      // The periodic Laplacian is self-adjoint: lap of the weights.
      const float gx = g2[ix], gy = g2[ix + 1];
      const float wx = gx * R.LXc[ri][rj], wy = gy * R.LYc[ri][rj];
      dvx = dvx + ((gx * R.LXc[ri + 1][rj] - 2.0f * wx + gx * R.LXc[ri - 1][rj]) * A.inv_dx2 +
                   (gx * R.LXc[ri][rj + 1] - 2.0f * wx + gx * R.LXc[ri][rj - 1]) * A.inv_dy2) * A.kxreg;
      dvy = dvy + ((gy * R.LYc[ri + 1][rj] - 2.0f * wy + gy * R.LYc[ri - 1][rj]) * A.inv_dx2 +
                   (gy * R.LYc[ri][rj + 1] - 2.0f * wy + gy * R.LYc[ri][rj - 1]) * A.inv_dy2) * A.kxreg;
    }
    if (A.has_t) {
      dvx = dvx + (t == 0 ? 0.0f : g2[it_] * res4) * A.kt;
      dvy = dvy + (t == 0 ? 0.0f : g2[it_ + 1] * res5) * A.kt;
    }

    // "prev" adjoint of residual row t+1, which reads row t.
    float dup = -(R.B0n[ri][rj] * A.inv_dt) * (it1 == 1 ? 0.0f : 1.0f);
    dup = dup + (R.CXn[ri][rj] * guc(VXn[i][j]) + R.CXn[ri + 1][rj] * gum(VXn[i + 1][j]) +
                 R.CXn[ri - 1][rj] * gup(VXn[i - 1][j]));
    dup = dup + (R.CYn[ri][rj] * guc(VYn[i][j]) + R.CYn[ri][rj + 1] * gum(VYn[i][j + 1]) +
                 R.CYn[ri][rj - 1] * gup(VYn[i][j - 1]));
    float dvxp = 0.0f, dvyp = 0.0f;
    if (A.has_t && it1 != 0) {
      if constexpr (Layer::on) {
        const float m1 = (*H.M)[i][j] * H.mt1;
        dvxp = -((g2[it_] * (((VXn[i][j] - VXc[i][j]) * A.kt) * m1)) * A.kt);
        dvyp = -((g2[it_ + 1] * (((VYn[i][j] - VYc[i][j]) * A.kt) * m1)) * A.kt);
      } else {
        dvxp = -((g2[it_] * ((VXn[i][j] - VXc[i][j]) * A.kt)) * A.kt);
        dvyp = -((g2[it_ + 1] * ((VYn[i][j] - VYc[i][j]) * A.kt)) * A.kt);
      }
    }
    d[0] = du + dup;
    d[1] = dvx + dvxp;
    d[2] = dvy + dvyp;
  }
}

// Block-wide sum of each thread's s[k] in fp64, written to the block's row of
// A.partials (nblocks, MAXTERMS).  Every thread of the block calls it.
template <class Args>
__device__ __forceinline__ void write_partials(const Args& A, const float* s, double* red) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  for (int k = 0; k < A.nterms; ++k) {
    red[tid] = s[k];
    __syncthreads();
    for (int w = NTHREADS / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    if (tid == 0) A.partials[(size_t)blk * MAXTERMS + k] = red[0];
    __syncthreads();
  }
}

// Fixed-order reduction of the per-block partial sums (one block): the sums
// repeat run to run.
template <class Args>
__global__ void __launch_bounds__(NTHREADS) reduce_sums_kernel(const Args A, int nblocks) {
  __shared__ double red[NTHREADS];
  const int tid = threadIdx.x;
  for (int k = 0; k < A.nterms; ++k) {
    double acc = 0.0;
    for (int b = tid; b < nblocks; b += NTHREADS) acc += A.partials[(size_t)b * MAXTERMS + k];
    red[tid] = acc;
    __syncthreads();
    for (int w = NTHREADS / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    if (tid == 0) A.sums[k] = (float)red[0];
    __syncthreads();
  }
}

}  // namespace
