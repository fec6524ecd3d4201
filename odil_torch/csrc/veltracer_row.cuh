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
// inv_dy, inv_dx2, inv_dy2, kimp, kimp_dx, kxreg, kt, plus nterms, partials,
// sums and ticket for the reduction of the sums.
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

// A source sets the tile's rows and its block's thread rows before including
// this header (rowwise_mg.cu and rowwise.cu: 16 rows, 8 thread rows, two
// cells a thread), and the plane column of the tile's first column
// (rowwise_mg.cu: HALO; rowwise.cu: 4, so that the owned columns of a staged
// row are 16-byte aligned for cp.async, the halo columns at 2, 3 and 36, 37
// of a 40-column plane).
#if !defined(ODIL_TILE_X) || !defined(ODIL_THREAD_ROWS) || !defined(ODIL_PLANE_YOFF)
#error "veltracer_row.cuh: define ODIL_TILE_X, ODIL_THREAD_ROWS and ODIL_PLANE_YOFF before including it"
#endif

constexpr int NF = 3;  // fields u, vx, vy
constexpr int TILE_X = ODIL_TILE_X;
constexpr int TILE_Y = 32;
constexpr int HALO = 2;
constexpr int YOFF = ODIL_PLANE_YOFF;  // plane column of the tile's first column
constexpr int HX = TILE_X + 2 * HALO;
constexpr int HY = TILE_Y + 2 * YOFF;
constexpr int THREAD_ROWS = ODIL_THREAD_ROWS;
constexpr int CELLS = TILE_X / THREAD_ROWS;  // owned cells a thread: rows r, r + THREAD_ROWS, ...
static_assert(YOFF >= HALO && TILE_X % THREAD_ROWS == 0, "veltracer_row.cuh: tile constants");
constexpr int NTHREADS = THREAD_ROWS * TILE_Y;
constexpr int NWARPS = NTHREADS / 32;
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

// The ring-1 values of position idx of the RX x RY ring -- those of residual
// row t+1 (`it1`, row 0 after T-1) and the Laplacian terms of row t, masked
// with the halo layer -- each handed to put(k, ri, rj, value) as it is
// formed, k the Ring1 array (0 B0n, 1 CXn, 2 CYn, 3 LXc, 4 LYc; 3 and 4 only
// with has_x).
template <class Args, class Layer, class Put>
__device__ __forceinline__ void ring1_at(const Args& A, const RowPlanes& P, int it1, const float* g2, int idx,
                                         const Layer& H, Put put) {
  const int ri = idx / RY, rj = idx % RY;
  const int qi = ri + HALO - 1, qj = rj + YOFF - 1;
  // Residual row t+1 reads row t as its previous row.
  const Fu n = fu_at(A, it1, P.Un, P.Uc, P.VXn, P.VYn, P.U0, qi, qj);
  float res = n.res;
  if constexpr (Layer::on) res = res * ((*H.M)[qi][qj] * H.mt1);
  const float bq = it1 == 0 ? 0.0f : g2[0] * res;
  put(0, ri, rj, bq);
  put(1, ri, rj, bq * P.VXn[qi][qj] * A.inv_dx);
  put(2, ri, rj, bq * P.VYn[qi][qj] * A.inv_dy);
  if (A.has_x) {
    if constexpr (Layer::on) {
      const float m = (*H.M)[qi][qj] * H.mt;
      put(3, ri, rj, (lap(A, P.VXc, qi, qj) * A.kxreg) * m);
      put(4, ri, rj, (lap(A, P.VYc, qi, qj) * A.kxreg) * m);
    } else {
      put(3, ri, rj, lap(A, P.VXc, qi, qj) * A.kxreg);
      put(4, ri, rj, lap(A, P.VYc, qi, qj) * A.kxreg);
    }
  }
}

// The Ring1 array k (ring1_at's order).
__device__ __forceinline__ float (&ring1_array(Ring1& R, int k))[RX][RY] {
  return k == 0 ? R.B0n : k == 1 ? R.CXn : k == 2 ? R.CYn : k == 3 ? R.LXc : R.LYc;
}

// Stages the ring-1 quantities of residual row t+1 (`it1`, row 0 after T-1)
// and the Laplacian terms of row t, one position at a time.  Every thread of
// the block calls it; it ends with a barrier.  With the halo layer the
// staged residuals are masked.
template <class Args, class Layer = NoHalo>
__device__ __forceinline__ void stage_ring1(const Args& A, const RowPlanes& P, int it1, const float* g2, Ring1& R,
                                            const Layer& H = Layer()) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  for (int idx = tid; idx < RX * RY; idx += NTHREADS) {
    ring1_at(A, P, it1, g2, idx, H, [&](int k, int ri, int rj, float v) { ring1_array(R, k)[ri][rj] = v; });
  }
  __syncthreads();
}

// Residual row t at the owned cell (i, j) of the tile (u1: the final tracer
// value there).  With SUMS, adds the squares of its terms to s; with GRADS,
// writes to d[f] the cell's cotangent of sum_k g[k] S[k] for field f: the "cur"
// adjoint of residual row t plus the "prev" adjoint of residual row t+1, from
// the ring-1 values that stage_ring1 left in R.  g2[k] = 2 g[k].  With the
// halo layer, t and it1 are global rows and the residuals are masked.  A
// caller that evaluates a tile cell outside the plane (own false: branch-free
// code for the cells of a thread) adds nothing to s; s + 0 * 0 is s.
template <bool GRADS, bool SUMS, class Args, class Layer = NoHalo>
__device__ __forceinline__ void cell_terms(const Args& A, const RowPlanes& P, const Ring1& R, int t, int it1, int i,
                                           int j, float u1, const float* g2, float* s, float* d,
                                           const Layer& H = Layer(), bool own = true) {
  const int T = rows_T(A, H);
  // Term positions: the x terms at 2 and 3, the t terms after them.  The t
  // terms' slots are chosen by selects, not a computed index, so that s and
  // g2 stay in registers.
  constexpr int ix = 2;
  const int ri = i - HALO + 1, rj = j - YOFF + 1;  // position in the ring-1 arrays
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
    const float q0 = own ? res0 : 0.0f, q1 = own ? res1 : 0.0f, q2 = own ? res2 : 0.0f, q3 = own ? res3 : 0.0f;
    const float q4 = own ? res4 : 0.0f, q5 = own ? res5 : 0.0f;
    s[0] += q0 * q0;
    s[1] += q1 * q1;
    if (A.has_x) {
      s[ix] += q2 * q2;
      s[ix + 1] += q3 * q3;
    }
    if (A.has_t) {
      if (A.has_x) {
        s[4] += q4 * q4;
        s[5] += q5 * q5;
      } else {
        s[2] += q4 * q4;
        s[3] += q5 * q5;
      }
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
    const float gt0 = A.has_x ? g2[4] : g2[2], gt1 = A.has_x ? g2[5] : g2[3];  // the t terms' weights
    if (A.has_t) {
      dvx = dvx + (t == 0 ? 0.0f : gt0 * res4) * A.kt;
      dvy = dvy + (t == 0 ? 0.0f : gt1 * res5) * A.kt;
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
        dvxp = -((gt0 * (((VXn[i][j] - VXc[i][j]) * A.kt) * m1)) * A.kt);
        dvyp = -((gt1 * (((VYn[i][j] - VYc[i][j]) * A.kt) * m1)) * A.kt);
      } else {
        dvxp = -((gt0 * ((VXn[i][j] - VXc[i][j]) * A.kt)) * A.kt);
        dvyp = -((gt1 * ((VYn[i][j] - VYc[i][j]) * A.kt)) * A.kt);
      }
    }
    d[0] = du + dup;
    d[1] = dvx + dvxp;
    d[2] = dvy + dvyp;
  }
}

// The sums: each thread's s[k] reduced over the block in fp64 (warp shuffles,
// then the warps in order) into the block's row of A.partials; the last block
// to finish (an integer ticket; the float order does not depend on which
// block it is) reduces the rows in block order into A.sums and resets the
// ticket (Args::ticket).  Every thread of the block calls it, at its end.
// The mg walk and the row kernels of rowwise.cu reduce their sums so.  The
// last block reads every term of a block's row in one pass (L2 loads,
// __ldcg): each thread adds the rows tid, tid + NTHREADS, ... in that order
// for every term, then the same shuffle tree and the warps in order, so
// each term's float order is that of a pass per term.
template <class Args>
__device__ void finish_sums(const Args& A, const float* s, double (&red)[NWARPS][MAXTERMS]) {
  __shared__ bool last;
  const int tid = threadIdx.y * TILE_Y + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned nblocks = gridDim.x * gridDim.y * gridDim.z;
  const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) {
    double v = s[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (tid < A.nterms) {
    double v = red[0][tid];
    for (int w = 1; w < NWARPS; ++w) v += red[w][tid];
    A.partials[(size_t)blk * MAXTERMS + tid] = v;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(A.ticket, 1u) == nblocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double v[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) v[k] = 0.0;
  for (unsigned b = tid; b < nblocks; b += NTHREADS) {
    const double* row = A.partials + (size_t)b * MAXTERMS;
#pragma unroll
    for (int k = 0; k < MAXTERMS; ++k) {
      if (k < A.nterms) v[k] += __ldcg(row + k);
    }
  }
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) {
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  }
  if (lane == 0) {  // (the block's own reduction read red before the ticket's barriers)
#pragma unroll
    for (int k = 0; k < MAXTERMS; ++k) red[warp][k] = v[k];
  }
  __syncthreads();
  if (tid < A.nterms) {
    double acc = red[0][tid];
    for (int w = 1; w < NWARPS; ++w) acc += red[w][tid];
    A.sums[tid] = (float)acc;
  }
  if (tid == 0) *A.ticket = 0u;
}

}  // namespace
