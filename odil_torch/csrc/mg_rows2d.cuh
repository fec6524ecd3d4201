// The multigrid-fused row walk over 2-D planes for any row model with the
// rows2d.cuh interface: the row models that odil_torch/ops/rowtrace.py
// generates from a user's row function.  Included by the generated mg units
// (rowtrace.Trace.mg_source), which export the launchers (odil_mg2d_*).
//
// Replaces, for a user's row function, the TPU kernels of
// odil_tpu/ops/rowwise_mg.py that trace it into their bodies:
//   _forward_mg  (:257, pallas_call at :336)              -> forward (MODE_SUMS);
//   _backward_mg (:350, pallas_call at :766), with and without the sums
//                                                         -> backward (Mg2DArgs);
//     with lvl2, the two-level fusion                     -> backward2 (Mg2DLvl2Args);
//     with wraps_in/emit_dwraps, a shard's local block    -> backward_local (Mg2DLocalArgs);
//   rowwise_mg_tiled._loss_and_grads_tiled (:145, pallas_call at :490) and
//   rowwise_mg_local_tiled._loss_and_grads_local_tiled (:259, pallas_call at
//   :565), the same functions past the TPU's VMEM: one tiled design serves
//   every plane and block size here.
//
// What they compute.  NF fields on a (T, X, Y) grid, T odd, each given as its
// level-0 multigrid term t0 (T, X, Y) and the level-1 Horner partial P (Tc,
// X/2, Y/2); the fine rows are rebuilt as
//   fine[r] = f0 * t0[r] + Wx . blend_t(P[r/2], P[r/2+1]) . Wy^T
// (the exact 2-tap prolongation along x and y, the node midpoints along t),
// residual row t of the row model reads fine rows t, t-1, ..., t-HIST
// (periodic in t, x and y) at the 3 x 3 cells around its cell, data rows at t,
// const planes and the params.  The forward pass gives the per-term sums of
// squares S[k]; the backward pass gives, for the loss sum_k g[k] S[k],
// dt0 = f0 * dfine, dP = down2d(blend_t^T(dfine)) and the param cotangents,
// and with the sums on, S.
//
// Design: rowwise_mg.cu's rebuild and in-walk dP with rows2d.cuh's model
// evaluation.  The staged coarse window, the taps, the level-1 rebuild, the
// dP stage with the close and flush of its coarse rows and the dP2 kernel's
// body are the device code of mg_common.cuh, which rowwise_mg.cu includes
// too; init_taps and init_dp_taps (the tap tables of the window and of
// dP), dp_step/dp_finish and the dP gather are this file's copies of
// rowwise_mg.cu's (see mg_common.cuh).
//   * A block of 8 x 32 threads owns a TILE_X x TILE_Y = 16 x 32 tile (two
//     cells a thread) of a slab of `slab` residual rows, and walks the
//     residual rows of its slab (with the gradients also the HIST rows past
//     it) through a ring of HIST + 1 rebuilt fine rows (halo 2 around the
//     tile) in shared memory: rows t-HIST .. t of residual row t.  Fine row
//     t+1 is rebuilt after residual row t is evaluated, into the slot of row
//     t-HIST, which nothing reads any more; two barriers a row.  A row is
//     rebuilt from a window of t-blended coarse values staged in shared
//     memory (WX x WY cells a field, the taps of the tile's halo included),
//     its global loads (this thread's t0 values and coarse values) issued
//     into registers a row ahead, in flight while the block evaluates the
//     row before.  At depth 2 the level-1 rows are rebuilt per block over the
//     coarse window from the level-2 partial into a two-slot ring (one every
//     two fine rows), as rowwise_mg.cu does.
//   * Each residual row is evaluated once at every cell of the tile and of
//     its ring of one cell (rows2d.cuh's scheme): the cotangents at a nonzero
//     offset are staged one plane a used D entry, those at the cell's own
//     position stay in registers, and after a barrier each owned cell gathers
//     its cotangents from the 3 x 3 cells around it.  A thread keeps the sums
//     of its cells' rows t-HIST .. t in registers; row t-HIST is complete
//     after residual row t.  Then its mg epilogue: dt0 = f0 * dfine, and the
//     row's share of dP (rowwise_mg.cu's dp_step: the transposed t-blend in
//     an open coarse row, the y taps by shuffles into a ring of closed rows,
//     the x taps when the ring is full, each block's window of each coarse
//     row stored as its partial), and on a local block the head rows'
//     cotangents into dheads.  A gather kernel adds the at most 2 x 2 x 2
//     windows that hold each coarse cell, in a fixed order; at depth 2 one
//     more kernel forms dP2 from dP1.
//   * Sums and param cotangents: fp64 block sums reduced by the last block
//     (rows2d::reduce_terms) -- one launch, the same bits run to run; no
//     atomics touch a float.
//
// The local block (Mg2DLocalArgs; the --halo per-shard route): one shard's
// level-0 block (Tl, Xe, Y), x-halo-extended, the time window of the level-1
// partial (Tcw = (Tl-1)/2 + 1 rows, the whole coarse plane) and the HIST fine
// rows before the block (`heads`) in place of its periodic wrap: residual
// rows 0 .. Tl-1 read heads for rows before 0, no residual row wraps, and the
// heads' cotangents leave as dheads.  Local column c is global column (x0 +
// c) mod Xg, whose taps it takes (the tiles start at even global columns, so
// that the coarse window holds every tap; the dP windows run over unwrapped
// global coarse columns).  The model sees global rows (row + off) and the
// global row count, reads the block's data rows, and every residual is
// multiplied by the plane mask and the row mask (r_lo <= row < r_hi), as
// rows2d.cuh's masked layer does.
//
// Bound: by bytes at the row functions of this repository (the veltracer's
// ~40 fp32 operations a cell forward and ~100 backward against 12 bytes of t0
// read and 12 of dt0 written): t0 and P read, dt0 and dP written.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "mg_common.cuh"
#include "rows2d.cuh"

namespace mg2d {

using rows2d::MAXF;
using rows2d::pmod;

// Mirrored by odil_torch/ops/rowwise_mg.py::_MgPart (ctypes).
struct MgPart {
  const float* P[MAXF];  // (Tc, CX, CY): the level-1 partial (level 2 at depth 2; a local block's window)
  float* dP[MAXF];       // its cotangent (dP1 at depth 2)
  float* dp_part;        // the blocks' dP windows (odil_mg2d_dp_floats floats)
  int Tc, CX, CY;        // the coarse rows and plane of the fine rebuild (level 1)
  float f0[MAXF];        // the level-0 factors
};

// The whole-plane walk: Rows2DArgs over the fine grid (f: t0, df: dt0) plus
// the mg part.  Mirrored by odil_torch/ops/rowwise_mg.py::_Mg2DArgs (checked
// through odil_mg2d_args_size()).
struct Mg2DArgs : rows2d::Rows2DArgs {
  MgPart mg;
};

// The two-level fusion: mg.P holds the level-2 partial (Tc2, CX2, CY2) and
// mg.dP receives dP1; t1 holds the level-1 terms (mg.Tc, mg.CX, mg.CY) with
// factors f1; dP2 the level-2 cotangent.
struct Mg2DLvl2Args : Mg2DArgs {
  const float* t1[MAXF];
  float* dP2[MAXF];
  int Tc2, CX2, CY2;
  float f1[MAXF];
};

// A shard's local block: Rows2DHaloArgs over the block (T = Tl, X = Xe) plus
// the mg part (mg.Tc = Tcw, mg.CX, mg.CY the global coarse plane), the heads
// (HIST, Xe, Y), their cotangents and the block's global columns.
struct Mg2DLocalArgs : rows2d::Rows2DHaloArgs {
  MgPart mg;
  const float* heads[MAXF];
  float* dheads[MAXF];
  int x0, Xg;  // the global column of local column 0 (may be < 0); the global X
};

constexpr int TILE_X = rows2d::TILE_X, TILE_Y = rows2d::TILE_Y, THREAD_ROWS = rows2d::THREAD_ROWS;
constexpr int CELLS = rows2d::CELLS, NTHREADS = rows2d::NTHREADS, NWARPS = rows2d::NWARPS;
constexpr int RX = rows2d::RX, RY = rows2d::RY, NRING = rows2d::NRING;
constexpr int SM_SMEM = 233472;  // the shared memory of an SM
// The rebuild's window, the coarse windows and dP's (mg_common.cuh).
static_assert(TILE_X == mgc::TILE_X && TILE_Y == mgc::TILE_Y && THREAD_ROWS == mgc::THREAD_ROWS &&
                  NTHREADS == mgc::NTHREADS && CELLS == mgc::CELLS,
              "mg_rows2d.cuh: the tile of mg_common.cuh");
using mgc::CT;
using mgc::GATHER_B;
using mgc::HALO;
using mgc::HX;
using mgc::HY;
constexpr int NPOS = (HX * HY + NTHREADS - 1) / NTHREADS;  // window positions a thread rebuilds
using mgc::DPR;
using mgc::DWA;
using mgc::DWB;
using mgc::WX;
using mgc::WY;
using mgc::close_dp_row;
using mgc::flush_dp;
using mgc::taps;
using mgc::DpStage;
using mgc::Lvl2Stage;
using mgc::RowStage;

enum { MODE_SUMS = rows2d::MODE_SUMS, MODE_GRADS = rows2d::MODE_GRADS };

template <class Args>
constexpr bool is_local = std::is_same<Args, Mg2DLocalArgs>::value;
template <class Args>
constexpr bool is_lvl2 = std::is_same<Args, Mg2DLvl2Args>::value;

// The fine columns as the prolongation sees them: a whole plane's are its
// own; a local block's column c is global column (x0 + c) mod Xg, and its
// tiles start at even global columns (tile 0 at local column -tile_shift).
template <class Args>
__host__ __device__ __forceinline__ int first_col(const Args& A) {
  if constexpr (is_local<Args>) return A.x0;
  else return 0;
}
template <class Args>
__host__ __device__ __forceinline__ int fine_cols(const Args& A) {
  if constexpr (is_local<Args>) return A.Xg;
  else return A.X;
}
template <class Args>
__host__ __device__ __forceinline__ int tile_shift(const Args& A) {
  if constexpr (is_local<Args>) return A.x0 & 1;
  else return 0;
}

// The blocks of the walk: y tiles, x tiles, slabs of residual rows.
template <class Args>
__host__ __device__ __forceinline__ dim3 walk_grid(const Args& A) {
  return dim3((A.Y + TILE_Y - 1) / TILE_Y, (A.X + tile_shift(A) + TILE_X - 1) / TILE_X, (A.T + A.slab - 1) / A.slab);
}

// The stages of a block's shared memory (an unused one is NoStage).
struct NoStage {
  float unused;
};

// The shared memory of a block (dynamic).  Mirrored by
// odil_torch/ops/rowtrace.py::mg2d_smem.
template <class M, bool GRADS, bool LVL2>
struct Smem {
  static constexpr int NF = M::NF, NSLOT = M::HIST + 1;
  static constexpr int NS = rows2d::nstaged<M>() > 0 ? rows2d::nstaged<M>() : 1;
  static constexpr int NRED = M::MAXT + (M::NP > 0 ? M::NP : 1);
  static constexpr int NRED16 = (NRED + 15) / 16 * 16;
  double red[NWARPS][NRED16];
  float F[NSLOT][NF][HX][HY];  // fine row q in slot (q - ts + HIST) % NSLOT
  float D[GRADS ? NS : 1][GRADS ? RX : 1][GRADS ? RY : 1];
  float P[M::NP > 0 ? M::NP : 1];
  RowStage<NF> S;
  typename std::conditional<LVL2, Lvl2Stage<NF>, NoStage>::type S2;
  typename std::conditional<GRADS, DpStage<NF>, NoStage>::type Q;
};

template <class M, int MODE, class Args>
constexpr size_t smem_bytes() {
  return sizeof(Smem<M, (MODE & MODE_GRADS) != 0, is_lvl2<Args>>);
}

// The blocks an SM should hold (__launch_bounds__): those whose shared
// memory it holds (1 KB reserved a block), at most two, one past 16 params.
template <class M, int MODE, class Args>
constexpr int blocks_per_sm() {
  constexpr int fit = (int)(SM_SMEM / (smem_bytes<M, MODE, Args>() + 1024));
  constexpr int most = M::NP > 16 ? 1 : 2;
  return fit < 1 ? 1 : (fit < most ? fit : most);
}

// The plane rows and columns of the tile's window and their taps (once per
// block).  x0: the tile's first local column; the taps are those of the
// unwrapped global columns (a local block's), the plane index the wrapped
// local one.
template <int NF, class Args>
__device__ void init_taps(RowStage<NF>& S, const Args& A, int x0, int y0) {
  const int xg0 = x0 + first_col(A);
  const int ax0 = (xg0 >> 1) - 2, by0 = (y0 >> 1) - 2;
  const int CX = A.mg.CX, CY = A.mg.CY;
  for (int idx = threadIdx.y * TILE_Y + threadIdx.x; idx < HX + HY; idx += NTHREADS) {
    int a0, a1;
    float w0, w1;
    if (idx < HX) {
      S.xi[idx] = pmod(x0 + idx - HALO, A.X);
      taps(pmod(xg0 + idx - HALO, fine_cols(A)), CX, a0, w0, a1, w1);
      S.ta[idx][0] = pmod(a0 - ax0, CX);
      S.ta[idx][1] = pmod(a1 - ax0, CX);
      S.tw[idx][0] = w0;
      S.tw[idx][1] = w1;
    } else {
      const int k = idx - HX;
      S.yi[k] = pmod(y0 + k - HALO, A.Y);
      taps(S.yi[k], CY, a0, w0, a1, w1);
      S.tb[k][0] = pmod(a0 - by0, CY);
      S.tb[k][1] = pmod(a1 - by0, CY);
      S.sw[k][0] = w0;
      S.sw[k][1] = w1;
    }
  }
}

// The global loads of one fine row, issued a row ahead into registers: this
// thread's window positions' t0 values (a local block's head rows as they
// are) and its share of the coarse window's two rows (not at depth 2, whose
// coarse rows come from the level-1 ring).
template <int NF>
struct RowLoads {
  static constexpr int NCB = mgc::window_share<NF>;
  int rr;  // the fine row (periodic); -1 - h for head row h of a local block
  float p0[NCB], p1[NCB];
  float t0[NPOS][NF];
};

// Issues the loads of fine row q (whole plane: periodic in t; local block:
// q < 0 is head row HIST + q).
template <int NF, int H, class Args>
__device__ __forceinline__ void fetch_row(RowLoads<NF>& L, const RowStage<NF>& S, const Args& A, int q, int x0,
                                          int y0) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const size_t plane = (size_t)A.X * A.Y;
  if constexpr (is_local<Args>) {
    if (q < 0) {
      L.rr = -1 - (H + q);
#pragma unroll
      for (int k = 0; k < NPOS; ++k) {
        const int idx = tid + k * NTHREADS;
        if (idx < HX * HY) {
          const size_t o = (size_t)(H + q) * plane + (size_t)S.xi[idx / HY] * A.Y + S.yi[idx % HY];
#pragma unroll
          for (int f = 0; f < NF; ++f) L.t0[k][f] = __ldg(A.heads[f] + o);
        }
      }
      return;
    }
  }
  const int rr = is_local<Args> ? q : pmod(q, A.T);
  L.rr = rr;
  if constexpr (!is_lvl2<Args>) mgc::fetch_window<NF>(L.p0, L.p1, A.mg, rr, x0 + first_col(A), y0);
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
      const size_t o = (size_t)rr * plane + (size_t)S.xi[idx / HY] * A.Y + S.yi[idx % HY];
#pragma unroll
      for (int f = 0; f < NF; ++f) L.t0[k][f] = __ldg(A.f[f] + o);
    }
  }
}

// The first half of a fine row's rebuild: the t-blended coarse window into
// S.CB (at depth 2 from the level-1 ring, its rows rebuilt first where the
// ring lacks them: barriers inside, block-uniform).  Nothing for a head row.
template <int NF, class Stage2, class Args>
__device__ __forceinline__ void stage_row(RowStage<NF>& S, Stage2& S2, const Args& A, const RowLoads<NF>& L,
                                          int (&p1_rows)[2], int x0, int y0) {
  if (L.rr < 0) return;
  if constexpr (is_lvl2<Args>) mgc::stage_window2(S, S2, A.mg, A, L.rr, p1_rows, x0, y0);
  else mgc::stage_window(S, L.p0, L.p1, L.rr);
}

// The second half, after a barrier: fine = f0 * t0 + the prolonged window
// over the tile and its halo into F (a head row as it is).
template <int NF, class Args>
__device__ __forceinline__ void rebuild_row(float (*F)[HX][HY], const RowStage<NF>& S, const Args& A,
                                            const RowLoads<NF>& L) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
      const int hx = idx / HY, hy = idx % HY;
      if (L.rr < 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) F[f][hx][hy] = L.t0[k][f];
        continue;
      }
      mgc::rebuild_at(F, S, A.mg.f0, L.t0[k], hx, hy);
    }
  }
}

// -- dP inside the walk (rowwise_mg.cu's init_dp_taps, dp_step and dp_finish
// for NF fields, with mg_common.cuh's DpStage, close_dp_row and flush_dp) -----

// The coarse rows [c_lo, c_hi] of slab z's dP partials: its rows [l0, l1)
// reach coarse rows l0 >> 1 .. l1 >> 1.  dp_slots: the most a slab reaches.
__host__ __device__ __forceinline__ int dp_slots(int slab) { return slab / 2 + 2; }
template <class Args>
__host__ __device__ __forceinline__ void dp_rows(const Args& A, int z, int& c_lo, int& c_hi) {
  const int l0 = z * A.slab, l1 = min(l0 + A.slab, A.T);
  c_lo = l0 >> 1;
  c_hi = min(A.mg.Tc - 1, l1 >> 1);
}

// The dP tap weights of the tile's owned rows and columns toward coarse
// index i/2 - 1, i/2, i/2 + 1 (unwrapped global columns; zero where the tile
// owns no cell).
template <int NF, class Args>
__device__ void init_dp_taps(DpStage<NF>& Q, const Args& A, int x0, int y0) {
  const int xg0 = x0 + first_col(A), Xg = fine_cols(A);
  for (int idx = threadIdx.y * TILE_Y + threadIdx.x; idx < TILE_X + TILE_Y; idx += NTHREADS) {
    int a[2];
    float w[2], q[3] = {0.0f, 0.0f, 0.0f};
    if (idx < TILE_X) {
      const int xl = x0 + idx, gx = xg0 + idx, gm = pmod(gx, Xg);
      if (xl >= 0 && xl < A.X) {
        taps(gm, A.mg.CX, a[0], w[0], a[1], w[1]);
        for (int k = 0; k < 2; ++k) q[a[k] + (gx - gm) / Xg * A.mg.CX - (gx >> 1) + 1] += w[k];
      }
      for (int k = 0; k < 3; ++k) Q.xw[idx][k] = q[k];
    } else {
      const int c = idx - TILE_X, y = y0 + c;
      if (y < A.Y) {
        taps(y, A.mg.CY, a[0], w[0], a[1], w[1]);
        for (int k = 0; k < 2; ++k) q[a[k] - (y >> 1) + 1] += w[k];
      }
      for (int k = 0; k < 3; ++k) Q.yw[c][k] = q[k];
    }
  }
}


template <int NF, class Args>
__device__ __forceinline__ float* dp_partial(const Args& A, int k, size_t& stride) {
  stride = (size_t)gridDim.x * gridDim.y * NF * DWA * DWB;
  return A.mg.dp_part + (blockIdx.z * dp_slots(A.slab) + k) * stride;
}

// dP row l of this thread's cells (d: their cotangents before the level-0
// factor, 0 for a cell it does not own), rows in order: an even row adds to
// the open coarse row l/2; an odd row closes (l-1)/2 (slab-relative k) into
// the ring, flushes a full ring and opens (l+1)/2.  Every thread calls it.
template <int NF, class Args>
__device__ __forceinline__ void dp_step(DpStage<NF>& Q, const Args& A, const float (&d)[CELLS][NF], int l, int c_lo) {
  const int k = ((l - 1) >> 1) - c_lo;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int row = threadIdx.y + c * THREAD_ROWS;
    float closed[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float& acc = Q.acc[f][row][threadIdx.x];
      if ((l & 1) == 0) {
        acc += d[c][f];
      } else {
        closed[f] = acc + 0.5f * d[c][f];
        acc = 0.5f * d[c][f];
      }
    }
    if (l & 1) close_dp_row(Q, closed, k % DPR, row);
  }
  if ((l & 1) && k % DPR == DPR - 1) {
    size_t stride;
    float* out = dp_partial<NF>(A, k - (DPR - 1), stride);
    flush_dp(Q, DPR, out, stride);
  }
}

// The slab's end (l1: its first row past): the open coarse row closes if it
// is a row of the plane, and the ring's rows flush.
template <int NF, class Args>
__device__ void dp_finish(DpStage<NF>& Q, const Args& A, int l1, int c_lo) {
  const int open = l1 >> 1, k = open - c_lo;
  int n = k % DPR;
  if (open <= A.mg.Tc - 1) {
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int row = threadIdx.y + c * THREAD_ROWS;
      float closed[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) closed[f] = Q.acc[f][row][threadIdx.x];
      close_dp_row(Q, closed, n, row);
    }
    ++n;
  }
  if (n > 0) {
    size_t stride;
    float* out = dp_partial<NF>(A, k - k % DPR, stride);
    flush_dp(Q, n, out, stride);
  }
}

// -- The walk --------------------------------------------------------------------

template <class M, int MODE, class Args>
__global__ void __launch_bounds__(NTHREADS, blocks_per_sm<M, MODE, Args>()) walk_kernel(const Args A) {
  constexpr int H = M::HIST, NF = M::NF, NT = M::MAXT;
  constexpr int NP = M::NP > 0 ? M::NP : 1;
  constexpr bool grads = (MODE & MODE_GRADS) != 0;
  constexpr bool sums = (MODE & MODE_SUMS) != 0;
  constexpr bool LOCAL = is_local<Args>;
  using S = Smem<M, grads, is_lvl2<Args>>;
  constexpr int NSLOT = S::NSLOT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int T = A.T, X = A.X, Y = A.Y;
  const int x0 = blockIdx.y * TILE_X - tile_shift(A), y0 = blockIdx.x * TILE_Y;
  const int ts = blockIdx.z * A.slab, te = min(ts + A.slab, T);
  // The walk's residual rows ts .. re-1 (a whole plane's wrap past T-1; a
  // local block has none, its rows past Tl-1 only complete the last rows).
  const int re = te + (grads ? H : 0);
  const bool infer = grads && M::NP > 0 && A.nparams > 0;
  // The fine rows the walk reads: ts-HIST .. re-1 (a local block's < Tl).
  auto needed = [&](int q) { return q < re && (!LOCAL || q < T); };
  auto slot = [&](int q) { return (q - ts + H) % NSLOT; };

  for (int p = 0, off = 0; off < A.nparams; off += A.param_size[p++]) {
    for (int k = tid; k < A.param_size[p]; k += NTHREADS) sm.P[off + k] = __ldg(A.params[p] + k);
  }
  init_taps(sm.S, A, x0, y0);
  if constexpr (is_lvl2<Args>) mgc::init_taps2(sm.S2, A.mg, A, x0, y0);
  int c_lo = 0;  // dP: the slab's first coarse row
  if constexpr (grads) {
    int c_hi;
    dp_rows(A, blockIdx.z, c_lo, c_hi);
    init_dp_taps(sm.Q, A, x0, y0);
#pragma unroll
    for (int c = 0; c < CELLS; ++c)
#pragma unroll
      for (int f = 0; f < NF; ++f) sm.Q.acc[f][threadIdx.y + c * THREAD_ROWS][threadIdx.x] = 0.0f;
  }
  __syncthreads();

  int p1_rows[2] = {-1, -1};  // the level-1 rows in the depth-2 ring's slots
  RowLoads<NF> L;
  // The ring's first rows: ts-HIST .. ts.
  for (int q = ts - H; q <= ts; ++q) {
    fetch_row<NF, H>(L, sm.S, A, q, x0, y0);
    stage_row(sm.S, sm.S2, A, L, p1_rows, x0, y0);
    __syncthreads();
    rebuild_row(sm.F[slot(q)], sm.S, A, L);
    __syncthreads();
  }
  if (needed(ts + 1)) fetch_row<NF, H>(L, sm.S, A, ts + 1, x0, y0);

  float g2[NT], s[NT], pacc[NP];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    g2[k] = (grads && k < A.nterms) ? 2.0f * __ldg(A.g + k) : 0.0f;
    s[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) pacc[k] = 0.0f;
  // acc[j][c][f]: this thread's cotangent of field f at cell c of fine row
  // t - j, so far.
  float acc[H + 1][CELLS][NF];
#pragma unroll
  for (int j = 0; j <= H; ++j)
#pragma unroll
    for (int c = 0; c < CELLS; ++c)
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[j][c][f] = 0.0f;

  for (int t = ts; t < re; ++t) {
    // Rows t-HIST .. t are in the ring.
    const bool live = !LOCAL || t < T;  // a residual row of the plane
    int it = t < T ? t : t - T;         // the model's row
    float rm = 1.0f;
    if constexpr (LOCAL) {
      it = t + A.off;
      rm = t >= A.r_lo && t < A.r_hi ? 1.0f : 0.0f;
    }
    const bool own_row = t < te;

    // Residual row t at tile cell (ti, tj) (-1 .. TILE): its terms into the
    // sums where `own`, its staged cotangents into D, those at its own cell
    // into dc (rows2d.cuh's cell).
    auto cell = [&](int ti, int tj, bool own, float (&dc)[H + 1][NF]) {
      float v[H + 1][NF][3][3];
#pragma unroll
      for (int m = 0; m <= H; ++m) {
        const int sl = slot(t - m);
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int qx = 0; qx < 3; ++qx)
#pragma unroll
            for (int qy = 0; qy < 3; ++qy) v[m][f][qx][qy] = sm.F[sl][f][ti + HALO + qx - 1][tj + HALO + qy - 1];
      }
      const int xw = sm.S.xi[ti + HALO], yw = sm.S.yi[tj + HALO];
      float res[NT], Dl[H + 1][NF][3][3];
      if constexpr (LOCAL) {
        const float mk = rm * __ldg(A.mask + (size_t)xw * Y + yw);
        float g2m[NT];
#pragma unroll
        for (int k = 0; k < NT; ++k) g2m[k] = g2[k] * mk;
        M::template eval<grads>(A, sm.P, it, xw, yw, v, g2m, res, Dl, pacc, own);
#pragma unroll
        for (int k = 0; k < NT; ++k) res[k] *= mk;
      } else {
        M::template eval<grads>(A, sm.P, it, xw, yw, v, g2, res, Dl, pacc, own);
      }
      if (sums && own) {
#pragma unroll
        for (int k = 0; k < NT; ++k) s[k] += k < A.nterms ? res[k] * res[k] : 0.0f;
      }
      if constexpr (grads) {
        rows2d::static_for<0, (H + 1) * NF * 9>([&](auto E) {
          constexpr int e = decltype(E)::value, m = e / (NF * 9), f = e / 9 % NF, q = e % 9;
          if constexpr (M::used(e)) {
            if constexpr (q == 4) {
              dc[m][f] = Dl[m][f][1][1];
            } else {
              constexpr int plane = rows2d::staged_slot<M>(e);
              sm.D[plane][ti + 1][tj + 1] = Dl[m][f][q / 3][q % 3];
            }
          }
        });
      }
    };

    float dc[CELLS][H + 1][NF];
    if (live) {
#pragma unroll
      for (int c = 0; c < CELLS; ++c) {
        const int ti = threadIdx.y + c * THREAD_ROWS, tj = threadIdx.x, x = x0 + ti;
        cell(ti, tj, own_row && x >= 0 && x < X && y0 + tj < Y, dc[c]);
      }
      if constexpr (grads) {
        // The ring of one cell around the tile: its top and bottom rows,
        // then its left and right columns.
        if (tid < NRING) {
          int ri, rj;
          if (tid < 2 * RY) {
            ri = tid < RY ? 0 : RX - 1;
            rj = tid % RY;
          } else {
            ri = 1 + (tid - 2 * RY) / 2;
            rj = (tid - 2 * RY) % 2 ? RY - 1 : 0;
          }
          float unused[H + 1][NF];
          cell(ri - 1, rj - 1, false, unused);
        }
      }
    }
    // Fine row t+1: its coarse window staged (the rebuild follows the
    // barrier, into the slot of row t-HIST, which residual row t read last).
    const int qn = t + 1;
    const bool next = needed(qn);
    if (next) stage_row(sm.S, sm.S2, A, L, p1_rows, x0, y0);
    __syncthreads();
    if constexpr (grads) {
      // Each owned cell gathers residual row t's cotangents of its field rows
      // t - j (entry m = j) from the 3 x 3 cells around it; field row
      // t - HIST is then complete and takes the mg epilogue.
      const int w = t - H;
      float d[CELLS][NF];
#pragma unroll
      for (int c = 0; c < CELLS; ++c) {
        const int ti = threadIdx.y + c * THREAD_ROWS, tj = threadIdx.x;
        if (live) {
          rows2d::static_for<0, (H + 1) * NF * 9>([&](auto E) {
            constexpr int e = decltype(E)::value, j = e / (NF * 9), f = e / 9 % NF, q = e % 9;
            if constexpr (M::used(e)) {
              if constexpr (q == 4) {
                acc[j][c][f] += dc[c][j][f];
              } else {
                constexpr int plane = rows2d::staged_slot<M>(e);
                acc[j][c][f] += sm.D[plane][ti + 2 - q / 3][tj + 2 - q % 3];
              }
            }
          });
        }
        const int x = x0 + ti, y = y0 + tj;
        const bool cell_ok = x >= 0 && x < X && y < Y;
#pragma unroll
        for (int f = 0; f < NF; ++f) d[c][f] = (w >= ts && cell_ok) ? acc[H][c][f] : 0.0f;
        if (w >= ts && cell_ok) {
#pragma unroll
          for (int f = 0; f < NF; ++f) A.df[f][((size_t)w * X + x) * Y + y] = A.mg.f0[f] * acc[H][c][f];
        }
        if constexpr (LOCAL) {
          if (w < 0 && cell_ok) {
#pragma unroll
            for (int f = 0; f < NF; ++f) A.dheads[f][((size_t)(H + w) * X + x) * Y + y] = acc[H][c][f];
          }
        }
#pragma unroll
        for (int j = H; j > 0; --j)
#pragma unroll
          for (int f = 0; f < NF; ++f) acc[j][c][f] = acc[j - 1][c][f];
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[0][c][f] = 0.0f;
      }
      if (w >= ts) dp_step(sm.Q, A, d, w, c_lo);
    }
    if (next) {
      rebuild_row(sm.F[slot(qn)], sm.S, A, L);
      if (needed(qn + 1)) fetch_row<NF, H>(L, sm.S, A, qn + 1, x0, y0);  // in flight during row t+1
    }
    __syncthreads();
  }
  if constexpr (grads) dp_finish(sm.Q, A, te, c_lo);
  rows2d::reduce_terms<M, S::NRED16>(A, s, pacc, sm.red, sums, infer, tid);
}

// dP[f][c][a][b] from the blocks' windows: the at most 2 (slabs) x 2 (x
// tiles) x 2 (y tiles) windows that hold coarse cell (c, a, b), added in the
// order slab, x tile, y tile.  A local block's windows are unwrapped (global
// coarse column a appears as a + m * CX); the cells no window holds are 0.
// Grid: (CY / GATHER_B, CX, Tc) blocks of GATHER_B threads.
template <int NF, class Args>
__global__ void __launch_bounds__(GATHER_B) dp_gather_kernel(const Args A) {
  constexpr int DWIN = NF * DWA * DWB;
  const int b = blockIdx.x * GATHER_B + threadIdx.x;
  if (b >= A.mg.CY) return;
  const int a = blockIdx.y, c = blockIdx.z;
  const dim3 grid = walk_grid(A);
  const int nby = grid.x, nbx = grid.y, nz = grid.z;
  constexpr int HXT = TILE_X / 2, HYT = TILE_Y / 2;
  const int u0 = ((first_col(A) - tile_shift(A)) >> 1) - 1;  // unwrapped coarse column of tile 0's window 0
  const int u_end = u0 + (nbx - 1) * HXT + DWA;
  const int zc = 2 * c / A.slab;  // the slab of fine row 2c
  const int jy = b + 1, by1 = jy / HYT;
  const size_t tiles = (size_t)nbx * nby;
  float v[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) v[f] = 0.0f;
  for (int z = max(zc - 1, 0); z <= min(zc + 1, nz - 1); ++z) {
    int c_lo, c_hi;
    dp_rows(A, z, c_lo, c_hi);
    if (c < c_lo || c > c_hi) continue;
    const float* row = A.mg.dp_part + (size_t)(z * dp_slots(A.slab) + c - c_lo) * tiles * DWIN;
    int u = a;
    while (u - A.mg.CX >= u0) u -= A.mg.CX;
    while (u < u0) u += A.mg.CX;
    for (; u < u_end; u += A.mg.CX) {
      const int jx = u - u0;
      for (int bx = jx / HXT - 1; bx <= jx / HXT; ++bx) {
        const int wa = jx - bx * HXT;
        if (bx < 0 || bx >= nbx || wa >= DWA) continue;
        for (int by = by1 - 1; by <= by1; ++by) {
          const int wb = jy - by * HYT;
          if (by < 0 || by >= nby || wb >= DWB) continue;
          const float* w = row + ((size_t)bx * nby + by) * DWIN + wa * DWB + wb;
#pragma unroll
          for (int f = 0; f < NF; ++f) v[f] += w[f * DWA * DWB];
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) A.mg.dP[f][((size_t)c * A.mg.CX + a) * A.mg.CY + b] = v[f];
}

// Depth 2: dP2 from dP1 (mg_common.cuh's coarse_grad).
template <int NF>
__global__ void __launch_bounds__(CT * CT) coarse_grad_kernel(const mgc::CoarseArgs<NF> A) {
  mgc::coarse_grad<NF>(A);
}

// -- Launchers -------------------------------------------------------------------

// The walk (MODE) and, with the gradients, the dP gather (and at depth 2 the
// level-2 cotangent), one after another on the stream.
template <class M, int MODE, class Args>
int launch(const Args& A, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<M, MODE, Args>();
  static_assert(bytes <= rows2d::SMEM_LIMIT, "mg_rows2d.cuh: the block's shared memory exceeds what a block may take");
  static const cudaError_t attr =
      cudaFuncSetAttribute(walk_kernel<M, MODE, Args>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  if (A.T < 2 * M::HIST + 1 || A.T % 2 == 0 || A.X < 1 || A.Y < 1 || A.slab < 1 || A.mg.Tc != (A.T - 1) / 2 + 1 ||
      !M::takes(A))
    return (int)cudaErrorInvalidValue;
  walk_kernel<M, MODE, Args><<<walk_grid(A), dim3(TILE_Y, THREAD_ROWS), bytes, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !(MODE & MODE_GRADS)) return (int)err;
  dp_gather_kernel<M::NF, Args><<<dim3((A.mg.CY + GATHER_B - 1) / GATHER_B, A.mg.CX, A.mg.Tc), GATHER_B, 0, s>>>(A);
  err = cudaGetLastError();
  if constexpr (is_lvl2<Args>) {
    if (err != cudaSuccess) return (int)err;
    const dim3 cgrid((A.CY2 + CT - 1) / CT, (A.CX2 + CT - 1) / CT, A.Tc2 * M::NF);
    mgc::CoarseArgs<M::NF> C;
    for (int f = 0; f < M::NF; ++f) {
      C.dt0[f] = A.mg.dP[f];
      C.dP[f] = A.dP2[f];
    }
    C.T = A.mg.Tc, C.X = A.mg.CX, C.Y = A.mg.CY, C.CX = A.CX2, C.CY = A.CY2;
    coarse_grad_kernel<M::NF><<<cgrid, dim3(CT, CT), 0, s>>>(C);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <class M, class Args>
int backward(const Args& A, int with_sums, cudaStream_t s) {
  return with_sums ? launch<M, MODE_SUMS | MODE_GRADS>(A, s) : launch<M, MODE_GRADS>(A, s);
}

template <class M, int MODE, class Args>
int resident_blocks() {
  constexpr size_t bytes = smem_bytes<M, MODE, Args>();
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(walk_kernel<M, MODE, Args>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_kernel<M, MODE, Args>, NTHREADS, bytes) !=
      cudaSuccess)
    return 0;
  return sms * per_sm;
}

// The blocks the card holds at once of a form's launch (form: 0 the whole
// plane, 1 depth 2, 2 the local block; mode: 1 the sums, 2 the gradients, 3
// both; the depth-2 and local forms take the gradients).
template <class M>
int resident(int form, int mode) {
  switch (form * 4 + mode) {
    case MODE_SUMS: return resident_blocks<M, MODE_SUMS, Mg2DArgs>();
    case MODE_GRADS: return resident_blocks<M, MODE_GRADS, Mg2DArgs>();
    case MODE_SUMS | MODE_GRADS: return resident_blocks<M, MODE_SUMS | MODE_GRADS, Mg2DArgs>();
    case 4 + MODE_GRADS: return resident_blocks<M, MODE_GRADS, Mg2DLvl2Args>();
    case 4 + (MODE_SUMS | MODE_GRADS): return resident_blocks<M, MODE_SUMS | MODE_GRADS, Mg2DLvl2Args>();
    case 8 + (MODE_SUMS | MODE_GRADS): return resident_blocks<M, MODE_SUMS | MODE_GRADS, Mg2DLocalArgs>();
    default: return 0;
  }
}

// The dynamic shared memory of a block of a form (form and mode as above).
template <class M>
int smem(int form, int mode) {
  switch (form * 4 + mode) {
    case MODE_SUMS: return (int)smem_bytes<M, MODE_SUMS, Mg2DArgs>();
    case MODE_GRADS:
    case MODE_SUMS | MODE_GRADS: return (int)smem_bytes<M, MODE_GRADS, Mg2DArgs>();
    case 4 + MODE_GRADS:
    case 4 + (MODE_SUMS | MODE_GRADS): return (int)smem_bytes<M, MODE_GRADS, Mg2DLvl2Args>();
    case 8 + (MODE_SUMS | MODE_GRADS): return (int)smem_bytes<M, MODE_GRADS, Mg2DLocalArgs>();
    default: return 0;
  }
}

// The floats of the dP windows of a launch over T residual rows, X (+ the
// local tile shift) columns and Y, in slabs of `slab` rows.
template <int NF>
long long dp_floats(int T, int X, int Y, int slab) {
  const long long blocks = (long long)((Y + TILE_Y - 1) / TILE_Y) * ((X + TILE_X - 1) / TILE_X) * ((T + slab - 1) / slab);
  return blocks * dp_slots(slab) * NF * DWA * DWB;
}

}  // namespace mg2d
