// Multigrid-fused row-wise residual kernels for Hopper (sm_90a), specialised
// to the velocity-from-tracer row model.
//
// Replaces the TPU kernels of odil_tpu/ops/rowwise_mg.py:
//   _backward_mg (:350, pallas_call at :766), with and without the sums, with
//                lvl2=None (mg_rows_kernel<MODE, false>) and with lvl2, the
//                two-level fusion (mg_rows_kernel<MODE, true>, below);
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
//   * Tiles: a block of 8 x 32 threads owns TILE_X x TILE_Y = 16 x 32 cells
//     (two a thread, rows r and r + 8) of a slab of `slab` rows and walks
//     its rows with a 3-row ring of rebuilt fine rows (halo 2, periodic
//     wrap) in shared memory; rows at the slab edges are rebuilt twice.  Two
//     cells a thread rebuild 1.41 fine cells and stage 1.2 ring-1 cells per
//     owned cell (1.69 and 1.33 at one cell a thread on 8 x 32) and halve the
//     barriers per cell.  Each
//     row is rebuilt from a window of t-blended coarse values staged in
//     shared memory (two loads per coarse value instead of eight per fine
//     value), and its global loads are issued into registers one row ahead,
//     so that they are in flight while the block works on the row before.
//     The slab length is the host's choice (ops/rowwise_mg.py::_mg_slab):
//     the fewest row-times in whole waves of the blocks the card holds at
//     once (odil_mg_resident_blocks), e.g. 3 slabs of 22 rows, 384 blocks
//     of the 396 the card holds, at 256^2.
//   * dP inside the walk, as the TPU kernel forms it in its ring: each thread
//     sums the t-blended cotangent of its own cell for the open coarse row
//     (before the f0 scaling); when the row closes, the warps apply the
//     transposed y taps by shuffles into a ring of closed rows, and every
//     DPR rows the block applies the x taps and stores its coarse window
//     (the coarse cells its owned cells' taps reach) as its partial of each
//     row (dp_part).  A gather kernel then adds the at most 2 x 2 x 2
//     windows (slabs, x tiles, y tiles) that hold a coarse cell, in a fixed
//     order.  dt0 is never read back and no atomics touch a float.
//   * Sums: each block reduces its threads' fp32 sums in fp64 by warp
//     shuffles and then its warps in order, and writes its row of partials;
//     the last block to finish (an integer ticket) reduces the rows in block
//     order -- deterministic run to run, no second launch.
//   * The row model's residuals, their adjoint and the ring-1 staging are
//     device code of veltracer_row.cuh, shared with the generic row kernels
//     of rowwise.cu.
//
// Bound on the H100 (3.35 TB/s HBM): at the flagship shapes (65,256,256) x3
// the backward must read t0 (51.1 MB) and P (6.5 MB) and write dt0 and dP
// (57.6 MB): ~115 MB, ~35 us.  The forward reads half of that, ~17 us.  The
// arithmetic (a few hundred fp32 operations per cell) is far below the
// memory time, so both are bound by bytes.  The walk runs far above that
// bound (PERF.md): it issues its per-cell work -- the rebuild of 1.41 fine
// cells, the ring-1 staging of 1.2 and the residuals and adjoint of one --
// with 3 blocks of 256 threads an SM (its ~70 KB of dynamic shared memory).
//
// Two-level fusion (odil_mg_backward2; lvl2 = (t1s, f1s, W1x, W1y) of the
// TPU kernel).  P is then the level-2 Horner partial P2 (Tc2, X/4, Y/4) and
// the level-1 term t1 (Tc, X/2, Y/2) is an input: the level-1 rows
//   P1[c] = f1 * t1[c] + W1x . blend_t(P2[c/2], P2[c/2+1]) . W1y^T
// are rebuilt per block over the coarse window its fine rows read (12 x 20
// level-1 cells from a staged 8 x 12 window of t-blended level-2 values),
// into a two-slot ring in shared memory: fine row r reads P1 rows r/2 and
// r/2+1, so the walk rebuilds one P1 row every two fine rows (two at the
// slab start; the slab-edge recompute stands in for the TPU kernel's
// XLA-built head and wrap residents).  The dP output then holds the level-1
// cotangent dP1, formed as at depth 1, and mg_coarse_grad_kernel runs once
// more one level down for dP2 = W1x^T (0.5 dP1[2c-1] + dP1[2c] +
// 0.5 dP1[2c+1]) W1y (1/8 of the walk's bytes); the caller scales dP1 by f1
// for dt1 (the TPU kernel's caller does both in XLA,
// odil_tpu/ops/rowwise_mg.py:947-959).  The P1 rebuild loads its window
// directly (no register prefetch).
//
// Local-block form (odil_mg_backward_local: mg_rows_kernel and
// mg_dp_gather_kernel on MgLocalArgs): the per-shard kernel of the halo
// path.  Replaces
//   _backward_mg with wraps_in / emit_dwraps (odil_tpu/ops/rowwise_mg.py:350-365,
//       pallas_call at :766), with the sums, and
//   rowwise_mg_local_tiled._loss_and_grads_local_tiled (:259, pallas_call at
//       :565), the same function for blocks beyond the TPU's VMEM -- one
//       tiled design serves every block here.
// The block is one shard's level-0 term (Tl, Xe, Y), x-halo-extended, with
// the time window of the level-1 partial (Tcw = (Tl-1)/2 + 1 rows, window
// row 0 at global row g0/2, the whole coarse plane) and the `hist` (= 1)
// fine row before local row 0 (`heads`) in place of the block's own
// periodic wrap.  The walk runs over the stack [heads; rebuilt rows
// 0..Tl-1]: stack row 0 is the head, loaded as it is; its cotangent (the
// "prev" adjoint of residual row 0) leaves as dheads instead of being folded
// into the last rows.  Local column c is global column (x0 + c) mod Xg: its
// 2-tap prolongation weights and coarse window are those of the global
// column (the TPU kernel takes the gathered rows of the x prolongation
// matrix).  Residuals carry the halo layer of veltracer_row.cuh (global rows,
// plane mask, the block's own rows).  The dP windows run over unwrapped
// global coarse columns (a block may straddle the seam); the gather writes
// the whole coarse plane of the time window, 0 where no block's taps reach.
// Bound: the bytes of the block, its window and heads in, dt0, dP and dheads
// out; ~28.8 MB at the flagship's t:2,x:2 shards, ~8.6 us at 3.35 TB/s.
//
// Ablation builds (odil_torch/ops/mg_ablation.py; the kernel-ablation tool's
// variants, benchmarks/kernel_ablation.py:224-291): the macro ODIL_MG_ABLATION
// picks what the depth-1 whole-plane walk leaves out, and nothing else of the
// walk changes.  Built without it (the library of every path), the code is
// the code above.  1: the row model's arithmetic -- the row header is
// mg_trivial_row.cuh, whose trivial row touches every input plane.  2: the
// 2-tap prolongation and its transpose (the TPU tool's "no-matmul", which
// stubs the in-kernel MXU dots by copies of the same shapes): a fine cell
// takes the t-blended coarse value at (x mod CX, y mod CY), loaded with its
// t0 values in place of the staged window and its taps (the tool's tiled
// copy), and dP is the t-blended fine cotangent of the cells x < CX, y < CY
// (the tool's slice), written by the owning thread as its slab's partial of
// that coarse cell and summed over the slabs by mg_dp_slice_gather_kernel.
// Both compute another function than the loss: each is held to its own
// plain version.  The two-level and local-block entry points refuse an
// ablation build.

#include <type_traits>

// The walk's tile: 16 x 32 cells, 8 x 32 threads, two cells a thread; the
// tile's first column at plane column 2 (the halo).
#define ODIL_TILE_X 16
#define ODIL_THREAD_ROWS 8
#define ODIL_PLANE_YOFF 2
#if ODIL_MG_ABLATION == 1
#include "mg_trivial_row.cuh"
#else
#include "veltracer_row.cuh"
#endif

// The device code this walk shares with the generic mg walk over a traced
// row model (mg_rows2d.cuh), templated on the field count: the window's and
// the dP stages' types, the taps, the close and flush of dP's coarse rows,
// the level-1 rebuild, the loads and staging of the coarse window, a fine
// cell's rebuild and the dP2 kernel's body.  The rest -- init_taps,
// init_dp_taps, dp_step/dp_finish and the dP gather -- stays a copy here:
// shared, each moved this file's SASS (its pin in tests/test_torch_gpu.py),
// which these parts keep instruction for instruction.
#include "mg_common.cuh"

namespace {

using mgc::CT;
using mgc::DPR;
using mgc::DWA;
using mgc::DWB;
using mgc::FW;
using mgc::GATHER_B;
using mgc::WX;
using mgc::WX2;
using mgc::WY;
using mgc::WY2;
constexpr int DWIN = NF * DWA * DWB;
using RowStage = mgc::RowStage<NF>;
using Lvl2Stage = mgc::Lvl2Stage<NF>;
using DpStage = mgc::DpStage<NF>;
using mgc::taps;
using mgc::tap_weight;
using mgc::close_dp_row;
using mgc::flush_dp;

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
  double* partials;   // (nblocks, MAXTERMS): each block's sums
  float* sums;        // (MAXTERMS,)
  float* dp_part;     // each block's dP partials (odil_mg_dp_floats floats)
  unsigned* ticket;   // 0 between launches: the blocks that have written their sums
  int T, X, Y, Tc, CX, CY, slab, nterms;
  int has_x, has_t;
  float f0[NF];
  // Reciprocals of the steps (1/dt, 1/dx, ..., 1/dy^2): the residuals
  // multiply by them.  For the usual power-of-two steps that is exactly the
  // JAX package's division.
  float inv_dt, inv_dx, inv_dy, inv_dx2, inv_dy2;
  float kimp, kimp_dx, kxreg, kt;  // kimp_dx = kimp/dx, kt = ktreg/dt
};

// The arguments of the two-level fusion (odil_mg_backward2): P holds the
// level-2 partial (Tc2, CX2, CY2) and dP receives dP1; t1 holds the level-1
// terms (Tc, CX, CY) with factors f1.  A struct of its own, so that the
// depth-1 kernels keep their argument block.  Mirrored by
// odil_torch/ops/rowwise_mg.py::_Mg2Args (checked through odil_mg2_args_size()).
struct Mg2Args : MgArgs {
  const float* t1[NF];
  float* dP2[NF];  // the level-2 cotangent
  int Tc2, CX2, CY2;
  float f1[NF];
};

// The local-block kernel's arguments (odil_mg_backward_local): MgArgs over
// the block (T = Tl rows of t0, X = Xe, Tc = Tcw window rows, CX, CY the
// global coarse plane, slab over the Tl + 1 rows of the stack) plus the head
// row, its cotangent and the halo layer.  Mirrored by
// odil_torch/ops/rowwise_mg.py::_MgLocalArgs (checked through
// odil_mg_local_args_size()).
struct MgLocalArgs : MgArgs {
  const float* heads[NF];  // (1, Xe, Y): the fine row before local row 0
  float* dheads[NF];
  const float* mask;       // (Xe, Y) 0/1 plane: zero on halo columns
  int x0, Xg;              // global column of local column 0 (may be < 0); the global X
  int off, Tg;             // global row of local row 0; the global row count
  int r_lo, r_hi;          // the block's own residual rows [r_lo, r_hi), local
};

namespace {

// Window index of coarse index a (0 <= a < n) for a window starting at a0.
__device__ __forceinline__ int win(int a, int a0, int n) { return pmod(a - a0, n); }

// The fine x columns as the prolongation sees them: a whole plane's are its
// own; a local block's column c is global column (x0 + c) mod Xg.
// first_col: the global column of column 0; fine_cols: the global X;
// tile_shift: the local column of tile 0's first column is -tile_shift (a
// local block's tiles start at even global columns).
__device__ __forceinline__ int first_col(const MgArgs&) { return 0; }
__device__ __forceinline__ int first_col(const MgLocalArgs& A) { return A.x0; }
__device__ __forceinline__ int fine_cols(const MgArgs& A) { return A.X; }
__device__ __forceinline__ int fine_cols(const MgLocalArgs& A) { return A.Xg; }
__host__ __device__ __forceinline__ int tile_shift(const MgArgs&) { return 0; }
__host__ __device__ __forceinline__ int tile_shift(const MgLocalArgs& A) { return A.x0 & 1; }

template <class Args>
constexpr bool is_local = std::is_same<Args, MgLocalArgs>::value;

// The rows a block walks (a local block: the stack [heads; block]) and the
// dP row of walked row 0 (-1: a local block's head row has no dP row).
template <class Args>
__host__ __device__ __forceinline__ int walked_rows(const Args& A) { return is_local<Args> ? A.T + 1 : A.T; }
template <class Args>
__host__ __device__ __forceinline__ int dp_row0(const Args&) { return is_local<Args> ? -1 : 0; }

// The blocks of the row kernels: y tiles, x tiles, slabs.
template <class Args>
__host__ __device__ __forceinline__ dim3 rows_grid(const Args& A) {
  return dim3((A.Y + TILE_Y - 1) / TILE_Y, (A.X + tile_shift(A) + TILE_X - 1) / TILE_X,
              (walked_rows(A) + A.slab - 1) / A.slab);
}

// The coarse rows [c_lo, c_hi] of slab z's dP partials: its dP rows
// [l0, l1) reach coarse rows l0 >> 1 .. l1 >> 1 (fine row 2c+-1 enters row c
// with weight 1/2).  dp_slots: the most a slab reaches.
__host__ __device__ __forceinline__ int dp_slots(int slab) { return slab / 2 + 2; }
template <class Args>
__device__ __forceinline__ void dp_rows(const Args& A, int z, int& c_lo, int& c_hi) {
  const int ts = z * A.slab, te = min(ts + A.slab, walked_rows(A));
  const int l0 = max(ts + dp_row0(A), 0), l1 = te + dp_row0(A);
  c_lo = l0 >> 1;
  c_hi = min(A.Tc - 1, l1 >> 1);
}

// dP inside the walk.  A thread sums the t-blended cotangent
// 0.5 d[2c-1] + d[2c] + 0.5 d[2c+1] of its own cell for the coarse row c that
// is open.  When c closes (after fine row 2c+1, or at the slab's end) each
// warp -- one tile row of TILE_Y = 32 cells -- applies the transposed y taps
// by shuffles (cells 2q and 2q+1 share their coarse taps q-1, q, q+1) into a
// ring of DPR closed rows in shared memory; when the ring is full, or at the
// slab's end, the block applies the transposed x taps and stores each row's
// coarse window (DWA x DWB cells per field; window x index wa is unwrapped
// global coarse column (xg0 >> 1) - 1 + wa, xg0 the tile's first global
// column, so that a local block's window may straddle the periodic seam;
// window y index wb is coarse row y0/2 - 1 + wb) as the block's partial of
// that coarse row.
static_assert(TILE_Y == 32, "the dP y taps take one warp per tile row");

// The dP tap weights of the tile's owned columns and rows (once per block;
// zero where the tile owns no cell).  x0: the tile's first local column.
template <class Args>
__device__ void init_dp_taps(DpStage& Q, const Args& A, int x0, int y0) {
  const int xg0 = x0 + first_col(A), Xg = fine_cols(A);
  for (int idx = threadIdx.y * TILE_Y + threadIdx.x; idx < TILE_X + TILE_Y; idx += NTHREADS) {
    int a[2];
    float w[2], q[3] = {0.0f, 0.0f, 0.0f};
    if (idx < TILE_X) {
      const int xl = x0 + idx, gx = xg0 + idx, gm = pmod(gx, Xg);
      if (xl >= 0 && xl < A.X) {
        taps(gm, A.CX, a[0], w[0], a[1], w[1]);
        for (int k = 0; k < 2; ++k) q[a[k] + (gx - gm) / Xg * A.CX - (gx >> 1) + 1] += w[k];
      }
      for (int k = 0; k < 3; ++k) Q.xw[idx][k] = q[k];
    } else {
      const int c = idx - TILE_X, y = y0 + c;
      if (y < A.Y) {
        taps(y, A.CY, a[0], w[0], a[1], w[1]);
        for (int k = 0; k < 2; ++k) q[a[k] - (y >> 1) + 1] += w[k];
      }
      for (int k = 0; k < 3; ++k) Q.yw[c][k] = q[k];
    }
  }
}

// The block's partials of slab-relative coarse row k (stride: to row k + 1).
template <class Args>
__device__ __forceinline__ float* dp_partial(const Args& A, int k, size_t& stride) {
  stride = (size_t)gridDim.x * gridDim.y * DWIN;
  return A.dp_part + (blockIdx.z * dp_slots(A.slab) + k) * stride;
}

#if ODIL_MG_ABLATION == 2
// The ablation without the prolongation: the closed coarse row k
// (slab-relative) of this thread's cell in tile row `row` is its slab's
// partial of coarse cell (x, y) where x < CX and y < CY (the slice), in
// dense planes (slab, k, field) of the coarse shape.
template <class Args>
__device__ __forceinline__ void slice_dp(const Args& A, int k, int row, const float (&closed)[NF]) {
  const int x = blockIdx.y * TILE_X + row, y = blockIdx.x * TILE_Y + threadIdx.x;
  if (x >= A.CX || y >= A.CY) return;
  const size_t cplane = (size_t)A.CX * A.CY;
  float* out = A.dp_part + ((size_t)blockIdx.z * dp_slots(A.slab) + k) * NF * cplane + (size_t)x * A.CY + y;
#pragma unroll
  for (int f = 0; f < NF; ++f) out[f * cplane] = closed[f];
}
#endif

// dP row l (the walk's fine row) of this thread's cells, d their cotangents
// before the level-0 factor (0 for a cell it does not own): an even row adds
// to the open coarse row l/2; an odd row closes (l-1)/2 (slab-relative k)
// into the ring, flushes a full ring and opens (l+1)/2.  c_lo: the slab's
// first coarse row.  Every thread of the block calls it.
template <class Args>
__device__ __forceinline__ void dp_step(DpStage& Q, const Args& A, const float (&d)[CELLS][NF], int l, int c_lo) {
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
#if ODIL_MG_ABLATION == 2
    if (l & 1) slice_dp(A, k, row, closed);
#else
    if (l & 1) close_dp_row(Q, closed, k % DPR, row);
#endif
  }
#if ODIL_MG_ABLATION != 2
  if ((l & 1) && k % DPR == DPR - 1) {
    size_t stride;
    float* out = dp_partial(A, k - (DPR - 1), stride);
    flush_dp(Q, DPR, out, stride);
  }
#endif
}

// The slab's end: the open coarse row (walk rows end before l1, the next dP
// row) closes if it is a row of the plane, and the ring's rows flush.
template <class Args>
__device__ void dp_finish(DpStage& Q, const Args& A, int l1, int c_lo) {
  const int open = l1 >> 1, k = open - c_lo;
#if ODIL_MG_ABLATION == 2
  if (open <= A.Tc - 1) {
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int row = threadIdx.y + c * THREAD_ROWS;
      float closed[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) closed[f] = Q.acc[f][row][threadIdx.x];
      slice_dp(A, k, row, closed);
    }
  }
#else
  int n = k % DPR;
  if (open <= A.Tc - 1) {
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
    float* out = dp_partial(A, k - k % DPR, stride);
    flush_dp(Q, n, out, stride);
  }
#endif
}

// The plane indices of the tile's fine rows and columns and their taps, as
// window indices (once per block).  x0: the tile's first (local) column; the
// taps are those of the global columns.
template <class Args>
__device__ void init_taps(RowStage& S, const Args& A, int x0, int y0) {
  const int xg0 = x0 + first_col(A);
  const int ax0 = (xg0 >> 1) - 2, by0 = (y0 >> 1) - 2;
  for (int idx = threadIdx.y * TILE_Y + threadIdx.x; idx < HX + HY; idx += NTHREADS) {
    int a0, a1;
    float w0, w1;
    if (idx < HX) {
      S.xi[idx] = pmod(x0 + idx - HALO, A.X);
      taps(pmod(xg0 + idx - HALO, fine_cols(A)), A.CX, a0, w0, a1, w1);
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

struct NoStage {};

// The global loads of one fine row, held in registers so that they are in
// flight while the block works on the previous row: this thread's share of
// the coarse window (two coarse rows; at depth 2 the coarse rows come from
// the P1 ring instead) and of the tile's t0 values.
constexpr int NCB = mgc::window_share<NF>;
constexpr int NPOS = (HX * HY + NTHREADS - 1) / NTHREADS;

struct RowLoads {
  int rr;
  float p0[NCB], p1[NCB];
  float t0[NPOS][NF];
#if ODIL_MG_ABLATION == 2
  float pb[NPOS][NF];  // the t-blended coarse value at (x mod CX, y mod CY) of each position
#endif
};

#if ODIL_MG_ABLATION == 2
// The ablation without the prolongation: this thread's blended coarse values
// of fine row rr at (x mod CX, y mod CY) for its tile positions.
template <class Args>
__device__ __forceinline__ void fetch_tiled(RowLoads& L, const RowStage& S, const Args& A, int rr) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int c0 = rr >> 1, c1 = min(c0 + 1, A.Tc - 1);
  const float w = (rr & 1) ? 0.5f : 0.0f;
  const size_t cplane = (size_t)A.CX * A.CY;
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
      const size_t o = (size_t)(S.xi[idx / HY] % A.CX) * A.CY + S.yi[idx % HY] % A.CY;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        L.pb[k][f] = (1.0f - w) * __ldg(A.P[f] + c0 * cplane + o) + w * __ldg(A.P[f] + c1 * cplane + o);
    }
  }
}
#endif

// Issues the loads of fine row r (periodic in t; x0: the tile's first global
// column).  A local block walks the stack [heads; block] of A.T + 1 rows:
// stack row 0 is the head row (L.rr = -1, loaded as it is), stack row r > 0
// is fine row r - 1.
template <bool LVL2, class Args>
__device__ __forceinline__ void fetch_row(RowLoads& L, const RowStage& S, const Args& A, int r, int x0, int y0) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  int rr;
  if constexpr (is_local<Args>) {
    const int Tq = A.T + 1;
    const int q = r < 0 ? r + Tq : (r >= Tq ? r - Tq : r);
    if (q == 0) {
      L.rr = -1;
#pragma unroll
      for (int k = 0; k < NPOS; ++k) {
        const int idx = tid + k * NTHREADS;
        if (idx < HX * HY) {
          const int hx = idx / HY, hy = idx % HY;
          const size_t o = (size_t)S.xi[hx] * A.Y + S.yi[hy];
#pragma unroll
          for (int f = 0; f < NF; ++f) L.t0[k][f] = __ldg(A.heads[f] + o);
        }
      }
      return;
    }
    rr = q - 1;
  } else {
    rr = r < 0 ? r + A.T : (r >= A.T ? r - A.T : r);
  }
  L.rr = rr;
#if ODIL_MG_ABLATION == 2
  if constexpr (!LVL2) fetch_tiled(L, S, A, rr);
#else
  if constexpr (!LVL2) mgc::fetch_window<NF>(L.p0, L.p1, A, rr, x0, y0);
#endif
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

// The fine rows from the staged blended coarse window: see build_row.
__device__ __forceinline__ void rebuild_fine(Plane* F, const RowStage& S, const MgArgs& A, const RowLoads& L) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) mgc::rebuild_at(F, S, A.f0, L.t0[k], idx / HY, idx % HY);
  }
}

// Rebuilds the fetched fine row of every field for the block's tile plus a
// halo of HALO cells (periodic in x and y) into F[0..NF):
// fine = f0 * t0[r] + Wx . blend_t(P[r/2], P[r/2+1]) . Wy^T, with the
// blended coarse window staged in shared memory first.  Contains barriers,
// so every thread of the block must call it; it ends with one.
#if ODIL_MG_ABLATION == 2
// The ablation without the prolongation: no staged window and no taps, the
// loaded blended values themselves.
__device__ void build_row(Plane* F, RowStage&, const MgArgs& A, const RowLoads& L) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
#pragma unroll
      for (int f = 0; f < NF; ++f) F[f][idx / HY][idx % HY] = A.f0[f] * L.t0[k][f] + L.pb[k][f];
    }
  }
  __syncthreads();
}
#else
__device__ void build_row(Plane* F, RowStage& S, const MgArgs& A, const RowLoads& L) {
  mgc::stage_window(S, L.p0, L.p1, L.rr);
  __syncthreads();
  rebuild_fine(F, S, A, L);
  __syncthreads();
}
#endif

// build_row at depth 2: the two coarse rows are level-1 rows of the P1 ring,
// rebuilt first where the ring does not hold them (p1_rows: the rows in its
// slots, the same in every thread).
__device__ void build_row2(Plane* F, RowStage& S, Lvl2Stage& S2, const Mg2Args& A, const RowLoads& L,
                           int (&p1_rows)[2], int x0, int y0) {
  mgc::stage_window2(S, S2, A, A, L.rr, p1_rows, x0, y0);
  __syncthreads();
  rebuild_fine(F, S, A, L);
  __syncthreads();
}

// The head row of a local block's stack into F[0..NF), as it is.  Every
// thread of the block calls it; it ends with a barrier.
__device__ void store_head(Plane* F, const RowLoads& L) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NPOS; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < HX * HY) {
      const int hx = idx / HY, hy = idx % HY;
#pragma unroll
      for (int f = 0; f < NF; ++f) F[f][hx][hy] = L.t0[k][f];
    }
  }
  __syncthreads();
}

// The ring's next fine row: build_row, build_row2 at depth 2 (Args is then
// Mg2Args), or a local block's head row.
template <bool LVL2, class Stage2, class Args>
__device__ __forceinline__ void next_row(Plane* F, RowStage& S, Stage2& S2, const Args& A, const RowLoads& L,
                                         int (&p1_rows)[2], int x0, int y0) {
  if constexpr (LVL2) build_row2(F, S, S2, A, L, p1_rows, x0, y0);
  else if constexpr (is_local<Args>) {
    if (L.rr < 0) store_head(F, L);
    else build_row(F, S, A, L);
  } else build_row(F, S, A, L);
}

// The global row of walked row 0: 0 for a whole plane, the row before a
// local block's first for its stack.
__device__ __forceinline__ int walk_off(const MgArgs&) { return 0; }
__device__ __forceinline__ int walk_off(const MgLocalArgs& A) { return A.off - 1; }

// The halo layer of stack rows t and it1 of a local block (local rows t - 1
// and it1 - 1), or none.
__device__ __forceinline__ NoHalo row_layer(const MgArgs&, const NoMask&, int, int) { return {}; }
__device__ __forceinline__ HaloRow row_layer(const MgLocalArgs& A, const MaskTile& MT, int t, int it1) {
  return {&MT.M, (t - 1 >= A.r_lo && t - 1 < A.r_hi) ? 1.0f : 0.0f,
          (it1 - 1 >= A.r_lo && it1 - 1 < A.r_hi) ? 1.0f : 0.0f, A.Tg};
}

// The walk's shared memory, dynamic (it exceeds the 48 KB of static shared
// memory): the ring of fine rows (slot of row r is (r - ts + 1) % 3), the
// initial tracer plane, the ring-1 staging, the sums' warp partials, the
// coarse window, and per form the level-1 ring, the mask and the dP stage.
template <int MODE, bool LVL2, class Args>
struct WalkSmem {
  float F[3][NF][HX][HY];
  float U0[HX][HY];
  Ring1 R;
  double red[NWARPS][MAXTERMS];
  RowStage S;
  typename std::conditional<LVL2, Lvl2Stage, NoStage>::type S2;
  typename std::conditional<is_local<Args>, MaskTile, NoMask>::type MT;
  typename std::conditional<(MODE & MODE_GRADS) != 0, DpStage, NoStage>::type Q;
};

// 3 blocks of 256 threads an SM (the shared memory of 3 fits the SM's 227
// KB), so up to 80 registers a thread for its two cells.  LVL2: the
// two-level fusion.  Args: MgArgs; Mg2Args at depth 2; MgLocalArgs for a
// local block, which walks the stack [heads; block] (stack row t is local
// row t - 1), takes global rows and the halo layer in the residuals, and
// writes the cotangent of stack row 0 to dheads.
constexpr int WALK_BLOCKS_PER_SM = 3;

template <int MODE, bool LVL2, class Args>
__global__ void __launch_bounds__(NTHREADS, WALK_BLOCKS_PER_SM) mg_rows_kernel(const Args A) {
  constexpr bool LOCAL = is_local<Args>;
  static_assert(std::is_same<Args, typename std::conditional<LVL2, Mg2Args, MgArgs>::type>::value || (LOCAL && !LVL2),
                "mg_rows_kernel: Mg2Args goes with LVL2");
  constexpr bool grads = (MODE & MODE_GRADS) != 0;
  constexpr bool sums = (MODE & MODE_SUMS) != 0;
  extern __shared__ __align__(16) unsigned char walk_smem[];
  auto& W = *reinterpret_cast<WalkSmem<MODE, LVL2, Args>*>(walk_smem);
  auto& F = W.F;
  auto& U0 = W.U0;
  auto& R = W.R;
  auto& S = W.S;
  auto& S2 = W.S2;
  auto& MT = W.MT;
  auto& Q = W.Q;
  int p1_rows[2] = {-1, -1};  // the level-1 rows in the P1 ring's slots (depth 2)

  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  // A local block's tiles start at even global columns (shifted by one local
  // column when A.x0 is odd), so that the coarse window covers every tap, the
  // extrapolation taps at the global seam included.
  const int x0 = blockIdx.y * TILE_X - tile_shift(A);
  const int y0 = blockIdx.x * TILE_Y;
  const int xg0 = x0 + first_col(A);
  const int y = y0 + threadIdx.x, j = threadIdx.x + HALO;
  const int T = walked_rows(A);
  const int ts = blockIdx.z * A.slab, te = min(ts + A.slab, T);
  const int off = walk_off(A);  // the global row of walked row 0

  for (int idx = tid; idx < HX * HY; idx += NTHREADS) {
    const int hx = idx / HY, hy = idx % HY;
    const size_t o = (size_t)pmod(x0 + hx - HALO, A.X) * A.Y + pmod(y0 + hy - HALO, A.Y);
    U0[hx][hy] = __ldg(A.u_init + o);
    if constexpr (LOCAL) MT.M[hx][hy] = __ldg(A.mask + o);
  }
  float g2[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) g2[k] = (grads && k < A.nterms) ? 2.0f * __ldg(A.g + k) : 0.0f;
  float s[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) s[k] = 0.0f;
  int c_lo = 0;  // dP: the slab's first coarse row
  if constexpr (grads) {
    int c_hi;
    dp_rows(A, blockIdx.z, c_lo, c_hi);
    init_dp_taps(Q, A, x0, y0);
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
#pragma unroll
      for (int f = 0; f < NF; ++f) Q.acc[f][threadIdx.y + c * THREAD_ROWS][threadIdx.x] = 0.0f;
    }
  }

  init_taps(S, A, x0, y0);
  if constexpr (LVL2) mgc::init_taps2(S2, A, A, x0, y0);
  __syncthreads();
  RowLoads L;
  fetch_row<LVL2>(L, S, A, ts - 1, xg0, y0);
  next_row<LVL2>(F[0], S, S2, A, L, p1_rows, x0, y0);
  if (grads) {
    fetch_row<LVL2>(L, S, A, ts, xg0, y0);
    next_row<LVL2>(F[1], S, S2, A, L, p1_rows, x0, y0);
  }
  // The row each iteration adds to the ring: t+1 for the gradients, t else.
  const int ahead = grads ? 1 : 0;
  fetch_row<LVL2>(L, S, A, ts + ahead, xg0, y0);
  for (int t = ts; t < te; ++t) {
    const int sm = (t - ts) % 3, sc = (t - ts + 1) % 3, sp = (t - ts + 2) % 3;
    next_row<LVL2>(F[grads ? sp : sc], S, S2, A, L, p1_rows, x0, y0);
    if (t + 1 < te) fetch_row<LVL2>(L, S, A, t + 1 + ahead, xg0, y0);  // in flight during this row's work
    const RowPlanes P{F[sm][0], F[sc][0], F[sp][0], F[sm][1], F[sc][1], F[sp][1], F[sm][2], F[sc][2], F[sp][2], U0};
    const int it1 = t + 1 < T ? t + 1 : 0;  // residual row t+1 (row 0 after T-1)
    const auto H = row_layer(A, MT, t, it1);

    if (grads) stage_ring1(A, P, it1 + off, g2, R, H);
    float d[CELLS][NF] = {};
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int x = x0 + threadIdx.y + c * THREAD_ROWS, i = threadIdx.y + c * THREAD_ROWS + HALO;
      if (!((!LOCAL || x >= 0) && x < A.X && y < A.Y)) continue;
      const float u1 = __ldg(A.u_final + (size_t)x * A.Y + y);
      cell_terms<grads, sums>(A, P, R, t + off, it1 + off, i, j, u1, g2, s, d[c], H);
      if (grads) {
        const size_t cell = ((size_t)(LOCAL ? t - 1 : t) * A.X + x) * A.Y + y;
        bool head = false;
        if constexpr (LOCAL) {
          head = t == 0;
          if (head) {
#pragma unroll
            for (int f = 0; f < NF; ++f) A.dheads[f][(size_t)x * A.Y + y] = d[c][f];
          }
        }
        if (!head) {
          A.dt0[0][cell] = A.f0[0] * d[c][0];
          A.dt0[1][cell] = A.f0[1] * d[c][1];
          A.dt0[2][cell] = A.f0[2] * d[c][2];
        }
      }
    }
    if constexpr (grads) {
      const int l = t + dp_row0(A);  // the dP row (fine row) of walked row t
      if (l >= 0) dp_step(Q, A, d, l, c_lo);
    }
    __syncthreads();
  }
  if constexpr (grads) dp_finish(Q, A, te + dp_row0(A), c_lo);
  if constexpr (sums) finish_sums(A, s, W.red);
}

// dP[f][c][a][b] from the blocks' partials: the at most 2 (slabs) x 2 (x
// tiles) x 2 (y tiles) windows that hold coarse cell (c, a, b), added in the
// order slab, x tile, y tile -- deterministic, no atomics.  A local block's
// windows are unwrapped (global coarse column a appears as a + m * CX); the
// cells no window holds are 0 (the rest of a local block's coarse plane).
// Grid: (CY / GATHER_B, CX, Tc) blocks of GATHER_B threads along b, each
// thread all NF fields (independent sums in flight together).

template <class Args>
__global__ void __launch_bounds__(GATHER_B) mg_dp_gather_kernel(const Args A) {
  const int b = blockIdx.x * GATHER_B + threadIdx.x;
  if (b >= A.CY) return;
  const int a = blockIdx.y, c = blockIdx.z;
  const dim3 grid = rows_grid(A);
  const int nby = grid.x, nbx = grid.y, nz = grid.z;
  constexpr int HXT = TILE_X / 2, HYT = TILE_Y / 2;
  const int u0 = ((first_col(A) - tile_shift(A)) >> 1) - 1;  // unwrapped coarse column of tile 0's window 0
  const int u_end = u0 + (nbx - 1) * HXT + DWA;
  const int zc = (2 * c - dp_row0(A)) / A.slab;  // the slab of fine row 2c
  const int jy = b + 1, by1 = jy / HYT;
  const size_t tiles = (size_t)nbx * nby;
  float v[NF] = {0.0f, 0.0f, 0.0f};
  for (int z = max(zc - 1, 0); z <= min(zc + 1, nz - 1); ++z) {
    int c_lo, c_hi;
    dp_rows(A, z, c_lo, c_hi);
    if (c < c_lo || c > c_hi) continue;
    const float* row = A.dp_part + (size_t)(z * dp_slots(A.slab) + c - c_lo) * tiles * DWIN;
    int u = a;
    while (u - A.CX >= u0) u -= A.CX;
    while (u < u0) u += A.CX;
    for (; u < u_end; u += A.CX) {
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
  for (int f = 0; f < NF; ++f) A.dP[f][((size_t)c * A.CX + a) * A.CY + b] = v[f];
}

#if ODIL_MG_ABLATION == 2
// The ablation without the prolongation: dP[f][c][a][b] from the slabs'
// dense partials (slice_dp), added in slab order.  Grid and threads as
// mg_dp_gather_kernel's.
__global__ void __launch_bounds__(GATHER_B) mg_dp_slice_gather_kernel(const MgArgs A) {
  const int b = blockIdx.x * GATHER_B + threadIdx.x;
  if (b >= A.CY) return;
  const int a = blockIdx.y, c = blockIdx.z;
  const int nz = (A.T + A.slab - 1) / A.slab, zc = 2 * c / A.slab;
  const size_t cplane = (size_t)A.CX * A.CY, o = (size_t)a * A.CY + b;
  float v[NF] = {0.0f, 0.0f, 0.0f};
  for (int z = max(zc - 1, 0); z <= min(zc + 1, nz - 1); ++z) {
    int c_lo, c_hi;
    dp_rows(A, z, c_lo, c_hi);
    if (c < c_lo || c > c_hi) continue;
    const float* part = A.dp_part + ((size_t)z * dp_slots(A.slab) + c - c_lo) * NF * cplane + o;
#pragma unroll
    for (int f = 0; f < NF; ++f) v[f] += part[f * cplane];
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) A.dP[f][(size_t)c * cplane + o] = v[f];
}
#endif

// The two-level fusion's dP2 = W1x^T (0.5 dP1[2c-1] + dP1[2c] + 0.5 dP1[2c+1])
// W1y, gathered per level-2 cell from dP1 (dt0 here: the level-1 plane, X, Y
// its size, CX, CY, Tc the level-2 ones; a coarse tile staged in shared
// memory).  It reads 1/8 of the bytes the row walk reads.
__global__ void __launch_bounds__(CT * CT) mg_coarse_grad_kernel(const MgArgs A) { mgc::coarse_grad<NF>(A); }

// The row walk (MODE) and, with the gradients, the dP gather.
// The walk's dynamic shared memory, allowed once per form.
template <int MODE, bool LVL2, class Args>
size_t walk_smem() {
  constexpr size_t bytes = sizeof(WalkSmem<MODE, LVL2, Args>);
  static const cudaError_t set =
      cudaFuncSetAttribute(mg_rows_kernel<MODE, LVL2, Args>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  (void)set;  // a refusal shows as the launch's error
  return bytes;
}

template <int MODE, bool LVL2, class Args>
int mg_launch(const Args& A, cudaStream_t s) {
  mg_rows_kernel<MODE, LVL2><<<rows_grid(A), dim3(TILE_Y, THREAD_ROWS), walk_smem<MODE, LVL2, Args>(), s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !(MODE & MODE_GRADS)) return (int)err;
  const dim3 ggrid((A.CY + GATHER_B - 1) / GATHER_B, A.CX, A.Tc);
#if ODIL_MG_ABLATION == 2
  mg_dp_slice_gather_kernel<<<ggrid, GATHER_B, 0, s>>>(A);
#else
  mg_dp_gather_kernel<Args><<<ggrid, GATHER_B, 0, s>>>(A);
#endif
  return (int)cudaGetLastError();
}

template <bool LVL2, class Args>
int mg_backward(const Args& A, int with_sums, cudaStream_t s) {
  return with_sums ? mg_launch<MODE_SUMS | MODE_GRADS, LVL2>(A, s) : mg_launch<MODE_GRADS, LVL2>(A, s);
}

}  // namespace

extern "C" {

int odil_mg_args_size() { return (int)sizeof(MgArgs); }

int odil_mg2_args_size() { return (int)sizeof(Mg2Args); }

int odil_mg_local_args_size() { return (int)sizeof(MgLocalArgs); }

// The blocks of a launch over T walked rows and X columns (X + 1 for a local
// block with odd x0): the rows of A->partials.
int odil_mg_num_blocks(int T, int X, int Y, int slab) {
  return ((Y + TILE_Y - 1) / TILE_Y) * ((X + TILE_X - 1) / TILE_X) * ((T + slab - 1) / slab);
}

// The floats of A->dp_part for the same launch.
long long odil_mg_dp_floats(int T, int X, int Y, int slab) {
  const long long windows = (long long)odil_mg_num_blocks(T, X, Y, slab) * dp_slots(slab) * DWIN;
#if ODIL_MG_ABLATION == 2
  const long long dense = (long long)((T + slab - 1) / slab) * dp_slots(slab) * NF * (X / 2) * (Y / 2);
  return dense > windows ? dense : windows;
#else
  return windows;
#endif
}

// The walk's tile: its rows (axis 0) or its columns (axis 1), the tile the
// plain dP route (rowwise_mg._dp_partials) maps the blocks' windows with.
int odil_mg_tile(int axis) { return axis == 0 ? TILE_X : TILE_Y; }

// The blocks of the backward+sums row walk (MgArgs; the other forms take
// the same resources within a register or two) that the card holds at once:
// the waves the Python side sizes the slabs for.
int odil_mg_resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  const size_t smem = walk_smem<MODE_SUMS | MODE_GRADS, false, MgArgs>();
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mg_rows_kernel<MODE_SUMS | MODE_GRADS, false, MgArgs>,
                                                    NTHREADS, smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

const char* odil_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Loss-only pass (_forward_mg): per-term sums of squares into A->sums.
int odil_mg_forward(const MgArgs* a, void* stream) {
  return mg_launch<MODE_SUMS, false>(*a, (cudaStream_t)stream);
}

// Gradient pass (_backward_mg): dt0 and dP, plus the sums when with_sums.
int odil_mg_backward(const MgArgs* a, int with_sums, void* stream) {
  return mg_backward<false>(*a, with_sums, (cudaStream_t)stream);
}

// Two-level gradient pass (_backward_mg with lvl2): dt0 and dP1 (in dP), plus
// the sums when with_sums, then dP2 from dP1 by the same transposed
// prolongation one level down.
int odil_mg_backward2(const Mg2Args* a, int with_sums, void* stream) {
#if ODIL_MG_ABLATION
  return (int)cudaErrorNotSupported;
#else
  const Mg2Args A = *a;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = mg_backward<true>(A, with_sums, s);
  if (err != (int)cudaSuccess) return err;
  MgArgs B = A;
  for (int f = 0; f < NF; ++f) {
    B.dt0[f] = A.dP[f];
    B.dP[f] = A.dP2[f];
  }
  B.T = A.Tc, B.X = A.CX, B.Y = A.CY, B.Tc = A.Tc2, B.CX = A.CX2, B.CY = A.CY2;
  const dim3 cgrid((B.CY + CT - 1) / CT, (B.CX + CT - 1) / CT, B.Tc * NF);
  mg_coarse_grad_kernel<<<cgrid, dim3(CT, CT), 0, s>>>(B);
  return (int)cudaGetLastError();
#endif
}

// The local-block gradient pass (_backward_mg with wraps_in/emit_dwraps, with
// the sums; the only form its caller asks for): dt0, dP over the window,
// dheads and the sums.  A->slab slabs the Tl + 1 rows of the stack.
int odil_mg_backward_local(const MgLocalArgs* a, int with_sums, void* stream) {
  if (!with_sums) return (int)cudaErrorInvalidValue;
#if ODIL_MG_ABLATION
  return (int)cudaErrorNotSupported;
#else
  return mg_launch<MODE_SUMS | MODE_GRADS, false>(*a, (cudaStream_t)stream);
#endif
}

}  // extern "C"
