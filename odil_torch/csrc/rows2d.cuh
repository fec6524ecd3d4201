// The generic row-wise kernels over 2-D planes (T, X, Y), for any row model
// with the interface below: the row models that odil_torch/ops/rowtrace.py
// generates from a user's row function.  Included by the generated units,
// which export the launchers (odil_rows2d_*).
//
// What they compute.  NF fields on a (T, X, Y) grid, any T >= 2 and X, Y >=
// 1, periodic in t, x and y.  Residual row t reads rows t, t-1, ..., t-HIST
// of the fields at the 3 x 3 cells around its cell, data rows at t, const
// planes and the params.  The forward pass gives the per-term sums of
// squares S[k] over all T rows; the backward pass gives d(sum_k g[k] S[k]) /
// d(fields, params) and, with the sums on, S.  Field row i collects the
// cotangents of residual rows i, i+1, ..., i+HIST (mod T), as the TPU
// kernels' `(i + o) % T` does.
//
// Replaces, for a user's row function on 2-D planes, the TPU's whole-plane
// pair (_forward, _backward: odil_tpu/ops/rowwise.py:132, :185), its blocked
// pair (:322, :396), its streaming pair (:616, :690) and the x-tiled pair of
// odil_tpu/ops/rowwise_tiled.py (_forward_tiled :187, _backward_tiled :283),
// and with the halo layer the x-tiled pair with xpad on a shard's block.  A
// Hopper block never holds a whole plane, so one tiled design serves every
// plane size, every block size and the streaming pair (the slabbed launch,
// as in rowwise.cu).
//
// Design (rowwise.cu's rows_kernel, the model a template parameter):
//   * A block of 8 x 32 threads owns a TILE_X x TILE_Y = 16 x 32 tile (two
//     cells a thread, rows r and r + 8) of a slab of `slab` rows.  It walks
//     the residual rows of its slab (and, with the gradients, the HIST rows
//     past it) through a ring of HIST + 4 fine rows in dynamic shared memory
//     (halo 2 around the tile, periodic through full-modulo index tables):
//     rows t-HIST .. t of residual row t and three rows in flight, copied by
//     cp.async AHEAD = 3 rows before the row that first reads them, one
//     commit group a row: 16-byte copies for the 32 owned columns of a tile
//     row (at plane column 4, aligned) and 4-byte copies for the halo, the
//     wrap and ragged planes.
//   * With the gradients each residual row is evaluated once at every cell
//     of the tile and of the ring of one cell around it (18 x 34; two cells
//     a thread, and the 100 ring cells by the first 100 threads).  A cell's
//     cotangents of its samples at a nonzero offset (the entries that the
//     model's DUSED marks there) go to shared memory, one plane of 18 x 34
//     a used entry; those at its own cell stay in the registers of the
//     thread that owns the cell.  After a barrier each owned cell gathers
//     its cotangents from the 3 x 3 cells around it: no atomics.  A thread
//     keeps the sums of its cells' field rows t-HIST .. t in registers; row
//     t-HIST is complete after residual row t and is written.
//   * Slabs: whole waves of the resident blocks (ops/rowwise.py::_wave_slab).
//   * Sums and param cotangents (owned cells only, in registers): fp64 block
//     sums (warp shuffles, then the warps in order) into the block's column
//     of A.partials; the last block to finish reduces the columns in block
//     order -- one launch, the same bits run to run.
//
// The halo layer (rows2d_kernel<M, MODE, true>, Rows2DHaloArgs; the masked
// per-shard pair, odil_rows2d_halo_*): a per-shard launch runs on one
// shard's halo-extended block, its own periodic (T, X, Y) grid.  The model
// sees GLOBAL rows (block row + off) and the global row count (model_T),
// reads the data at the block's rows, and every residual is multiplied by
// the 0/1 plane mask at its cell and by the row mask of its row (r_lo <= row
// < r_hi), so its adjoint sees masked weights, as the wrapped row function
// of odil_tpu/halo.py:873-885 does.  The grid is a ceiling division over
// the tiles with every cell guarded, so it runs on the unpadded extent and
// the mask does what the TPU's edge padding (xpad) does.
//
// Bound: by bytes at the row functions of this repository (the veltracer's
// at 40 fp32 operations a cell forward and 100 backward against 12 bytes
// read and 12 written): each field row is read once per slab (the HIST rows
// past a slab's edges again) and each cotangent row written once.
//
// Row model interface (struct M):
//   static constexpr int NF, HIST, MAXT, NP;  // fields, rows back, terms, params
//   static constexpr int BLOCKS_PER_SM;       // the blocks an SM should hold (__launch_bounds__)
//   __host__ __device__ static constexpr bool used(int e);  // whether eval writes D entry e =
//                                                          // ((m * NF + f) * 3 + qx) * 3 + qy
//   static bool takes(const Rows2DArgs&);     // whether a launch's arguments are this build's
//   template <bool GRADS, class Args> __device__ static void eval(
//       const Args& A, const float* P, int it, int x, int y, const float (&v)[HIST + 1][NF][3][3],
//       const float* g2, float* res, float (&D)[HIST + 1][NF][3][3], float* pacc, bool own);
// eval writes the terms of residual row `it` at cell (x, y) into
// res[0..MAXT) from its samples v[m][f][qx][qy] (field f, row it-m, cell
// (x+qx-1, y+qy-1)); with GRADS, D gets the cotangents of sum_k g2[k]/2
// res[k]^2 with respect to v (the used entries) and, where `own`, pacc the
// param cotangents.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "rows1d.cuh"  // rows1d::warp_sums16 and the cp.async copies (cp_async.cuh)

namespace rows2d {

constexpr int MAXF = 3, MAXD = 2, MAXC = 6, MAXP = 8;

// Mirrored by odil_torch/ops/rowwise.py::_Rows2DArgs (ctypes); the Python side
// checks sizeof through odil_rows2d_args_size().
struct Rows2DArgs {
  const float* f[MAXF];       // the fields (T, X, Y)
  const float* data[MAXD];    // (T, X, Y) or (T, 1, 1), read at row it
  const float* consts[MAXC];  // planes (X, Y) or scalars of one element
  const float* params[MAXP];  // the params in order (flat in shared memory)
  const float* g;             // (nterms,) loss weights, on the device
  float* df[MAXF];
  float* dparams;             // (nparams,)
  double* partials;           // (stride, blocks): the block sums of the terms, then of the param cotangents
  float* sums;                // (nterms,)
  unsigned* ticket;           // 0 between launches: the blocks that have written their partials
  int data_stride[MAXD];      // X * Y or 1
  int param_size[MAXP];       // elements of each param
  int T, X, Y, slab, nterms, nparams, stride;
};

// The masked per-shard launch: Rows2DArgs over the shard's halo-extended
// block (T its rows) plus the halo layer.  Mirrored by
// odil_torch/ops/rowwise.py::_Rows2DHaloArgs (checked through
// odil_rows2d_halo_args_size()).
struct Rows2DHaloArgs : Rows2DArgs {
  const float* mask;  // (X, Y) 0/1 plane mask: zero on halo columns
  int off;            // the global row of block row 0
  int Tg;             // the global row count
  int r_lo, r_hi;     // the block's own rows: r_lo <= row < r_hi
};

template <bool MASKED>
using ArgsOf = typename std::conditional<MASKED, Rows2DHaloArgs, Rows2DArgs>::type;

constexpr int TILE_X = 16, TILE_Y = 32, THREAD_ROWS = 8, CELLS = TILE_X / THREAD_ROWS;
constexpr int NTHREADS = THREAD_ROWS * TILE_Y, NWARPS = NTHREADS / 32;
constexpr int HALO = 2;                       // the window's cells around the tile
constexpr int YOFF = 4;                       // plane column of the tile's first column (16-byte aligned)
constexpr int HX = TILE_X + 2 * HALO, HY = TILE_Y + 2 * YOFF;
constexpr int HYS = TILE_Y + 2 * HALO;        // staged columns of a window row
constexpr int RX = TILE_X + 2, RY = TILE_Y + 2;  // the tile and its ring of one cell
constexpr int NRING = RX * RY - TILE_X * TILE_Y;
constexpr int AHEAD = 3;                      // rows in flight
constexpr int VEC = TILE_Y / 4, VEC_COPIES = VEC + 2 * HALO;  // copies of a window row in the aligned form
constexpr int SMEM_LIMIT = 232448;            // the shared memory a block may take
static_assert(HX * VEC_COPIES <= NTHREADS, "rows2d.cuh: one aligned copy a thread");
static_assert(NRING <= NTHREADS, "rows2d.cuh: one ring cell a thread");
static_assert(YOFF % 4 == 0 && HY % 4 == 0 && YOFF >= HALO, "rows2d.cuh: staged rows must be 16-byte aligned");

enum { MODE_SUMS = 1, MODE_GRADS = 2, MODE_MASKED = 4 };

// Any v wrapped into [0, n): the window of a tile reaches TILE + HALO cells
// past its origin, so past 2n on planes narrower than a tile.
__host__ __device__ __forceinline__ int pmod(int v, int n) { return ((v % n) + n) % n; }

// The row count a model sees: the grid's, or the global one on a shard's block.
__host__ __device__ __forceinline__ int model_T(const Rows2DArgs& A) { return A.T; }
__host__ __device__ __forceinline__ int model_T(const Rows2DHaloArgs& A) { return A.Tg; }

// Data d at row it and cell (x, y): (T, X, Y) data, or (T, 1, 1) data read
// at every cell.
__device__ __forceinline__ float data_at(const Rows2DArgs& A, int d, int it, int x, int y) {
  const int st = A.data_stride[d];
  return __ldg(A.data[d] + (size_t)it * st + (st == 1 ? 0 : (size_t)x * A.Y + y));
}

// The same on a shard's block, `it` being the global row.
__device__ __forceinline__ float data_at(const Rows2DHaloArgs& A, int d, int it, int x, int y) {
  return data_at(static_cast<const Rows2DArgs&>(A), d, it - A.off, x, y);
}

// The D entries that a model stages in shared memory (used at a nonzero
// offset; entry e is at offset (0, 0) where e % 9 == 4), and an entry's
// plane among them.
template <class M>
__host__ __device__ constexpr bool staged(int e) {
  return M::used(e) && e % 9 != 4;
}
template <class M>
__host__ __device__ constexpr int staged_slot(int e) {
  int n = 0;
  for (int i = 0; i < e; ++i) n += staged<M>(i) ? 1 : 0;
  return n;
}
template <class M>
__host__ __device__ constexpr int nstaged() {
  return staged_slot<M>((M::HIST + 1) * M::NF * 9);
}

// f(std::integral_constant<int, I>) for I = B .. N-1: the D entries' loops,
// so that each entry's use and staged plane are compile-time constants.
template <int B, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < N) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, N>(f);
  }
}

// The shared memory of a block (dynamic: it exceeds 48 KB).  Mirrored by
// odil_torch/ops/rowtrace.py::rows2d_smem.
template <class M, bool GRADS>
struct Smem {
  static constexpr int NSLOT = M::HIST + AHEAD + 1;  // rows t-HIST .. t and the rows in flight
  static constexpr int NS = nstaged<M>() > 0 ? nstaged<M>() : 1;
  static constexpr int NRED = M::MAXT + (M::NP > 0 ? M::NP : 1);
  static constexpr int NRED16 = (NRED + 15) / 16 * 16;
  float F[NSLOT][M::NF][HX][HY];  // fine row q in slot (q - ts + HIST) % NSLOT
  float D[GRADS ? NS : 1][GRADS ? RX : 1][GRADS ? RY : 1];  // the staged cotangents of one residual row
  float P[M::NP > 0 ? M::NP : 1];
  double red[NWARPS][NRED16];
  int xi[HX], yi[HYS];  // the plane row and column of window row and column k (tile origin - HALO + k)
};

template <class M, int MODE>
constexpr size_t smem_bytes() {
  return sizeof(Smem<M, (MODE & MODE_GRADS) != 0>);
}

// The sums of the terms and the param cotangents of a launch (internal
// index k: the terms, then the params; column c of A.partials: the live
// terms, then the params), as rows1d.cuh reduces them: fp64 block sums
// (warp shuffles, then the warps in order) into the block's column of
// A.partials; the last block to finish reduces the columns in block order.
// s, pacc: this thread's terms and param cotangents (owned cells); red: the
// block's warp sums (shared memory).  Every thread of the block calls it.
template <class M, int NRED16>
__device__ __forceinline__ void reduce_terms(const Rows2DArgs& A, const float* s, const float* pacc,
                                             double (*red)[NRED16], bool sums, bool infer, int tid) {
  constexpr int NT = M::MAXT, NRED = M::MAXT + (M::NP > 0 ? M::NP : 1);
  __shared__ bool last;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = sums ? 0 : A.nterms, c1 = infer ? A.stride : A.nterms;
  if (c0 >= c1) return;
  const unsigned nblocks = gridDim.x * gridDim.y * gridDim.z;
  const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  auto col = [&](int k) { return k < NT ? (k < A.nterms ? k : -1) : (k - NT < A.nparams ? A.nterms + k - NT : -1); };
  auto live = [&](int k) { return k < NRED && col(k) >= c0 && col(k) < c1; };
#pragma unroll
  for (int base = 0; base < NRED16; base += 16) {
    double v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // (the index guards keep unrolled dead branches in range)
      const int k = base + j;
      v[j] = k < NT ? (double)s[k < NT ? k : 0] : (k < NRED ? (double)pacc[k < NRED ? k - NT : 0] : 0.0);
    }
    rows1d::warp_sums16(v, lane, red[warp] + base);
  }
  __syncthreads();
  if (tid < NRED && live(tid)) {
    double a = red[0][tid];
    for (int w = 1; w < NWARPS; ++w) a += red[w][tid];
    A.partials[(size_t)col(tid) * nblocks + blk] = a;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(A.ticket, 1u) == nblocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int base = 0; base < NRED16; base += 16) {
    double v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = 0.0;
    for (unsigned b = tid; b < nblocks; b += NTHREADS) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (live(base + j)) v[j] += __ldcg(A.partials + (size_t)col(base + j) * nblocks + b);
      }
    }
    rows1d::warp_sums16(v, lane, red[warp] + base);
  }
  __syncthreads();
  if (tid < NRED && live(tid)) {
    double a = red[0][tid];
    for (int w = 1; w < NWARPS; ++w) a += red[w][tid];
    const int c = col(tid);
    if (c < A.nterms) A.sums[c] = (float)a;
    else A.dparams[c - A.nterms] = (float)a;
  }
  if (tid == 0) *A.ticket = 0u;
}

template <class M, int MODE, bool MASKED = false>
__global__ void __launch_bounds__(NTHREADS, M::BLOCKS_PER_SM) rows2d_kernel(const ArgsOf<MASKED> A) {
  constexpr int H = M::HIST, NF = M::NF, NT = M::MAXT;
  constexpr int NP = M::NP > 0 ? M::NP : 1;
  constexpr bool grads = (MODE & MODE_GRADS) != 0;
  constexpr bool sums = (MODE & MODE_SUMS) != 0;
  using S = Smem<M, grads>;
  constexpr int NSLOT = S::NSLOT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int T = A.T, X = A.X, Y = A.Y;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;
  const int ts = blockIdx.z * A.slab, te = min(ts + A.slab, T);
  const int re = te + (grads ? H : 0);  // the residual rows of the walk: ts .. re-1
  const bool infer = grads && M::NP > 0 && A.nparams > 0;

  for (int p = 0, off = 0; off < A.nparams; off += A.param_size[p++]) {
    for (int k = tid; k < A.param_size[p]; k += NTHREADS) sm.P[off + k] = __ldg(A.params[p] + k);
  }
  for (int k = tid; k < HX + HYS; k += NTHREADS) {
    if (k < HX) sm.xi[k] = pmod(x0 - HALO + k, X);
    else sm.yi[k - HX] = pmod(y0 - HALO + k - HX, Y);
  }
  __syncthreads();

  // How this thread stages a window row of a plane.  Aligned form: the owned
  // columns of each window row in 16-byte copies (8 a row) and its 4 halo
  // columns in 4-byte ones, one copy a thread, fixed for the block (its
  // offset in the plane row, its target in a window and its size; 0: none).
  // Else every cell in 4-byte copies through the index tables: planes
  // narrower than a tile, a Y that is not a multiple of 4, the last y tile of
  // a ragged plane, fields that are not 16-byte aligned.
  bool vec = y0 + TILE_Y <= Y && Y % 4 == 0;
#pragma unroll
  for (int f = 0; f < NF; ++f) vec = vec && (reinterpret_cast<size_t>(A.f[f]) & 15) == 0;
  int csrc = 0, cdst = 0, cbytes = 0;
  if (vec && tid < HX * VEC_COPIES) {
    const int hx = tid / VEC_COPIES, c = tid % VEC_COPIES;
    const int row = sm.xi[hx] * Y;
    if (c < VEC) {
      csrc = row + y0 + 4 * c;
      cdst = hx * HY + YOFF + 4 * c;
      cbytes = 16;
    } else {
      const int hy = c - VEC < HALO ? c - VEC : c - VEC + TILE_Y;
      csrc = row + sm.yi[hy];
      cdst = hx * HY + YOFF - HALO + hy;
      cbytes = 4;
    }
  }
  auto slot = [&](int q) { return (q - ts + H) % NSLOT; };
  // Starts the copies of fine row q (periodic in t) into its slot and
  // commits them as one group; a row past the walk commits none, so that
  // every iteration waits for the same count.
  auto issue = [&](int q, bool live) {
    if (live) {
      const size_t base = (size_t)pmod(q, T) * X * Y;
      float* dst = &sm.F[slot(q)][0][0][0];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float* src = A.f[f] + base;
        float* d = dst + f * HX * HY;
        if (vec) {
          if (cbytes == 16) copy16_async(d + cdst, src + csrc);
          else if (cbytes == 4) copy4_async(d + cdst, src + csrc);
        } else {
          for (int k = tid; k < HX * HYS; k += NTHREADS) {
            const int hx = k / HYS, hy = k % HYS;
            copy4_async(d + hx * HY + YOFF - HALO + hy, src + (size_t)sm.xi[hx] * Y + sm.yi[hy]);
          }
        }
      }
    }
    commit_copies();
  };

  // The fine rows ts-HIST .. ts+AHEAD-1, a group each.
#pragma unroll
  for (int q = 0; q < H + AHEAD; ++q) issue(ts - H + q, ts - H + q < re);
  float g2[NT], s[NT], pacc[NP];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    g2[k] = (grads && k < A.nterms) ? 2.0f * __ldg(A.g + k) : 0.0f;
    s[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) pacc[k] = 0.0f;
  // acc[j][c][f]: this thread's cotangent of field f at cell c of field row
  // t - j, so far.
  float acc[H + 1][CELLS][NF];
#pragma unroll
  for (int j = 0; j <= H; ++j)
#pragma unroll
    for (int c = 0; c < CELLS; ++c)
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[j][c][f] = 0.0f;

  for (int t = ts; t < re; ++t) {
    // Row t has landed (this thread's copies; AHEAD - 1 groups stay in
    // flight); the barrier publishes it to the block and frees the slot of
    // row t - HIST - 1, which the last iteration read last.
    wait_groups<AHEAD - 1>();
    __syncthreads();
    issue(t + AHEAD, t + AHEAD < re);
    const int lt = t < T ? t : t - T;  // the block's row of residual row t
    int it = lt;
    float rm = 1.0f;
    if constexpr (MASKED) {
      it = lt + A.off;
      rm = lt >= A.r_lo && lt < A.r_hi ? 1.0f : 0.0f;
    }
    const bool own_row = t < te;

    // Residual row t at tile cell (ti, tj) (-1 .. TILE): its terms into the
    // sums where `own`, its staged cotangents into D, those at its own cell
    // into dc.
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
            for (int qy = 0; qy < 3; ++qy) v[m][f][qx][qy] = sm.F[sl][f][ti + HALO + qx - 1][tj + YOFF + qy - 1];
      }
      const int xw = sm.xi[ti + HALO], yw = sm.yi[tj + HALO];
      float res[NT], Dl[H + 1][NF][3][3];
      if constexpr (MASKED) {
        // The cell's mask scales the loss weights (so the cotangents) and,
        // after the model, the terms.
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
        static_for<0, (H + 1) * NF * 9>([&](auto E) {
          constexpr int e = decltype(E)::value, m = e / (NF * 9), f = e / 9 % NF, q = e % 9;
          if constexpr (M::used(e)) {
            if constexpr (q == 4) {
              dc[m][f] = Dl[m][f][1][1];
            } else {
              constexpr int plane = staged_slot<M>(e);
              sm.D[plane][ti + 1][tj + 1] = Dl[m][f][q / 3][q % 3];
            }
          }
        });
      }
    };

    float dc[CELLS][H + 1][NF];
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int ti = threadIdx.y + c * THREAD_ROWS, tj = threadIdx.x;
      cell(ti, tj, own_row && x0 + ti < X && y0 + tj < Y, dc[c]);
    }
    if constexpr (grads) {
      // The ring of one cell around the tile: its top and bottom rows, then
      // its left and right columns.
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
      __syncthreads();
      // Each owned cell gathers residual row t's cotangents of its field rows
      // t - j (entry m = j) from the 3 x 3 cells around it.
#pragma unroll
      for (int c = 0; c < CELLS; ++c) {
        const int ti = threadIdx.y + c * THREAD_ROWS, tj = threadIdx.x;
        static_for<0, (H + 1) * NF * 9>([&](auto E) {
          constexpr int e = decltype(E)::value, j = e / (NF * 9), f = e / 9 % NF, q = e % 9;
          if constexpr (M::used(e)) {
            if constexpr (q == 4) {
              acc[j][c][f] += dc[c][j][f];
            } else {
              constexpr int plane = staged_slot<M>(e);
              acc[j][c][f] += sm.D[plane][ti + 2 - q / 3][tj + 2 - q % 3];
            }
          }
        });
        // Field row t - HIST is complete.
        const int w = t - H, x = x0 + ti, y = y0 + tj;
        if (w >= ts && x < X && y < Y) {
#pragma unroll
          for (int f = 0; f < NF; ++f) A.df[f][((size_t)w * X + x) * Y + y] = acc[H][c][f];
        }
#pragma unroll
        for (int j = H; j > 0; --j)
#pragma unroll
          for (int f = 0; f < NF; ++f) acc[j][c][f] = acc[j - 1][c][f];
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[0][c][f] = 0.0f;
      }
    }
  }

  reduce_terms<M, S::NRED16>(A, s, pacc, sm.red, sums, infer, tid);
}

template <class M, int MODE, bool MASKED>
int launch(const ArgsOf<MASKED>& A, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<M, MODE>();
  static_assert(bytes <= SMEM_LIMIT, "rows2d.cuh: the block's shared memory exceeds what a block may take");
  static const cudaError_t attr =
      cudaFuncSetAttribute(rows2d_kernel<M, MODE, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  if (A.T < 2 || A.X < 1 || A.Y < 1 || A.slab < 1 || !M::takes(A)) return (int)cudaErrorInvalidValue;
  const dim3 grid((A.Y + TILE_Y - 1) / TILE_Y, (A.X + TILE_X - 1) / TILE_X, (A.T + A.slab - 1) / A.slab);
  rows2d_kernel<M, MODE, MASKED><<<grid, dim3(TILE_Y, THREAD_ROWS), bytes, s>>>(A);
  return (int)cudaGetLastError();
}

// The blocks of a launch (MODE) that the card holds at once: the waves the
// Python side sizes the slabs for.
template <class M, int MODE, bool MASKED>
int resident_blocks() {
  constexpr size_t bytes = smem_bytes<M, MODE>();
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(rows2d_kernel<M, MODE, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows2d_kernel<M, MODE, MASKED>, NTHREADS, bytes) !=
      cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <class M, bool MASKED>
int forward(const ArgsOf<MASKED>& A, cudaStream_t s) {
  return launch<M, MODE_SUMS, MASKED>(A, s);
}

template <class M, bool MASKED>
int backward(const ArgsOf<MASKED>& A, int with_sums, cudaStream_t s) {
  return with_sums ? launch<M, MODE_SUMS | MODE_GRADS, MASKED>(A, s) : launch<M, MODE_GRADS, MASKED>(A, s);
}

// The blocks a launch holds at once; mode: 1 the sums, 2 the gradients, 3
// both, plus MODE_MASKED for the masked per-shard form.
template <class M>
int resident(int mode) {
  switch (mode) {
    case MODE_SUMS: return resident_blocks<M, MODE_SUMS, false>();
    case MODE_GRADS: return resident_blocks<M, MODE_GRADS, false>();
    case MODE_SUMS | MODE_GRADS: return resident_blocks<M, MODE_SUMS | MODE_GRADS, false>();
    case MODE_MASKED | MODE_SUMS: return resident_blocks<M, MODE_SUMS, true>();
    case MODE_MASKED | MODE_GRADS: return resident_blocks<M, MODE_GRADS, true>();
    case MODE_MASKED | MODE_SUMS | MODE_GRADS: return resident_blocks<M, MODE_SUMS | MODE_GRADS, true>();
    default: return 0;
  }
}

// The tile's rows (0), columns (1) and threads (2), and the dynamic shared
// memory of a forward (3) and a backward (4) block.
template <class M>
int tile_info(int what) {
  switch (what) {
    case 0: return TILE_X;
    case 1: return TILE_Y;
    case 2: return NTHREADS;
    case 3: return (int)smem_bytes<M, MODE_SUMS>();
    case 4: return (int)smem_bytes<M, MODE_SUMS | MODE_GRADS>();
    default: return 0;
  }
}

}  // namespace rows2d
