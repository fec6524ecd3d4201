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
// Replaces, for 1-D planes, the TPU's blocked pair (_forward_blocked,
// _backward_blocked: odil_tpu/ops/rowwise.py:322, :396) and its streaming
// pair (_forward_stream, _backward_stream: :616, :690).  The TPU walks its
// rows on a sequential grid: the blocked pair B rows a program, the
// streaming pair every row once with a ring of HIST rows carried from one
// program to the next, so that VMEM holds a few rows of a plane.  On Hopper
// a block's shared memory does not grow with the rows it covers and no
// order runs between blocks, so both pairs become one launch of tiles over
// (t, x); the streaming launch reads each field row once per tile row band
// (the HIST rows past a band's edges are read again, HIST/slab of the bytes
// on each side), the price of a grid that fills the card.
//
// Design.  A block owns a tile of `slab` rows by TILE cells at a time and
// takes the tiles b, b + gridDim.x, ... (the Python side sizes slab and
// grid to whole waves of the resident blocks, ops/rowwise.py::_tile_rows).
// A tile runs in four phases and three barriers, nothing carried from one
// tile to the next but the sums:
//   1. its window of field rows (the rows t0-HIST .. te-1+HIST, the tile and
//      two cells on each side, periodic) is staged into shared memory with
//      cp.async (16-byte chunks where the row is aligned, the whole window
//      so where it lies inside the row, 4-byte copies at the wrap) while the
//      block works on the tile before (two buffers), and waited for;
//   2. (row models with faces: heat) at every face of every residual row of
//      the window, the face's temperature and conductivity once, and the
//      net's activations for the adjoint;
//   3. every residual cell of the window (the tile plus one cell on each
//      side, HIST rows past its end with the gradients) in parallel: the
//      terms, and the cotangents D[m][f][q] of the weighted terms with
//      respect to the samples (field f, row it-m, cell x+q-1) and of the
//      face conductivities into shared memory;
//   4. each owned cell gathers its cotangent from the D of the residual
//      rows t..t+HIST at x-1..x+1 (no atomics), and each face adds the two
//      cells' conductivity cotangents (left, then right) into one param
//      adjoint.
// The params live in shared memory; each thread sums its cells' terms and
// param cotangents in registers across its tiles.  At the end each block
// reduces them in fp64 (warp shuffles, then the warps in order) into its
// column of A.partials, and the last block to finish (an integer ticket)
// reduces the columns in block order into A.sums and A.dparams and resets
// the ticket: one launch, and the bits repeat run to run.
//
// The halo layer (rows1d_kernel<M, MODE, true>, Rows1DHaloArgs; the masked
// per-shard pair, odil_rows1d_halo_*): a per-shard launch (odil_torch/halo.py)
// runs on one shard's halo-extended block of the grid, its own periodic
// (T, N) grid.  It replaces, for 1-D planes, the TPU's blocked pair run on
// the row function that odil_tpu/halo.py:873-885 wraps with the shard's
// masks (halo.py:924-936 -> odil_tpu/ops/rowwise.py:994-1048).  The row
// model sees GLOBAL row indices (block row + off) for its row conditions
// and reads the data at the block's own rows (data_at takes the global row
// back); every residual is multiplied by the 0/1 plane mask at its cell and
// by the row mask of its residual row (zero on halo rows and on a ghost node
// the left shard owns: r_lo <= row < r_hi), so the adjoint sees masked
// weights, as the wrapped row function's vjp does.  The rows a block reads
// past its ends wrap inside the block: only masked rows read them, and
// their cotangents are zero.  Without the layer (MASKED false) the kernel
// is the code it was.
//
// Row model interface (struct M):
//   static constexpr int NF, HIST, MAXT, NP;  // fields, rows back, terms, params
//   static constexpr unsigned DUSED;          // the D entries (m * NF + f) * 3 + q it writes
//   static constexpr int BLOCKS_PER_SM;       // the blocks an SM should hold (__launch_bounds__)
//   static constexpr bool FACES;              // a face phase (heat) or none (wave)
//   struct Face;                              // what the face phase leaves
//   template <bool ADJ> __device__ static void face(
//       const Rows1DArgs& A, const float* P, int it, int xa, const float (&va)[HIST + 1][NF][3],
//       int xb, const float (&vb)[HIST + 1][NF][3], bool lview, bool rview, Face& F);
//   template <bool GRADS, class Args> __device__ static void eval(
//       const Args& A, const float* P, int it, int x, const float (&v)[HIST + 1][NF][3],
//       const Face& fl, const Face& fr, const float* g2, float* res, float (&D)[HIST + 1][NF][3],
//       float (&gk)[2]);
//   __device__ static void face_vjp(const Rows1DArgs& A, const float* P, const Face& F, bool shared,
//                                   float gl, float gr, float* pacc);
// face: the face between cells xa and xb = xa + 1 (mod N) of residual row
// it, from their samples; lview/rview: whether the left/right cell is in the
// window.  eval (Args: Rows1DArgs, or Rows1DHaloArgs on a shard's block,
// whose data_at reads the data at the block's row of the global row it)
// writes the terms of residual row `it` at cell x into
// res[0..nterms), reading its faces' conductivities from fl and fr; with
// GRADS, D gets the cotangents of sum_k g2[k]/2 res[k]^2 with respect to v
// and gk those of its left and right face conductivities.  face_vjp adds the
// param cotangents of a face, gl and gr being the gk of the cells on its
// left and right; `shared` says both cells saw the same face temperature.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "cp_async.cuh"

namespace rows1d {

constexpr int MAXF = 2, MAXD = 2, MAXC = 6, MAXP = 6, NSCALARS = 8;

// Mirrored by odil_torch/ops/rowwise.py::_Rows1DArgs (ctypes); the Python side
// checks sizeof through odil_rows1d_args_size().
struct Rows1DArgs {
  const float* f[MAXF];       // the fields (T, N)
  const float* data[MAXD];    // (T, N) or (T, 1), read at row it
  const float* consts[MAXC];  // planes (N) or scalars (1, 1)
  const float* params[MAXP];  // the params in order (flat in shared memory)
  const float* g;             // (nterms,) loss weights, on the device
  float* df[MAXF];
  float* dparams;             // (nparams,)
  double* partials;           // (stride, blocks): the block sums of the terms, then of the param cotangents
  float* sums;                // (nterms,)
  unsigned* ticket;           // 0 between launches: the blocks that have written their partials
  int data_stride[MAXD];      // N or 1
  int param_size[MAXP];       // elements of each param
  int T, N, slab, blocks, nterms, nparams, stride, flags;
  float s[NSCALARS];          // the row model's scalars
};

// The masked per-shard launch: Rows1DArgs over the shard's halo-extended
// block (T its rows) plus the halo layer.  Mirrored by
// odil_torch/ops/rowwise.py::_Rows1DHaloArgs (checked through
// odil_rows1d_halo_args_size()).
struct Rows1DHaloArgs : Rows1DArgs {
  const float* mask;  // (N) 0/1 plane mask: zero on halo columns
  int off;            // the global row of block row 0
  int r_lo, r_hi;     // the block's own rows: r_lo <= row < r_hi
};

template <bool MASKED>
using ArgsOf = typename std::conditional<MASKED, Rows1DHaloArgs, Rows1DArgs>::type;

constexpr int TILE = 32;       // cells of a tile
constexpr int MAX_SLAB = 30;   // rows of a tile, at most
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int FPAD = 4;             // column c of a staged field row holds cell x0 - FPAD + c
constexpr int FCOLS = TILE + 2 * FPAD;
constexpr int RW = TILE + 2;        // residual cells of a window row: the tile and one on each side
constexpr int NFACE = TILE + 3;     // faces of a window row: face j lies between residual cells j-1 and j

enum { MODE_SUMS = 1, MODE_GRADS = 2 };

__device__ __forceinline__ int pmod(int v, int n) { return ((v % n) + n) % n; }

// Data d at row it and cell x: (T, N) data, or (T, 1) data read at every x.
__device__ __forceinline__ float data_at(const Rows1DArgs& A, int d, int it, int x) {
  const int st = A.data_stride[d];
  return __ldg(A.data[d] + (size_t)it * st + (st == 1 ? 0 : x));
}

// The same on a shard's block, `it` being the global row.
__device__ __forceinline__ float data_at(const Rows1DHaloArgs& A, int d, int it, int x) {
  return data_at(static_cast<const Rows1DArgs&>(A), d, it - A.off, x);
}

// a[k] for a runtime k, through compile-time indices (keeps a in registers).
template <int N>
__device__ __forceinline__ float pick(const float* a, int k) {
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) v = j == k ? a[j] : v;
  return v;
}

// One round of warp_sums16: lanes with bit `2 N` set keep the upper half of
// their 2 N values, the others the lower half, each adding its partner's.
template <int N>
__device__ __forceinline__ void halve(double (&v)[16], int lane) {
  const bool up = (lane & (2 * N)) != 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double send = up ? v[j] : v[j + N], keep = up ? v[j + N] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * N);
  }
}

// The sums over a warp's lanes of their 16 values v, in fp64, into out[0..16)
// (shared memory): four halving rounds and one exchange, 16 shuffles where
// one sum at a time takes 80.
__device__ __forceinline__ void warp_sums16(double (&v)[16], int lane, double* out) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  if ((lane & 1) == 0) {
    out[((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1)] = v[0];
  }
}

// The position of the D entry e = (m * NF + f) * 3 + q among the entries a
// row model uses (the set bits of its DUSED mask).
__host__ __device__ constexpr int d_slot(unsigned used, int e) {
  int n = 0;
  for (int i = 0; i < e; ++i) n += (used >> i) & 1u;
  return n;
}

// The shared memory of a block (dynamic: it exceeds 48 KB with the faces).
template <class M, bool GRADS>
struct TileSmem {
  static constexpr int H = M::HIST, NF = M::NF;
  static constexpr int RROWS = MAX_SLAB + (GRADS ? H : 0);  // residual rows of a window
  static constexpr int FROWS = RROWS + H;                   // field rows of a window
  static constexpr int ND = d_slot(M::DUSED, (H + 1) * NF * 3);  // the D entries the model uses
  static constexpr int NRED = M::MAXT + (M::NP > 0 ? M::NP : 1);
  static constexpr int NRED16 = (NRED + 15) / 16 * 16;
  float F[2][FROWS][NF][FCOLS];  // by tile parity; field row q of a window: global row t0 - H + q
  float D[GRADS ? RROWS : 1][GRADS ? ND : 1][RW];
  typename M::Face face[M::FACES ? RROWS : 1][M::FACES ? NFACE : 1];
  float gk[M::FACES && GRADS ? RROWS : 1][RW][2];  // the cells' face-conductivity cotangents (left, right)
  float P[M::NP > 0 ? M::NP : 1];
  int xi[2][TILE + 4];  // by tile parity: the global cell of window cell x0 - 2 + k
  double red[NWARPS][NRED16];
};

template <class M, int MODE>
constexpr size_t smem_bytes() {
  return sizeof(TileSmem<M, (MODE & MODE_GRADS) != 0>);
}

template <class M, int MODE, bool MASKED = false>
__global__ void __launch_bounds__(NTHREADS, M::BLOCKS_PER_SM) rows1d_kernel(const ArgsOf<MASKED> A) {
  constexpr int H = M::HIST, NF = M::NF, NT = M::MAXT;
  constexpr int NP = M::NP > 0 ? M::NP : 1;
  constexpr bool grads = (MODE & MODE_GRADS) != 0;
  constexpr bool sums = (MODE & MODE_SUMS) != 0;
  using S = TileSmem<M, grads>;
  constexpr int NRED = S::NRED;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  __shared__ bool last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = A.T, N = A.N, slab = A.slab;
  const int ntx = (N + TILE - 1) / TILE, ntiles = ntx * ((T + slab - 1) / slab);
  const bool infer = grads && M::NP > 0 && A.nparams > 0;

  for (int p = 0, off = 0; off < A.nparams; off += A.param_size[p++]) {
    for (int k = tid; k < A.param_size[p]; k += NTHREADS) sm.P[off + k] = __ldg(A.params[p] + k);
  }
  float g2[NT], s[NT], pacc[NP];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    g2[k] = (grads && k < A.nterms) ? 2.0f * __ldg(A.g + k) : 0.0f;
    s[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) pacc[k] = 0.0f;

  // Stages the window of a tile (its field rows, a warp a row) and its cell
  // table into buffer `buf`: the two cells on each side in 4-byte copies,
  // the tile's cells in 16-byte chunks where the row is aligned, else one by
  // one.
  auto stage = [&](int tile, int buf) {
    const int x0 = (tile % ntx) * TILE, t0 = (tile / ntx) * slab;
    const int nfld = min(slab, T - t0) + (grads ? 2 * H : H);
    for (int k = tid; k < TILE + 4; k += NTHREADS) sm.xi[buf][k] = pmod(x0 - 2 + k, N);
    for (int qf = warp; qf < nfld * NF; qf += NWARPS) {
      const int q = qf / NF, f = qf % NF;
      const float* row = A.f[f] + (size_t)pmod(t0 - H + q, T) * N;
      float* dst = sm.F[buf][q][f];
      const bool aligned = x0 + TILE <= N && (reinterpret_cast<size_t>(row + x0) & 15) == 0;
      if (aligned && x0 >= FPAD && x0 + TILE + FPAD <= N) {  // the whole window in 16-byte chunks
        if (lane < FCOLS / 4) copy16_async(dst + 4 * lane, row + x0 - FPAD + 4 * lane);
        continue;
      }
      for (int c = lane; c < 4 + (aligned ? TILE / 4 : TILE); c += 32) {
        if (c < 4) {
          const int col = c < 2 ? FPAD - 2 + c : FPAD + TILE + c - 2;
          copy4_async(dst + col, row + pmod(x0 - FPAD + col, N));
        } else if (aligned) {
          copy16_async(dst + FPAD + 4 * (c - 4), row + x0 + 4 * (c - 4));
        } else {
          copy4_async(dst + FPAD + c - 4, row + pmod(x0 + c - 4, N));
        }
      }
    }
  };

  // 1. Each tile's window is staged while the block works on the tile
  // before (two buffers).
  if (blockIdx.x < ntiles) stage(blockIdx.x, 0);
  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int x0 = (tile % ntx) * TILE, t0 = (tile / ntx) * slab;
    const int nown = min(slab, T - t0);        // owned rows of the tile
    const int nres = nown + (grads ? H : 0);   // residual rows of the window: t0 .. t0 + nres - 1
    const int* xi = sm.xi[buf];
    wait_copies();
    __syncthreads();
    if (tile + (int)gridDim.x < ntiles) stage(tile + gridDim.x, buf ^ 1);

    // The samples of residual row r (of the window) at window cell i.
    auto samples = [&](int r, int i, float (&v)[H + 1][NF][3]) {
#pragma unroll
      for (int m = 0; m <= H; ++m) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
#pragma unroll
          for (int q = 0; q < 3; ++q) v[m][f][q] = sm.F[buf][r - m + H][f][i + q + FPAD - 2];
        }
      }
    };
    auto row_it = [&](int r) { return t0 + r < T ? t0 + r : t0 + r - T; };
    // The row the model sees: the global row on a shard's block.
    auto model_it = [&](int r) {
      if constexpr (MASKED) return row_it(r) + A.off;
      else return row_it(r);
    };

    // 2. The faces of the window's residual rows (only those of the owned
    // cells without the gradients).
    if constexpr (M::FACES) {
      constexpr int j0 = grads ? 0 : 1, nf = grads ? NFACE : TILE + 1;
      for (int idx = tid; idx < nres * nf; idx += NTHREADS) {
        const int r = idx / nf, j = j0 + idx % nf;
        const bool lview = j >= 1, rview = j <= TILE + 1;
        float va[H + 1][NF][3], vb[H + 1][NF][3];
        samples(r, lview ? j - 1 : j, va);
        samples(r, rview ? j : j - 1, vb);
        M::template face<grads>(A, sm.P, model_it(r), xi[j], va, xi[j + 1], vb, lview, rview, sm.face[r][j]);
      }
      __syncthreads();
    }

    // 3. The residual cells of the window (the owned ones without the
    // gradients).
    {
      constexpr int i0 = grads ? 0 : 1, nc = grads ? RW : TILE;
      for (int idx = tid; idx < nres * nc; idx += NTHREADS) {
        const int r = idx / nc, i = i0 + idx % nc;
        const bool own = i >= 1 && i <= TILE && x0 + i - 1 < N && r < nown;
        if (!grads && !own) continue;
        float v[H + 1][NF][3], res[NT], Dl[H + 1][NF][3], gk[2];
        samples(r, i, v);
        const int fi = M::FACES ? r : 0, fj = M::FACES ? i : 0, fk = M::FACES ? i + 1 : 0;
        if constexpr (MASKED) {
          // The cell's mask scales the loss weights (so the cotangents) and,
          // after the model, the terms.
          const int lt = row_it(r);
          const float m = lt >= A.r_lo && lt < A.r_hi ? __ldg(A.mask + xi[i + 1]) : 0.0f;
          float g2m[NT];
#pragma unroll
          for (int k = 0; k < NT; ++k) g2m[k] = g2[k] * m;
          M::template eval<grads>(A, sm.P, model_it(r), xi[i + 1], v, sm.face[fi][fj], sm.face[fi][fk], g2m, res, Dl,
                                  gk);
#pragma unroll
          for (int k = 0; k < NT; ++k) res[k] *= m;
        } else {
          M::template eval<grads>(A, sm.P, row_it(r), xi[i + 1], v, sm.face[fi][fj], sm.face[fi][fk], g2, res, Dl,
                                  gk);
        }
        if (sums && own) {
#pragma unroll
          for (int k = 0; k < NT; ++k) s[k] += k < A.nterms ? res[k] * res[k] : 0.0f;
        }
        if constexpr (grads) {
#pragma unroll
          for (int m = 0; m <= H; ++m) {
#pragma unroll
            for (int f = 0; f < NF; ++f) {
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                const int e = (m * NF + f) * 3 + q;
                if ((M::DUSED >> e) & 1u) sm.D[r][d_slot(M::DUSED, e)][i] = Dl[m][f][q];
              }
            }
          }
          if constexpr (M::FACES) {
            sm.gk[r][i][0] = own ? gk[0] : 0.0f;
            sm.gk[r][i][1] = own ? gk[1] : 0.0f;
          }
        }
      }
      __syncthreads();
    }

    // 4. The owned cells gather their cotangents; the faces of the owned
    // rows add their param cotangents.
    if constexpr (grads) {
      for (int idx = tid; idx < nown * TILE; idx += NTHREADS) {
        const int tl = idx / TILE, c = idx % TILE, x = x0 + c;
        if (x >= N) continue;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m <= H; ++m) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const int e = (m * NF + f) * 3 + q;
              if ((M::DUSED >> e) & 1u) acc += sm.D[tl + m][d_slot(M::DUSED, e)][c + 2 - q];
            }
          }
          A.df[f][(size_t)(t0 + tl) * N + x] = acc;
        }
      }
      if constexpr (M::FACES) {
        if (infer) {
          for (int idx = tid; idx < nown * (TILE + 1); idx += NTHREADS) {
            const int r = idx / (TILE + 1), j = 1 + idx % (TILE + 1);
            const float gl = sm.gk[r][j - 1][1], gr = sm.gk[r][j][0];
            if (gl == 0.0f && gr == 0.0f) continue;
            const typename M::Face& F = sm.face[r][j];
            const bool shared = xi[j + 1] != 0 && __float_as_uint(F.u[0]) == __float_as_uint(F.u[1]);
            M::face_vjp(A, sm.P, F, shared, gl, gr, pacc);
          }
        }
      }
    }
  }

  // The sums of the terms and the param cotangents (internal index k: the
  // terms, then the params; column c of A.partials: the live terms, then
  // the params).  Each block sums its threads' values in fp64 into its
  // column entries; the last block to finish sums the blocks' entries, each
  // thread the blocks tid, tid + NTHREADS, ... in order, the same way.
  const int c0 = sums ? 0 : A.nterms, c1 = infer ? A.stride : A.nterms;
  if (c0 >= c1) return;
  auto col = [&](int k) { return k < NT ? (k < A.nterms ? k : -1) : (k - NT < A.nparams ? A.nterms + k - NT : -1); };
  auto live = [&](int k) { return k < NRED && col(k) >= c0 && col(k) < c1; };
#pragma unroll
  for (int base = 0; base < S::NRED16; base += 16) {
    double v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // (the index guards keep unrolled dead branches in range)
      const int k = base + j;
      v[j] = k < NT ? (double)s[k < NT ? k : 0] : (k < NRED ? (double)pacc[k < NRED ? k - NT : 0] : 0.0);
    }
    warp_sums16(v, lane, sm.red[warp] + base);
  }
  __syncthreads();
  const unsigned nblocks = gridDim.x;
  if (tid < NRED && live(tid)) {
    double acc = sm.red[0][tid];
    for (int w = 1; w < NWARPS; ++w) acc += sm.red[w][tid];
    A.partials[(size_t)col(tid) * nblocks + blockIdx.x] = acc;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(A.ticket, 1u) == nblocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int base = 0; base < S::NRED16; base += 16) {
    double v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = 0.0;
    for (unsigned b = tid; b < nblocks; b += NTHREADS) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (live(base + j)) v[j] += __ldcg(A.partials + (size_t)col(base + j) * nblocks + b);
      }
    }
    warp_sums16(v, lane, sm.red[warp] + base);
  }
  __syncthreads();
  if (tid < NRED && live(tid)) {
    double acc = sm.red[0][tid];
    for (int w = 1; w < NWARPS; ++w) acc += sm.red[w][tid];
    const int c = col(tid);
    if (c < A.nterms) A.sums[c] = (float)acc;
    else A.dparams[c - A.nterms] = (float)acc;
  }
  if (tid == 0) *A.ticket = 0u;
}

template <class M, int MODE, bool MASKED>
int launch(const ArgsOf<MASKED>& A, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<M, MODE>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(rows1d_kernel<M, MODE, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  if (A.blocks < 1 || A.slab < 1 || A.slab > MAX_SLAB) return (int)cudaErrorInvalidValue;
  rows1d_kernel<M, MODE, MASKED><<<A.blocks, NTHREADS, bytes, s>>>(A);
  return (int)cudaGetLastError();
}

// The blocks of a launch (MODE) that the card holds at once: the waves the
// Python side sizes the slabs and the grid for.
template <class M, int MODE, bool MASKED>
int resident_blocks() {
  constexpr size_t bytes = smem_bytes<M, MODE>();
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(rows1d_kernel<M, MODE, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows1d_kernel<M, MODE, MASKED>, NTHREADS, bytes) !=
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
enum { MODE_MASKED = 4 };

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

}  // namespace rows1d
