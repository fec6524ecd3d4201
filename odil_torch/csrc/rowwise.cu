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
// computes the slabbed pair's function; the TPU streams to keep VMEM small.
// A Hopper block's shared-memory ring does not grow with its slab, and one
// slab of all T rows leaves most of the 132 SMs idle, so on the card the
// streaming pair is the slabbed launch itself: slabs sized to whole waves of
// the resident blocks (ops/rowwise.py::_wave_slab, _tile_rows), each field
// row read once per slab and the `hist` rows above a slab read again
// (hist/slab of the bytes).  The odil_torch.ops.rowwise streaming wrappers
// launch these entry points with launch counters of their own.
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
//   * A block of 8 x 32 threads owns a TILE_X x TILE_Y = 16 x 32 tile (two
//     cells a thread, rows r and r + 8) of a slab of `slab` rows and walks
//     its rows through a ring of NSLOT = 5 fine rows in dynamic shared
//     memory (halo 2, periodic through full-modulo index tables, so planes
//     narrower than a tile wrap more than once): rows t-1, t and t+1 of row
//     t and two rows in flight.  The rows go straight from HBM into the
//     ring by cp.async, started AHEAD = 3 rows before the row that first
//     reads them, one commit group a row, so that a row waits for its own
//     copies only: 16-byte copies for the 32 owned columns of a tile row
//     (owned columns at plane column 4, aligned) and 4-byte copies through
//     the index tables for the halo columns, the wrap and ragged planes.
//     Two barriers a row (one in the forward mode): one publishes the row
//     that has landed and frees the oldest slot, one follows the ring-1
//     staging.  The rows at the slab edges are read twice.  Two cells a
//     thread stage 1.41 halo cells and 1.2 ring-1 cells per owned cell
//     (1.69 and 1.33 at one cell a thread on 8 x 32) and halve the barriers
//     per cell; ~64 KB of shared memory (67 KB masked) holds 3 blocks an SM.
//   * The thread owning cell (t, x, y) gathers its whole cotangent (the "cur"
//     adjoint of residual row t plus the "prev" adjoint of row t+1): no
//     atomics.
//   * Slabs: whole waves of the resident blocks (odil_rows_resident_blocks;
//     ops/rowwise.py::_wave_slab), counting the row a block reads before its
//     slab: 3 slabs of 22 rows, 384 blocks in one wave of 396 at 256^2.
//   * Sums: fp64 block sums (warp shuffles, then the warps in order); the
//     last block to finish reduces them in block order (finish_sums of
//     veltracer_row.cuh, every term's partials in one pass) -- one launch,
//     the same bits run to run.

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
// shards) up to its tile; here the grid is a ceiling division over the
// 16x32 tiles and every cell is guarded, so the kernel runs on the unpadded
// extent and the mask alone does what the padding's mask does (at X = 130
// the 9 x tiles cover 144 rows: 9.7% of the threads own no cell).
//
// Bound on the H100 (3.35 TB/s HBM): at (65,256,256) x3 fp32 the backward
// must read the fields (51.1 MB) and the two const planes (0.5 MB) and write
// dfields (51.1 MB), ~30.7 us; the forward reads ~51.6 MB, ~15.4 us.  The
// arithmetic (about 150 fp32 operations per cell) is far below the memory
// time, so both are bound by bytes.  The heat and wave instantiations and
// their bounds are described in rows1d.cuh, heat_row.cuh and wave_row.cuh:
// heat (one network pass per face) has about equal byte and operation
// bounds, wave is bound by bytes.

#include <type_traits>

// The row kernel's tile: 16 x 32 cells, 8 x 32 threads, two cells a thread;
// the owned columns of a staged row at plane column 4 (16-byte aligned).
#define ODIL_TILE_X 16
#define ODIL_THREAD_ROWS 8
#define ODIL_PLANE_YOFF 4
#include "cp_async.cuh"
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
  unsigned* ticket;     // 0 between launches: the blocks that have written their sums
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

// The ring of fine rows: rows t-1, t and t+1 of iteration t and two rows in
// flight; iteration t starts the copies of row t + AHEAD into the slot of
// row t - 2.
constexpr int NSLOT = 5;
constexpr int AHEAD = NSLOT - 2;
constexpr int HYS = TILE_Y + 2 * HALO;  // staged columns of a tile row: y0 - HALO .. y0 + TILE_Y + HALO - 1
constexpr int VEC = TILE_Y / 4;         // 16-byte copies of a tile row's owned columns
constexpr int ROW_BLOCKS_PER_SM = 3;    // the shared memory of 3 blocks fits an SM's 227 KB
static_assert(YOFF % 4 == 0 && HY % 4 == 0 && YOFF - HALO >= 0, "rowwise.cu: staged rows must be 16-byte aligned");

// The block's dynamic shared memory: the ring (slot of row r: (r - ts + 1) %
// NSLOT), the const planes of the tile (the initial tracer plane, and the
// mask of a masked launch), the ring-1 staging, the sums' warp partials and
// the plane index of each staged tile row and column (the ragged form of
// Window).
template <bool MASKED>
struct RowSmem {
  float F[NSLOT][NF][HX][HY];
  Plane C[MASKED ? 2 : 1];
  Ring1 R;
  double red[NWARPS][MAXTERMS];
  int xi[HX], yi[HYS];
};

// How a thread stages the tile's window (HX x HYS cells, periodic) of a
// plane.  vec: the owned columns of each tile row in 16-byte copies (8 a
// row) and its 4 halo columns in 4-byte ones, 12 copies a tile row, one a
// thread, fixed for the block: its offset in the plane (src), its target in
// a Plane (dst) and its size (bytes; 0: none).  Else every column in 4-byte
// copies through the plane index tables xi, yi: planes narrower than a
// tile, a Y that is not a multiple of 4, the last y tile of a ragged plane,
// fields that are not 16-byte aligned.
struct Window {
  bool vec;
  int src, dst, bytes;
  const int *xi, *yi;
  int Y;
};
constexpr int VEC_COPIES = VEC + 2 * HALO;  // copies of a tile row in the vec form
static_assert(HX * VEC_COPIES <= NTHREADS, "rowwise.cu: one vec copy a thread");

// Starts the copies of the window of NP planes src(p) + base into dst[p],
// without a commit.
template <int NP, class Src>
__device__ __forceinline__ void copy_window(Plane* dst, Src src, size_t base, const Window& w) {
  if (w.vec) {
    if (w.bytes == 16) {
#pragma unroll
      for (int p = 0; p < NP; ++p) copy16_async(&dst[p][0][0] + w.dst, src(p) + base + w.src);
    } else if (w.bytes == 4) {
#pragma unroll
      for (int p = 0; p < NP; ++p) copy4_async(&dst[p][0][0] + w.dst, src(p) + base + w.src);
    }
    return;
  }
  for (int it = threadIdx.y * TILE_Y + threadIdx.x; it < HX * HYS; it += NTHREADS) {
    const int hx = it / HYS, hy = it % HYS;
    const size_t o = base + (size_t)w.xi[hx] * w.Y + w.yi[hy];
#pragma unroll
    for (int p = 0; p < NP; ++p) copy4_async(&dst[p][hx][hy + YOFF - HALO], src(p) + o);
  }
}

// Starts the copies of fine row r (periodic in t; -1 <= r <= T) of the tile
// into ring slot F and commits them, with every copy this thread started
// before, as one group; with live false it commits no new copy, so that
// every iteration waits for the same count.
template <class Args>
__device__ __forceinline__ void issue_row(Plane* F, const Args& A, const Window& w, int r, bool live) {
  if (live) {
    const int rr = r < 0 ? r + A.T : (r >= A.T ? r - A.T : r);
    copy_window<NF>(F, [&](int f) { return A.f[f]; }, (size_t)rr * A.X * A.Y, w);
  }
  commit_copies();
}

// stage_ring1 for the row kernel: the positions every thread takes (FULL of
// them) in straight-line code, their stores after them, then the rest of
// the ring; a barrier at the end.  (The mg walk keeps one position at a
// time: its other live values leave no registers for this.)
template <class Args, class Layer>
__device__ __forceinline__ void stage_ring1_rows(const Args& A, const RowPlanes& P, int it1, const float* g2, Ring1& R,
                                                 const Layer& H) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  constexpr int FULL = RX * RY / NTHREADS;
  float v[FULL][5];
#pragma unroll
  for (int q = 0; q < FULL; ++q) {
    ring1_at(A, P, it1, g2, tid + q * NTHREADS, H, [&](int k, int, int, float x) { v[q][k] = x; });
  }
#pragma unroll
  for (int q = 0; q < FULL; ++q) {
    const int ri = (tid + q * NTHREADS) / RY, rj = (tid + q * NTHREADS) % RY;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (k < 3 || A.has_x) ring1_array(R, k)[ri][rj] = v[q][k];
    }
  }
  for (int idx = tid + FULL * NTHREADS; idx < RX * RY; idx += NTHREADS) {
    ring1_at(A, P, it1, g2, idx, H, [&](int k, int ri, int rj, float x) { ring1_array(R, k)[ri][rj] = x; });
  }
  __syncthreads();
}

// The halo layer of residual rows t and it1 (local rows) and the global row
// of local row 0: none for a plain launch, the mask tile, the own rows and
// the offset for a masked one.
__device__ __forceinline__ NoHalo row_layer(const RowArgs&, const Plane*, int, int) { return {}; }
__device__ __forceinline__ HaloRow row_layer(const RowHaloArgs& A, const Plane* M, int t, int it1) {
  return {M, (t >= A.r_lo && t < A.r_hi) ? 1.0f : 0.0f, (it1 >= A.r_lo && it1 < A.r_hi) ? 1.0f : 0.0f, A.Tg};
}
__device__ __forceinline__ int row_off(const RowArgs&) { return 0; }
__device__ __forceinline__ int row_off(const RowHaloArgs& A) { return A.off; }
// The const planes of a launch: u_init, and the mask of a masked one.
__device__ __forceinline__ const float* const_plane(const RowArgs& A, int) { return A.u_init; }
__device__ __forceinline__ const float* const_plane(const RowHaloArgs& A, int p) { return p == 0 ? A.u_init : A.mask; }

// MASKED: the masked per-shard form (RowHaloArgs: global rows for the row
// conditions, masked residuals); the code of the plain instantiation is
// unchanged by it.
template <int MODE, bool MASKED = false>
__global__ void __launch_bounds__(NTHREADS, ROW_BLOCKS_PER_SM)
    rows_kernel(const typename std::conditional<MASKED, RowHaloArgs, RowArgs>::type A) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  auto& S = *reinterpret_cast<RowSmem<MASKED>*>(row_smem);
  auto& F = S.F;

  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;
  const int y = y0 + threadIdx.x, j = threadIdx.x + YOFF;
  const int T = A.T;
  const int ts = blockIdx.z * A.slab, te = min(ts + A.slab, T);
  const int off = row_off(A);
  constexpr bool grads = (MODE & MODE_GRADS) != 0;
  constexpr bool sums = (MODE & MODE_SUMS) != 0;
  // The row each iteration needs last: t+1 for the gradients, t else.
  constexpr int ahead = grads ? 1 : 0;
  const int last = te - 1 + ahead;  // the slab's last row

  bool vec = y0 + TILE_Y <= A.Y && A.Y % 4 == 0;
#pragma unroll
  for (int f = 0; f < NF; ++f) vec = vec && (reinterpret_cast<size_t>(A.f[f]) & 15) == 0;
  if constexpr (MASKED) vec = vec && (reinterpret_cast<size_t>(A.mask) & 15) == 0;
  vec = vec && (reinterpret_cast<size_t>(A.u_init) & 15) == 0;
  Window w{vec, 0, 0, 0, S.xi, S.yi, A.Y};
  if (vec) {
    if (tid < HX * VEC_COPIES) {
      const int hx = tid / VEC_COPIES, c = tid % VEC_COPIES;
      const int row = pmod(x0 + hx - HALO, A.X) * A.Y;
      if (c < VEC) {
        w.src = row + y0 + 4 * c;
        w.dst = hx * HY + YOFF + 4 * c;
        w.bytes = 16;
      } else {
        const int hy = c - VEC < HALO ? c - VEC : c - VEC + TILE_Y;
        w.src = row + pmod(y0 + hy - HALO, A.Y);
        w.dst = hx * HY + hy + YOFF - HALO;
        w.bytes = 4;
      }
    }
  } else {
    for (int idx = tid; idx < HX + HYS; idx += NTHREADS) {
      if (idx < HX) S.xi[idx] = pmod(x0 + idx - HALO, A.X);
      else S.yi[idx - HX] = pmod(y0 + idx - HX - HALO, A.Y);
    }
    __syncthreads();
  }
  // The const planes with row ts-1, then rows ts .. ts-1+AHEAD: a group each.
  copy_window<MASKED ? 2 : 1>(S.C, [&](int p) { return const_plane(A, p); }, 0, w);
#pragma unroll
  for (int q = 0; q <= AHEAD; ++q) issue_row(F[q], A, w, ts - 1 + q, ts - 1 + q <= last);
  float g2[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) g2[k] = (grads && k < A.nterms) ? 2.0f * __ldg(A.g + k) : 0.0f;
  float s[MAXTERMS];
#pragma unroll
  for (int k = 0; k < MAXTERMS; ++k) s[k] = 0.0f;
  float u1[CELLS];  // the final tracer at the owned cells
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int x = x0 + threadIdx.y + c * THREAD_ROWS;
    u1[c] = x < A.X && y < A.Y ? __ldg(A.u_final + (size_t)x * A.Y + y) : 0.0f;
  }

  for (int t = ts; t < te; ++t) {
    // Row t + ahead has landed (this thread's copies; AHEAD - 1 - ahead
    // groups stay in flight); the barrier publishes it to the block and
    // frees the slot of row t - 2, which the last iteration read.
    if constexpr (grads) wait_groups<AHEAD - 2>();
    else wait_groups<AHEAD - 1>();
    __syncthreads();
    issue_row(F[(t - ts + AHEAD + 1) % NSLOT], A, w, t + AHEAD, t + AHEAD <= last);
    const int sm = (t - ts) % NSLOT, sc = (t - ts + 1) % NSLOT, sp = (t - ts + 2) % NSLOT;
    const RowPlanes P{F[sm][0], F[sc][0], F[sp][0], F[sm][1], F[sc][1], F[sp][1], F[sm][2], F[sc][2], F[sp][2], S.C[0]};
    const int it1 = t + 1 < T ? t + 1 : 0;  // residual row t+1 (row 0 after T-1)
    const auto H = row_layer(A, &S.C[MASKED ? 1 : 0], t, it1);

    if (grads) stage_ring1_rows(A, P, it1 + off, g2, S.R, H);
    // Both cells of the thread in straight-line code (the staged planes hold
    // every tile row, so a cell outside the plane reads wrapped values and
    // adds nothing to the sums), their stores after them.
    float d[CELLS][NF];
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int x = x0 + threadIdx.y + c * THREAD_ROWS, i = threadIdx.y + c * THREAD_ROWS + HALO;
      cell_terms<grads, sums>(A, P, S.R, t + off, it1 + off, i, j, u1[c], g2, s, d[c], H, x < A.X && y < A.Y);
    }
    if (grads) {
#pragma unroll
      for (int c = 0; c < CELLS; ++c) {
        const int x = x0 + threadIdx.y + c * THREAD_ROWS;
        if (!(x < A.X && y < A.Y)) continue;
        const size_t cell = ((size_t)t * A.X + x) * A.Y + y;
#pragma unroll
        for (int f = 0; f < NF; ++f) A.df[f][cell] = d[c][f];
      }
    }
  }

  if (sums) finish_sums(A, s, S.red);
}

__global__ void empty_kernel() {}

dim3 rows_grid(const RowArgs& A) {
  return dim3((A.Y + TILE_Y - 1) / TILE_Y, (A.X + TILE_X - 1) / TILE_X, (A.T + A.slab - 1) / A.slab);
}

// The kernel's dynamic shared memory, allowed once per form (a refusal
// shows as the launch's error).
template <int MODE, bool MASKED>
size_t row_smem() {
  constexpr size_t bytes = sizeof(RowSmem<MASKED>);
  static const cudaError_t set =
      cudaFuncSetAttribute(rows_kernel<MODE, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  (void)set;
  return bytes;
}

template <int MODE, bool MASKED, class Args>
int rows_launch(const Args& A, cudaStream_t s) {
  rows_kernel<MODE, MASKED><<<rows_grid(A), dim3(TILE_Y, THREAD_ROWS), row_smem<MODE, MASKED>(), s>>>(A);
  return (int)cudaGetLastError();
}

// The blocks of the backward+sums form that an SM holds at once.
template <bool MASKED>
int blocks_per_sm() {
  constexpr int MODE = MODE_SUMS | MODE_GRADS;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel<MODE, MASKED>, NTHREADS,
                                                    row_smem<MODE, MASKED>()) != cudaSuccess)
    return 0;
  return per_sm;
}

}  // namespace

extern "C" {

int odil_rows_args_size() { return (int)sizeof(RowArgs); }

int odil_rows_num_blocks(int T, int X, int Y, int slab) {
  return ((Y + TILE_Y - 1) / TILE_Y) * ((X + TILE_X - 1) / TILE_X) * ((T + slab - 1) / slab);
}

// The blocks of the backward+sums row kernel that the card holds at once:
// the waves the Python side sizes the slabs for (the other forms take the
// same shared memory and the masked one 3 KB more, within the same blocks
// an SM: odil_rows_tile).
int odil_rows_resident_blocks() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms * blocks_per_sm<false>();
}

// The row kernel's tile for the launch-shape report: its rows (0), columns
// (1) and threads (2), the dynamic shared memory of a plain (3) and a
// masked (4) launch in bytes, and the backward+sums blocks an SM holds,
// plain (5) and masked (6).
int odil_rows_tile(int what) {
  switch (what) {
    case 0: return TILE_X;
    case 1: return TILE_Y;
    case 2: return NTHREADS;
    case 3: return (int)sizeof(RowSmem<false>);
    case 4: return (int)sizeof(RowSmem<true>);
    case 5: return blocks_per_sm<false>();
    case 6: return blocks_per_sm<true>();
    default: return 0;
  }
}

const char* odil_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// An empty kernel: the launch floor that chip_smoke.py times beside the
// small planes' kernels, the same way (a CUDA graph of 50 launches).
int odil_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Loss-only pass (_forward, _forward_stream): per-term sums of squares into
// A->sums.
int odil_rows_forward(const RowArgs* a, void* stream) {
  return rows_launch<MODE_SUMS, false>(*a, (cudaStream_t)stream);
}

// Gradient pass (_backward, _backward_stream): dfields, plus the sums when
// with_sums.
int odil_rows_backward(const RowArgs* a, int with_sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return with_sums ? rows_launch<MODE_SUMS | MODE_GRADS, false>(*a, s) : rows_launch<MODE_GRADS, false>(*a, s);
}

// The masked per-shard pair (_forward_tiled / _backward_tiled with xpad).
int odil_rows_halo_args_size() { return (int)sizeof(RowHaloArgs); }

int odil_rows_halo_forward(const RowHaloArgs* a, void* stream) {
  return rows_launch<MODE_SUMS, true>(*a, (cudaStream_t)stream);
}

int odil_rows_halo_backward(const RowHaloArgs* a, int with_sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return with_sums ? rows_launch<MODE_SUMS | MODE_GRADS, true>(*a, s) : rows_launch<MODE_GRADS, true>(*a, s);
}

// The 1-D row models, by id: 0 heat, 1 wave (odil_torch/ops/rowwise.py).
// The slabbed and the streaming launches are one tile launch (rows1d.cuh).
int odil_rows1d_args_size() { return (int)sizeof(rows1d::Rows1DArgs); }

// The tile's cells (0), its most rows (1) and a block's threads (2): the
// Python side's tile search (ops/rowwise.py::_tile_rows) reads them.
int odil_rows1d_tile(int what) {
  return what == 0 ? rows1d::TILE : what == 1 ? rows1d::MAX_SLAB : rows1d::NTHREADS;
}

// The blocks of a launch (mode: 1 sums, 2 gradients, 3 both; plus 4 for the
// masked per-shard form) that the card holds at once.
int odil_rows1d_resident_blocks(int model, int mode) {
  switch (model) {
    case 0: return rows1d::resident<rows1d::HeatRow>(mode);
    case 1: return rows1d::resident<rows1d::WaveRow>(mode);
    default: return 0;
  }
}

int odil_rows1d_forward(int model, const rows1d::Rows1DArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case 0: return rows1d::forward<rows1d::HeatRow, false>(*a, s);
    case 1: return rows1d::forward<rows1d::WaveRow, false>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int odil_rows1d_backward(int model, const rows1d::Rows1DArgs* a, int with_sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case 0: return rows1d::backward<rows1d::HeatRow, false>(*a, with_sums, s);
    case 1: return rows1d::backward<rows1d::WaveRow, false>(*a, with_sums, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The masked per-shard pair on 1-D planes (the blocked pair of
// odil_tpu/ops/rowwise.py:322, :396 on the row function that
// odil_tpu/halo.py:873-885 wraps): the halo layer of rows1d.cuh.
int odil_rows1d_halo_args_size() { return (int)sizeof(rows1d::Rows1DHaloArgs); }

int odil_rows1d_halo_forward(int model, const rows1d::Rows1DHaloArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case 0: return rows1d::forward<rows1d::HeatRow, true>(*a, s);
    case 1: return rows1d::forward<rows1d::WaveRow, true>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int odil_rows1d_halo_backward(int model, const rows1d::Rows1DHaloArgs* a, int with_sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
    case 0: return rows1d::backward<rows1d::HeatRow, true>(*a, with_sums, s);
    case 1: return rows1d::backward<rows1d::WaveRow, true>(*a, with_sums, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
