// Device code of the multigrid-fused row walks shared by the veltracer's hand
// walk (rowwise_mg.cu, NF = 3) and the generic walk over a traced row model
// (mg_rows2d.cuh), templated on the field count NF: the 2-tap prolongation's
// taps, the staged coarse window (its type, loads, t-blend and a fine cell's
// rebuild from it), the level-1 rebuild of the two-level fusion, the stage
// of dP inside the walk with the close and flush of its coarse rows, and
// the body of the kernel that forms dP2 at depth 2.  What else the walks
// have in common (init_taps and init_dp_taps, the tap tables of the window
// and of dP; dp_step/dp_finish; the dP gather) each keeps a copy of: shared, each of those moved the hand
// walk's SASS, which the parts here keep instruction for instruction
// (test_row_kernels_keep_their_sass in tests/test_torch_gpu.py).
//
// The two walks keep their own argument structs.  A function here reads the
// coarse level through `M` (the hand walk's MgArgs; the generic walk's
// MgPart): M.P, M.Tc, M.CX, M.CY; and the two-level fusion's level-1 terms
// through `A2` (Mg2Args; Mg2DLvl2Args): A2.t1, A2.f1, A2.Tc2, A2.CX2, A2.CY2.
//
// The tile: a block of THREAD_ROWS x TILE_Y = 8 x 32 threads owns TILE_X x
// TILE_Y = 16 x 32 cells (two a thread) and rebuilds its fine rows over the
// tile and a halo of HALO = 2 cells, from a window of WX x WY coarse cells.

#pragma once

namespace mgc {
namespace {

constexpr int TILE_X = 16, TILE_Y = 32, THREAD_ROWS = 8, CELLS = TILE_X / THREAD_ROWS;
constexpr int NTHREADS = THREAD_ROWS * TILE_Y;
constexpr int HALO = 2, HX = TILE_X + 2 * HALO, HY = TILE_Y + 2 * HALO;  // a rebuilt row's window
// The blended coarse window a tile's fine rows read: coarse x indices
// ax0 .. ax0+WX-1 and y indices by0 .. by0+WY-1 (periodic), with
// ax0 = x0/2 - 2, by0 = y0/2 - 2.  Every coarse tap of the tile's fine cells,
// halo and edge extrapolation included, lies in it.
constexpr int WX = TILE_X / 2 + 4, WY = TILE_Y / 2 + 4;
// Two-level fusion: the level-2 window that the level-1 window's taps read,
// x indices (ax0 >> 1) - 1 .. + WX2-1 and y likewise (periodic); every tap of
// the level-1 window, edge extrapolation included, lies in it.
constexpr int WX2 = WX / 2 + 2, WY2 = WY / 2 + 2;
// The coarse window of one tile's dP partial: the coarse columns and rows
// that the taps of its TILE_X x TILE_Y owned fine cells reach.
constexpr int DWA = TILE_X / 2 + 2, DWB = TILE_Y / 2 + 2;
constexpr int DPR = 4;          // the ring of closed coarse rows
constexpr int CT = 16;          // coarse tile of the level-2 dP kernel
constexpr int FW = 2 * CT + 4;  // fine window covering a coarse tile's taps
constexpr int GATHER_B = 128;   // threads of a dP gather block, along b
static_assert(TILE_Y == 32, "mg_common.cuh: the dP y taps take one warp per tile row");

__host__ __device__ __forceinline__ int pmod(int v, int n) { return ((v % n) + n) % n; }

// The two coarse taps (index, weight) of fine index x along a cell axis with
// n coarse cells: fine[2i] = (c[i-1] + 3c[i])/4, fine[2i+1] = (3c[i] + c[i+1])/4,
// linear-extrapolation ghosts at both ends (transfer._interp_axis).
__host__ __device__ __forceinline__ void taps(int x, int n, int& a0, float& w0, int& a1, float& w1) {
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
__host__ __device__ __forceinline__ float tap_weight(int x, int a, int n) {
  int a0, a1;
  float w0, w1;
  taps(x, n, a0, w0, a1, w1);
  return (a0 == a ? w0 : 0.0f) + (a1 == a ? w1 : 0.0f);
}

// -- The rebuild ---------------------------------------------------------------

// The t-blended coarse window and each window row's and column's plane index
// and taps (as window indices).
template <int NF>
struct RowStage {
  float CB[NF][WX][WY];  // blend_t of P's two coarse rows over the window
  int ta[HX][2];         // x taps of each window row: window indices and weights
  float tw[HX][2];
  int tb[HY][2];
  float sw[HY][2];
  int xi[HX], yi[HY];    // plane x and y of each window row and column (periodic)
};

// Depth 2: the level-1 rows over the coarse window (row c in slot c & 1),
// the t-blended level-2 window and the level-1 window's taps into it.
template <int NF>
struct Lvl2Stage {
  float P1[2][NF][WX][WY];  // level-1 rows over the coarse window; row c in slot c & 1
  float CB2[NF][WX2][WY2];  // blend_t of P2's two rows over the level-2 window
  int ta[WX][2];            // level-2 taps of each level-1 window row and column
  float tw[WX][2];
  int tb[WY][2];
  float sw[WY][2];
};

// The level-1 window's taps into the level-2 window (once per block).
template <int NF, class Part, class L2>
__device__ void init_taps2(Lvl2Stage<NF>& S2, const Part& M, const L2& A2, int x0, int y0) {
  const int ax0 = (x0 >> 1) - 2, by0 = (y0 >> 1) - 2;
  const int ax2 = (ax0 >> 1) - 1, by2 = (by0 >> 1) - 1;
  for (int idx = threadIdx.y * TILE_Y + threadIdx.x; idx < WX + WY; idx += NTHREADS) {
    int a0, a1;
    float w0, w1;
    if (idx < WX) {
      taps(pmod(ax0 + idx, M.CX), A2.CX2, a0, w0, a1, w1);
      S2.ta[idx][0] = pmod(a0 - ax2, A2.CX2);
      S2.ta[idx][1] = pmod(a1 - ax2, A2.CX2);
      S2.tw[idx][0] = w0;
      S2.tw[idx][1] = w1;
    } else {
      const int k = idx - WX;
      taps(pmod(by0 + k, M.CY), A2.CY2, a0, w0, a1, w1);
      S2.tb[k][0] = pmod(a0 - by2, A2.CY2);
      S2.tb[k][1] = pmod(a1 - by2, A2.CY2);
      S2.sw[k][0] = w0;
      S2.sw[k][1] = w1;
    }
  }
}

// Rebuilds level-1 row c over the coarse window into its ring slot:
// P1[c] = f1 * t1[c] + W1x . blend_t(P2[c/2], P2[c/2+1]) . W1y^T (M.P the
// level-2 partial, M.CX x M.CY the level-1 plane), in the order of the
// depth-1 fine rebuild.  Every thread of the block calls it; it ends with a
// barrier.
template <int NF, class Part, class L2>
__device__ void build_p1(Lvl2Stage<NF>& S2, const Part& M, const L2& A2, int c, int x0, int y0) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int ax0 = (x0 >> 1) - 2, by0 = (y0 >> 1) - 2;
  const int ax2 = (ax0 >> 1) - 1, by2 = (by0 >> 1) - 1;
  const int c0 = c >> 1, c1 = min(c0 + 1, A2.Tc2 - 1);
  const float w = (c & 1) ? 0.5f : 0.0f;
  const size_t plane2 = (size_t)A2.CX2 * A2.CY2;
  for (int idx = tid; idx < NF * WX2 * WY2; idx += NTHREADS) {
    const int f = idx / (WX2 * WY2), la = (idx / WY2) % WX2, lb = idx % WY2;
    const size_t o = (size_t)pmod(ax2 + la, A2.CX2) * A2.CY2 + pmod(by2 + lb, A2.CY2);
    S2.CB2[f][la][lb] = (1.0f - w) * __ldg(M.P[f] + c0 * plane2 + o) + w * __ldg(M.P[f] + c1 * plane2 + o);
  }
  __syncthreads();
  const size_t plane1 = (size_t)M.CX * M.CY;
  float(*out)[WX][WY] = S2.P1[c & 1];
  for (int idx = tid; idx < NF * WX * WY; idx += NTHREADS) {
    const int f = idx / (WX * WY), la = (idx / WY) % WX, lb = idx % WY;
    const size_t o = (size_t)pmod(ax0 + la, M.CX) * M.CY + pmod(by0 + lb, M.CY);
    const int a0 = S2.ta[la][0], a1 = S2.ta[la][1], b0 = S2.tb[lb][0], b1 = S2.tb[lb][1];
    const float in0 = S2.CB2[f][a0][b0] * S2.sw[lb][0] + S2.CB2[f][a0][b1] * S2.sw[lb][1];
    const float in1 = S2.CB2[f][a1][b0] * S2.sw[lb][0] + S2.CB2[f][a1][b1] * S2.sw[lb][1];
    out[f][la][lb] = A2.f1[f] * __ldg(A2.t1[f] + c * plane1 + o) + (S2.tw[la][0] * in0 + S2.tw[la][1] * in1);
  }
  __syncthreads();
}

// The coarse values of the window that a thread loads of each of a fine
// row's two coarse rows (the walks issue them a row ahead into registers).
template <int NF>
constexpr int window_share = (NF * WX * WY + NTHREADS - 1) / NTHREADS;

// Issues this thread's loads of the coarse window of fine row rr: coarse
// rows rr/2 and rr/2 + 1 of M.P (xg0: the tile's first global column).
template <int NF, class Part>
__device__ __forceinline__ void fetch_window(float (&p0)[window_share<NF>], float (&p1)[window_share<NF>],
                                             const Part& M, int rr, int xg0, int y0) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int c0 = rr >> 1;
  const int c1 = min(c0 + 1, M.Tc - 1);
  const int ax0 = (xg0 >> 1) - 2, by0 = (y0 >> 1) - 2;
  const size_t cplane = (size_t)M.CX * M.CY;
#pragma unroll
  for (int k = 0; k < window_share<NF>; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < NF * WX * WY) {
      const int f = idx / (WX * WY), la = (idx / WY) % WX, lb = idx % WY;
      const int a = pmod(ax0 + la, M.CX), b = pmod(by0 + lb, M.CY);
      const size_t o = (size_t)a * M.CY + b;
      p0[k] = __ldg(M.P[f] + c0 * cplane + o);
      p1[k] = __ldg(M.P[f] + c1 * cplane + o);
    }
  }
}

// The t-blended coarse window of fine row rr into S.CB, from this thread's
// loads of coarse rows rr/2 and rr/2 + 1.  No barrier.
template <int NF>
__device__ __forceinline__ void stage_window(RowStage<NF>& S, const float (&p0)[window_share<NF>],
                                             const float (&p1)[window_share<NF>], int rr) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const float w = (rr & 1) ? 0.5f : 0.0f;
#pragma unroll
  for (int k = 0; k < window_share<NF>; ++k) {
    const int idx = tid + k * NTHREADS;
    if (idx < NF * WX * WY) (&S.CB[0][0][0])[idx] = (1.0f - w) * p0[k] + w * p1[k];
  }
}

// stage_window at depth 2: the two coarse rows are level-1 rows of the P1
// ring, rebuilt first where the ring does not hold them (p1_rows: the rows
// in its slots, the same in every thread; barriers inside).  No barrier
// after.
template <int NF, class Part, class L2>
__device__ __forceinline__ void stage_window2(RowStage<NF>& S, Lvl2Stage<NF>& S2, const Part& M, const L2& A2, int rr,
                                              int (&p1_rows)[2], int x0, int y0) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const float w = (rr & 1) ? 0.5f : 0.0f;
  const int c0 = rr >> 1, c1 = min(c0 + 1, M.Tc - 1);
  if (p1_rows[c0 & 1] != c0) {
    build_p1(S2, M, A2, c0, x0, y0);
    p1_rows[c0 & 1] = c0;
  }
  if (p1_rows[c1 & 1] != c1) {
    build_p1(S2, M, A2, c1, x0, y0);
    p1_rows[c1 & 1] = c1;
  }
  const float* q0 = &S2.P1[c0 & 1][0][0][0];
  const float* q1 = &S2.P1[c1 & 1][0][0][0];
  for (int idx = tid; idx < NF * WX * WY; idx += NTHREADS) (&S.CB[0][0][0])[idx] = (1.0f - w) * q0[idx] + w * q1[idx];
}

// The fine values at window position (hx, hy) of every field into F:
// f0 * t0 + Wx . the staged window . Wy^T.
template <int NF, class Fine, class F0>
__device__ __forceinline__ void rebuild_at(Fine* F, const RowStage<NF>& S, const F0& f0, const float (&t0)[NF], int hx,
                                           int hy) {
  const int a0 = S.ta[hx][0], a1 = S.ta[hx][1], b0 = S.tb[hy][0], b1 = S.tb[hy][1];
  const float wa0 = S.tw[hx][0], wa1 = S.tw[hx][1], wb0 = S.sw[hy][0], wb1 = S.sw[hy][1];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const float in0 = S.CB[f][a0][b0] * wb0 + S.CB[f][a0][b1] * wb1;
    const float in1 = S.CB[f][a1][b0] * wb0 + S.CB[f][a1][b1] * wb1;
    F[f][hx][hy] = f0[f] * t0[f] + (wa0 * in0 + wa1 * in1);
  }
}

// -- dP inside the walk ----------------------------------------------------------
//
// A thread sums the t-blended cotangent 0.5 d[2c-1] + d[2c] + 0.5 d[2c+1] of
// its own cell for the coarse row c that is open.  When c closes (after fine
// row 2c+1, or at the slab's end) each warp -- one tile row of TILE_Y = 32
// cells -- applies the transposed y taps by shuffles (cells 2q and 2q+1 share
// their coarse taps q-1, q, q+1) into a ring of DPR closed rows in shared
// memory; when the ring is full, or at the slab's end, the block applies the
// transposed x taps and stores each row's coarse window (DWA x DWB cells per
// field; window x index wa is unwrapped global coarse column (xg0 >> 1) - 1 +
// wa, xg0 the tile's first global column, so that a local block's window may
// straddle the periodic seam; window y index wb is coarse row y0/2 - 1 + wb)
// as the block's partial of that coarse row.

template <int NF>
struct DpStage {
  float acc[NF][TILE_X][TILE_Y];  // each thread's open coarse row (shared memory, not registers: the walks
                                  // run at their register bound)
  float E[DPR][NF][TILE_X][DWB];  // the ring of closed coarse rows after the y taps
  float yw[TILE_Y][3];            // tap weights of each tile column toward coarse y/2 - 1, y/2, y/2 + 1
  float xw[TILE_X][3];            // the same for each tile row (unwrapped global columns)
};

// The closed coarse row's y taps of tile row `row` into ring slot `slot`:
// lane 2q writes window index q + 1, lane 0 index 0 and lane 31 index
// DWB - 1.  No barrier.
template <int NF>
__device__ __forceinline__ void close_dp_row(DpStage<NF>& Q, const float (&acc)[NF], int slot, int row) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  const float wm = Q.yw[lane][0], wc = Q.yw[lane][1], wp = Q.yw[lane][2];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    float vm = wm * acc[f], vc = wc * acc[f], vp = wp * acc[f];
    vm += __shfl_xor_sync(FULL, vm, 1);  // the pair's weights toward its q - 1, q, q + 1
    vc += __shfl_xor_sync(FULL, vc, 1);
    vp += __shfl_xor_sync(FULL, vp, 1);
    const float up = __shfl_up_sync(FULL, vp, 2), dn = __shfl_down_sync(FULL, vm, 2);
    const float e = ((lane >= 2 ? up : 0.0f) + vc) + (lane < 30 ? dn : 0.0f);
    if ((lane & 1) == 0) Q.E[slot][f][row][(lane >> 1) + 1] = e;
    if (lane == 0) Q.E[slot][f][row][0] = vm;
    if (lane == TILE_Y - 1) Q.E[slot][f][row][DWB - 1] = vp;
  }
}

// The x taps of the ring's first n rows, stored at out + k * stride for
// ring slot k (NF * DWA * DWB floats: field, window x, window y).  Every
// thread of the block calls it; it starts with a barrier, and the row loop's
// barrier follows before the ring is written again.
template <int NF>
__device__ void flush_dp(const DpStage<NF>& Q, int n, float* out, size_t stride) {
  constexpr int DWIN = NF * DWA * DWB;
  __syncthreads();
  out += (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * DWIN;
  for (int idx = threadIdx.y * TILE_Y + threadIdx.x; idx < n * DWIN; idx += NTHREADS) {
    const int k = idx / DWIN, rem = idx % DWIN;
    const int f = rem / (DWA * DWB), wa = (rem / DWB) % DWA, wb = rem % DWB;
    float v = 0.0f;
    // Window index wa takes tile rows r = 2 wa - 4 + m (m < 6) with r / 2 in
    // wa - 2 .. wa: their weight toward coarse r/2 - 1 + (wa - r/2).
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const int r = 2 * wa - 4 + m;
      if (r >= 0 && r < TILE_X) v += Q.xw[r][2 - (m >> 1)] * Q.E[k][f][r][wb];
    }
    out[k * stride + rem] = v;
  }
}

// -- The dP2 kernel's body -----------------------------------------------------------

// The two-level fusion's dP2 = W1x^T (0.5 dP1[2c-1] + dP1[2c] + 0.5 dP1[2c+1])
// W1y, gathered per level-2 cell from dP1 (a coarse tile staged in shared
// memory).  It reads 1/8 of the bytes the row walk reads.  A: the hand
// walk's MgArgs or a CoarseArgs -- A.dt0 the level-1 cotangent dP1 (A.T
// rows of A.X x A.Y), A.dP the level-2 one (A.CX x A.CY).  Launched on
// (CY / CT, CX / CT, Tc2 * NF) blocks of CT x CT threads.
template <int NF, class Args>
__device__ __forceinline__ void coarse_grad(const Args& A) {
  __shared__ float S1[FW][FW + 1];
  __shared__ float S2[FW][CT + 1];
  const int f = blockIdx.z % NF, c = blockIdx.z / NF;
  const int a0 = blockIdx.y * CT, b0 = blockIdx.x * CT;
  const int xs = 2 * a0 - 2, ys = 2 * b0 - 2;
  const int tid = threadIdx.y * CT + threadIdx.x;
  const float* d = A.dt0[f];
  const size_t plane = (size_t)A.X * A.Y;

  for (int idx = tid; idx < FW * FW; idx += CT * CT) {
    const int i = idx / FW, j = idx % FW;
    const int x = xs + i, y = ys + j;
    float v = 0.0f;
    if (x >= 0 && x < A.X && y >= 0 && y < A.Y) {
      const size_t o = (size_t)x * A.Y + y;
      const int r = 2 * c;
      v = (c >= 1 ? 0.5f * d[(size_t)(r - 1) * plane + o] : 0.0f) + d[(size_t)r * plane + o];
      if (r + 1 < A.T) v = v + 0.5f * d[(size_t)(r + 1) * plane + o];
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

// The arguments of coarse_grad for a walk whose own struct names them
// otherwise (mg_rows2d.cuh's depth 2).
template <int NF>
struct CoarseArgs {
  const float* dt0[NF];  // dP1
  float* dP[NF];         // dP2
  int T, X, Y;           // dP1's rows and plane
  int CX, CY;            // dP2's plane
};

}  // namespace
}  // namespace mgc
