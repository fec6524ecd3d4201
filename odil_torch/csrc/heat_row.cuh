// The heat inverse-conductivity residual rows and their adjoint as device
// code for the 1-D row kernels of rows1d.cuh.
//
// The row model is odil_torch/models/heat.py::_make_row_fn with its hand
// adjoint _make_row_vjp (keep_init and keep_frozen on): residual row t reads
// rows t and t-1 of u at x-1, x, x+1.  The previous row at t == 0 is the
// linear extrapolation to the initial temperature, and the samples past the
// ends are quadratic-half ghosts of a zero wall (ix == 0 first, then
// ix == N-1).  The flux uses the conductivity k at the two faces, either the
// [1, 5, 5, 1] tanh network of the params squashed by kmax * sigmoid
// (infer_k) or the true conductivity; the face temperatures are frozen, so
// d/du does not pass through k, while d/dparams does, through both faces.
// Terms, in order: fu, then imp (data rows imp_mask, imp_u), xreg and treg
// (const (1, 1) weights kx, kt, read on the device so that the epoch's
// annealing reaches them), each where its flag is set.
//
// Scalars: s[0] = 1/dt, s[1] = 1/dx, s[2] = 1/(2 dx), s[3] = imp weight,
// s[4] = kmax.  Consts: u0 at x, at x-1, at x+1, ix (unused: the kernel knows
// x), kx, kt.  Params: W1 (5,1), W2 (5,5), W3 (1,5), b1 (5), b2 (5), b3 (1),
// flat.
//
// The face form.  Cell x's right-face temperature (s2 + s0)/4 and cell
// x+1's left-face temperature (s0' + s1')/4 add the same two sums, so
// wherever the two cells impose the same samples (every interior face but
// row 0 with initial temperatures that disagree, which the plain version
// allows) they have the same bits and one network pass serves both; the
// kernel checks the bits.  The wall faces of the periodic seam (the ghosts
// of x = N-1 and x = 0) belong to one cell each and keep their own pass.
// The face adjoint adds the two cells' conductivity cotangents, left then
// right, and runs one param adjoint.  The plain version of this order is
// models/heat.py::_make_row_vjp_faces.
//
// Operations per residual cell (backward, infer_k; a multiply-add counted
// as two and a tanhf or expf as one, as OPS_HEAT_* in chip_smoke.py counts
// them): one network pass per face (84) and its face temperature (3), one
// param adjoint per face (170), the stencil and its adjoint (~55), the
// gather (6): about 320 fp32 operations against ~20 bytes a cell (the
// field, the measured data rows, dfields).  On the H100 the two bounds are
// about equal (0.005 ms at 1024^2); the kernel is held back by neither but
// by the latency of its phases (PERF.md §6-§7).

#pragma once

#include "rows1d.cuh"

namespace rows1d {

struct HeatRow {
  static constexpr int NF = 1, HIST = 1, MAXT = 4, NP = 46;
  static constexpr unsigned DUSED = 0x3f;  // every sample of both rows
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr bool FACES = true;
  enum { HAS_IMP = 1, HAS_X = 2, HAS_T = 4, INFER_K = 8 };
  // Offsets of the params in the flat buffer.
  static constexpr int W1 = 0, W2 = 5, W3 = 30, B1 = 35, B2 = 40, B3 = 45;

  struct Net {
    float h1[5], h2[5], s;
  };

  // A face of a residual row: k[0] as its left cell sees it (that cell's
  // right face), k[1] as its right cell does, their temperatures u, and the
  // network's activations at u[0] for the param adjoint (15 floats: an odd
  // stride, so a warp reads its faces without bank conflicts).
  struct Face {
    float k[2], u[2];
    Net n;
  };

  // The imposed samples of cell x in rows it (a, c) and it-1 (b, p).
  struct Cell {
    float a0, b0, c1, c2, p1, p2;
  };

  __device__ __forceinline__ static Cell cell_at(const Rows1DArgs& A, int it, int x, const float (&v)[2][1][3]) {
    const bool first = it == 0, left = x == 0, right = x == A.N - 1;
    const float am = v[0][0][0], a0 = v[0][0][1], ap = v[0][0][2];
    float bm = v[1][0][0], b0 = v[1][0][1], bp = v[1][0][2];
    if (first) {
      bm = 2.0f * __ldg(A.consts[1] + x) - am;
      b0 = 2.0f * __ldg(A.consts[0] + x) - a0;
      bp = 2.0f * __ldg(A.consts[2] + x) - ap;
    }
    Cell c{a0, b0, am, ap, bm, bp};
    if (left) {  // a branch: the divisions only at the walls
      c.c1 = (ap - 6.0f * a0) / 3.0f;
      c.p1 = (bp - 6.0f * b0) / 3.0f;
    }
    if (right) {
      c.c2 = (c.c1 - 6.0f * a0) / 3.0f;
      c.p2 = (c.p1 - 6.0f * b0) / 3.0f;
    }
    return c;
  }

  // The conductivity at the face temperature x (and the network's
  // activations, for the param adjoint).
  __device__ __forceinline__ static float k_of(const Rows1DArgs& A, const float* P, float x, Net& n, bool infer) {
    if (!infer) {
      const float d = x - 0.5f;
      return 0.02f * expf(-(d * d) * 20.0f);
    }
#pragma unroll
    for (int o = 0; o < 5; ++o) n.h1[o] = tanhf(P[B1 + o] + P[W1 + o] * x);
#pragma unroll
    for (int o = 0; o < 5; ++o) {
      float acc = P[B2 + o];
#pragma unroll
      for (int i = 0; i < 5; ++i) acc = acc + P[W2 + 5 * o + i] * n.h1[i];
      n.h2[o] = tanhf(acc);
    }
    float acc = P[B3];
#pragma unroll
    for (int i = 0; i < 5; ++i) acc = acc + P[W3 + i] * n.h2[i];
    n.s = 1.0f / (1.0f + expf(-acc));
    return n.s * A.s[4];
  }

  // Adds the param cotangents of gk * k(x) to pacc.
  __device__ __forceinline__ static void k_vjp(const float* P, float x, const Net& n, float gk, float kmax,
                                               float* pacc) {
    const float go = gk * kmax * (n.s * (1.0f - n.s));
    pacc[B3] += go;
    float ga2[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      pacc[W3 + i] += go * n.h2[i];
      ga2[i] = go * P[W3 + i] * (1.0f - n.h2[i] * n.h2[i]);
    }
#pragma unroll
    for (int o = 0; o < 5; ++o) {
      pacc[B2 + o] += ga2[o];
#pragma unroll
      for (int i = 0; i < 5; ++i) pacc[W2 + 5 * o + i] += ga2[o] * n.h1[i];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      float gin = 0.0f;
#pragma unroll
      for (int o = 0; o < 5; ++o) gin += P[W2 + 5 * o + j] * ga2[o];
      const float ga1 = gin * (1.0f - n.h1[j] * n.h1[j]);
      pacc[W1 + j] += ga1 * x;
      pacc[B1 + j] += ga1;
    }
  }

  // The face between cells xa and xb = xa + 1 (mod N) of residual row it:
  // the left cell's right-face temperature and the right cell's left-face
  // one, each where that cell is in the window (lview, rview), and their
  // conductivities: one network pass where the two have the same bits and
  // the face is not the seam, else one each.
  template <bool ADJ>
  __device__ __forceinline__ static void face(const Rows1DArgs& A, const float* P, int it, int xa,
                                              const float (&va)[2][1][3], int xb, const float (&vb)[2][1][3],
                                              bool lview, bool rview, Face& F) {
    const bool infer = A.flags & INFER_K;
    float uL = 0.0f, uR = 0.0f;
    if (lview) {
      const Cell c = cell_at(A, it, xa, va);
      uL = ((c.c2 + c.p2) + (c.a0 + c.b0)) * 0.25f;
    }
    if (rview) {
      const Cell c = cell_at(A, it, xb, vb);
      uR = ((c.a0 + c.b0) + (c.c1 + c.p1)) * 0.25f;
    }
    const bool shared = lview && rview && xb != 0 && __float_as_uint(uL) == __float_as_uint(uR);
    Net n;
    const float k0 = k_of(A, P, lview ? uL : uR, n, infer);
    float k1 = k0;
    if (lview && rview && !shared) {
      Net m;
      k1 = k_of(A, P, uR, m, infer);
    }
    F.k[0] = k0;
    F.k[1] = k1;
    F.u[0] = uL;
    F.u[1] = uR;
    if (ADJ) F.n = n;
  }

  // Adds the param cotangents of a face: gl from the cell on its left (of
  // its right face), gr from the cell on its right (of its left face); one
  // adjoint of their sum where both saw the same temperature, else one each
  // (the network's activations at u[1] recomputed).
  __device__ __forceinline__ static void face_vjp(const Rows1DArgs& A, const float* P, const Face& F, bool shared,
                                                  float gl, float gr, float* pacc) {
    const float kmax = A.s[4];
    k_vjp(P, F.u[0], F.n, shared ? gl + gr : gl, kmax, pacc);
    if (!shared && gr != 0.0f) {
      Net m;
      k_of(A, P, F.u[1], m, true);
      k_vjp(P, F.u[1], m, gr, kmax, pacc);
    }
  }

  // Transpose of the quadratic-half ghosts (ix == N-1 reads the ix == 0 one,
  // so it goes first): (g0, g1, g2) on the imposed samples -> on the raw ones.
  __device__ __forceinline__ static void quadh_adjoint(float& g0, float& g1, float& g2, bool left, bool right) {
    if (right) {
      g1 += g2 / 3.0f;
      g0 += -2.0f * g2;
      g2 = 0.0f;
    }
    if (left) {
      g2 += g1 / 3.0f;
      g0 += -2.0f * g1;
      g1 = 0.0f;
    }
  }

  template <bool GRADS, class Args>
  __device__ __forceinline__ static void eval(const Args& A, const float* P, int it, int x,
                                              const float (&v)[2][1][3], const Face& fl, const Face& fr,
                                              const float* g2, float* res, float (&D)[2][1][3], float (&gk)[2]) {
    const float inv_dt = A.s[0], inv_dx = A.s[1], inv_2dx = A.s[2], impw = A.s[3];
    const bool first = it == 0, left = x == 0, right = x == A.N - 1;
    const bool has_imp = A.flags & HAS_IMP, has_x = A.flags & HAS_X, has_t = A.flags & HAS_T;
    const Cell c = cell_at(A, it, x, v);
    const float a0 = c.a0, b0 = c.b0;
    const float s0 = a0 + b0, s1 = c.c1 + c.p1, s2 = c.c2 + c.p2;
    const float du_m = (s0 - s1) * inv_2dx, du_p = (s2 - s0) * inv_2dx;
    const float km = fl.k[1], kp = fr.k[0];
    const float fu = (a0 - b0) * inv_dt - (du_p * kp - du_m * km) * inv_dx;

    // The optional terms and their positions after fu.
    const int kimp = 1, kxr = 1 + has_imp, ktr = kxr + has_x;
    float mask = 0.0f, imp = 0.0f, xr = 0.0f, tr = 0.0f, kx = 0.0f, kt = 0.0f;
    if (has_imp) {
      mask = data_at(A, 0, it, x);
      imp = mask * (a0 - data_at(A, 1, it, x)) * impw;
    }
    if (has_x) {
      kx = __ldg(A.consts[4]);
      xr = (left ? 0.0f : (a0 - c.c1) * inv_dx) * kx;
    }
    if (has_t) {
      kt = __ldg(A.consts[5]);
      tr = (first ? 0.0f : (a0 - b0) * inv_dt) * kt;
    }
    res[0] = fu;
#pragma unroll
    for (int k = 1; k < MAXT; ++k)
      res[k] = (has_imp && k == kimp) ? imp : (has_x && k == kxr) ? xr : (has_t && k == ktr) ? tr : 0.0f;

    if (GRADS) {
      const float w0 = g2[0] * fu;
      const float g_dup = -w0 * kp * inv_dx, g_dum = w0 * km * inv_dx;
      const float gs0 = (g_dum - g_dup) * inv_2dx, gs1 = -g_dum * inv_2dx, gs2 = g_dup * inv_2dx;
      float gc0 = gs0 + w0 * inv_dt, gc1 = gs1, gc2 = gs2;
      float gp0 = gs0 - w0 * inv_dt, gp1 = gs1, gp2 = gs2;
      if (has_imp) gc0 += pick<MAXT>(g2, kimp) * imp * mask * impw;
      if (has_x) {
        const float wx = left ? 0.0f : pick<MAXT>(g2, kxr) * xr * kx * inv_dx;
        gc0 += wx;
        gc1 -= wx;
      }
      if (has_t) {
        const float wt = first ? 0.0f : pick<MAXT>(g2, ktr) * tr * kt * inv_dt;
        gc0 += wt;
        gp0 -= wt;
      }
      quadh_adjoint(gc0, gc1, gc2, left, right);
      quadh_adjoint(gp0, gp1, gp2, left, right);
      if (first) {  // the previous row is 2 u0 - the current one
        gc0 -= gp0;
        gc1 -= gp1;
        gc2 -= gp2;
        gp0 = gp1 = gp2 = 0.0f;
      }
      D[0][0][0] = gc1;
      D[0][0][1] = gc0;
      D[0][0][2] = gc2;
      D[1][0][0] = gp1;
      D[1][0][1] = gp0;
      D[1][0][2] = gp2;
      gk[0] = w0 * du_m * inv_dx;   // of km
      gk[1] = -w0 * du_p * inv_dx;  // of kp
    }
  }
};

}  // namespace rows1d
