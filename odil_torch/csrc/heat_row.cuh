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
// Operations per cell and residual row (backward, infer_k): two network
// passes (2 x 46 multiply-adds, 2 x 11 tanhf/expf), their param adjoints
// (2 x ~110), the stencil and its adjoint (~60): about 470 fp32 operations
// and 22 transcendentals, against 16 bytes moved -- the kernel is bound by
// arithmetic, not by bytes (OPS_HEAT_* in chip_smoke.py).

#pragma once

#include "rows1d.cuh"

namespace rows1d {

struct HeatRow {
  static constexpr int NF = 1, HIST = 1, MAXT = 4, NP = 46;
  enum { HAS_IMP = 1, HAS_X = 2, HAS_T = 4, INFER_K = 8 };
  // Offsets of the params in the flat buffer.
  static constexpr int W1 = 0, W2 = 5, W3 = 30, B1 = 35, B2 = 40, B3 = 45;

  struct Net {
    float h1[5], h2[5], s;
  };

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

  template <bool GRADS>
  __device__ __forceinline__ static void eval(const Rows1DArgs& A, const float* P, int it, int x,
                                              const float (&v)[2][1][3], const float* g2, bool own, float* res,
                                              float (&D)[2][1][3], float* pacc) {
    const float inv_dt = A.s[0], inv_dx = A.s[1], inv_2dx = A.s[2], impw = A.s[3], kmax = A.s[4];
    const bool first = it == 0, left = x == 0, right = x == A.N - 1;
    const bool has_imp = A.flags & HAS_IMP, has_x = A.flags & HAS_X, has_t = A.flags & HAS_T;
    const bool infer = A.flags & INFER_K;
    // Raw samples (x-1, x, x+1) of rows it and it-1.
    const float am = v[0][0][0], a0 = v[0][0][1], ap = v[0][0][2];
    float bm = v[1][0][0], b0 = v[1][0][1], bp = v[1][0][2];
    if (first) {
      bm = 2.0f * __ldg(A.consts[1] + x) - am;
      b0 = 2.0f * __ldg(A.consts[0] + x) - a0;
      bp = 2.0f * __ldg(A.consts[2] + x) - ap;
    }
    const float c1 = left ? (ap - 6.0f * a0) / 3.0f : am;
    const float c2 = right ? (c1 - 6.0f * a0) / 3.0f : ap;
    const float p1 = left ? (bp - 6.0f * b0) / 3.0f : bm;
    const float p2 = right ? (p1 - 6.0f * b0) / 3.0f : bp;
    const float s0 = a0 + b0, s1 = c1 + p1, s2 = c2 + p2;
    const float du_m = (s0 - s1) * inv_2dx, du_p = (s2 - s0) * inv_2dx;
    const float ufm = (s0 + s1) * 0.25f, ufp = (s2 + s0) * 0.25f;
    Net nm, np;
    const float km = k_of(A, P, ufm, nm, infer);
    const float kp = k_of(A, P, ufp, np, infer);
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
      xr = (left ? 0.0f : (a0 - c1) * inv_dx) * kx;
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
      if (own && infer) {
        k_vjp(P, ufm, nm, w0 * du_m * inv_dx, kmax, pacc);
        k_vjp(P, ufp, np, -w0 * du_p * inv_dx, kmax, pacc);
      }
    }
  }
};

}  // namespace rows1d
