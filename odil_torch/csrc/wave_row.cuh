// The wave residual rows and their adjoint as device code for the 1-D row
// kernels of rows1d.cuh.
//
// The row model is odil_torch/models/wave.py::_make_row_fn with its hand
// adjoint _make_row_vjp: residual row t reads u at row t (x), row t-1 (x-1,
// x, x+1) and row t-2 (x).  The samples of row t-1 past the ends are
// quadratic-half ghosts of the boundary traces, per-row data of shape (T, 1)
// (ix == 0 first, then ix == N-1); at it == 1 the previous time derivative is
// the initial one (const ut0), and row 0 holds the staggered initial
// condition u0 + dt/2 ut0 with weight kimp.
//
// Scalars: s[0] = 1/dt, s[1] = 1/dx^2, s[2] = kimp, s[3] = dt/2.  Data: left
// and right traces at it - 1.  Consts: u0, ut0, ix (unused: the kernel knows
// x).  About 20 fp32 operations per cell: the kernel is bound by bytes.  No
// faces: the kernel skips its face phases.

#pragma once

#include "rows1d.cuh"

namespace rows1d {

struct WaveRow {
  static constexpr int NF = 1, HIST = 2, MAXT = 1, NP = 0;
  // The samples it reads: row t at x, row t-1 at x-1, x, x+1, row t-2 at x.
  static constexpr unsigned DUSED = 1u << 1 | 1u << 3 | 1u << 4 | 1u << 5 | 1u << 7;
  static constexpr int BLOCKS_PER_SM = 4;
  static constexpr bool FACES = false;
  struct Face {};

  template <bool GRADS, class Args>
  __device__ __forceinline__ static void eval(const Args& A, const float* P, int it, int x,
                                              const float (&v)[3][1][3], const Face&, const Face&, const float* g2,
                                              float* res, float (&D)[3][1][3], float (&)[2]) {
    const float inv_dt = A.s[0], inv_dx2 = A.s[1], kimp = A.s[2], hdt = A.s[3];
    const bool first = it == 0, left = x == 0, right = x == A.N - 1;
    const float cur = v[0][0][1], tm = v[1][0][1], tmm = v[2][0][1];
    const float ut0 = __ldg(A.consts[1] + x);
    float uxm = v[1][0][0], uxp = v[1][0][2];
    if (left) uxm = (uxp - 6.0f * tm + 8.0f * data_at(A, 0, it, x)) / 3.0f;
    if (right) uxp = (uxm - 6.0f * tm + 8.0f * data_at(A, 1, it, x)) / 3.0f;
    const float u_t_here = (cur - tm) * inv_dt;
    const float u_t_prev = it == 1 ? ut0 : (tm - tmm) * inv_dt;
    float fu = (u_t_here - u_t_prev) * inv_dt - (uxm - 2.0f * tm + uxp) * inv_dx2;
    if (first) fu = (cur - (__ldg(A.consts[0] + x) + hdt * ut0)) * kimp;
    res[0] = fu;

    if (GRADS) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
#pragma unroll
        for (int q = 0; q < 3; ++q) D[m][0][q] = 0.0f;
      }
      const float w = g2[0] * fu;
      if (first) {
        D[0][0][1] = w * kimp;
        return;
      }
      const float a = w * inv_dt * inv_dt;
      const float gl = -w * inv_dx2;  // each of uxm, uxp (and -2 x tm) in the Laplacian
      const bool not1 = it != 1;
      float gtm = -a - 2.0f * gl + (not1 ? -a : 0.0f);
      // Transposes of the ghosts: the right one reads uxm, so it goes first.
      const float guxm = gl + (right ? gl / 3.0f : 0.0f);
      if (right) gtm += -2.0f * gl;
      const float gnext = (right ? 0.0f : gl) + (left ? guxm / 3.0f : 0.0f);
      if (left) gtm += -2.0f * guxm;
      D[0][0][1] = a;
      D[1][0][0] = left ? 0.0f : guxm;
      D[1][0][1] = gtm;
      D[1][0][2] = gnext;
      D[2][0][1] = not1 ? a : 0.0f;
    }
  }
};

}  // namespace rows1d
