// The trivial row model of the kernel-ablation tool, as device code for the
// mg walk of rowwise_mg.cu: its ablation build with ODIL_MG_ABLATION=1 takes
// this header in place of veltracer_row.cuh.
//
// The row function of benchmarks/kernel_ablation.py:254-261 (and
// odil_torch/ops/mg_ablation.py::trivial_row_fn): residual row t at a cell is
//   s_t = u[t] + u[t-1] + vx[t] + vx[t-1] + vy[t] + vy[t-1] + u_init + u_final
// (in that order, t-1 periodic), and its six terms are s_t * 0.1 (k + 1).  It
// touches every input plane, so the walk keeps its data flow (the ring of
// rebuilt rows, the staging, the dP route); what it drops is the row model's
// arithmetic.  Its adjoint is exact (the terms are linear): the cell of row t
// gets W_t + W_{t+1} in each field, W_r = sum_k 2 g[k] res_k(r) 0.1 (k + 1).
//
// The tile, the planes, the halo structs, Ring1 and the reduction of the sums
// are veltracer_row.cuh's, included with its two row-math functions renamed;
// stage_ring1 and cell_terms below take their places.  The whole-plane walk
// only: the halo layer is refused at compile time.

#pragma once

#define stage_ring1 veltracer_stage_ring1
#define cell_terms veltracer_cell_terms
#include "veltracer_row.cuh"
#undef stage_ring1
#undef cell_terms

namespace {

// The terms' factors 0.1 (k + 1), rounded from double as the JAX package's
// Python floats are.
__device__ __forceinline__ float trivial_factor(int k) { return (float)(0.1 * (k + 1)); }

// Nothing to stage: a residual reads its own cell only.  Ends with the
// barrier veltracer_row.cuh's staging ends with.
template <class Args, class Layer = NoHalo>
__device__ __forceinline__ void stage_ring1(const Args&, const RowPlanes&, int, const float*, Ring1&,
                                            const Layer& = Layer()) {
  __syncthreads();
}

// veltracer_row.cuh's cell_terms contract for the trivial row: residual row t
// at the owned cell (i, j), its squares into s (SUMS), and the cell's
// cotangent into d (GRADS): the "cur" adjoint of row t plus the "prev"
// adjoint of row t+1.
template <bool GRADS, bool SUMS, class Args, class Layer = NoHalo>
__device__ __forceinline__ void cell_terms(const Args&, const RowPlanes& P, const Ring1&, int, int, int i, int j,
                                           float u1, const float* g2, float* s, float* d, const Layer& = Layer(),
                                           bool own = true) {
  static_assert(!Layer::on, "mg_trivial_row.cuh: the whole-plane walk only");
  const float u0 = P.U0[i][j];
  const float st = (((((((P.Uc[i][j] + P.Um[i][j]) + P.VXc[i][j]) + P.VXm[i][j]) + P.VYc[i][j]) + P.VYm[i][j]) + u0) + u1);
  if (SUMS) {
#pragma unroll
    for (int k = 0; k < MAXTERMS; ++k) {
      const float q = own ? st * trivial_factor(k) : 0.0f;
      s[k] += q * q;
    }
  }
  if (GRADS) {
    const float sn = (((((((P.Un[i][j] + P.Uc[i][j]) + P.VXn[i][j]) + P.VXc[i][j]) + P.VYn[i][j]) + P.VYc[i][j]) + u0) + u1);
    float w = 0.0f, wn = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXTERMS; ++k) {
      w += g2[k] * (st * trivial_factor(k)) * trivial_factor(k);
      wn += g2[k] * (sn * trivial_factor(k)) * trivial_factor(k);
    }
    d[0] = w + wn;
    d[1] = w + wn;
    d[2] = w + wn;
  }
}

}  // namespace
