// The heat row model's wide conductivity nets (more than 48 params, up to
// three hidden tanh layers of 32 units): the engine of the 1-D tile
// kernel's param form for those nets (rows1d.cuh, REG_PARAMS false;
// heat_row.cuh's HeatModel).
//
// What bounds it.  A face's net is a chain of small dense layers, about
// 2 W FFMA a pass for W weights (twice that with its tangent or its
// adjoint) and a tanh a unit, and its param cotangents are a sum over a
// tile's faces of outer products of the layers' output cotangents and
// inputs: a thousand or more params, beyond a thread's registers.  The form
// before this one ran the nets as scalar chains that read each weight with
// its own LDS and summed the outer products a param at a time, two LDS a
// FFMA.  Here:
//   - a thread runs its face's net (forward, beside it the tangent d/du or
//     after it the adjoint) in registers, the weights in 16-byte loads, each
//     feeding 4 FFMA (8 beside the tangent): W_l row-major, its rows padded
//     to a multiple of 4 with zeros, the biases after.  The face phase takes
//     a face a thread and has no barrier;
//   - the param phase records a batch of RB face passes (a pass a thread):
//     each layer's inputs H_l (its units, a row of ones for the biases,
//     zeros to a multiple of 4) and its output cotangents G_l, feature-major
//     ([feature][pass], RB + 4 floats a row: a stride of 4 banks, so the 8
//     rows a warp reads at once fall on distinct banks);
//   - then dW_l[o][i] += sum_r G_l[o][r] H_l[i][r] as products over the
//     batch: a job a 2x2 register tile of (outputs, inputs and bias), 4
//     16-byte loads a block of 4 passes for 16 FFMA, a thread's jobs fixed
//     (tid, tid + 256, ...: 186 jobs for [1, 16, 16, 16, 1], 626 for three
//     layers of 32), so that its tiles sum in fp32 over a tile's batches in
//     registers and go into the block's fp64 sums once a tile, each param by
//     its one owner: no atomics, no shuffles, the bits repeat.
// The face phase's activations are not kept: the param phase runs each
// owned face's forward again for its record (a third of that phase's FFMA),
// where keeping them would hold up to 96 floats a face and cut the slab to
// a few rows.  A copy that stores the records without that rerun
// (tools/time_row_kernels.py ablations) times the most that keeping them
// could gain; PERF.md §6 has it.  Measured on the H100 (PERF.md §6), the
// loads do not bound it: with its weights as immediates (no weight load at all) the
// [1, 16, 16, 16, 1] backward at 1024^2 runs its face and param phases only
// about 20% faster.  Its warps issue about an instruction every 8 clocks:
// the chains of the nets (FFMA, then tanh_fast's two MUFU) and the batches'
// barriers set its time.
//
// Replaces nothing of the TPU on its own: it is the net of the heat row
// function (odil_tpu/models/heat.py:136-250) inside the kernels that
// rows1d.cuh says it replaces.

#pragma once

#include <cuda_runtime.h>

namespace rows1d {

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// tanh(x) as (1 - e) / (1 + e) with e = e^(-2|x|), by the hardware's exp2
// and reciprocal, with the sign of x: 7 instructions where tanhf takes about
// 20 and a branch.  Its error is absolute, about that of e near 1: near 0,
// where 1 - e cancels, its relative error grows as 1/|x| (tanhf's does
// not).  A layer sums its units' values into the next, so the absolute
// error is what reaches the net's output.  PERF.md §6 has both errors
// against fp64 tanh on the H100 (tools/time_row_kernels.py tanh) and the
// kernels' times with tanhf.  A pass of a wide net takes up to 96 of them.
__device__ __forceinline__ float tanh_fast(float x) {
  const float e = __expf(-2.0f * fabsf(x));
  return copysignf(__fdividef(1.0f - e, 1.0f + e), x);
}

// NET: rows1d::HeatNet<W...> (heat_row.cuh); NTHR: the block's threads;
// BUDGET: the bytes its weights, sums and records may take.
template <class NET, int NTHR, int BUDGET>
struct WideNet {
  static constexpr int NL = NET::NL, NP = NET::NP, MW = round4(NET::MAXW);
  __host__ __device__ static constexpr int ni(int l) { return NET::width(l); }
  __host__ __device__ static constexpr int no(int l) { return NET::width(l + 1); }
  // Layer l's input block of a record: its ni(l) units, the ones row, zeros
  // to a multiple of 4; its output cotangents' block: nop(l) rows (4 for the
  // output layer: its one cotangent, zeros).
  __host__ __device__ static constexpr int ki(int l) { return round4(ni(l) + 1); }
  __host__ __device__ static constexpr int nop(int l) { return round4(no(l)); }
  __host__ __device__ static constexpr int nip(int l) { return round4(ni(l)); }

  // The weights in shared memory (floats): layer l's W_l, no(l) rows of
  // nip(l) (zeros past ni(l)), then its biases, nop(l) (zeros past no(l)).
  __host__ __device__ static constexpr int w_off(int l) {
    int n = 0;
    for (int k = 0; k < l; ++k) n += no(k) * nip(k) + nop(k);
    return n;
  }
  __host__ __device__ static constexpr int b_off(int l) { return w_off(l) + no(l) * nip(l); }
  static constexpr int NWTS = w_off(NL);

  // A record's rows: H_0 .. H_(NL-1), then G_0 .. G_(NL-1).
  __host__ __device__ static constexpr int h_off(int l) {
    int n = 0;
    for (int k = 0; k < l; ++k) n += ki(k);
    return n;
  }
  __host__ __device__ static constexpr int g_off(int l) {
    int n = h_off(NL);
    for (int k = 0; k < l; ++k) n += nop(k);
    return n;
  }
  static constexpr int ROWS = g_off(NL);

  // Passes a batch: the most of NTHR, NTHR / 2, ..., 64 whose records fit
  // the budget beside the weights and the fp64 sums.
  __host__ __device__ static constexpr int pick_rb() {
    for (int rb = NTHR; rb > 64; rb /= 2) {
      if (4 * NWTS + 8 * NP + 4 * ROWS * (rb + 4) <= BUDGET) return rb;
    }
    return 64;
  }
  static constexpr int RB = pick_rb(), RS = RB + 4;
  static_assert(RB % 32 == 0 && RB <= NTHR, "a pass a thread, a multiple of the warp");

  template <bool GRADS>
  struct Smem {
    alignas(16) float wts[NWTS];
    double acc[GRADS ? NP : 1];                               // the block's param cotangents
    alignas(16) float rec[GRADS ? ROWS : 1][GRADS ? RS : 4];  // a batch's records
    float sx[GRADS ? RB : 1], sg[GRADS ? RB : 1];             // a batch's second views: input, cotangent
    int cnt[2][NTHR / 32];                                    // second views a warp, by batch parity
  };

  // The flat param of layer l's (o, i): i < ni(l) a weight, i == ni(l) the bias.
  __host__ __device__ static constexpr int pidx(int l, int o, int i) {
    return i < ni(l) ? NET::woff(l) + ni(l) * o + i : NET::boff(l) + o;
  }

  // The jobs of the param products: layer l's 2x2 tiles of (o, i) (o over
  // its outputs, i over its input block), numbered layer after layer; job
  // `job` of layer l holds (o, i) = (job % ob(l) + ob(l) jo, job / ob(l) +
  // ib(l) ji); its slot (jo, ji)'s flat param, -1 on a padding row or column.
  __host__ __device__ static constexpr int ob(int l) { return (no(l) + 1) / 2; }
  __host__ __device__ static constexpr int ib(int l) { return ki(l) / 2; }
  __host__ __device__ static constexpr int jobs(int l) { return ob(l) * ib(l); }
  __host__ __device__ static constexpr int job_off(int l) {
    int n = 0;
    for (int k = 0; k < l; ++k) n += jobs(k);
    return n;
  }
  static constexpr int JOBS = job_off(NL), JPT = (JOBS + NTHR - 1) / NTHR;  // jobs, jobs a thread
  __host__ __device__ static constexpr int tile_param(int l, int job, int jo, int ji) {
    const int o = job % ob(l) + ob(l) * jo, i = job / ob(l) + ib(l) * ji;
    return o < no(l) && i <= ni(l) ? pidx(l, o, i) : -1;
  }

  // Each flat param in one slot of one job of its own layer, and the
  // weights, sums and records within the budget: the build fails where the
  // layout does not hold them.
  __host__ __device__ static constexpr bool owns_each_param_once() {
    int count[NP] = {};
    for (int l = 0; l < NL; ++l) {
      for (int job = 0; job < jobs(l); ++job) {
        for (int slot = 0; slot < 4; ++slot) {
          const int p = tile_param(l, job, slot / 2, slot % 2);
          if (p >= 0) {
            const bool w = p >= NET::woff(l) && p < NET::woff(l + 1), b = p >= NET::boff(l) && p < NET::boff(l + 1);
            if (!w && !b) return false;
            ++count[p];
          }
        }
      }
    }
    for (int p = 0; p < NP; ++p) {
      if (count[p] != 1) return false;
    }
    return true;
  }
  static_assert(owns_each_param_once(), "the param products own each param once");
  static_assert(4 * NWTS + 8 * NP + 4 * ROWS * RS <= BUDGET, "the weights, sums and records fit the budget");

  // Stages the weights from the param tensors (the layers' weights, then
  // their biases) and zeroes the sums.
  template <bool GRADS, class Args>
  __device__ __forceinline__ static void stage(const Args& A, Smem<GRADS>& w) {
    const int tid = threadIdx.x;
    if (A.nparams == NP) {
      for (int e = tid; e < NWTS; e += NTHR) {
        float v = 0.0f;
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          const int d = e - w_off(l), nw = no(l) * nip(l);
          if (d >= 0 && d < nw && d % nip(l) < ni(l)) v = __ldg(A.params[l] + d / nip(l) * ni(l) + d % nip(l));
          if (d >= nw && d < nw + no(l)) v = __ldg(A.params[NL + l] + d - nw);
        }
        w.wts[e] = v;
      }
    }
    if constexpr (GRADS) {
      for (int p = tid; p < NP; p += NTHR) w.acc[p] = 0.0;
    }
  }

  // The rank of this thread's flag among those of the threads before it,
  // after `cnt` holds every warp's count (a barrier between); and the total.
  __device__ __forceinline__ static int rank(const int* cnt, unsigned ballot, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int before = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < NTHR / 32; ++w) {
      before += w < warp ? cnt[w] : 0;
      total += cnt[w];
    }
    return before + __popc(ballot & ((1u << lane) - 1u));
  }

  // Hidden layer L of a face's net from its inputs h (and tangents t with
  // TAN) into ho (to); with REC its outputs into rec, this pass's column of
  // layer L + 1's input block (then the ones row and the zeros).
  template <int L, bool TAN, bool REC>
  __device__ __forceinline__ static void hidden(const float* wts, const float (&h)[MW], const float (&t)[MW],
                                                float (&ho)[MW], float (&to)[MW], float* rec) {
    constexpr int NI = ni(L), NIP = nip(L), NO = no(L);
    const float* W = wts + w_off(L);
    const float* B = wts + b_off(L);
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float acc = B[o], tacc = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; i += 4) {
        const float4 w = ld4(W + o * NIP + i);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (i + k < NI) {
            acc = fmaf(wv[k], h[i + k], acc);
            if (TAN) tacc = fmaf(wv[k], t[i + k], tacc);
          }
        }
      }
      const float v = tanh_fast(acc);
      ho[o] = v;
      if (TAN) to[o] = (1.0f - v * v) * tacc;
      if (REC) rec[o * RS] = v;
    }
    if (REC) {
#pragma unroll
      for (int k = NO; k < ki(L + 1); ++k) rec[k * RS] = k == NO ? 1.0f : 0.0f;
    }
  }

  // Layers L .. NL - 1 of a face's net: the output layer's sum (before the
  // sigmoid), its derivative by u into tout with TAN; with REC the layers'
  // inputs into the record column rec and the last hidden layer into hl.
  template <int L, bool TAN, bool REC>
  __device__ __forceinline__ static float layers(const float* wts, const float (&h)[MW], const float (&t)[MW],
                                                 float& tout, float* rec, float (&hl)[MW]) {
    if constexpr (L == NL - 1) {
      const float* W = wts + w_off(L);
      float acc = wts[b_off(L)], tacc = 0.0f;
#pragma unroll
      for (int i = 0; i < ni(L); i += 4) {
        const float4 w = ld4(W + i);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (i + k < ni(L)) {
            acc = fmaf(wv[k], h[i + k], acc);
            if (TAN) tacc = fmaf(wv[k], t[i + k], tacc);
            if (REC) hl[i + k] = h[i + k];
          }
        }
      }
      tout = tacc;
      return acc;
    } else {
      float ho[MW], to[MW];
      hidden<L, TAN, REC>(wts, h, t, ho, to, rec + h_off(L + 1) * RS);
      return layers<L + 1, TAN, REC>(wts, ho, to, tout, rec, hl);
    }
  }

  // A face's net at x: the output layer's sum before the sigmoid; with TAN
  // its derivative by x into tout; with REC the record of every layer's
  // inputs into rec (this pass's column) and the last hidden layer into hl.
  template <bool TAN, bool REC>
  __device__ __forceinline__ static float net(const float* wts, float x, float& tout, float* rec, float (&hl)[MW]) {
    constexpr int NO = no(0);
    const float* W = wts + w_off(0);  // layer 0: one input, rows of 4 (w, 0, 0, 0)
    const float* B = wts + b_off(0);
    float h[MW], t[MW];
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const float v = tanh_fast(fmaf(W[4 * o], x, B[o]));
      h[o] = v;
      if (TAN) t[o] = (1.0f - v * v) * W[4 * o];
    }
    if (REC) {
      rec[0] = x;
      rec[RS] = 1.0f;
      rec[2 * RS] = 0.0f;
      rec[3 * RS] = 0.0f;
#pragma unroll
      for (int k = 0; k < ki(1); ++k) rec[(h_off(1) + k) * RS] = k < NO ? h[k] : k == NO ? 1.0f : 0.0f;
    }
    return layers<1, TAN, REC>(wts, h, t, tout, rec, hl);
  }

  // Writes G_L (g) into the record column rec and back-propagates below
  // layer L: G_(L-1)[i] = (sum_o W_L[o][i] G_L[o]) (1 - H_L[i]^2), H_L read
  // back from the record.
  template <int L>
  __device__ __forceinline__ static void back_from(const float* wts, float* rec, const float (&g)[MW]) {
    constexpr int NO = no(L), NI = ni(L), NIP = nip(L);
    float* G = rec + g_off(L) * RS;
#pragma unroll
    for (int o = 0; o < nop(L); ++o) G[o * RS] = o < NO ? g[o] : 0.0f;
    if constexpr (L > 0) {
      const float* W = wts + w_off(L);
      const float* H = rec + h_off(L) * RS;
      float gi[MW];
#pragma unroll
      for (int i = 0; i < MW; ++i) gi[i] = 0.0f;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
#pragma unroll
        for (int i = 0; i < NI; i += 4) {
          const float4 w = ld4(W + o * NIP + i);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (i + k < NI) gi[i + k] = fmaf(wv[k], g[o], gi[i + k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float v = H[i * RS];
        gi[i] *= 1.0f - v * v;
      }
      back_from<L - 1>(wts, rec, gi);
    }
  }

  // The param cotangents of a batch's records (nrb blocks of 4 passes) into
  // a thread's tiles a (fp32, its jobs tid, tid + NTHR, ...):
  // a[q][jo][ji] += sum_r G_l[o][r] H_l[i][r], 4 16-byte loads a block of
  // passes for 16 FFMA.  No barrier: the jobs read the records and write
  // their own tiles.
  __device__ __forceinline__ static void products(const float* rec, int nrb, float (&a)[JPT][2][2]) {
#pragma unroll
    for (int q = 0; q < JPT; ++q) {
      const int j = threadIdx.x + q * NTHR;
      if (j < JOBS) {
        int job = 0, obl = 1, ibl = 1, g = 0, h = 0;
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          if (j >= job_off(l) && j < job_off(l + 1)) {
            job = j - job_off(l);
            obl = ob(l);
            ibl = ib(l);
            g = g_off(l);
            h = h_off(l);
          }
        }
        const float* G0 = rec + (g + job % obl) * RS;
        const float* H0 = rec + (h + job / obl) * RS;
        const float* G1 = G0 + obl * RS;
        const float* H1 = H0 + ibl * RS;
#pragma unroll 4
        for (int rb = 0; rb < nrb; ++rb) {
          const float4 gv[2] = {ld4(G0 + 4 * rb), ld4(G1 + 4 * rb)}, hv[2] = {ld4(H0 + 4 * rb), ld4(H1 + 4 * rb)};
#pragma unroll
          for (int jo = 0; jo < 2; ++jo) {
#pragma unroll
            for (int ji = 0; ji < 2; ++ji) {
              float v = a[q][jo][ji];
              v = fmaf(gv[jo].x, hv[ji].x, v);
              v = fmaf(gv[jo].y, hv[ji].y, v);
              v = fmaf(gv[jo].z, hv[ji].z, v);
              v = fmaf(gv[jo].w, hv[ji].w, v);
              a[q][jo][ji] = v;
            }
          }
        }
      }
    }
  }

  // A tile's param cotangents (a, summed in fp32 over its batches) into the
  // block's fp64 sums, a param by its one owner; a zeroed for the next tile.
  __device__ __forceinline__ static void flush(double* acc, float (&a)[JPT][2][2]) {
#pragma unroll
    for (int q = 0; q < JPT; ++q) {
      const int j = threadIdx.x + q * NTHR;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (j >= job_off(l) && j < job_off(l + 1)) {
#pragma unroll
          for (int jo = 0; jo < 2; ++jo) {
#pragma unroll
            for (int ji = 0; ji < 2; ++ji) {
              const int p = tile_param(l, j - job_off(l), jo, ji);
              if (p >= 0) acc[p] += (double)a[q][jo][ji];
            }
          }
        }
      }
#pragma unroll
      for (int jo = 0; jo < 2; ++jo) a[q][jo][0] = a[q][jo][1] = 0.0f;
    }
  }

  // Param phase: the param cotangents of n passes (this thread's pass tid <
  // n: input x, conductivity cotangent g), kmax * sigmoid the net's head,
  // into the tiles a.  Every thread calls it; it ends with a barrier.
  __device__ __forceinline__ static void grads(Smem<true>& w, int n, float x, float g, float kmax,
                                               float (&a)[JPT][2][2]) {
    const int tid = threadIdx.x, nrb = (n + 3) / 4;
    float* rec = &w.rec[0][0] + tid;
    if (tid < n) {
      float hl[MW], tout;
      const float acc = net<false, true>(w.wts, x, tout, rec, hl);
      const float s = 1.0f / (1.0f + expf(-acc)), go = g * kmax * (s * (1.0f - s));
      constexpr int LO = NL - 1;
      const float* W = w.wts + w_off(LO);
      float gl[MW];  // G_(NL-2): the last hidden layer's output cotangents
#pragma unroll
      for (int i = 0; i < MW; ++i) gl[i] = i < ni(LO) ? go * W[i] * (1.0f - hl[i] * hl[i]) : 0.0f;
      float* G = rec + g_off(LO) * RS;
      G[0] = go;
      G[RS] = G[2 * RS] = G[3 * RS] = 0.0f;
      back_from<LO - 1>(w.wts, rec, gl);
    } else if (tid < 4 * nrb) {  // the padding passes of the last block: zeros
      for (int k = 0; k < ROWS; ++k) rec[k * RS] = 0.0f;
    }
    __syncthreads();
    products(&w.rec[0][0], nrb, a);
    __syncthreads();
  }
};

}  // namespace rows1d
