// The heat inverse-conductivity residual rows and their adjoint as device
// code for the 1-D row kernels of rows1d.cuh.
//
// The row model is odil_torch/models/heat.py::_make_row_fn with its hand
// adjoint _make_row_vjp: residual row t reads rows t and t-1 of u at x-1, x,
// x+1.  With keep_init the previous row at t == 0 is the linear
// extrapolation to the initial temperature; without it the previous row is
// the periodic row T-1 and fu is zero at t == 0.  The samples past the ends
// are quadratic-half ghosts of a zero wall (ix == 0 first, then ix == N-1).
// The flux uses the conductivity k at the two faces, either a tanh network
// [1, w1, ..., wL, 1] of the params squashed by kmax * sigmoid (infer_k) or
// the true conductivity.  d/dparams passes through k at both faces.  With
// keep_frozen the face temperatures are frozen, so d/du does not pass
// through k; without it each face temperature (a quarter of four imposed
// samples) takes the cotangent of its conductivity times dk/du, which the
// face phase forms by a tangent pass beside the network's forward pass.
// Terms, in order: fu, then imp (data rows imp_mask, imp_u), xreg and treg
// (const (1, 1) weights kx, kt, read on the device so that the epoch's
// annealing reaches them), each where its flag is set.
//
// Scalars: s[0] = 1/dt, s[1] = 1/dx, s[2] = 1/(2 dx), s[3] = imp weight,
// s[4] = kmax.  Consts: u0 at x, at x-1, at x+1, ix (unused: the kernel knows
// x), kx, kt.  Params: the layers' weights (out, in) row-major in order, then
// their biases, flat (the default net: W1 (5,1), W2 (5,5), W3 (1,5), b1 (5),
// b2 (5), b3 (1)).
//
// Two builds of one template (HeatModel<NET, RUNTIME_KEEP>):
//   - HeatRow, in rowwise.cu: the [1, 5, 5, 1] net with keep_init and
//     keep_frozen compiled in (the flags word must carry both), the
//     network's activations kept per face and the param cotangents summed
//     per thread in registers (pacc of rows1d.cuh);
//   - heat_net.cu, one library per net (its hidden widths a macro, built at
//     first use by ops/rowwise.py): keep_init and keep_frozen read from the
//     flags word, dk/du per face view.  Nets of at most 48 params keep the
//     register form; larger ones (up to 3 hidden layers of 32 units, 2209
//     params) the wide form of rows1d.cuh and heat_wide.cuh: the face
//     phase runs a face's net a thread in registers with the weights in
//     16-byte loads (face_wide) and keeps k, u and dk only; the param phase
//     records batches of face passes (each layer's inputs and output
//     cotangents) and forms the param cotangents as products over them, each
//     param owned by one thread's register tile (a fixed order: no atomics).
//
// The face form.  Cell x's right-face temperature (s2 + s0)/4 and cell
// x+1's left-face temperature (s0' + s1')/4 add the same two sums, so
// wherever the two cells impose the same samples (every interior face but
// row 0 with initial temperatures that disagree, which the plain version
// allows) they have the same bits and one network pass serves both; the
// kernel checks the bits.  The wall faces of the periodic seam (the ghosts
// of x = N-1 and x = 0) belong to one cell each and keep their own pass.
// The face adjoint adds the two cells' conductivity cotangents, left then
// right, and runs one param adjoint.  Without keep_frozen each cell adds its
// own faces' input cotangents into its samples (dk of the view it sees).
// The plain version of this order is models/heat.py::_make_row_vjp(faces=True).
//
// Operations per residual cell of the default net (backward, infer_k; a
// multiply-add counted as two and a tanhf or expf as one, as heat_ops in
// chip_smoke.py counts them for any net): one network pass per face (84) and
// its face temperature (3), one param adjoint per face (170), the stencil
// and its adjoint (~55), the gather (6): about 320 fp32 operations against
// ~20 bytes a cell (the field, the measured data rows, dfields).  On the
// H100 the two bounds are about equal (0.005 ms at 1024^2); the kernel is
// held back by neither but by the latency of its phases (PERF.md §6-§7).
// A wide net is bound by operations: [1, 16, 16, 16, 1] without keep_frozen
// about 4200 a cell (heat_ops, which counts a tanh as one; tanhf issues
// about 20 instructions, the wide form's tanh_fast 7).  The wide form
// (heat_wide.cuh) issues a 16-byte weight load a 4 FFMA (8 beside the
// tangent) and a record load a 4 FFMA; the latency of its chains, not its
// loads, sets its time (PERF.md §6).

#pragma once

#include "heat_wide.cuh"
#include "rows1d.cuh"

namespace rows1d {

// A conductivity net [1, W..., 1]: tanh hidden layers of widths W, a linear
// output.  Layer l maps width(l) units to width(l + 1).
template <int... W>
struct HeatNet {
  static constexpr int NH = sizeof...(W);  // hidden layers
  static constexpr int NL = NH + 1;        // layers
  static_assert(NH >= 1, "the heat kernels take nets of at least one hidden layer");
  __host__ __device__ static constexpr int width(int l) {
    constexpr int w[] = {1, W..., 1};
    return w[l];
  }
  // The offsets of layer l's weights and biases in the flat params.
  __host__ __device__ static constexpr int woff(int l) {
    int n = 0;
    for (int k = 0; k < l; ++k) n += width(k) * width(k + 1);
    return n;
  }
  static constexpr int NW = woff(NL);
  __host__ __device__ static constexpr int boff(int l) {
    int n = NW;
    for (int k = 0; k < l; ++k) n += width(k + 1);
    return n;
  }
  static constexpr int NP = boff(NL);
  __host__ __device__ static constexpr int max_width() {
    int m = 1;
    for (int l = 1; l < NL; ++l) m = width(l) > m ? width(l) : m;
    return m;
  }
  static constexpr int MAXW = max_width();
};

// The hidden activations at one face temperature, and the sigmoid.
template <class NET>
struct NetAct {
  float h[NET::NH][NET::MAXW];
  float s;
};

// The input of layer L's unit i.
template <class NET, int L>
__device__ __forceinline__ float layer_in(float x, const float (&h)[NET::NH][NET::MAXW], int i) {
  if constexpr (L == 0) return x;
  else return h[L - 1][i];
}

// The net's output before the sigmoid at x; the hidden activations into h.
template <class NET, int L = 0>
__device__ __forceinline__ float net_out(const float* P, float x, float (&h)[NET::NH][NET::MAXW]) {
  constexpr int NI = NET::width(L), NO = NET::width(L + 1), WO = NET::woff(L), BO = NET::boff(L);
  if constexpr (L + 1 == NET::NL) {
    float acc = P[BO];
#pragma unroll
    for (int i = 0; i < NI; ++i) acc = acc + P[WO + i] * layer_in<NET, L>(x, h, i);
    return acc;
  } else {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float acc = P[BO + o];
#pragma unroll
      for (int i = 0; i < NI; ++i) acc = acc + P[WO + NI * o + i] * layer_in<NET, L>(x, h, i);
      h[L][o] = tanhf(acc);
    }
    return net_out<NET, L + 1>(P, x, h);
  }
}

// net_out with its derivative by x (forward mode): the hidden tangents into
// t, the output's into tout.
template <class NET, int L = 0>
__device__ __forceinline__ float net_out_tangent(const float* P, float x, float (&h)[NET::NH][NET::MAXW],
                                                 float (&t)[NET::NH][NET::MAXW], float& tout) {
  constexpr int NI = NET::width(L), NO = NET::width(L + 1), WO = NET::woff(L), BO = NET::boff(L);
  auto tin = [&](int i) {
    if constexpr (L == 0) return 1.0f;
    else return t[L - 1][i];
  };
  if constexpr (L + 1 == NET::NL) {
    float acc = P[BO], tacc = 0.0f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      acc = acc + P[WO + i] * layer_in<NET, L>(x, h, i);
      tacc += P[WO + i] * tin(i);
    }
    tout = tacc;
    return acc;
  } else {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float acc = P[BO + o], tacc = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        acc = acc + P[WO + NI * o + i] * layer_in<NET, L>(x, h, i);
        tacc += P[WO + NI * o + i] * tin(i);
      }
      const float v = tanhf(acc);
      h[L][o] = v;
      t[L][o] = (1.0f - v * v) * tacc;
    }
    return net_out_tangent<NET, L + 1>(P, x, h, t, tout);
  }
}

// Adds the param cotangents of layer L and the layers below it to pacc, ga
// being the cotangents of layer L's outputs.
template <class NET, int L>
__device__ __forceinline__ void net_vjp(const float* P, float x, const float (&h)[NET::NH][NET::MAXW],
                                        const float (&ga)[NET::width(L + 1)], float* pacc) {
  constexpr int NI = NET::width(L), NO = NET::width(L + 1), WO = NET::woff(L), BO = NET::boff(L);
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    pacc[BO + o] += ga[o];
#pragma unroll
    for (int i = 0; i < NI; ++i) pacc[WO + NI * o + i] += ga[o] * layer_in<NET, L>(x, h, i);
  }
  if constexpr (L > 0) {
    float gb[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float gin;
      if constexpr (NO == 1) {
        gin = ga[0] * P[WO + i];
      } else {
        gin = 0.0f;
#pragma unroll
        for (int o = 0; o < NO; ++o) gin += P[WO + NI * o + i] * ga[o];
      }
      gb[i] = gin * (1.0f - h[L - 1][i] * h[L - 1][i]);
    }
    net_vjp<NET, L - 1>(P, x, h, gb, pacc);
  }
}

// What the face phase keeps of a face: k[0] as its left cell sees it (that
// cell's right face), k[1] as its right cell does, their temperatures u;
// dk/du of both views where keep_frozen is read at run time; and the
// network's activations at u[0] for the param adjoint in the register form.
template <class ACT, bool DK, bool ACTS>
struct HeatFace {
  float k[2], u[2];
  ACT n;  // 15 floats with the default net: an odd stride, so a warp reads its faces without bank conflicts
};
template <class ACT>
struct HeatFace<ACT, true, true> {
  float k[2], u[2], dk[2];
  ACT n;
};
template <class ACT>
struct HeatFace<ACT, true, false> {
  float k[2], u[2], dk[2], pad;
};

template <class NET, bool RUNTIME_KEEP>
struct HeatModel {
  static constexpr int NF = 1, HIST = 1, MAXT = 4, NP = NET::NP;
  static constexpr unsigned DUSED = 0x3f;  // every sample of both rows
  // The param cotangents per thread in registers up to 48 params (the
  // default net's 46), else the wide form (rows1d.cuh, heat_wide.cuh): two
  // blocks an SM for nets of at most 16 units a layer (a pass's registers
  // and its records in 70 KB beside the tile's 37 KB), else one (two layers
  // of 32 units and their tangents take 128 registers).
  static constexpr bool REG_PARAMS = NP <= 48;
  static constexpr int BLOCKS_PER_SM = !REG_PARAMS ? (NET::MAXW <= 16 ? 2 : 1) : RUNTIME_KEEP ? 1 : 2;
  static constexpr bool FACES = true;
  enum { HAS_IMP = 1, HAS_X = 2, HAS_T = 4, INFER_K = 8, KEEP_INIT = 16, KEEP_FROZEN = 32 };
  using Act = NetAct<NET>;
  using Face = HeatFace<Act, RUNTIME_KEEP, REG_PARAMS>;
  static constexpr int WIDE_SLAB = 14;
  using Wide = WideNet<NET, NTHREADS, NET::MAXW <= 16 ? 70000 : 170000>;

  // Whether a launch's arguments are this build's: the compiled-in keep
  // flags, and the net's params.
  static bool takes(const Rows1DArgs& A) {
    if (!RUNTIME_KEEP && !((A.flags & KEEP_INIT) && (A.flags & KEEP_FROZEN))) return false;
    return !(A.flags & INFER_K) || A.nparams == NP;
  }

  __device__ __forceinline__ static bool keep_init(const Rows1DArgs& A) {
    if constexpr (RUNTIME_KEEP) return (A.flags & KEEP_INIT) != 0;
    else return true;
  }

  // The imposed samples of cell x in rows it (a, c) and it-1 (b, p).
  struct Cell {
    float a0, b0, c1, c2, p1, p2;
  };

  __device__ __forceinline__ static Cell cell_at(const Rows1DArgs& A, int it, int x, const float (&v)[2][1][3]) {
    const bool first = it == 0 && keep_init(A), left = x == 0, right = x == A.N - 1;
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
  __device__ __forceinline__ static float k_of(const Rows1DArgs& A, const float* P, float x, Act& n, bool infer) {
    if (!infer) {
      const float d = x - 0.5f;
      return 0.02f * expf(-(d * d) * 20.0f);
    }
    const float acc = net_out<NET>(P, x, n.h);
    n.s = 1.0f / (1.0f + expf(-acc));
    return n.s * A.s[4];
  }

  // k_of and dk/dx into dk.
  __device__ __forceinline__ static float k_dk(const Rows1DArgs& A, const float* P, float x, Act& n, bool infer,
                                               float& dk) {
    if (!infer) {
      const float d = x - 0.5f;
      const float k = 0.02f * expf(-(d * d) * 20.0f);
      dk = k * (-40.0f * d);
      return k;
    }
    float t[NET::NH][NET::MAXW], tout;
    const float acc = net_out_tangent<NET>(P, x, n.h, t, tout);
    n.s = 1.0f / (1.0f + expf(-acc));
    dk = A.s[4] * (n.s * (1.0f - n.s)) * tout;
    return n.s * A.s[4];
  }

  // Adds the param cotangents of gk * k(x) to pacc (the register form).
  __device__ __forceinline__ static void k_vjp(const float* P, float x, const Act& n, float gk, float kmax,
                                               float* pacc) {
    const float go[1] = {gk * kmax * (n.s * (1.0f - n.s))};
    net_vjp<NET, NET::NL - 1>(P, x, n.h, go, pacc);
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
    if constexpr (!REG_PARAMS) {
      face_wide<ADJ>(A, P, it, xa, va, xb, vb, lview, rview, F);
      return;
    }
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
    Act n;
    float k0, k1;
    if constexpr (RUNTIME_KEEP) {
      float dk0 = 0.0f, dk1 = 0.0f;
      if (ADJ && !(A.flags & KEEP_FROZEN)) {
        k0 = k_dk(A, P, lview ? uL : uR, n, infer, dk0);
        k1 = k0;
        dk1 = dk0;
        if (lview && rview && !shared) {
          Act m;
          k1 = k_dk(A, P, uR, m, infer, dk1);
        }
      } else {
        k0 = k_of(A, P, lview ? uL : uR, n, infer);
        k1 = k0;
        if (lview && rview && !shared) {
          Act m;
          k1 = k_of(A, P, uR, m, infer);
        }
      }
      F.dk[0] = dk0;
      F.dk[1] = dk1;
    } else {
      k0 = k_of(A, P, lview ? uL : uR, n, infer);
      k1 = k0;
      if (lview && rview && !shared) {
        Act m;
        k1 = k_of(A, P, uR, m, infer);
      }
    }
    F.k[0] = k0;
    F.k[1] = k1;
    F.u[0] = uL;
    F.u[1] = uR;
    if constexpr (REG_PARAMS) {
      if (ADJ) F.n = n;
    }
  }

  // face() of the wide form (P: its weights, heat_wide.cuh): the net of the
  // first view in registers (its tangent beside it with ADJ and keep_frozen
  // off), the second view's where the two differ.
  template <bool ADJ>
  __device__ __forceinline__ static void face_wide(const Rows1DArgs& A, const float* P, int it, int xa,
                                                   const float (&va)[2][1][3], int xb, const float (&vb)[2][1][3],
                                                   bool lview, bool rview, Face& F) {
    float uL = 0.0f, uR = 0.0f;
    if (lview) {
      const Cell c = cell_at(A, it, xa, va);
      uL = ((c.c2 + c.p2) + (c.a0 + c.b0)) * 0.25f;
    }
    if (rview) {
      const Cell c = cell_at(A, it, xb, vb);
      uR = ((c.a0 + c.b0) + (c.c1 + c.p1)) * 0.25f;
    }
    const bool second = lview && rview && !(xb != 0 && __float_as_uint(uL) == __float_as_uint(uR));
    const bool tan = ADJ && !(A.flags & KEEP_FROZEN), infer = A.flags & INFER_K;
    for (int view = 0; view < 2; ++view) {
      if (view == 1 && !second) {
        F.k[1] = F.k[0];
        F.dk[1] = F.dk[0];
        break;
      }
      const float x = view == 0 && lview ? uL : uR;
      float k, dk = 0.0f;
      if (!infer) {
        const float d = x - 0.5f;
        k = 0.02f * expf(-(d * d) * 20.0f);
        if (tan) dk = k * (-40.0f * d);
      } else {
        float tout = 0.0f, hl[Wide::MW];
        const float acc = tan ? Wide::template net<true, false>(P, x, tout, nullptr, hl)
                              : Wide::template net<false, false>(P, x, tout, nullptr, hl);
        const float s = 1.0f / (1.0f + expf(-acc));
        k = s * A.s[4];
        if (tan) dk = A.s[4] * (s * (1.0f - s)) * tout;
      }
      F.k[view] = k;
      F.dk[view] = dk;
    }
    F.u[0] = uL;
    F.u[1] = uR;
  }

  // Adds the param cotangents of a face (the register form): gl from the
  // cell on its left (of its right face), gr from the cell on its right (of
  // its left face); one adjoint of their sum where both saw the same
  // temperature, else one each (the network's activations at u[1]
  // recomputed).
  __device__ __forceinline__ static void face_vjp(const Rows1DArgs& A, const float* P, const Face& F, bool shared,
                                                  float gl, float gr, float* pacc) {
    const float kmax = A.s[4];
    k_vjp(P, F.u[0], F.n, shared ? gl + gr : gl, kmax, pacc);
    if (!shared && gr != 0.0f) {
      Act m;
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
    const bool ki = keep_init(A);
    const bool has_imp = A.flags & HAS_IMP, has_x = A.flags & HAS_X, has_t = A.flags & HAS_T;
    const Cell c = cell_at(A, it, x, v);
    const float a0 = c.a0, b0 = c.b0;
    const float s0 = a0 + b0, s1 = c.c1 + c.p1, s2 = c.c2 + c.p2;
    const float du_m = (s0 - s1) * inv_2dx, du_p = (s2 - s0) * inv_2dx;
    const float km = fl.k[1], kp = fr.k[0];
    float fu = (a0 - b0) * inv_dt - (du_p * kp - du_m * km) * inv_dx;
    if (!ki && first) fu = 0.0f;

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
      float gs0 = (g_dum - g_dup) * inv_2dx, gs1 = -g_dum * inv_2dx, gs2 = g_dup * inv_2dx;
      if constexpr (RUNTIME_KEEP) {
        if (!(A.flags & KEEP_FROZEN)) {  // the face temperatures (s0 + s1)/4 and (s2 + s0)/4
          const float gum = w0 * du_m * inv_dx * fl.dk[1] * 0.25f, gup = -w0 * du_p * inv_dx * fr.dk[0] * 0.25f;
          gs0 += gum + gup;
          gs1 += gum;
          gs2 += gup;
        }
      }
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
      if (first && ki) {  // the previous row is 2 u0 - the current one
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

// The default: the [1, 5, 5, 1] net with keep_init and keep_frozen on, in
// rowwise.cu (model id 0).
struct HeatRow : HeatModel<HeatNet<5, 5>, false> {};

}  // namespace rows1d
