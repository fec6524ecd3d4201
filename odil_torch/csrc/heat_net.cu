// The heat row model's 1-D tile kernels (rows1d.cuh, heat_row.cuh) for one
// conductivity net [1, w1, ..., wL, 1], its hidden widths given at build
// time: -DODIL_HEAT_W1=w1 -DODIL_HEAT_W2=w2 -DODIL_HEAT_W3=w3, 0 past the
// last hidden layer (L <= 3).  ops/rowwise.py builds one library per
// net at first use (odil_torch/ops/_build.py, the widths in the library's
// name) for every heat configuration but the default one of rowwise.cu (the
// [1, 5, 5, 1] net with keep_init and keep_frozen on): keep_init and
// keep_frozen are read from the flags word, infer_k off takes the
// true conductivity (built with the default widths).  Nets of more than 48
// params take the wide form (rows1d.cuh, heat_wide.cuh), whose layout
// the build holds to every param owned once (static_assert).
//
// Replaces, for these configurations, the TPU kernels that run the heat row
// function of odil_tpu/models/heat.py:136-250 (its in-kernel jax.vjp): the
// blocked pair _forward_blocked/_backward_blocked
// (odil_tpu/ops/rowwise.py:322, :396), the streaming pair
// _forward_stream/_backward_stream (:616, :690) and, under --halo, the
// blocked pair on the wrapped row function (odil_tpu/halo.py:873-885).  The
// exports are rowwise.cu's odil_rows1d_* with the one row model of id 0.

#include <cuda_runtime.h>

#include "heat_row.cuh"

#if !defined(ODIL_HEAT_W1) || !defined(ODIL_HEAT_W2) || !defined(ODIL_HEAT_W3)
#error "build with -DODIL_HEAT_W1=w1 -DODIL_HEAT_W2=w2 -DODIL_HEAT_W3=w3: the hidden widths, 0 past the last"
#endif

namespace {

// The net of the hidden widths A, B, C without the trailing zeros.
template <int A, int B, int C>
struct NetOf {
  using type = rows1d::HeatNet<A, B, C>;
};
template <int A, int B>
struct NetOf<A, B, 0> {
  using type = rows1d::HeatNet<A, B>;
};
template <int A>
struct NetOf<A, 0, 0> {
  using type = rows1d::HeatNet<A>;
};

struct HeatNetRow : rows1d::HeatModel<NetOf<ODIL_HEAT_W1, ODIL_HEAT_W2, ODIL_HEAT_W3>::type, true> {};

}  // namespace

extern "C" {

// The params of this library's net: the Python side checks them.
int odil_heat_net_params() { return HeatNetRow::NP; }

// The passes a batch of the wide form's param phase (heat_wide.cuh), 0 for
// the register form: ops/rowwise.py sizes the launch's tiles by them.
int odil_heat_wide_rows() { return HeatNetRow::REG_PARAMS ? 0 : HeatNetRow::Wide::RB; }

int odil_rows1d_args_size() { return (int)sizeof(rows1d::Rows1DArgs); }

int odil_rows1d_halo_args_size() { return (int)sizeof(rows1d::Rows1DHaloArgs); }

int odil_rows1d_tile(int what) {
  return what == 0 ? rows1d::TILE : what == 1 ? rows1d::max_slab<HeatNetRow>() : rows1d::NTHREADS;
}

int odil_rows1d_resident_blocks(int model, int mode) {
  return model == 0 ? rows1d::resident<HeatNetRow>(mode) : 0;
}

const char* odil_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int odil_rows1d_forward(int model, const rows1d::Rows1DArgs* a, void* stream) {
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows1d::forward<HeatNetRow, false>(*a, (cudaStream_t)stream);
}

int odil_rows1d_backward(int model, const rows1d::Rows1DArgs* a, int with_sums, void* stream) {
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows1d::backward<HeatNetRow, false>(*a, with_sums, (cudaStream_t)stream);
}

int odil_rows1d_halo_forward(int model, const rows1d::Rows1DHaloArgs* a, void* stream) {
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows1d::forward<HeatNetRow, true>(*a, (cudaStream_t)stream);
}

int odil_rows1d_halo_backward(int model, const rows1d::Rows1DHaloArgs* a, int with_sums, void* stream) {
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows1d::backward<HeatNetRow, true>(*a, with_sums, (cudaStream_t)stream);
}

}  // extern "C"
