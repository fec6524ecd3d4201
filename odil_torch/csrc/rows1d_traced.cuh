// What the row models that odil_torch/ops/rowtrace.py generates from a
// user's row function call besides rows1d.cuh and rows2d.cuh:
// torch.minimum and torch.maximum, which give NaN where an operand is NaN
// (fminf and fmaxf give the other operand), and the row count a 1-D model
// sees.  Host code too, for the CPU tests' harness.

#pragma once

#include <cuda_runtime.h>

#include "rows1d.cuh"

namespace rows1d_traced {

__host__ __device__ __forceinline__ float min_of(float a, float b) { return a != a || b != b ? a + b : a < b ? a : b; }
__host__ __device__ __forceinline__ float max_of(float a, float b) { return a != a || b != b ? a + b : a > b ? a : b; }
__host__ __device__ __forceinline__ int min_of(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int max_of(int a, int b) { return a > b ? a : b; }

// The row count T of a traced 1-D model: the grid's, or on a shard's block
// (the masked launch) the global one, which ops/rowwise.py passes as the
// launch's flags.
__host__ __device__ __forceinline__ int model_T(const rows1d::Rows1DArgs& A) { return A.T; }
__host__ __device__ __forceinline__ int model_T(const rows1d::Rows1DHaloArgs& A) { return A.flags; }

}  // namespace rows1d_traced
