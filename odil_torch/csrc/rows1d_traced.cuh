// What the row models that odil_torch/ops/rowtrace.py generates from a
// user's row function call besides rows1d.cuh: torch.minimum and
// torch.maximum, which give NaN where an operand is NaN (fminf and fmaxf
// give the other operand).  Host code too, for the CPU tests' harness.

#pragma once

#include <cuda_runtime.h>

namespace rows1d_traced {

__host__ __device__ __forceinline__ float min_of(float a, float b) { return a != a || b != b ? a + b : a < b ? a : b; }
__host__ __device__ __forceinline__ float max_of(float a, float b) { return a != a || b != b ? a + b : a > b ? a : b; }
__host__ __device__ __forceinline__ int min_of(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int max_of(int a, int b) { return a > b ? a : b; }

}  // namespace rows1d_traced
