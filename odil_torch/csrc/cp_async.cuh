// Asynchronous global -> shared copies (cp.async) for the row kernels of
// rowwise.cu (rows1d.cuh's tile windows, rows_kernel's ring of fine rows):
// the copies (`src` aligned to the size copied), the commit of a thread's
// copies so far as one group, and the waits for all of them or for all
// but the newest N groups.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
