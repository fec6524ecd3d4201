// Probe kernels for Hopper (sm_90a): the copy chain of the port's roofline
// tool and the FMA chain of its kernel-ablation tool.  They measure the two
// ceilings that every bound of the port's kernels divides by: the HBM copy
// rate and the fp32 FMA rate this card reaches.
//
// Replaces the TPU kernels of the JAX package's tools:
//   copy3 (benchmarks/roofline.py:120-136, pallas_call at :129): three fp32
//         (T, nx, nx) arrays copied into three new outputs, one plane a grid
//         step, x-tiled at 128 rows beyond 256^2 (VMEM);
//   fma   (benchmarks/kernel_ablation.py:167-185, pallas_call at :181): K
//         register FMAs x = x * 1.0000001f + 1e-7f on every element of an
//         fp32 (T, nx, nx) array, (1, nx, nx) blocks, grid (T,), K = 128.
//
// How the TPU design is restated.  The planes and their x tiles are VMEM
// artifacts: here both kernels walk the arrays as flat vectors with a
// grid-stride loop of 16-byte (float4) loads and stores, a few blocks an SM
// for all the SMs, and a scalar tail for the last n % 4 elements (or for the
// whole array when a pointer is not 16-byte aligned).
//   * copy3: blockIdx.y picks the array, so one launch copies all three;
//     each thread keeps four float4 loads in flight before it stores them.
//     Bound on the H100 (3.35 TB/s): six arrays of 17.04 MB at (65,256,256),
//     102.2 MB, ~30.5 us; 408.9 MB at (65,512,512), ~122 us.  The first
//     exceeds the 50 MB L2, but a chain whose outputs are the next call's
//     inputs may find part of them there: the 512^2 reading is the HBM one.
//   * fma: each thread runs four independent chains (one float4), so the
//     4-cycle FFMA latency is hidden by the chains and the other warps.  The
//     FMA is __fmaf_rn, one rounding a step (the plain version's x * a + b
//     rounds twice: within ~8e-6 relative over 128 steps).  K is a template
//     parameter at 128 (the tools' value; fully unrolled, K FFMAs an element
//     in the SASS) and a run-time loop otherwise.  Bound: 2 K operations an
//     element against 8 bytes: at K = 128, 1.09 GFLOP at (65,256,256), 16.3
//     us at 67 TFLOP/s, against 10.2 us for its 34.1 MB -- 1.6x past the
//     ridge, so its rate is a lower bound of the card's FMA ceiling.  Its
//     input and output fit the L2 at 256^2; at 512^2 they do not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int COPY_UNROLL = 4;

// Blocks of a grid-stride launch over n4 float4 items: enough to fill the
// card, never more than the items need.
unsigned grid_blocks(long long n4) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const long long want = (n4 + THREADS - 1) / THREADS;
  const long long most = (long long)sms * BLOCKS_PER_SM;
  return (unsigned)(want < 1 ? 1 : (want < most ? want : most));
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// One of the three arrays (blockIdx.y): n floats from src to dst, as float4
// when vec (both pointers 16-byte aligned), the n % 4 tail (or all of it
// without vec) as floats.
__global__ void __launch_bounds__(THREADS) copy3_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                                        const float* __restrict__ c, float* __restrict__ a2,
                                                        float* __restrict__ b2, float* __restrict__ c2, long long n,
                                                        int vec) {
  const float* __restrict__ src = blockIdx.y == 0 ? a : (blockIdx.y == 1 ? b : c);
  float* __restrict__ dst = blockIdx.y == 0 ? a2 : (blockIdx.y == 1 ? b2 : c2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
    float4* __restrict__ d4 = reinterpret_cast<float4*>(dst);
    long long j = first;
    for (; j + (COPY_UNROLL - 1) * stride < n4; j += COPY_UNROLL * stride) {
      float4 v[COPY_UNROLL];
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u) v[u] = __ldg(s4 + j + u * stride);
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u) d4[j + u * stride] = v[u];
    }
    for (; j < n4; j += stride) d4[j] = __ldg(s4 + j);
    done = n4 << 2;
  }
  for (long long j = done + first; j < n; j += stride) dst[j] = __ldg(src + j);
}

__device__ __forceinline__ float fma_chain(float x, int k) {
  for (int s = 0; s < k; ++s) x = __fmaf_rn(x, 1.0000001f, 1e-7f);
  return x;
}

template <int K>
__device__ __forceinline__ float fma_steps(float x, int k) {
  if constexpr (K > 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) x = __fmaf_rn(x, 1.0000001f, 1e-7f);
    return x;
  } else {
    return fma_chain(x, k);
  }
}

// y = K FMA steps of x, element by element (K = 0: k steps, a run-time loop).
template <int K>
__global__ void __launch_bounds__(THREADS) fma_kernel(const float* __restrict__ x, float* __restrict__ y, long long n,
                                                      int k, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
    for (long long j = first; j < n4; j += stride) {
      float4 v = __ldg(x4 + j);
      v.x = fma_steps<K>(v.x, k);
      v.y = fma_steps<K>(v.y, k);
      v.z = fma_steps<K>(v.z, k);
      v.w = fma_steps<K>(v.w, k);
      y4[j] = v;
    }
    done = n4 << 2;
  }
  for (long long j = done + first; j < n; j += stride) y[j] = fma_steps<K>(__ldg(x + j), k);
}

}  // namespace

extern "C" {

const char* odil_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// copy3: a2, b2, c2 = a, b, c (n floats each), on the stream.
int odil_probe_copy3(const float* a, const float* b, const float* c, float* a2, float* b2, float* c2, long long n,
                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int vec = aligned16(a) && aligned16(b) && aligned16(c) && aligned16(a2) && aligned16(b2) && aligned16(c2);
  const dim3 grid(grid_blocks(vec ? n >> 2 : n), 3);
  copy3_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, c, a2, b2, c2, n, vec);
  return (int)cudaGetLastError();
}

// fma: y = k FMA steps of x (n floats), on the stream; k = 128 takes the
// unrolled kernel.
int odil_probe_fma(const float* x, float* y, long long n, int k, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 0) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(x) && aligned16(y);
  const unsigned grid = grid_blocks(vec ? n >> 2 : n);
  if (k == 128) fma_kernel<128><<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, y, n, k, vec);
  else fma_kernel<0><<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, y, n, k, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
