// Row-wise RMSNorm: y = (x * rsqrt(mean(x^2) + eps)) * w, statistics in f32.
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas`
// (src/repro/kernels/rmsnorm/kernel.py). Plain version: `rmsnorm_ref` in
// ../ref.py.
//
//   x [rows, d]  bf16 or f32, contiguous; d need not be a power of two
//   w [d]        f32
//   y [rows, d]  x's type, contiguous
//
// As the TPU kernel does, it upcasts x to f32, takes the mean of the squares
// in f32, computes (x * r) * w in f32 and casts once, to x's type
// (round-to-nearest-even for bf16). Unlike the TPU wrapper it needs no row
// padding: a ragged last block does not exist, one CTA takes one row.
//
// What bounds it on an H100: bytes. It does 4 flops per element against 4
// (bf16) or 8 (f32) bytes moved, far below the card's ~20 f32 flops per byte
// of HBM bandwidth. On the serving path of gemma-7b (d = 3072) a prefill
// norms up to 1000 rows and a decode step 4 rows (one per slot). The design
// keeps HBM traffic at one read of x, one read of w and one write of y:
//   * one CTA of 256 threads per row, neighbouring threads on neighbouring
//     elements, so every load and store is coalesced;
//   * the sum of squares is reduced by warp shuffles and one shared-memory
//     pass, then the row is read a second time to scale it; the second read
//     finds the row (6 KB at d = 3072 in bf16) in L1/L2, not in HBM.
// Vector (16-byte) loads, several rows per CTA for short rows, and keeping
// the row in registers between the two passes are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kWarps];
  __shared__ float inv_rms;
  const long long offset = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + offset;
  T* yr = y + offset;

  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += partial[i];
    inv_rms = 1.0f / sqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    yr[c] = from_f32<T>((to_f32(xr[c]) * r) * w[c]);
  }
}

}  // namespace

// Launches on `stream` without synchronising; is_bf16 selects the type of x
// and y (1: bf16, 0: f32). Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows, int d,
                              float eps, int is_bf16, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(y), d, eps);
  } else {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
