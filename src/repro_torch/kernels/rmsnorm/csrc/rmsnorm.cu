// Row-wise RMSNorm: y = (x * rsqrt(mean(x^2) + eps)) * w, statistics in f32.
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas`
// (src/repro/kernels/rmsnorm/kernel.py:24). Plain version: `rmsnorm_ref` in
// ../ref.py.
//
//   x [rows, d]  bf16 or f32, contiguous; d need not be a power of two
//   w [d]        f32
//   y [rows, d]  x's type, contiguous
//
// As the TPU kernel does, it upcasts x to f32, takes the mean of the squares
// in f32, computes (x * r) * w in f32 and casts once, to x's type
// (round-to-nearest-even for bf16). Unlike the TPU wrapper it needs no row
// padding: rows past the end of the last CTA are masked.
//
// What bounds it on an H100: bytes. It does 4 flops per element against 4
// (bf16) or 8 (f32) bytes moved, far below the card's ~20 f32 flops per byte
// of HBM bandwidth. But every shape the port runs is small (a prefill norms
// up to 1000 rows of d = 512-3072, a decode step 4 rows; 0.6-3.7 us at the
// bytes bound), so launch latency and the number of dependent memory round
// trips set the time. The design:
//   * one read of x: each thread loads its share of the row, and of w,
//     into registers before anything else (every load of the row in
//     flight at once), sums the squares from the registers and scales
//     them; nothing is read twice;
//   * 16-byte vector loads and stores: 8 bf16 or 4 f32 elements of x and y,
//     w as float4 (two a vector for bf16);
//   * the launch plan -- vector width, vectors a thread holds (NV), threads
//     a row (tpr) and rows a CTA (rpc) -- comes from the wrapper
//     (`launch_plan` in ../ops.py), so a short row takes part of a warp or
//     one warp and a CTA holds several rows, and a decode row (4 rows in all)
//     gets one CTA whose threads each hold one or two vectors;
//   * the sum of squares is a pairwise tree over a thread's elements, then
//     a warp-shuffle butterfly over the row's threads (every lane ends with
//     the same bits) and, for a row wider than a warp, one shared-memory
//     step in which each thread adds its row's warp sums in warp order; no
//     serial loop in one thread. The tree keeps the sum within a few ulps
//     of the exact one (on an H100, a sequential sum of a thread's 40-48
//     squares put recurrentgemma-2b's served bf16 logits 3.04% of max|ref|
//     from the plain path's, past their 3% gate; the tree 2.87%, the first
//     version's 10-12 terms a thread 2.03%);
//   * a scalar path (vector width 1) for a d that is not a multiple of the
//     vector width or for x, w or y not 16-byte aligned, and a two-pass
//     loop for rows longer than 8 vectors of 512 threads: every shape is
//     computed, none refused.
// The summation order is fixed by the plan: two runs agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBlock = 512;    // threads a CTA of the register-held kernel
constexpr int kLongBlock = 1024;  // threads a CTA (a row) of the two-pass kernel
constexpr int kMaxNv = 8;         // vectors a thread holds in registers

// x/y vectors of VEC elements as f32: 16-byte loads and stores where VEC > 1.
__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_vec(const float* p, float (&o)[1]) { o[0] = __ldg(p); }
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[1]) {
  o[0] = __bfloat162float(p[0]);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    words[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { p[0] = v[0]; }
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[1]) {
  p[0] = __float2bfloat16_rn(v[0]);
}

// w as f32, VEC at a time: float4 loads where VEC > 1.
template <int VEC>
__device__ __forceinline__ void load_w(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  }
}

// The sum of a[0..N) as a pairwise tree, in place (a[0] holds it): its
// rounding error grows with log2(N), not N.
template <int N>
__device__ __forceinline__ float tree_sum(float (&a)[N]) {
#pragma unroll
  for (int step = 1; step < N; step *= 2)
#pragma unroll
    for (int i = 0; i + step < N; i += 2 * step) a[i] += a[i + step];
  return a[0];
}

// The row's sum of `ss` over its tpr threads, the same bits in every one of
// them. tpr <= 32: a power of two, the row's lanes aligned within the warp.
// tpr > 32: a multiple of 32; one shared-memory step over the row's warps.
__device__ __forceinline__ float row_sum(float ss, int tpr, int row_in_cta,
                                         float* partial) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width >> 1; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr <= 32) return ss;
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  const int wpr = tpr >> 5;
  const float* mine = partial + row_in_cta * wpr;
  float total = 0.f;
  for (int i = 0; i < wpr; ++i) total += mine[i];
  return total;
}

// Rows held in registers: thread t of a row holds vectors t + i * tpr,
// i < NV, of VEC elements each (n_vec * VEC = d; NV * tpr >= n_vec).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxBlock)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int rows, int d, float eps, int tpr, int rpc) {
  __shared__ float partial[kMaxBlock / 32];
  const int row_in_cta = threadIdx.x / tpr;
  const int t = threadIdx.x - row_in_cta * tpr;
  const long long row = static_cast<long long>(blockIdx.x) * rpc + row_in_cta;
  const int n_vec = d / VEC;
  const bool live = row < rows;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float xv[NV][VEC], wv[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + i * tpr;
    if (live && j < n_vec) {
      load_vec(xr + j * VEC, xv[i]);
      load_w<VEC>(w + j * VEC, wv[i]);
    }
  }
  // the squares summed as one pairwise tree over the thread's elements,
  // then over the row's threads (the butterfly is a tree too)
  float sq[NV * VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bool held = live && t + i * tpr < n_vec;
#pragma unroll
    for (int e = 0; e < VEC; ++e) sq[i * VEC + e] = held ? xv[i][e] * xv[i][e] : 0.f;
  }
  const float ss = row_sum(tree_sum(sq), tpr, row_in_cta, partial);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + i * tpr;
    if (live && j < n_vec) {
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = (xv[i][e] * r) * wv[i][e];
      store_vec(yr + j * VEC, out);
    }
  }
}

// Rows longer than kMaxNv vectors of kMaxBlock threads: one CTA a row,
// two passes over x (the second finds the row in L2).
template <typename T, int VEC>
__global__ void __launch_bounds__(kLongBlock)
rmsnorm_kernel_long(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kLongBlock / 32];
  const int n_vec = d / VEC;
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* yr = y + static_cast<long long>(blockIdx.x) * d;
  float ss = 0.f;
  for (int j = threadIdx.x; j < n_vec; j += blockDim.x) {
    float v[VEC];
    load_vec(xr + j * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss = fmaf(v[e], v[e], ss);
  }
  ss = row_sum(ss, blockDim.x, 0, partial);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
  for (int j = threadIdx.x; j < n_vec; j += blockDim.x) {
    float v[VEC], wv[VEC], out[VEC];
    load_vec(xr + j * VEC, v);
    load_w<VEC>(w + j * VEC, wv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = (v[e] * r) * wv[e];
    store_vec(yr + j * VEC, out);
  }
}

template <typename T, int VEC>
cudaError_t launch_typed(const T* x, const float* w, T* y, int rows, int d, float eps, int nv,
                         int tpr, int rpc, cudaStream_t s) {
  if (nv == 0) {
    rmsnorm_kernel_long<T, VEC><<<rows, tpr, 0, s>>>(x, w, y, d, eps);
    return cudaGetLastError();
  }
  const unsigned grid = static_cast<unsigned>((rows + rpc - 1) / rpc);
  const unsigned block = static_cast<unsigned>(tpr * rpc);
  switch (nv) {
#define RMSNORM_CASE(N)                                                              \
  case N:                                                                            \
    rmsnorm_kernel<T, VEC, N><<<grid, block, 0, s>>>(x, w, y, rows, d, eps, tpr, rpc); \
    break;
    RMSNORM_CASE(1) RMSNORM_CASE(2) RMSNORM_CASE(3) RMSNORM_CASE(4)
    RMSNORM_CASE(5) RMSNORM_CASE(6) RMSNORM_CASE(7) RMSNORM_CASE(8)
#undef RMSNORM_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Whether the plan covers the row and maps onto warps as the kernel needs.
bool plan_ok(int d, int vec, int nv, int tpr, int rpc, bool vec_ok) {
  if (vec != 1 && !vec_ok) return false;
  if (nv == 0) return rpc == 1 && tpr % 32 == 0 && tpr <= kLongBlock;
  if (nv < 1 || nv > kMaxNv || tpr < 1 || rpc < 1) return false;
  if (tpr <= 32 ? (tpr & (tpr - 1)) != 0 : tpr % 32 != 0) return false;
  const long long block = static_cast<long long>(tpr) * rpc;
  if (block > kMaxBlock || block % 32 != 0) return false;
  return static_cast<long long>(nv) * tpr * vec >= d;
}

}  // namespace

// Launches on `stream` without synchronising; is_bf16 selects the type of x
// and y (1: bf16, 0: f32). The plan (ops.py `launch_plan`): `vec` elements
// a vector (1, or 16 bytes' worth: 8 bf16, 4 f32; then d must be a multiple
// of it and x, w, y 16-byte aligned), `nv` vectors a thread (1-8; 0 for the
// two-pass kernel of long rows, one CTA of `tpr` threads a row, a multiple
// of 32 up to 1024), `tpr` threads a row (a power of two up to 32, else a
// multiple of 32) and `rpc` rows a CTA (tpr * rpc a multiple of 32, at most
// 512). A plan the kernel
// cannot run returns cudaErrorInvalidValue; otherwise cudaGetLastError()
// after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows, int d,
                              float eps, int is_bf16, int vec, int nv, int tpr, int rpc,
                              void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const int vec_width = is_bf16 ? 8 : 4;
  const bool vec_ok = vec == vec_width && d % vec == 0 && aligned16(x) && aligned16(w) &&
                      aligned16(y);
  if (!plan_ok(d, vec, nv, tpr, rpc, vec_ok)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  cudaError_t err;
  if (is_bf16) {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    auto* yp = static_cast<__nv_bfloat16*>(y);
    err = vec == 1 ? launch_typed<__nv_bfloat16, 1>(xp, wp, yp, rows, d, eps, nv, tpr, rpc, s)
                   : launch_typed<__nv_bfloat16, 8>(xp, wp, yp, rows, d, eps, nv, tpr, rpc, s);
  } else {
    const auto* xp = static_cast<const float*>(x);
    auto* yp = static_cast<float*>(y);
    err = vec == 1 ? launch_typed<float, 1>(xp, wp, yp, rows, d, eps, nv, tpr, rpc, s)
                   : launch_typed<float, 4>(xp, wp, yp, rows, d, eps, nv, tpr, rpc, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
