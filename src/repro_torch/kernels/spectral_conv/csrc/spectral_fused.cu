// Fused truncate + complex channel mix + zero-pad of the FNO spectral block.
//
// Replaces the Pallas TPU kernel `spectral_fused_pallas`
// (src/repro/kernels/spectral_conv/kernel.py). Plain version:
// `spectral_apply_fused_ref` in ../ref.py.
//
//   x   [B, CI, E1, E2, E3, Tin]  complex64, any strides (the full or partly
//                                 pre-truncated spectrum; cuFFT's 4-D rfftn
//                                 returns it permuted, so it is read in place)
//   w   [CI, CO, K1, K2, K3, KT]  complex64, kept-mode weights, addressed
//                                 through two channel strides so that the
//                                 backward's dx runs on conj(W^T) without
//                                 a copy (see below)
//   add [B, CO, K1, K2, K3, KT]   complex64, optional kept-mode term summed
//                                 on kept positions (spectral_apply_fused_add)
//   y   [B, CO, E1, E2, E3, Tout] complex64, written in full, zeros included
//
// For a truncated dim d (n_d = full size N >= 0), position e is kept when
// e < K_d/2 (kept index e) or e >= N - K_d/2 (kept index e - (N - K_d));
// n_d = -1 marks a pre-truncated dim (E_d == K_d, identity). Bins t >= KT
// and non-kept positions are written as zeros.
//
// What bounds it on an H100: bytes. At the serving block shape (B=2,
// CI=CO=40, E=(128,64,32), Tout=45, K=(48,32,16,10)) it reads w once
// (3.15 GB) and the kept part of x (0.16 GB) and writes the padded output
// (7.55 GB): 10.9 GB against 6.3 GFLOP. The design keeps each operand's
// HBM traffic at one pass:
//   * one thread per output element (co, e1, e2, e3, t), t fastest, so
//     loads of w and the store of y are coalesced along t and e3 (x is
//     read through its strides; its kept part is the smallest operand);
//   * the batch loop sits inside the thread, so each weight element is
//     read once for up to kBatchChunk batch rows;
//   * co is the fastest block index, so the CO blocks that re-read the same
//     x tile run together and find it in L2;
//   * no atomics and a fixed summation order over ci: results are
//     deterministic run to run.
// Shared-memory tiling over co, TMA and skipping the zero region are left
// for later work.
//
// Training reuses this kernel for the input cotangent of the fused op:
// dx = S^T (conj(W)^T .) S (g), i.e. the same truncate + mix + pad run on
// the output cotangent g with ci and co swapped and the weights
// conjugated (torch's .grad convention; JAX's plain transpose is the
// conjugate of it). The wrapper passes the weight's channel strides
// swapped and conj_w = 1 instead of materialising conj(W^T), which at the
// training shape would be a 3.15 GB copy per block per backward.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatchChunk = 4;

struct Dims {
  int B, CI, CO;
  int E1, E2, E3;
  int K1, K2, K3, KT;
  int Tout;
  int N1, N2, N3;
  long long xs[6];  // strides of x, in complex elements
  long long w_in;   // weight stride of the contracted channel (ci)
  long long w_out;  // weight stride of the output channel (co)
  int conj_w;       // 1: multiply by conj(w)
};

// Full-spectrum position -> kept index, or -1 for a position not kept.
__device__ __forceinline__ int kept_index(int e, int n, int k) {
  if (n < 0) return e;
  const int m = k >> 1;
  if (e < m) return e;
  if (e >= n - m) return e - (n - k);
  return -1;
}

__global__ void __launch_bounds__(kThreads)
spectral_fused_kernel(const float2* __restrict__ x,
                      const float2* __restrict__ w,
                      const float2* __restrict__ add,
                      float2* __restrict__ y, Dims d) {
  const int co = static_cast<int>(blockIdx.x % static_cast<unsigned>(d.CO));
  const long long tile = blockIdx.x / static_cast<unsigned>(d.CO);
  const long long S = static_cast<long long>(d.E1) * d.E2 * d.E3 * d.Tout;
  const long long s = tile * kThreads + threadIdx.x;
  if (s >= S) return;

  const int t = static_cast<int>(s % d.Tout);
  long long r = s / d.Tout;
  const int e3 = static_cast<int>(r % d.E3);
  r /= d.E3;
  const int e2 = static_cast<int>(r % d.E2);
  const int e1 = static_cast<int>(r / d.E2);

  const long long y_bstride = static_cast<long long>(d.CO) * S;
  float2* yp = y + static_cast<long long>(co) * S + s;

  const int k1 = kept_index(e1, d.N1, d.K1);
  const int k2 = kept_index(e2, d.N2, d.K2);
  const int k3 = kept_index(e3, d.N3, d.K3);
  if (k1 < 0 || k2 < 0 || k3 < 0 || t >= d.KT) {
    for (int b = 0; b < d.B; ++b) yp[b * y_bstride] = make_float2(0.f, 0.f);
    return;
  }

  const long long K = static_cast<long long>(d.K1) * d.K2 * d.K3 * d.KT;
  const long long kidx =
      ((static_cast<long long>(k1) * d.K2 + k2) * d.K3 + k3) * d.KT + t;
  const long long xidx = e1 * d.xs[2] + e2 * d.xs[3] + e3 * d.xs[4] + t * d.xs[5];
  const float2* wp = w + co * d.w_out + kidx;
  const long long w_ci_stride = d.w_in;
  const float w_im_sign = d.conj_w ? -1.f : 1.f;

  for (int b0 = 0; b0 < d.B; b0 += kBatchChunk) {
    float2 acc[kBatchChunk];
#pragma unroll
    for (int j = 0; j < kBatchChunk; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int ci = 0; ci < d.CI; ++ci) {
      float2 wv = __ldg(wp + ci * w_ci_stride);
      wv.y *= w_im_sign;
#pragma unroll
      for (int j = 0; j < kBatchChunk; ++j) {
        if (b0 + j < d.B) {
          const float2 xv =
              __ldg(x + (b0 + j) * d.xs[0] + ci * d.xs[1] + xidx);
          acc[j].x = fmaf(xv.x, wv.x, acc[j].x);
          acc[j].x = fmaf(-xv.y, wv.y, acc[j].x);
          acc[j].y = fmaf(xv.x, wv.y, acc[j].y);
          acc[j].y = fmaf(xv.y, wv.x, acc[j].y);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatchChunk; ++j) {
      const int b = b0 + j;
      if (b < d.B) {
        float2 v = acc[j];
        if (add != nullptr) {
          const float2 a =
              __ldg(add + (static_cast<long long>(b) * d.CO + co) * K + kidx);
          v.x += a.x;
          v.y += a.y;
        }
        yp[b * y_bstride] = v;
      }
    }
  }
}

}  // namespace

// C interface, bound from Python with ctypes (ops.py). Pointers are device
// pointers of complex64 tensors: `add` and `y` contiguous, `x` with the
// strides `xs` (in elements), `w` a contiguous [*, *, K1, K2, K3, KT]
// tensor whose contracted channel has stride `w_in` and whose output
// channel has stride `w_out` (in elements; CO*K and K for the forward,
// swapped for the backward's dx); `add` may be null. Launches on `stream`
// without synchronising and returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int spectral_fused_launch(const void* x, const void* w,
                                     const void* add, void* y, int B, int CI,
                                     int CO, int E1, int E2, int E3, int K1,
                                     int K2, int K3, int KT, int Tout,
                                     int N1, int N2, int N3,
                                     const long long* xs, long long w_in,
                                     long long w_out, int conj_w,
                                     void* stream) {
  const Dims d{B,  CI, CO, E1, E2, E3, K1, K2, K3, KT, Tout,
               N1, N2, N3, {xs[0], xs[1], xs[2], xs[3], xs[4], xs[5]},
               w_in, w_out, conj_w};
  const long long S = static_cast<long long>(E1) * E2 * E3 * Tout;
  if (B == 0 || CO == 0 || S == 0) return 0;
  const long long n_tiles = (S + kThreads - 1) / kThreads;
  const long long n_blocks = n_tiles * CO;
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  spectral_fused_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(w),
      static_cast<const float2*>(add), static_cast<float2*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spectral_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
