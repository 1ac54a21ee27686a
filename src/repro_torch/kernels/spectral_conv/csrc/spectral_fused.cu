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
// (7.55 GB, 98% of it zeros): 10.9 GB against 6.3 GFLOP. The first version
// ran one thread per output element, t fastest, so in a kept row only the
// KT of Tout lanes of a warp that hold kept bins did the mix while the
// others had written their zero and waited, and their w loads came in
// 80-byte runs. This one splits the two kinds of work inside one launch:
//   * mix blocks (the first n_mix of the grid): one thread per flattened
//     kept mode k = (k1, k2, k3, kt) and tile of kCoTile output channels,
//     neighbouring threads on neighbouring k, so every lane computes and
//     every load of w (contiguous in k) coalesces; the loop over ci is
//     `spectral_mix::mix` (mix.cuh), shared with the flattened-K kernel:
//     one x load feeds the channel tile, the batch loop sits inside the
//     thread so w is read once per batch chunk, and ci is summed in a fixed
//     order without atomics (results are the same run to run). x is
//     gathered at the kept positions through its strides, y (and `add`)
//     scattered to them. The co tile is the fastest block index, so the
//     blocks that re-read one x tile run together and find it in L2;
//   * zero blocks (the rest): one warp per run of E3 * Tout elements of y
//     (fixed b, co, e1, e2), a pure streaming write in 16-byte stores where
//     the run is even; in the runs whose (e1, e2) are kept the lanes skip
//     the kept bins, which the mix blocks write.
// Offsets are 64-bit (w passes 2^31 elements at full width). On an NVIDIA
// H100 80GB HBM3 at a 700 W power limit (chip_smoke.py phases 2 and the
// backward's, CUDA events) it takes 4.90 ms at the serving block against
// its 3.24 ms bound (the first version: 11.96 ms) and 2.03 ms for the
// training dx (B=1) against 1.24 ms (first: 7.33 ms). Left for later work:
// the mix blocks keep the flattened-K kernel's loads in flight, no more; x
// is gathered through cuFFT's permuted strides (t outermost), so a warp's
// x loads touch about one sector per kept bin; TMA stores of the zeros.
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

#include "mix.cuh"

namespace {

using spectral_mix::kCoTile;  // output channels per mix thread
constexpr int kThreads = 128;
constexpr int kBatchChunk = 4;
constexpr int kZeroRows = kThreads / 32;  // y runs per zero block, a warp each

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
  long long K;      // kept modes, K1 * K2 * K3 * KT
  long long n_mix;  // mix blocks; the zero blocks follow
  long long rows;   // y runs of E3 * Tout elements, B * CO * E1 * E2
};

// Full-spectrum position -> kept index, or -1 for a position not kept.
__device__ __forceinline__ int kept_index(int e, int n, int k) {
  if (n < 0) return e;
  const int m = k >> 1;
  if (e < m) return e;
  if (e >= n - m) return e - (n - k);
  return -1;
}

// Kept index -> full-spectrum position.
__device__ __forceinline__ int full_index(int kk, int n, int k) {
  return n < 0 || kk < (k >> 1) ? kk : kk + (n - k);
}

template <int BC>
__device__ void mix_block(const float2* __restrict__ x, const float2* __restrict__ w,
                          const float2* __restrict__ add, float2* __restrict__ y,
                          const Dims& d) {
  const unsigned n_co_tiles = (d.CO + kCoTile - 1) / kCoTile;
  const int co0 = static_cast<int>(blockIdx.x % n_co_tiles) * kCoTile;
  const long long k =
      static_cast<long long>(blockIdx.x / n_co_tiles) * kThreads + threadIdx.x;
  if (k >= d.K) return;
  const int n_co = min(kCoTile, d.CO - co0);

  const int kt = static_cast<int>(k % d.KT);
  long long r = k / d.KT;
  const int k3 = static_cast<int>(r % d.K3);
  r /= d.K3;
  const int k2 = static_cast<int>(r % d.K2);
  const int k1 = static_cast<int>(r / d.K2);
  const int e1 = full_index(k1, d.N1, d.K1);
  const int e2 = full_index(k2, d.N2, d.K2);
  const int e3 = full_index(k3, d.N3, d.K3);
  const long long xoff = e1 * d.xs[2] + e2 * d.xs[3] + e3 * d.xs[4] + kt * d.xs[5];
  const long long S = static_cast<long long>(d.E1) * d.E2 * d.E3 * d.Tout;
  const long long yoff =
      ((static_cast<long long>(e1) * d.E2 + e2) * d.E3 + e3) * d.Tout + kt;
  const float w_im_sign = d.conj_w ? -1.f : 1.f;

  for (int b0 = 0; b0 < d.B; b0 += BC) {
    const int nb = min(BC, d.B - b0);
    float2 acc[BC][kCoTile];
    spectral_mix::mix<BC>(x + b0 * d.xs[0] + xoff, d.xs[0], d.xs[1], nb,
                          w + co0 * d.w_out + k, d.w_in, d.w_out, n_co, d.CI, w_im_sign, acc);
#pragma unroll
    for (int j = 0; j < BC; ++j) {
      if (j < nb) {
        const long long bco = static_cast<long long>(b0 + j) * d.CO + co0;
#pragma unroll
        for (int c = 0; c < kCoTile; ++c) {
          if (c < n_co) {
            float2 v = acc[j][c];
            if (add != nullptr) {
              const float2 a = __ldg(add + (bco + c) * d.K + k);
              v.x += a.x;
              v.y += a.y;
            }
            y[(bco + c) * S + yoff] = v;
          }
        }
      }
    }
  }
}

__device__ void zero_block(float2* __restrict__ y, const Dims& d) {
  const long long row = (blockIdx.x - d.n_mix) * kZeroRows + threadIdx.x / 32;
  if (row >= d.rows) return;
  const int lane = threadIdx.x % 32;
  const int e2 = static_cast<int>(row % d.E2);
  const int e1 = static_cast<int>((row / d.E2) % d.E1);
  const int run = d.E3 * d.Tout;
  float2* yr = y + row * run;
  if (kept_index(e1, d.N1, d.K1) >= 0 && kept_index(e2, d.N2, d.K2) >= 0) {
    for (int i = lane; i < run; i += 32) {
      const int e3 = i / d.Tout;
      if (i - e3 * d.Tout >= d.KT || kept_index(e3, d.N3, d.K3) < 0)
        yr[i] = make_float2(0.f, 0.f);
    }
  } else if (run % 2 == 0) {  // the run starts 16-byte aligned
    float4* yr4 = reinterpret_cast<float4*>(yr);
    for (int i = lane; i < run / 2; i += 32) yr4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < run; i += 32) yr[i] = make_float2(0.f, 0.f);
  }
}

template <int BC>
__global__ void __launch_bounds__(kThreads)
spectral_fused_kernel(const float2* __restrict__ x, const float2* __restrict__ w,
                      const float2* __restrict__ add, float2* __restrict__ y, Dims d) {
  if (blockIdx.x < d.n_mix)
    mix_block<BC>(x, w, add, y, d);
  else
    zero_block(y, d);
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
  const long long S = static_cast<long long>(E1) * E2 * E3 * Tout;
  if (B == 0 || CO == 0 || S == 0) return 0;
  const long long K = static_cast<long long>(K1) * K2 * K3 * KT;
  const long long n_mix = (K + kThreads - 1) / kThreads * ((CO + kCoTile - 1) / kCoTile);
  const long long rows = static_cast<long long>(B) * CO * E1 * E2;
  const long long n_blocks = n_mix + (rows + kZeroRows - 1) / kZeroRows;
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Dims d{B,  CI, CO, E1, E2, E3, K1, K2, K3, KT, Tout,
               N1, N2, N3, {xs[0], xs[1], xs[2], xs[3], xs[4], xs[5]},
               w_in, w_out, conj_w, K, n_mix, rows};
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* xp = static_cast<const float2*>(x);
  const float2* wp = static_cast<const float2*>(w);
  const float2* ap = static_cast<const float2*>(add);
  float2* yp = static_cast<float2*>(y);
  if (B == 1)
    spectral_fused_kernel<1><<<grid, kThreads, 0, s>>>(xp, wp, ap, yp, d);
  else if (B == 2)
    spectral_fused_kernel<2><<<grid, kThreads, 0, s>>>(xp, wp, ap, yp, d);
  else
    spectral_fused_kernel<kBatchChunk><<<grid, kThreads, 0, s>>>(xp, wp, ap, yp, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spectral_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
