// Flattened-K spectral channel mix: y[b, co, k] = sum_ci x[b, ci, k] * w[ci, co, k].
//
// Replaces the Pallas TPU kernel `spectral_apply_pallas`
// (src/repro/kernels/spectral_conv/kernel.py). Plain version:
// `spectral_apply_ref` in ../ref.py.
//
//   x [B, CI, *modes]  complex64; the mode dims form one contiguous run of
//                      K elements, batch and channel are read through their
//                      strides
//   w [CI, CO, *modes] complex64, the same contiguous mode run, addressed
//                      through two channel strides so that the backward's
//                      dx runs on conj(W^T) without a copy (see below)
//   y [B, CO, *modes]  complex64, contiguous, written in full
//
// This is the JAX package's public layout. The TPU wrapper moves K to the
// front and pads it to its block size; here K stays innermost, no copy is
// made, and the kernel masks the ragged tail of K itself.
//
// What bounds it on an H100: bytes. At the Sleipner FNO's full kept-mode
// shape (CI=CO=40, K=48*32*16*10=245,760) it reads w once (3.15 GB) and x
// (79 MB per batch row) and writes y (79 MB per batch row): at B=2, 3.46 GB
// against 6.3 GFLOP, about 2 flops per byte. The design reads w exactly
// once for up to kBatchChunk batch rows:
//   * one thread per (k, tile of kCoTile output channels); neighbouring
//     threads take neighbouring k, so every load of w and x and every store
//     of y is coalesced along the contiguous mode run;
//   * the batch loop sits inside the thread (the accumulators of a batch
//     chunk stay in registers), so each weight element is loaded once; the
//     loop over ci is `spectral_mix::mix` (mix.cuh), which the fused
//     kernel's kept modes share;
//   * the co tile is the fastest block index, so the CO/kCoTile blocks that
//     re-read the same x tile run together and find it in L2;
//   * no atomics and a fixed summation order over ci: results are
//     deterministic run to run.
// For B > kBatchChunk the weights are read once per chunk. TMA, cp.async
// double buffering and more loads in flight are left for later work.
//
// The backward reuses this kernel for the input cotangent:
// dx[b, ci, k] = sum_co g[b, co, k] * conj(w[ci, co, k]), i.e. the same mix
// run on the output cotangent with ci and co swapped and the weights
// conjugated (torch's .grad convention; JAX's plain transpose is the
// conjugate of it). The wrapper passes the weight's channel strides swapped
// and conj_w = 1 instead of materialising conj(W^T), a 3.15 GB copy at the
// full-width shape.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mix.cuh"

namespace {

using spectral_mix::kCoTile;  // output channels per thread
constexpr int kThreads = 128;  // consecutive k per block
constexpr int kBatchChunk = 4;

struct ApplyDims {
  int B, CI, CO;
  long long K;
  long long xs_b, xs_c;  // x strides of batch and contracted channel, in elements
  long long w_in;        // weight stride of the contracted channel
  long long w_out;       // weight stride of the output channel
  int conj_w;            // 1: multiply by conj(w)
};

template <int BC>
__global__ void __launch_bounds__(kThreads)
spectral_apply_kernel(const float2* __restrict__ x,
                      const float2* __restrict__ w,
                      float2* __restrict__ y, ApplyDims d) {
  const unsigned n_co_tiles = (d.CO + kCoTile - 1) / kCoTile;
  const int co0 = static_cast<int>(blockIdx.x % n_co_tiles) * kCoTile;
  const long long k =
      static_cast<long long>(blockIdx.x / n_co_tiles) * kThreads + threadIdx.x;
  if (k >= d.K) return;
  const int n_co = min(kCoTile, d.CO - co0);
  const float w_im_sign = d.conj_w ? -1.f : 1.f;

  for (int b0 = 0; b0 < d.B; b0 += BC) {
    const int nb = min(BC, d.B - b0);
    float2 acc[BC][kCoTile];
    spectral_mix::mix<BC>(x + b0 * d.xs_b + k, d.xs_b, d.xs_c, nb, w + co0 * d.w_out + k,
                          d.w_in, d.w_out, n_co, d.CI, w_im_sign, acc);
#pragma unroll
    for (int j = 0; j < BC; ++j) {
      if (j < nb) {
        float2* yp = y + (static_cast<long long>(b0 + j) * d.CO + co0) * d.K + k;
#pragma unroll
        for (int c = 0; c < kCoTile; ++c)
          if (c < n_co) yp[c * d.K] = acc[j][c];
      }
    }
  }
}

}  // namespace

// C interface, bound from Python with ctypes (ops.py). Pointers are device
// pointers of complex64 tensors: `x` with batch and channel strides `xs_b`,
// `xs_c` (in elements) and a contiguous run of K modes, `w` with contracted
// and output channel strides `w_in`, `w_out` and a contiguous run of K
// modes, `y` contiguous [B, CO, K]. Launches on `stream` without
// synchronising and returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int spectral_apply_launch(const void* x, const void* w, void* y,
                                     int B, int CI, int CO, long long K,
                                     long long xs_b, long long xs_c,
                                     long long w_in, long long w_out,
                                     int conj_w, void* stream) {
  const ApplyDims d{B, CI, CO, K, xs_b, xs_c, w_in, w_out, conj_w};
  if (B == 0 || CO == 0 || K == 0) return 0;
  const long long n_blocks =
      (K + kThreads - 1) / kThreads * ((CO + kCoTile - 1) / kCoTile);
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* xp = static_cast<const float2*>(x);
  const float2* wp = static_cast<const float2*>(w);
  float2* yp = static_cast<float2*>(y);
  if (B == 1)
    spectral_apply_kernel<1><<<grid, kThreads, 0, s>>>(xp, wp, yp, d);
  else if (B == 2)
    spectral_apply_kernel<2><<<grid, kThreads, 0, s>>>(xp, wp, yp, d);
  else
    spectral_apply_kernel<kBatchChunk><<<grid, kThreads, 0, s>>>(xp, wp, yp, d);
  return static_cast<int>(cudaGetLastError());
}
