// The per-mode complex channel mix that the spectral kernels share
// (spectral_apply.cu, the flattened-K op; spectral_fused.cu, the kept modes
// of the fused op): one thread holds one kept mode k and a tile of up to
// kCoTile output channels for up to BC batch rows, and sums over the
// contracted channel ci in order (no atomics: results are the same run to
// run). One x load feeds the whole channel tile and one w load every batch
// row, so w, the largest operand, is read once per batch chunk; the caller
// places neighbouring threads on neighbouring k, where w is contiguous, so
// its loads coalesce.
#pragma once

#include <cuda_runtime.h>

namespace spectral_mix {

constexpr int kCoTile = 8;  // output channels per thread

// acc[j][c] = sum_ci x[j * xs_b + ci * xs_c] * w[ci * w_in + c * w_out]
// for batch rows j < nb and channels c < n_co, with conj(w) when
// w_im_sign = -1. x and w point at this thread's mode.
template <int BC>
__device__ __forceinline__ void mix(const float2* __restrict__ x, long long xs_b, long long xs_c,
                                    int nb, const float2* __restrict__ w, long long w_in,
                                    long long w_out, int n_co, int CI, float w_im_sign,
                                    float2 (&acc)[BC][kCoTile]) {
#pragma unroll
  for (int j = 0; j < BC; ++j)
#pragma unroll
    for (int c = 0; c < kCoTile; ++c) acc[j][c] = make_float2(0.f, 0.f);

  for (int ci = 0; ci < CI; ++ci) {
    float2 xv[BC];
#pragma unroll
    for (int j = 0; j < BC; ++j)
      xv[j] = j < nb ? __ldg(x + j * xs_b + ci * xs_c) : make_float2(0.f, 0.f);
    const float2* wc = w + ci * w_in;
#pragma unroll
    for (int c = 0; c < kCoTile; ++c) {
      if (c < n_co) {
        float2 wv = __ldg(wc + c * w_out);
        wv.y *= w_im_sign;
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          acc[j][c].x = fmaf(xv[j].x, wv.x, acc[j][c].x);
          acc[j][c].x = fmaf(-xv[j].y, wv.y, acc[j][c].x);
          acc[j][c].y = fmaf(xv[j].x, wv.y, acc[j][c].y);
          acc[j][c].y = fmaf(xv[j].y, wv.x, acc[j][c].y);
        }
      }
    }
  }
}

}  // namespace spectral_mix
