// Weight cotangent of the fused FNO spectral op, on the kept modes only.
//
// Replaces the Pallas TPU kernel `spectral_fused_dw`
// (src/repro/kernels/spectral_conv/kernel.py). Plain version:
// `spectral_fused_dw_ref` in ../ref.py.
//
//   x  [B, CI, E1, E2, E3, Tx]  complex64, any strides: the spectrum the
//                               forward consumed (on the card the saved
//                               4-D rfftn output, t outermost)
//   g  [B, CO, E1, E2, E3, Tg]  complex64, any strides: the cotangent of the
//                               forward's output, as the irfftn backward
//                               hands it over
//   w  [CI, CO, K1, K2, K3, KT] complex64, contiguous, written in full:
//
//   w[ci, co, k] = sum_b conj(x[b, ci, S(k)]) * g[b, co, S(k)]
//
// in torch's .grad convention (JAX's kernel takes the plain transpose on
// JAX's cotangent, which is the conjugate of torch's). S(k) maps a kept
// index to its full-spectrum position: for a truncated dim (n_d = full size
// N >= 0) kept index k < K_d/2 is position k and the rest land at
// N - K_d + k; n_d = -1 marks a pre-truncated dim (identity). The trailing
// dim reads bins [0, KT).
//
// What bounds it on an H100: bytes. At the training block shape (micro-
// batch 1, CI=CO=40, E=(64,32,32), K=(48,32,16,10)) it writes 3.15 GB of
// weight gradient and needs only 0.08 GB each of x and g (their kept
// positions) and 2 complex FMAs per output element per batch row. Design:
//   * one thread per output element (ci, co, k1, k2, k3, kt), kt fastest,
//     so the store of w is coalesced;
//   * the batch loop sits inside the thread, in a fixed order, with no
//     atomics: every output element is written exactly once, so nothing
//     is masked or zero-filled, and results are deterministic;
//   * ci is the fastest block index and co the next, so the CI*CO blocks
//     of one kept-mode tile run together and read that tile of x and g
//     (CI + CO rows of it) from L2 instead of device memory;
//   * x and g are read through their strides, since neither arrives
//     contiguous on the training path.
// Shared-memory tiling and vectorised stores are left for later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct DwDims {
  int B, CI, CO;
  int K1, K2, K3, KT;
  int N1, N2, N3;
  long long xs[6];  // strides of x, in complex elements
  long long gs[6];  // strides of g, in complex elements
};

// Kept index -> full-spectrum position.
__device__ __forceinline__ int full_index(int k, int n, int kd) {
  if (n < 0) return k;
  return k < (kd >> 1) ? k : n - kd + k;
}

__global__ void __launch_bounds__(kThreads)
spectral_fused_dw_kernel(const float2* __restrict__ x,
                         const float2* __restrict__ g,
                         float2* __restrict__ w, DwDims d) {
  const int ci = static_cast<int>(blockIdx.x % static_cast<unsigned>(d.CI));
  const unsigned rest = blockIdx.x / static_cast<unsigned>(d.CI);
  const int co = static_cast<int>(rest % static_cast<unsigned>(d.CO));
  const long long tile = rest / static_cast<unsigned>(d.CO);
  const long long K = static_cast<long long>(d.K1) * d.K2 * d.K3 * d.KT;
  const long long kidx = tile * kThreads + threadIdx.x;
  if (kidx >= K) return;

  const int kt = static_cast<int>(kidx % d.KT);
  long long r = kidx / d.KT;
  const int k3 = static_cast<int>(r % d.K3);
  r /= d.K3;
  const int k2 = static_cast<int>(r % d.K2);
  const int k1 = static_cast<int>(r / d.K2);
  const long long e1 = full_index(k1, d.N1, d.K1);
  const long long e2 = full_index(k2, d.N2, d.K2);
  const long long e3 = full_index(k3, d.N3, d.K3);

  const float2* xp = x + ci * d.xs[1] + e1 * d.xs[2] + e2 * d.xs[3] +
                     e3 * d.xs[4] + kt * d.xs[5];
  const float2* gp = g + co * d.gs[1] + e1 * d.gs[2] + e2 * d.gs[3] +
                     e3 * d.gs[4] + kt * d.gs[5];
  float2 acc = make_float2(0.f, 0.f);
  for (int b = 0; b < d.B; ++b) {
    const float2 xv = __ldg(xp + b * d.xs[0]);
    const float2 gv = __ldg(gp + b * d.gs[0]);
    // conj(x) * g = (xr gr + xi gi) + i (xr gi - xi gr)
    acc.x = fmaf(xv.x, gv.x, acc.x);
    acc.x = fmaf(xv.y, gv.y, acc.x);
    acc.y = fmaf(xv.x, gv.y, acc.y);
    acc.y = fmaf(-xv.y, gv.x, acc.y);
  }
  w[(static_cast<long long>(ci) * d.CO + co) * K + kidx] = acc;
}

}  // namespace

// C interface, bound from Python with ctypes (ops.py). Pointers are device
// pointers of complex64 tensors: `x` and `g` with the strides `xs` and `gs`
// (in elements), `w` contiguous. Launches on `stream` without synchronising
// and returns cudaGetLastError() after the launch (0 on success).
extern "C" int spectral_fused_dw_launch(const void* x, const void* g, void* w,
                                        int B, int CI, int CO, int K1, int K2,
                                        int K3, int KT, int N1, int N2, int N3,
                                        const long long* xs,
                                        const long long* gs, void* stream) {
  DwDims d{B, CI, CO, K1, K2, K3, KT, N1, N2, N3, {}, {}};
  for (int i = 0; i < 6; ++i) {
    d.xs[i] = xs[i];
    d.gs[i] = gs[i];
  }
  const long long K = static_cast<long long>(K1) * K2 * K3 * KT;
  if (CI == 0 || CO == 0 || K == 0) return 0;
  const long long n_blocks =
      static_cast<long long>(CI) * CO * ((K + kThreads - 1) / kThreads);
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  spectral_fused_dw_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(g),
      static_cast<float2*>(w), d);
  return static_cast<int>(cudaGetLastError());
}
