// Weight cotangent of the flattened-K spectral channel mix.
//
// Replaces the Pallas TPU kernel `spectral_dw_pallas`
// (src/repro/kernels/spectral_conv/kernel.py). Plain version:
// `spectral_dw_ref` in ../ref.py.
//
//   x [B, CI, *modes]  complex64: the input the forward consumed
//   g [B, CO, *modes]  complex64: the cotangent of the forward's output
//                      (both with a contiguous run of K modes; batch and
//                      channel read through their strides)
//   w [CI, CO, *modes] complex64, contiguous, written in full:
//
//   w[ci, co, k] = sum_b conj(x[b, ci, k]) * g[b, co, k]
//
// in torch's .grad convention (JAX's kernel takes the plain transpose on
// JAX's cotangent, which is the conjugate of torch's).
//
// What bounds it on an H100: bytes. At the Sleipner FNO's full kept-mode
// shape (CI=CO=40, K=245,760) it writes 3.15 GB of weight gradient and
// reads 79 MB each of x and g per batch row, against 2 complex FMAs per
// output element per batch row. Design:
//   * a block covers kLanes consecutive k (the lanes of a warp) for a tile
//     of kCiTile input channels (one warp each) and kCoTile output
//     channels; each thread owns the kCoTile outputs (ci, co0.., k), so
//     every store of w is coalesced along the contiguous mode run;
//   * the block stages the g rows of its co tile in shared memory, a batch
//     chunk at a time, and all its warps read them there; each thread reads
//     its own x value straight from device memory;
//   * the batch loop runs in a fixed order inside the thread and the
//     accumulators stay in registers across batch chunks, with no atomics:
//     every output element is written exactly once and repeated runs agree
//     bitwise;
//   * the co tile is the fastest block index and the ci tile the next, so
//     the blocks that share one k tile of x and g run together and find it
//     in L2.
// Wider stores, more work per block, TMA and cp.async are left for later
// work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 32;      // consecutive k per block
constexpr int kCiTile = 8;      // warps per block, one input channel each
constexpr int kCoTile = 8;      // output channels per thread
constexpr int kBatchChunk = 4;  // batch rows staged in shared memory at once
static_assert(kCiTile == kCoTile, "each warp stages one g row per batch row");

struct DwDims {
  int B, CI, CO;
  long long K;
  long long xs_b, xs_c;  // strides of x's batch and channel, in elements
  long long gs_b, gs_c;  // strides of g's batch and channel, in elements
};

__global__ void __launch_bounds__(kLanes * kCiTile)
spectral_dw_kernel(const float2* __restrict__ x,
                   const float2* __restrict__ g,
                   float2* __restrict__ w, DwDims d) {
  __shared__ float2 gs[kBatchChunk][kCoTile][kLanes];

  const unsigned n_co_tiles = (d.CO + kCoTile - 1) / kCoTile;
  const unsigned n_ci_tiles = (d.CI + kCiTile - 1) / kCiTile;
  unsigned idx = blockIdx.x;
  const int co0 = static_cast<int>(idx % n_co_tiles) * kCoTile;
  idx /= n_co_tiles;
  const int ci0 = static_cast<int>(idx % n_ci_tiles) * kCiTile;
  idx /= n_ci_tiles;
  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const long long k = static_cast<long long>(idx) * kLanes + lane;
  const bool k_ok = k < d.K;
  const int ci = ci0 + row;
  const bool x_ok = k_ok && ci < d.CI;
  const bool g_ok = k_ok && co0 + row < d.CO;

  const float2* xp = x + ci * d.xs_c + k;
  const float2* gp = g + (co0 + row) * d.gs_c + k;
  float2 acc[kCoTile];
#pragma unroll
  for (int c = 0; c < kCoTile; ++c) acc[c] = make_float2(0.f, 0.f);

  for (int b0 = 0; b0 < d.B; b0 += kBatchChunk) {
    const int nb = min(kBatchChunk, d.B - b0);
    // each warp stages one g row of the co tile for the chunk's batch rows
    for (int j = 0; j < nb; ++j)
      gs[j][row][lane] = g_ok ? __ldg(gp + (b0 + j) * d.gs_b)
                              : make_float2(0.f, 0.f);
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      const float2 xv =
          x_ok ? __ldg(xp + (b0 + j) * d.xs_b) : make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < kCoTile; ++c) {
        const float2 gv = gs[j][c][lane];
        // conj(x) * g = (xr gr + xi gi) + i (xr gi - xi gr)
        acc[c].x = fmaf(xv.x, gv.x, acc[c].x);
        acc[c].x = fmaf(xv.y, gv.y, acc[c].x);
        acc[c].y = fmaf(xv.x, gv.y, acc[c].y);
        acc[c].y = fmaf(-xv.y, gv.x, acc[c].y);
      }
    }
    __syncthreads();
  }

  if (!x_ok) return;
  float2* wp = w + (static_cast<long long>(ci) * d.CO + co0) * d.K + k;
  const int n_co = min(kCoTile, d.CO - co0);
#pragma unroll
  for (int c = 0; c < kCoTile; ++c)
    if (c < n_co) wp[c * d.K] = acc[c];
}

}  // namespace

// C interface, bound from Python with ctypes (ops.py). Pointers are device
// pointers of complex64 tensors: `x` and `g` with batch and channel strides
// (in elements) and a contiguous run of K modes, `w` contiguous [CI, CO, K].
// Launches on `stream` without synchronising and returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int spectral_dw_launch(const void* x, const void* g, void* w,
                                  int B, int CI, int CO, long long K,
                                  long long xs_b, long long xs_c,
                                  long long gs_b, long long gs_c,
                                  void* stream) {
  const DwDims d{B, CI, CO, K, xs_b, xs_c, gs_b, gs_c};
  if (CI == 0 || CO == 0 || K == 0) return 0;
  const long long n_blocks = (K + kLanes - 1) / kLanes *
                             ((CI + kCiTile - 1) / kCiTile) *
                             ((CO + kCoTile - 1) / kCoTile);
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  spectral_dw_kernel<<<static_cast<unsigned>(n_blocks), dim3(kLanes, kCiTile),
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(g),
      static_cast<float2*>(w), d);
  return static_cast<int>(cudaGetLastError());
}
