// Flattened-K spectral channel mix: y[b, co, k] = sum_ci x[b, ci, k] * w[ci, co, k].
//
// Replaces the Pallas TPU kernel `spectral_apply_pallas`
// (src/repro/kernels/spectral_conv/kernel.py:101). Plain version:
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
// shape (CI=CO=40, K=48*32*16*10=245,760) it reads w once (3.15 GB, 91% of
// the bytes at B=2) and x (79 MB per batch row) and writes y (79 MB per
// batch row): at B=2, 3.46 GB against 6.3 GFLOP, about 2 flops per byte,
// 1.033 ms at 3.35 TB/s. w has no reuse, so the kernel is a stream of w with
// enough bytes in flight to keep HBM busy (about 26 KB an SM at 1 us of
// latency). The design:
//   * one persistent block per slot the card holds (2 an SM), each owning
//     an even share of the K mode pairs, one contiguous run starting on a
//     128-byte line, walked in tiles of up to kTilePairs pairs (its last
//     tile short): the ragged
//     tail of K and a short K (the P = 4 shard's 61,440) spread evenly over
//     the SMs instead of leaving a last partial wave (the first version's
//     grid was 2.6 waves at the shard);
//   * a block computes every output channel of its tile: kCoWarps warps
//     split co (kCoPerThread channels a thread), the lanes take mode pairs,
//     so x is read from device memory once (not once per co tile);
//   * a stage is one contracted channel ci of the tile: w[ci, 0:CO, tile]
//     (CO runs of up to 512 contiguous bytes) and x[b, ci, tile] for the
//     batch chunk, copied to shared memory with 16-byte cp.async (8-byte
//     where K, a stride or a pointer does not allow 16) into a ring of
//     kStages stages; kStages - 1 stages fly while one is consumed, across
//     tile boundaries;
//   * the stage, channel and item counters advance by increments: no
//     64-bit division on the per-stage path;
//   * each thread keeps its outputs (batch chunk x kCoPerThread channels x
//     2 modes) in registers over the ci loop and writes them once, with
//     16-byte streaming stores (8-byte where K is odd);
//   * a fixed order over ci and no atomics: two runs agree bitwise; the
//     complex multiply-adds are those of the fused kernel's mix
//     (mix.cuh), in the same order.
// For B > kBatchChunk the weights are read once per chunk; for CO past a
// block's kCoWarps * kCoPerThread channels, once per channel chunk (x then
// once per chunk too, mostly from L2). launch/ab_apply.py times the
// constants' variants against the first version.
//
// The backward reuses this kernel for the input cotangent:
// dx[b, ci, k] = sum_co g[b, co, k] * conj(w[ci, co, k]), i.e. the same mix
// run on the output cotangent with ci and co swapped and the weights
// conjugated (torch's .grad convention; JAX's plain transpose is the
// conjugate of it). The wrapper passes the weight's channel strides swapped
// and conj_w = 1 instead of materialising conj(W^T), a 3.15 GB copy at the
// full-width shape.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kCoWarps = 8;      // warps along the output channels
constexpr int kCoPerThread = 5;  // output channels a thread accumulates
constexpr int kStages = 4;       // shared-memory ring
constexpr int kMinBlocksPerSm = 2;
constexpr int kRunAlign = 8;     // a block's run starts on a multiple of this many pairs
constexpr int kThreads = 32 * kCoWarps;
constexpr int kTilePairs = 32;   // most mode pairs a tile: one a lane
constexpr int kCoChunk = kCoWarps * kCoPerThread;
constexpr int kBatchChunk = 4;

struct ApplyDims {
  int B, CI, CO;
  long long K;
  long long xs_b, xs_c;  // x strides of batch and contracted channel, in elements
  long long w_in;        // weight stride of the contracted channel
  long long w_out;       // weight stride of the output channel
  int conj_w;            // 1: multiply by conj(w)
  // set by the launcher
  int n_b_chunks, n_co_chunks;
  long long pairs;       // ceil(K / 2)
};

// The block's run of mode pairs [p0, p1): an even share of all of them in
// units of kRunAlign pairs (128 bytes of a weight row), so that every tile
// starts on a cache line.
struct Run {
  long long p0, p1;
  int n_tiles;  // of kTilePairs pairs, the last one short
};

__device__ __forceinline__ Run run_of_block(const ApplyDims& d) {
  Run r;
  const long long units = (d.pairs + kRunAlign - 1) / kRunAlign;
  r.p0 = min(d.pairs, units * blockIdx.x / gridDim.x * kRunAlign);
  r.p1 = min(d.pairs, units * (blockIdx.x + 1) / gridDim.x * kRunAlign);
  r.n_tiles = static_cast<int>((r.p1 - r.p0 + kTilePairs - 1) / kTilePairs);
  return r;
}

// One item of the block's work: a tile of its run for one batch chunk and
// one chunk of output channels, tiles fastest.
struct Item {
  long long k_lo, k_hi;  // modes [k_lo, k_hi), k_lo even
  int b0, nb, co0, nco;
};

__device__ __forceinline__ Item item_of(int item, const Run& run, const ApplyDims& d,
                                        int bc_rows) {
  Item it;
  const int t = item % run.n_tiles;
  item /= run.n_tiles;
  const int cc = item % d.n_co_chunks;
  const int bc = item / d.n_co_chunks;
  const long long q0 = run.p0 + static_cast<long long>(t) * kTilePairs;
  it.k_lo = 2 * q0;
  it.k_hi = min(2 * min(q0 + kTilePairs, run.p1), d.K);
  it.b0 = bc * bc_rows;
  it.nb = min(bc_rows, d.B - it.b0);
  it.co0 = cc * kCoChunk;
  it.nco = min(kCoChunk, d.CO - it.co0);
  return it;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `rows` rows of the tile (row r at src + r * stride, `len` modes)
// into a stage area of kTilePairs float4 a row: pairs with 16-byte copies
// (V16), else single elements with 8-byte ones.
template <bool V16>
__device__ __forceinline__ void stage_rows(float4* dst, const float2* src, long long stride,
                                           int rows, int len) {
  if (V16) {
    const int pairs = len >> 1;  // len is even on this path
    for (int i = threadIdx.x; i < rows * kTilePairs; i += kThreads) {
      const int r = i / kTilePairs, p = i % kTilePairs;
      if (p < pairs) cp_async16(dst + i, src + r * stride + 2 * p);
    }
  } else {
    float2* dst2 = reinterpret_cast<float2*>(dst);
    for (int i = threadIdx.x; i < rows * 2 * kTilePairs; i += kThreads) {
      const int r = i / (2 * kTilePairs), e = i % (2 * kTilePairs);
      if (e < len) cp_async8(dst2 + i, src + r * stride + e);
    }
  }
}

__device__ __forceinline__ void cmac(float2& acc, float xr, float xi, float wr, float wi) {
  acc.x = fmaf(xr, wr, acc.x);
  acc.x = fmaf(-xi, wi, acc.x);
  acc.y = fmaf(xr, wi, acc.y);
  acc.y = fmaf(xi, wr, acc.y);
}

template <int BC, bool V16>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
spectral_apply_kernel(const float2* __restrict__ x, const float2* __restrict__ w,
                      float2* __restrict__ y, ApplyDims d) {
  extern __shared__ float4 smem[];
  constexpr int kStageF4 = (kCoChunk + BC) * kTilePairs;
  const Run run = run_of_block(d);
  if (run.n_tiles == 0) return;
  const int n_items = d.n_b_chunks * d.n_co_chunks * run.n_tiles;
  const long long n_stages = static_cast<long long>(n_items) * d.CI;

  // where the copies are: stage `issued`, channel ci_in of item n_in
  long long issued = 0;
  int n_in = 0, ci_in = 0;
  Item in = item_of(0, run, d, BC);
  auto issue = [&]() {
    float4* stage = smem + (issued % kStages) * kStageF4;
    const int len = static_cast<int>(in.k_hi - in.k_lo);
    stage_rows<V16>(stage, w + ci_in * d.w_in + in.co0 * d.w_out + in.k_lo, d.w_out, in.nco, len);
    stage_rows<V16>(stage + kCoChunk * kTilePairs, x + in.b0 * d.xs_b + ci_in * d.xs_c + in.k_lo,
                    d.xs_b, in.nb, len);
    ++issued;
    if (++ci_in == d.CI) {
      ci_in = 0;
      if (++n_in < n_items) in = item_of(n_in, run, d, BC);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float w_im_sign = d.conj_w ? -1.f : 1.f;
  float2 acc[BC][kCoPerThread][2];
#pragma unroll
  for (int j = 0; j < BC; ++j)
#pragma unroll
    for (int c = 0; c < kCoPerThread; ++c) acc[j][c][0] = acc[j][c][1] = make_float2(0.f, 0.f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (issued < n_stages) issue();
    cp_async_commit();
  }
  int n_out = 0, ci_out = 0;  // the item and channel being consumed
  for (long long s = 0; s < n_stages; ++s) {
    cp_async_wait_stage();
    __syncthreads();  // stage s has landed, and every thread is done with stage s - 1
    if (issued < n_stages) issue();
    cp_async_commit();

    const float4* stage = smem + (s % kStages) * kStageF4;
    float4 xv[BC];
#pragma unroll
    for (int j = 0; j < BC; ++j) xv[j] = stage[(kCoChunk + j) * kTilePairs + lane];
#pragma unroll
    for (int c = 0; c < kCoPerThread; ++c) {
      const float4 wv = stage[(warp + c * kCoWarps) * kTilePairs + lane];
      const float wi0 = wv.y * w_im_sign, wi1 = wv.w * w_im_sign;
#pragma unroll
      for (int j = 0; j < BC; ++j) {
        cmac(acc[j][c][0], xv[j].x, xv[j].y, wv.x, wi0);
        cmac(acc[j][c][1], xv[j].z, xv[j].w, wv.z, wi1);
      }
    }

    if (++ci_out == d.CI) {  // the item's last ci: write its outputs
      ci_out = 0;
      const Item it = item_of(n_out++, run, d, BC);
      const long long k = it.k_lo + 2 * lane;
#pragma unroll
      for (int j = 0; j < BC; ++j) {
#pragma unroll
        for (int c = 0; c < kCoPerThread; ++c) {
          const int r = warp + c * kCoWarps;
          if (j < it.nb && r < it.nco && k < it.k_hi) {
            float2* yp = y + (static_cast<long long>(it.b0 + j) * d.CO + it.co0 + r) * d.K + k;
            if (V16) {
              __stcs(reinterpret_cast<float4*>(yp),
                     make_float4(acc[j][c][0].x, acc[j][c][0].y, acc[j][c][1].x, acc[j][c][1].y));
            } else {
              __stcs(yp, acc[j][c][0]);
              if (k + 1 < it.k_hi) __stcs(yp + 1, acc[j][c][1]);
            }
          }
          acc[j][c][0] = acc[j][c][1] = make_float2(0.f, 0.f);
        }
      }
    }
  }
  cp_async_wait_all();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int BC, bool V16>
constexpr int kSmem = kStages * (kCoChunk + BC) * kTilePairs * static_cast<int>(sizeof(float4));

constexpr int kMaxDevices = 64;

// The blocks the current card holds at once of this instance: set up (its
// shared-memory attribute) and counted on the first launch on each device,
// then read from a per-device cache.
template <int BC, bool V16>
cudaError_t slots_on_device(long long* slots) {
  static std::atomic<long long> cached[kMaxDevices];
  const auto kernel = spectral_apply_kernel<BC, V16>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*slots = cached[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<BC, V16>);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem<BC, V16>);
  if (err != cudaSuccess) return err;
  *slots = static_cast<long long>(std::max(per_sm, 1)) * sms;
  if (dev < kMaxDevices) cached[dev].store(*slots, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int BC, bool V16>
cudaError_t launch_kernel(const float2* x, const float2* w, float2* y, ApplyDims d,
                          cudaStream_t s) {
  long long slots = 0;
  const cudaError_t err = slots_on_device<BC, V16>(&slots);
  if (err != cudaSuccess) return err;
  // as many blocks as the card holds at once, none with less than a tile
  const long long grid = std::max(1LL, std::min(slots, d.pairs / kTilePairs));
  d.n_b_chunks = (d.B + BC - 1) / BC;
  if (static_cast<long long>(d.n_b_chunks) * d.n_co_chunks * (d.pairs / grid + 1) > INT_MAX)
    return cudaErrorInvalidConfiguration;
  spectral_apply_kernel<BC, V16><<<static_cast<unsigned>(grid), kThreads, kSmem<BC, V16>, s>>>(
      x, w, y, d);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound from Python with ctypes (ops.py). Pointers are device
// pointers of complex64 tensors: `x` with batch and channel strides `xs_b`,
// `xs_c` (in elements) and a contiguous run of K modes, `w` with contracted
// and output channel strides `w_in`, `w_out` and a contiguous run of K
// modes, `y` contiguous [B, CO, K]. The 16-byte path needs K, every stride
// in use even and the three pointers 16-byte aligned; anything else takes
// the 8-byte path. Launches on `stream` without synchronising and returns
// the first CUDA error of the launch (0 on success).
extern "C" int spectral_apply_launch(const void* x, const void* w, void* y,
                                     int B, int CI, int CO, long long K,
                                     long long xs_b, long long xs_c,
                                     long long w_in, long long w_out,
                                     int conj_w, void* stream) {
  if (B == 0 || CO == 0 || K == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CI == 0)  // an empty sum
    return static_cast<int>(
        cudaMemsetAsync(y, 0, static_cast<size_t>(B) * CO * K * sizeof(float2), s));
  ApplyDims d{B, CI, CO, K, xs_b, xs_c, w_in, w_out, conj_w, 0, 0, 0};
  d.n_co_chunks = (CO + kCoChunk - 1) / kCoChunk;
  d.pairs = (K + 1) / 2;
  const bool v16 = K % 2 == 0 && (B == 1 || xs_b % 2 == 0) &&
                   (CI == 1 || (xs_c % 2 == 0 && w_in % 2 == 0)) && (CO == 1 || w_out % 2 == 0) &&
                   aligned16(x) && aligned16(w) && aligned16(y);
  const float2* xp = static_cast<const float2*>(x);
  const float2* wp = static_cast<const float2*>(w);
  float2* yp = static_cast<float2*>(y);
  cudaError_t err;
  if (B == 1)
    err = v16 ? launch_kernel<1, true>(xp, wp, yp, d, s) : launch_kernel<1, false>(xp, wp, yp, d, s);
  else if (B == 2)
    err = v16 ? launch_kernel<2, true>(xp, wp, yp, d, s) : launch_kernel<2, false>(xp, wp, yp, d, s);
  else
    err = v16 ? launch_kernel<kBatchChunk, true>(xp, wp, yp, d, s)
              : launch_kernel<kBatchChunk, false>(xp, wp, yp, d, s);
  return static_cast<int>(err);
}
