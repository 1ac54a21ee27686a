// Weight cotangent of the fused FNO spectral op, on the kept modes only.
//
// Replaces the Pallas TPU kernel `spectral_fused_dw`
// (src/repro/kernels/spectral_conv/kernel.py:307). Plain version:
// `spectral_fused_dw_ref` in ../ref.py.
//
//   x  [B, CI, E1, E2, E3, Tx]  complex64, any strides: the spectrum the
//                               forward consumed (on the card the saved
//                               4-D rfftn output, t outermost)
//   g  [B, CO, E1, E2, E3, Tg]  complex64, any strides: the cotangent of the
//                               forward's output, as the irfftn backward
//                               hands it over (t innermost)
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
// What bounds it on an H100: bytes written. At the training block (micro-
// batch 1, CI=CO=40, E=(64,32,32), T=45, K=(48,32,16,10)) it writes 3.15 GB
// of w and needs only 79 MB each of x and g (their kept positions), against
// 2 complex FMAs per output per batch row: 0.986 ms at 3.35 TB/s. The first
// version ran a thread per output and a block per (ci, co): its x reads ran
// along t, 512 KB apart in cuFFT's layout, and every block re-read its mode
// tile of x and g from L2 (6.3 GB). This design:
//   * a tile is a box of kept modes that is one contiguous run of w for
//     each (ci, co) -- whole (k3, kt) planes of a few (k1, k2) rows, else a
//     run of k3 with all kt, else a run of kt -- for a tile of up to
//     kChannelTile input and kChannelTile output channels, all batch rows;
//     the box holds as many modes as the stage budget (kStageBytes) allows:
//     one (k1, k2) row of 160 modes at the training block;
//   * the tile's x and g go to shared memory with 8-byte cp.async gathers
//     through per-mode offset tables. Neighbouring threads take the kept
//     dimension (k3 or kt) whose stride is smaller -- the launcher picks it
//     from the strides: e3 for x in cuFFT's layout, t for g -- so the loads
//     coalesce whatever the layout. Each staged value feeds a whole row of
//     outputs, so x and g are read from device memory about once;
//   * a warp computes one ci against kRows co at a time; each lane owns a
//     pair of neighbouring modes, so one 16-byte shared load of x feeds
//     kRows rows (stage rows have an even stride, so every pair is
//     aligned), and writes each row's pair with one 16-byte streaming
//     store (two 8-byte ones only where w's pair is not aligned, which
//     needs an odd K or tile start). Every output is written exactly once:
//     nothing is zero-filled or masked;
//   * the batch loop runs inside the thread over the staged rows in a fixed
//     order, with no atomics: two launches agree bitwise;
//   * one persistent block per SM walks the tiles with two stages: the
//     gathers of the next tile fly while the current one is stored, so the
//     stores never wait for a gather (with a block per tile, all SMs gather
//     at once, and the card's stores stall for it every wave).
// One launch per call; the only allocation is the caller's w. On an NVIDIA
// H100 80GB HBM3 at a 700 W power limit (launch/ab_dw.py, CUDA events) it
// takes 1.46-1.48 ms at the training block on the FFT layouts (the first
// version: 4.68 ms), against 0.98 ms for zero_() of a w-sized tensor. What
// is left: the gathers, though overlapped, cost 0.25-0.30 ms (the same
// kernel without them: 1.19-1.21 ms) -- some 1,400 short reads a tile
// interleaved with the write stream.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChannelTile = 40;         // ci and co per tile
constexpr int kStageBytes = 100 * 1024;  // x and g of one tile, all batch rows
constexpr int kMaxModes = 512;           // modes per tile (offset tables)
constexpr int kRows = 4;                 // co rows a warp computes together

struct DwDims {
  int B, CI, CO;
  int K1, K2, K3, KT;
  int N1, N2, N3;
  long long xs[6];  // strides of x, in complex elements
  long long gs[6];  // strides of g, in complex elements
  // the tiling, set by the launcher
  int ct_i, ct_o;     // channels per tile
  int nr, n3, nt;     // mode box: (k1, k2) rows, k3, kt
  int modes;          // nr * n3 * nt rounded up to even: row stride of a stage
  int tiles_r, tiles_3, tiles_t, tiles_ci, tiles_co, n_tiles;
  int x_kt_fast, g_kt_fast;  // neighbouring threads gather along kt (1) or k3 (0)
};

// Kept index -> full-spectrum position.
__device__ __forceinline__ int full_index(int k, int n, int kd) {
  if (n < 0) return k;
  return k < (kd >> 1) ? k : n - kd + k;
}

// One tile: its channel ranges and its mode box, clipped at the edges.
struct Tile {
  int ci0, nci, co0, nco;
  int r0, nr, k30, n3, kt0, nt;
  int len;       // modes in the box
  long long k0;  // flattened kept index of its first mode
};

__device__ __forceinline__ Tile tile_of(int t, const DwDims& d) {
  Tile s;
  const int co_t = t % d.tiles_co;
  t /= d.tiles_co;
  const int ci_t = t % d.tiles_ci;
  t /= d.tiles_ci;
  const int kt_t = t % d.tiles_t;
  t /= d.tiles_t;
  const int k3_t = t % d.tiles_3;
  const int r_t = t / d.tiles_3;
  s.ci0 = ci_t * d.ct_i;
  s.nci = min(d.ct_i, d.CI - s.ci0);
  s.co0 = co_t * d.ct_o;
  s.nco = min(d.ct_o, d.CO - s.co0);
  s.r0 = r_t * d.nr;
  s.nr = min(d.nr, d.K1 * d.K2 - s.r0);
  s.k30 = k3_t * d.n3;
  s.n3 = min(d.n3, d.K3 - s.k30);
  s.kt0 = kt_t * d.nt;
  s.nt = min(d.nt, d.KT - s.kt0);
  s.len = s.nr * s.n3 * s.nt;
  s.k0 = (static_cast<long long>(s.r0) * d.K3 + s.k30) * d.KT + s.kt0;
  return s;
}

// Entry j of an operand's gather order: its mode's place in the stage row
// (`m`) and its offset in one (b, channel) plane of the operand (`off`).
// With kt_fast, consecutive j step along kt first, else along k3.
__device__ __forceinline__ void gather_entry(int j, int kt_fast, const Tile& s,
                                             const DwDims& d,
                                             const long long* st, int* m,
                                             long long* off) {
  int ktl, k3l;
  if (kt_fast) {
    ktl = j % s.nt;
    j /= s.nt;
    k3l = j % s.n3;
    j /= s.n3;
  } else {
    k3l = j % s.n3;
    j /= s.n3;
    ktl = j % s.nt;
    j /= s.nt;
  }
  const int rl = j;
  *m = (rl * s.n3 + k3l) * s.nt + ktl;
  const int r = s.r0 + rl;
  const long long e1 = full_index(r / d.K2, d.N1, d.K1);
  const long long e2 = full_index(r % d.K2, d.N2, d.K2);
  const long long e3 = full_index(s.k30 + k3l, d.N3, d.K3);
  *off = e1 * st[2] + e2 * st[3] + e3 * st[4] +
         static_cast<long long>(s.kt0 + ktl) * st[5];
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the gathers of one operand's tile, [B][n_ch][len] rows of the stage
// at row stride d.modes, through the offset table (m_tab, o_tab): a warp per
// (b, channel) row, its lanes along the table.
__device__ __forceinline__ void gather(const float2* __restrict__ src,
                                       const long long* st, int ch0, int n_ch,
                                       int ct, const Tile& s, const DwDims& d,
                                       const int* m_tab, const long long* o_tab,
                                       float2* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int bc = warp; bc < d.B * n_ch; bc += kWarps) {
    const int b = bc / n_ch, c = bc - b * n_ch;
    const float2* from = src + b * st[0] + (ch0 + c) * st[1];
    float2* to = stage + (b * ct + c) * d.modes;
    for (int j = lane; j < s.len; j += 32) cp_async8(to + m_tab[j], from + o_tab[j]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
spectral_fused_dw_kernel(const float2* __restrict__ x,
                         const float2* __restrict__ g,
                         float2* __restrict__ w, DwDims d) {
  extern __shared__ float4 smem[];
  __shared__ int m_tab[2][kMaxModes];
  __shared__ long long o_tab[2][kMaxModes];

  const int x_rows = d.B * d.ct_i, g_rows = d.B * d.ct_o;
  const int stage_elems = (x_rows + g_rows) * d.modes;
  float2* stages = reinterpret_cast<float2*>(smem);
  const long long K =
      static_cast<long long>(d.K1) * d.K2 * d.K3 * d.KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Tables of tile t, then its gathers into stage `buf` (one commit group).
  auto load = [&](int t, int buf) {
    const Tile s = tile_of(t, d);
    for (int j = threadIdx.x; j < s.len; j += kThreads) {
      gather_entry(j, d.x_kt_fast, s, d, d.xs, &m_tab[0][j], &o_tab[0][j]);
      gather_entry(j, d.g_kt_fast, s, d, d.gs, &m_tab[1][j], &o_tab[1][j]);
    }
    __syncthreads();
    float2* xst = stages + buf * stage_elems;
    gather(x, d.xs, s.ci0, s.nci, d.ct_i, s, d, m_tab[0], o_tab[0], xst);
    gather(g, d.gs, s.co0, s.nco, d.ct_o, s, d, m_tab[1], o_tab[1],
           xst + x_rows * d.modes);
  };

  int t = blockIdx.x;
  load(t, 0);
  cp_async_commit();
  for (int it = 0; t < d.n_tiles; ++it, t += gridDim.x) {
    const int buf = it & 1;
    __syncthreads();  // the other stage and the tables are free again
    if (t + static_cast<int>(gridDim.x) < d.n_tiles) load(t + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();  // every thread's gathers of tile t have landed

    const Tile s = tile_of(t, d);
    const float2* xst = stages + buf * stage_elems;
    const float2* gst = xst + x_rows * d.modes;
    const int xb = d.ct_i * d.modes, gb = d.ct_o * d.modes;
    // A warp takes ci and a group of kRows co: each lane owns pairs of
    // modes (m, m + 1), m even, one 16-byte load of x feeding kRows rows.
    const int groups = (s.nco + kRows - 1) / kRows;
    for (int item = warp; item < s.nci * groups; item += kWarps) {
      const int ci = item / groups;
      const int co = (item - ci * groups) * kRows;
      const float2* xr = xst + ci * d.modes;
      const float2* gr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) gr[r] = gst + min(co + r, s.nco - 1) * d.modes;
      // w's run for (ci, co) starts here; row r's K further on
      const long long start =
          (static_cast<long long>(s.ci0 + ci) * d.CO + s.co0 + co) * K + s.k0;
      for (int m = 2 * lane; m < s.len; m += 64) {
        float4 acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int b = 0; b < d.B; ++b) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + b * xb + m);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 gv = *reinterpret_cast<const float4*>(gr[r] + b * gb + m);
            // conj(x) * g = (xr gr + xi gi) + i (xr gi - xi gr), twice
            acc[r].x = fmaf(xv.x, gv.x, acc[r].x);
            acc[r].x = fmaf(xv.y, gv.y, acc[r].x);
            acc[r].y = fmaf(xv.x, gv.y, acc[r].y);
            acc[r].y = fmaf(-xv.y, gv.x, acc[r].y);
            acc[r].z = fmaf(xv.z, gv.z, acc[r].z);
            acc[r].z = fmaf(xv.w, gv.w, acc[r].z);
            acc[r].w = fmaf(xv.z, gv.w, acc[r].w);
            acc[r].w = fmaf(-xv.w, gv.z, acc[r].w);
          }
        }
        const bool pair = m + 1 < s.len;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (co + r >= s.nco) break;
          const long long at = start + r * K + m;
          float2* dst = w + at;
          // a 16-byte store where w's pair is aligned (always, when K and
          // the tile's first mode are even), else two 8-byte ones
          if (pair && !(at & 1)) {
            __stcs(reinterpret_cast<float4*>(dst), acc[r]);
          } else {
            __stcs(dst, make_float2(acc[r].x, acc[r].y));
            if (pair) __stcs(dst + 1, make_float2(acc[r].z, acc[r].w));
          }
        }
      }
    }
  }
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
  DwDims d{};
  d.B = B, d.CI = CI, d.CO = CO;
  d.K1 = K1, d.K2 = K2, d.K3 = K3, d.KT = KT;
  d.N1 = N1, d.N2 = N2, d.N3 = N3;
  for (int i = 0; i < 6; ++i) {
    d.xs[i] = xs[i];
    d.gs[i] = gs[i];
  }
  const long long R = static_cast<long long>(K1) * K2;
  const long long P = static_cast<long long>(K3) * KT;
  if (CI == 0 || CO == 0 || R * P == 0) return 0;

  // Channel tiles, narrowed only when two modes of all batch rows would
  // not fit the stage; then the longest mode box that does, its row
  // stride rounded up to even so that pairs of modes load as 16 bytes.
  const long long rows_b = std::max(B, 1);
  d.ct_i = std::min(CI, kChannelTile);
  d.ct_o = std::min(CO, kChannelTile);
  if (16 * rows_b * (d.ct_i + d.ct_o) > kStageBytes) {
    const int c = static_cast<int>(std::max(1LL, kStageBytes / (32 * rows_b)));
    d.ct_i = std::min(CI, c);
    d.ct_o = std::min(CO, c);
    if (16 * rows_b * (d.ct_i + d.ct_o) > kStageBytes)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long fit = std::min<long long>(
      kMaxModes, kStageBytes / (8 * rows_b * (d.ct_i + d.ct_o))) & ~1LL;
  if (P <= fit) {
    d.nr = static_cast<int>(std::min(R, fit / P)), d.n3 = K3, d.nt = KT;
  } else if (KT <= fit) {
    d.nr = 1, d.n3 = static_cast<int>(fit / KT), d.nt = KT;
  } else {
    d.nr = 1, d.n3 = 1, d.nt = static_cast<int>(fit);
  }
  d.modes = (d.nr * d.n3 * d.nt + 1) & ~1;
  d.tiles_r = static_cast<int>((R + d.nr - 1) / d.nr);
  d.tiles_3 = (K3 + d.n3 - 1) / d.n3;
  d.tiles_t = (KT + d.nt - 1) / d.nt;
  d.tiles_ci = (CI + d.ct_i - 1) / d.ct_i;
  d.tiles_co = (CO + d.ct_o - 1) / d.ct_o;
  const long long n_tiles = static_cast<long long>(d.tiles_r) * d.tiles_3 *
                            d.tiles_t * d.tiles_ci * d.tiles_co;
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  d.n_tiles = static_cast<int>(n_tiles);
  auto magnitude = [](long long v) { return v < 0 ? -v : v; };
  d.x_kt_fast = magnitude(xs[5]) <= magnitude(xs[4]);
  d.g_kt_fast = magnitude(gs[5]) <= magnitude(gs[4]);

  const int bytes = static_cast<int>(2 * 8 * rows_b * (d.ct_i + d.ct_o) * d.modes);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_fused_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, spectral_fused_dw_kernel, kThreads, bytes)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = static_cast<int>(
      std::min<long long>(d.n_tiles, static_cast<long long>(sms) * std::max(per_sm, 1)));
  spectral_fused_dw_kernel<<<blocks, kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(g),
      static_cast<float2*>(w), d);
  return static_cast<int>(cudaGetLastError());
}
