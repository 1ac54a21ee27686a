// Forward attention with an online softmax (flash attention), f32 inside.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`).
// Plain version: `flash_attention_ref` in ../ref.py.
//
//   q [B, H,   SQ, D]  bf16 or f32, strides (qs0, qs1, qs2, 1)
//   k [B, KVH, SK, D]  q's type,    strides (ks0, ks1, ks2, 1)
//   v [B, KVH, SK, D]  q's type,    strides (vs0, vs1, vs2, 1)
//   o [B, H,   SQ, D]  q's type, contiguous
//
// It computes what the TPU kernel computes: logits = (q . k) * scale in f32
// (a bf16 x bf16 product is exact in f32, so the TPU kernel's upcast before
// the dot changes nothing but the order of the sum); a logit is valid when
// its key is < SK and, if causal, key <= query + (SK - SQ) (the offset on
// the true lengths); invalid logits are -1e30; the running max m, sum l and
// accumulator acc are updated per kv tile as m' = max(m, max(s)),
// p = exp(s - m'), l' = exp(m - m') l + sum(p), acc' = exp(m - m') acc +
// p . v; the output is acc / max(l, 1e-30), cast once to q's type. GQA:
// query head h reads kv head h / (H / KVH). D is one of 16, 32, 64, 128,
// 256. The TPU kernel carries m, l and acc in VMEM scratch from one kv grid
// step to the next; here the kv walk is a loop inside one CTA, since CTAs
// run in no order, and a causal CTA stops after the last kv tile any of its
// rows can see (the tiles it skips would add exp(-1e30 - m) = 0).
//
// What bounds it on an H100: at the gemma-7b prefill (B=1, H=KVH=16,
// SQ=SK=1000, D=256, bf16) it moves 32.8 MB (q, k, v, o once) and does
// 8.2 GFLOP after the causal cut, so against the bf16 tensor-core peak the
// bytes bound it (about 10 us); the first version did its products in f32
// FFMA from shared memory (0.690 ms there). This one puts them on the
// tensor cores and feeds them with TMA:
//   * one CTA per (b*h, 64-row query tile), one warpgroup; its thread 0
//     issues TMA loads of the q tile and of 64-key K and V tiles into a
//     ring of kStages = 2 stages, each load completing on an mbarrier, and
//     refills a stage once the warpgroup is past it, so tile t+1 is in
//     flight while tile t is computed;
//   * the tensor maps take the true (b, h, s, d) strides and extents, so
//     the strided views of the attention layer are read in place, and
//     TMA's zero fill covers the rows past SQ and the keys past SK (those
//     keys are masked too; only tiles that reach past SK or the causal
//     diagonal run the mask). Boxes are 64 columns (128 bytes) wide, the
//     span of the 128-byte swizzle: D = 256 is four boxes a row, and
//     D < 64 one box whose columns past D are zeros;
//   * S = Q K^T with `wgmma` m64n64k16 (both operands K-major in shared
//     memory); O += P V with `wgmma` m64nDk16, P from registers (the
//     accumulator layout of S is the A-operand layout of P . V) and V
//     MN-major in shared memory. P keeps f32 precision, as the TPU kernel's
//     does: p = p_hi + p_lo, two bf16 values, both into one accumulator
//     (about 16 bits of mantissa; 1.5x the algorithm's operations). The
//     softmax statistics stay in f32 registers;
//   * causal query tiles are launched heaviest first (blockIdx.y reversed);
//   * no atomics and no split over keys: two runs agree bitwise.
// At D = 256 a CTA's tiles take 160 KB of shared memory (one CTA per SM)
// and 225 registers a thread; at D <= 128, two CTAs share an SM. On an
// NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py phase 8,
// device time) it takes 0.047 ms at the gemma-7b prefill layer against
// SDPA's 0.028 ms (the first version: 0.690 ms), 0.031 and 0.043 ms at the
// chatglm3-6b and minitron-8b prefills (SDPA 0.025, 0.029 ms). What holds
// it back now is not settled:
// dropping p_lo saves about a tenth, a cheaper exp less; neither two
// consumer warpgroups sharing the K/V tiles nor two CTAs an SM (single K
// and V buffers, each refilled as soon as it is read) were faster, so it is
// not one warpgroup's serial softmax alone. Candidates: the 16 dependent
// m64n64k16 products of Q K^T at D = 256, shared-memory operand traffic.
// Left for later work: a ping-pong schedule of two warpgroups, wider key
// tiles for Q K^T, a TMA store of O.
//
// f32 operands (`flash_kernel_f32`, kept from the first version): products
// in f32 FFMA from shared memory, a far lower ceiling (the 67 TFLOP/s f32
// peak): each thread holds a 4 x (BK/16) block of logits and a 4 x (D/16)
// block of the output (rows ty + 16 i, columns tx + 16 j); q, k and p are
// read from shared memory as float4, and padded row strides keep the loads
// free of bank conflicts; ragged rows and keys are masked in the kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KVH, SQ, SK;
  long long qs[3], ks[3], vs[3];
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// f32 operands: FFMA from shared memory
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per CTA
constexpr int kTM = 4;   // query rows per thread: ty + 16 * i

template <int D>
struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;  // keys per kv tile
  static constexpr int TN = BK / 16;             // logit columns per thread
  static constexpr int TD = D / 16;              // output columns per thread
  // shared row strides, in floats: Q, K and P rows are read as float4, so
  // their strides stay multiples of 4; the pad of 4 spreads the 16 rows a
  // half-warp reads over all 32 banks
  static constexpr int QS = D + 4;
  static constexpr int KS = D + 4;
  static constexpr int VS = D;
  static constexpr int PS = BK + 4;
  static constexpr int kFloats = kBQ * QS + BK * KS + BK * VS + kBQ * PS;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel_f32(const Params p) {
  using TL = Tile<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * TL::QS;
  float* Vs = Ks + TL::BK * TL::KS;
  float* Ps = Vs + TL::BK * TL::VS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kBQ;
  const float* qp = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* kp = static_cast<const float*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const float* vp = static_cast<const float*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
  float* op = static_cast<float*>(p.o) + static_cast<long long>(bh) * p.SQ * D;

#pragma unroll 8
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = q0 + r;
    Qs[r * TL::QS + c] = row < p.SQ ? qp[row * p.qs[2] + c] : 0.f;
  }

  const int offset = p.SK - p.SQ;
  int n_keys = p.SK;
  if (p.causal) n_keys = max(0, min(p.SK, min(q0 + kBQ, p.SQ) + offset));
  const int n_tiles = (n_keys + TL::BK - 1) / TL::BK;

  float m[kTM], l[kTM], acc[kTM][TL::TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TL::TD; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TL::BK;
    __syncthreads();  // the q tile is stored; the last tile's reads are done
    // unrolled, so that a thread's loads of the tile are in flight eight
    // rows at a time before their stores to shared memory
#pragma unroll 8
    for (int idx = tid; idx < TL::BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int key = k0 + r;
      const bool in = key < p.SK;
      Ks[r * TL::KS + c] = in ? kp[key * p.ks[2] + c] : 0.f;
      Vs[r * TL::VS + c] = in ? vp[key * p.vs[2] + c] : 0.f;
    }
    __syncthreads();

    float s[kTM][TL::TN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[kTM], kv[TL::TN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * TL::QS + c]);
#pragma unroll
      for (int j = 0; j < TL::TN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * TL::KS + c]);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < TL::TN; ++j) {  // the sum runs over c in order
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool valid = key < p.SK && (!p.causal || key <= qpos);
        s[i][j] = valid ? s[i][j] * p.scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      // the 16 threads holding one row are lanes 0-15 or 16-31 of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        const float pij = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * TL::PS + tx + 16 * j] = pij;
        ps += pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TL::TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int k4 = 0; k4 < TL::BK; k4 += 4) {
      float4 pv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * TL::PS + k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // keys in order
#pragma unroll
        for (int j = 0; j < TL::TD; ++j) {
          const float vv = Vs[(k4 + kk) * TL::VS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float pik = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y : kk == 2 ? pv[i].z : pv[i].w;
            acc[i][j] = fmaf(pik, vv, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < p.SQ) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < TL::TD; ++j) {
        op[static_cast<long long>(row) * D + tx + 16 * j] = acc[i][j] / denom;
      }
    }
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t bytes = Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.SQ + kBQ - 1) / kBQ, p.B * p.H);
  flash_kernel_f32<D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 operands: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------

constexpr int kRows = 64;            // query rows per CTA
constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kBoxCols = 64;         // columns per TMA box: 128 bytes a row
constexpr int kBoxBytes = 64 * 128;  // a box of 64 rows (query rows or keys)
constexpr int kStages = 2;           // K/V ring
constexpr int kBf16Threads = 128;    // one warpgroup; its thread 0 issues the loads

template <int D>
struct Bf16Tile {
  static constexpr int DP = D < kBoxCols ? kBoxCols : D;  // columns loaded (zeros past D)
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;   // a q, K or V tile
  // tiles first, 1024-byte aligned for the swizzle; the barriers after
  static constexpr int kSmem = 1024 + (1 + 2 * kStages) * kTileBytes + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at `dst`, completing `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: `lbo` and
// `sbo` in bytes (K-major: sbo = 8 rows of 128 bytes, lbo unused; MN-major:
// lbo = the step to the next 64 columns, sbo = the step to the next 8 rows).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins an operand's registers to this point of the program: before
// wgmma.fence, so that what a thread wrote to them is in place before the
// products read them; after the wait, so that nothing reads an accumulator
// while the asynchronous products still write it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S[64 x 64] += A[64 x 16] B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// O[64 x N] += A[64 x 16] B[16 x N]: A from registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 2)
flash_kernel_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using TL = Bf16Tile<D>;
  constexpr int DP = TL::DP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + TL::kTileBytes;               // + stage * kTileBytes
  const uint32_t v_s = k_s + kStages * TL::kTileBytes;     // + stage * kTileBytes
  const uint32_t q_full = v_s + kStages * TL::kTileBytes;  // barriers, 8 bytes each
  const uint32_t k_full = q_full + 8;                      // + 8 stage
  const uint32_t v_full = k_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first
  const int offset = p.SK - p.SQ;
  int n_keys = p.SK;
  if (p.causal) n_keys = max(0, min(p.SK, min(q0 + kRows, p.SQ) + offset));
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the K and V tiles of kv step t into stage t % kStages
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    mbar_expect_tx(k_full + 8 * s, TL::kTileBytes);
    for (int bx = 0; bx < TL::kBoxes; ++bx)
      tma_load(k_s + s * TL::kTileBytes + bx * kBoxBytes, &tk, k_full + 8 * s,
               bx * kBoxCols, t * kKeys, kvh, b);
    mbar_expect_tx(v_full + 8 * s, TL::kTileBytes);
    for (int bx = 0; bx < TL::kBoxes; ++bx)
      tma_load(v_s + s * TL::kTileBytes + bx * kBoxBytes, &tv, v_full + 8 * s,
               bx * kBoxCols, t * kKeys, kvh, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, TL::kTileBytes);
    for (int bx = 0; bx < TL::kBoxes; ++bx)
      tma_load(q_s + bx * kBoxBytes, &tq, q_full, bx * kBoxCols, q0, h, b);
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_kv(t);
  }
  __syncthreads();

  // thread (warp, lane) holds rows r and r + 8 of the tile, and
  // in each 8-column group j the columns 8 j + 2 (lane % 4) + {0, 1}
  const int r = 16 * warp + lane / 4;
  const int qpos0 = q0 + r + offset;
  const int qpos1 = qpos0 + 8;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const uint32_t k_tile = k_s + s * TL::kTileBytes;
    const uint32_t v_tile = v_s + s * TL::kTileBytes;

    // S = Q K^T over DP / 16 steps of 16 columns (32 bytes inside a box)
    float sc[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    mbar_wait(k_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      const uint32_t col = (kd / 4) * kBoxBytes + (kd % 4) * 32;
      wgmma_ss(sc, smem_desc(q_s + col, 16, 1024), smem_desc(k_tile + col, 16, 1024));
    }
    wgmma_commit_and_wait();
    fence_regs(sc);

    // online softmax in f32: sc[4 j + e] is row r (e < 2) or r + 8 (e >= 2),
    // key t * kKeys + 8 j + 2 (lane % 4) + (e & 1). Only a tile that reaches
    // past SK or, if causal, past the tile's first query needs the mask.
    const int key0 = t * kKeys + 2 * (lane % 4);
    const bool masked = (t + 1) * kKeys > p.SK || (p.causal && (t + 1) * kKeys - 1 > q0 + offset);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * j + e];
        x *= p.scale;
        if (masked) {
          const int key = key0 + 8 * j + (e & 1);
          if (key >= p.SK || (p.causal && key > (e < 2 ? qpos0 : qpos1))) x = kNegInf;
        }
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    // the 4 lanes holding a row are lane / 4's quad
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * j + e];
        x = expf(x - (e < 2 ? mn0 : mn1));
        if (e < 2) ps0 += x; else ps1 += x;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = alpha0 * l0 + ps0;
    l1 = alpha1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i % 4) < 2 ? alpha0 : alpha1;

    // P as the A operand of P . V: for 16 keys kk, register i holds
    // sc[8 kk + 2 i] and sc[8 kk + 2 i + 1]; split into bf16 hi + lo
    uint32_t p_hi[kKeys / 4], p_lo[kKeys / 4];
#pragma unroll
    for (int i = 0; i < kKeys / 4; ++i) {
      const float a = sc[2 * i], c = sc[2 * i + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
      const float2 back = __bfloat1622float2(hi);
      p_hi[i] = bf16x2_bits(hi);
      p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(a - back.x, c - back.y));
    }

    // O += P_hi V + P_lo V in steps of 16 keys (16 rows of 128 bytes)
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_wait(v_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t vd = smem_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024);
      wgmma_rs(o, p_hi + 4 * kk, vd);
      wgmma_rs(o, p_lo + 4 * kk, vd);
    }
    wgmma_commit_and_wait();
    fence_regs(o);
    // every warp's products on stage s are done: refill it
    __syncthreads();
    if (threadIdx.x == 0 && t + kStages < n_tiles) load_kv(t + kStages);
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + static_cast<long long>(bh) * p.SQ * D;
  const int row0 = q0 + r, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col < D) {
      if (row0 < p.SQ)
        *reinterpret_cast<__nv_bfloat162*>(op + static_cast<long long>(row0) * D + col) =
            __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (row1 < p.SQ)
        *reinterpret_cast<__nv_bfloat162*>(op + static_cast<long long>(row1) * D + col) =
            __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver at run time so that the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A [B, heads, S, D] bf16 operand with element strides st = (b, h, s) as a
// 4-D tensor map (d, s, h, b) of 64 x 64 boxes, 128-byte swizzled; reads
// past the extents are zeros. A dim of extent 1 is never stepped over, so
// it gets the packed stride whatever its own.
bool encode(CUtensorMap* map, const void* ptr, int B, int heads, int S, int D,
            const long long* st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  cuuint64_t packed = 2ull * D;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? 2ull * st[2 - i] : packed;
    packed = strides[i] * dims[i + 1];
  }
  static_assert(kRows == 64 && kKeys == 64, "one box shape serves q, K and V");
  const cuuint32_t box[4] = {kBoxCols, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (p.SK <= 0 || !encode(&tq, p.q, p.B, p.H, p.SQ, D, p.qs) ||
      !encode(&tk, p.k, p.B, p.KVH, p.SK, D, p.ks) ||
      !encode(&tv, p.v, p.B, p.KVH, p.SK, D, p.vs))
    return cudaErrorInvalidValue;
  const int bytes = Bf16Tile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.SQ + kRows - 1) / kRows);
  flash_kernel_bf16<D><<<grid, kBf16Threads, bytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(p, stream) : launch_f32<D>(p, stream);
}

}  // namespace

// strides: q's (b, h, s) strides, then k's, then v's, in elements. Launches
// on `stream` without synchronising; is_bf16 selects the type of q, k, v and
// o (1: bf16, the wgmma kernel, which needs 16-byte aligned base pointers
// and (b, h, s) strides; 0: f32, the FFMA kernel). Returns 0 or the CUDA
// error of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int KVH, int SQ, int SK, int D,
                                      const long long* strides, float scale, int causal,
                                      int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || SQ <= 0) return 0;
  if (KVH <= 0 || H % KVH) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.SQ = SQ;
  p.SK = SK;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
  }
  p.scale = scale;
  p.causal = causal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(p, is_bf16, s); break;
    case 32: err = launch<32>(p, is_bf16, s); break;
    case 64: err = launch<64>(p, is_bf16, s); break;
    case 128: err = launch<128>(p, is_bf16, s); break;
    case 256: err = launch<256>(p, is_bf16, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
