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
// It computes what the TPU kernel computes: q, k and v upcast to f32;
// logits = (q . k) * scale; a logit is valid when its key is < SK and, if
// causal, key <= query + (SK - SQ) (the offset on the true lengths);
// invalid logits are -1e30; the running max m, sum l and accumulator acc
// are updated per kv tile as m' = max(m, max(s)), p = exp(s - m'),
// l' = exp(m - m') l + sum(p), acc' = exp(m - m') acc + p . v; the output
// is acc / max(l, 1e-30), cast once to q's type. GQA: query head h reads kv
// head h / (H / KVH). D is one of 16, 32, 64, 128, 256.
//
// The TPU kernel walks a (B*H, SQ/128, SK/128) grid in order and carries
// m, l and acc in VMEM scratch from one kv step to the next. Here the kv
// walk is a loop inside one CTA, since CTAs run in no order: one CTA per
// (b*h, 64-row query tile), 256 threads, q tile resident in shared memory,
// K and V tiles staged through shared memory one after the other. Ragged
// tails are masked in the kernel: rows past SQ are not loaded (zeros) and
// not stored, keys past SK are loaded as zeros and masked, so the wrapper
// pads nothing and reads the strided views it is given in place. A causal
// CTA stops after the last kv tile any of its rows can see; the tiles it
// skips would add exp(-1e30 - m) = 0 to every sum, so skipping them changes
// no result.
//
// What bounds it on an H100: at the gemma-7b prefill (B=1, H=KVH=16,
// SQ=SK=1000, D=256, bf16) it moves 32.8 MB (q, k, v, o once) and does
// 8.2 GFLOP after the causal cut; against the bf16 tensor-core peak the
// bytes bound it (about 10 us). This kernel does its products in f32 FFMA
// from shared memory, a far lower ceiling (8.2 GFLOP at the 67 TFLOP/s f32
// peak is 0.12 ms): each thread holds a 4 x (BK/16) block of logits and a
// 4 x (D/16) block of the output (rows ty + 16 i, columns tx + 16 j); q, k
// and p are read from shared memory as float4, so one load feeds 8 (logits)
// or 3-4 (P . V) FFMAs, and padded row strides keep the loads free of bank
// conflicts. A thread starts its loads of a K/V tile eight at a time (the
// load loop is unrolled) before it stores them. At D = 256 the 64-row q tile, a
// 32-key K and V tile and the P tile take 139 KB of shared memory,
// above the 48 KB static limit, so the launch raises the kernel's dynamic
// limit; one CTA runs per SM there. Tensor-core products (mma/wgmma on bf16
// operands), TMA loads, double-buffered K/V tiles and more CTAs per SM are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(const Params p) {
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
  const T* qp = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* kp = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const T* vp = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
  T* op = static_cast<T*>(p.o) + static_cast<long long>(bh) * p.SQ * D;

#pragma unroll 8
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = q0 + r;
    Qs[r * TL::QS + c] = row < p.SQ ? to_f32(qp[row * p.qs[2] + c]) : 0.f;
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
      Ks[r * TL::KS + c] = in ? to_f32(kp[key * p.ks[2] + c]) : 0.f;
      Vs[r * TL::VS + c] = in ? to_f32(vp[key * p.vs[2] + c]) : 0.f;
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
        op[static_cast<long long>(row) * D + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.SQ + kBQ - 1) / kBQ, p.B * p.H);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q's (b, h, s) strides, then k's, then v's, in elements. Launches
// on `stream` without synchronising; is_bf16 selects the type of q, k, v and
// o (1: bf16, 0: f32). Returns 0 or the CUDA error of the launch.
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
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(p, D, s) : launch_d<float>(p, D, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
