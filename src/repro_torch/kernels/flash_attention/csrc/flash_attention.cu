// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// function `flash_attention` (:88; Pallas body `_kernel`, :29-85): attention
// forward with causal, sliding-window and tanh soft-cap masks, GQA (kv head =
// h / (H/KV)) and a `kv_len` mask, fp32 online softmax (m, l, acc), key tiles
// that no row can see skipped.
//
// Layout: the model's own. q, o (B, Sq, H, Dh); k, v (B, Sk, KV, Dh); the
// head dimension contiguous, every other stride given (in elements). Any Sq
// and Sk: the kernel masks the ragged last key tile itself (keys past Sk get
// -inf and never count) and stores no row past Sq, so the caller neither
// pads nor transposes. Numerics as the TPU kernel: scale = Dh^-0.5 before the
// soft-cap; finite NEG_INF = -1e30 for masked keys; l clamped at 1e-30.
//
// Two kernels, picked by dtype in the C entry point:
//
// bf16 (the serving path): tensor cores and TMA. One warpgroup (128 threads)
// owns 64 query rows of one (b, h). Q comes by TMA once; K and V tiles of 32
// keys come by TMA (4-D tensor maps over (Dh, heads, S, B), so the strides
// live in the descriptor) into a ring of 2 stages, K and V each with their
// own mbarrier, so each is refilled as soon as its last reader is done and
// arrives a whole tile before it is needed. S = Q K^T is a `wgmma`
// m64n32k16 chain with both operands in shared memory; the online softmax
// runs on S in fp32 registers; P goes to bf16 in registers and O += P V is
// a `wgmma` m64n{Dh}k16 chain with A from registers (P never touches shared
// memory) and V read MN-major from shared memory. The loop is
// software-pipelined: S_{j+1} is issued before P_j V_j, and its softmax runs
// while P_j V_j is on the tensor cores. Masks are evaluated only on the key
// tiles that need them. The shared tiles use the 128-byte swizzle (64-byte
// at Dh 32, 32-byte at Dh 16) that TMA writes and `wgmma` reads; Dh > 64 is
// held as slabs of 64 columns. Dh in {16, 32, 64, 120, 128, 160, 256}. A
// Dh that is not a multiple of 64 (H2O-Danube3's 120, StableLM-2's 160) runs
// at the padded width DP, 128 and 192: the tensor maps carry the real Dh as
// their inner extent, so TMA fills the last slab's columns past Dh with
// zeros; both products run over DP (the zero columns add nothing to Q K^T,
// and give zero output columns in P V), and only columns < Dh are stored.
// Nothing is padded in device memory. At Dh 256 the O accumulator is 128
// fp32 registers a thread (96 at DP 192), and Q plus two stages of K and V
// take 96 KB of shared memory (72 KB at DP 192, 48 KB at Dh 128), so
// several blocks share an SM. The TMA encoder (`cuTensorMapEncodeTiled`, a
// driver-API call) is fetched with `cudaGetDriverEntryPoint`, so the library
// links no -lcuda.
//
// fp32: the CUDA-core kernel of the first port (both products as fp32 FMAs,
// as the TPU kernel's `astype(float32)`); TF32 products would not hold the
// fp32 tolerance of 1e-5. It reads the same strided layout.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), at the
// serving paths' prefill shapes (bf16, B=4, S=500, causal):
//   StarCoder2-3B, H=24 KV=2 Dh=128: q + k + v + o = 26.6 MB -> 7.9 us;
//     4 * B * H * 125,250 pairs * Dh = 6.2 GFLOP -> 6.2 us. Bytes bound.
//   RecurrentGemma-9B, H=16 KV=1 Dh=256 (window 2048): 34.8 MB -> 10.4 us.
// The CUDA-core kernel this replaces at bf16 took 0.507 and 0.995 ms there
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 12), bounded by its own fp32
// FMA rate (>= 96 us for the StarCoder2 work alone) and by the transposed,
// padded copies its wrapper made. Here the products run at tensor-core
// rate, the copies are gone, and what is left is one pass over q and o and
// one pass over k, v per 64-row query tile (the GQA heads sharing a kv head
// read it from L2).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

// ------------------------------------------------ fp32, CUDA cores
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * kRowsPerWarp;   // 64 query rows per block
constexpr int kBK = 64;                      // 64 keys per tile: 2 per lane
constexpr int kKStride = kBK + 1;            // padded K^T row: no bank conflicts

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// NT = number of 32-wide chunks of the head dimension each lane owns in
// the output accumulator (lane owns dims lane, lane+32, ...): Dh <= 32*NT.
template <int NT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides sq,
              Strides sk, Strides sv, Strides so, int H, int KV, int Sq,
              int Sk, int Dh, int causal, int window, float cap, float scale,
              int kv_len, float* __restrict__ lse) {
  extern __shared__ float smem[];
  float* kT = smem;                    // [Dh][kKStride]  K tile, transposed
  float* vs = kT + Dh * kKStride;      // [kBK][Dh]       V tile
  float* qs = vs + kBK * Dh;           // [kBQ][Dh]       Q tile

  // Last query tiles first: under a causal mask they carry the most keys.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * kRowsPerWarp;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + g * sk.h;
  const float* vb = v + b * sv.b + g * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBQ * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    const int qpos = q0 + r;
    qs[i] = qpos < Sq ? qb[qpos * sq.s + d] : 0.f;
  }

  // Keys no row of this tile can see are never loaded.
  int k_begin = 0, k_end = Sk;
  if (kv_len >= 0) k_end = min(k_end, kv_len);
  if (causal) k_end = min(k_end, q0 + kBQ);
  if (window > 0) k_begin = max(0, q0 - window + 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q staged / previous K, V tile fully consumed
    for (int i = tid; i < kBK * Dh; i += kThreads) {
      const int j = i / Dh, d = i - j * Dh;
      const int kpos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kpos < Sk) {
        kx = kb[kpos * sk.s + d];
        vx = vb[kpos * sv.s + d];
      }
      kT[d * kKStride + j] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    // s[r][c]: score of row (row0 + r) against key (k0 + lane + 32c).
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float ka = kT[d * kKStride + lane];
      const float kb2 = kT[d * kKStride + lane + 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = qs[(row0 + r) * Dh + d];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kb2, s[r][1]);
      }
    }

    // Scale, softcap, masks; online softmax update. s becomes p.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + row0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        float x = s[r][c] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (kv_len >= 0) ok = ok && kpos < kv_len;
        x = ok ? x : kNegInf;
        if (kpos >= Sk) x = -INFINITY;
        s[r][c] = x;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= corr;
      s[r][0] = p0;
      s[r][1] = p1;
    }

    // acc[r][:] += sum_j p[r][j] * V[j][:]; p[r][j] lives in lane j % 32.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      for (int jj = 0; jj < 32; ++jj) {
        const int j = 32 * c + jj;
        float vx[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          vx[t] = d < Dh ? vs[j * Dh + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pj = __shfl_sync(kFull, s[r][c], jj);
#pragma unroll
          for (int t = 0; t < NT; ++t) acc[r][t] = fmaf(pj, vx[t], acc[r][t]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * H + h) * Sq + qpos] = m[r] + logf(denom);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) ob[qpos * so.s + d] = acc[r][t] / denom;
    }
  }
}

template <int NT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       Strides sq, Strides sk, Strides sv, Strides so, int B,
                       int H, int KV, int Sq, int Sk, int Dh, int causal,
                       int window, float cap, float scale, int kv_len,
                       float* lse, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)Dh * kKStride + (size_t)kBK * Dh +
                       (size_t)kBQ * Dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_f32<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so, H,
      KV, Sq, Sk, Dh, causal, window, cap, scale, kv_len, lse);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         Strides sq, Strides sk, Strides sv, Strides so, int B,
                         int H, int KV, int Sq, int Sk, int Dh, int causal,
                         int window, float cap, float scale, int kv_len,
                         float* lse, cudaStream_t st) {
  if (Dh <= 32)
    return launch_f32<1>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk, Dh,
                         causal, window, cap, scale, kv_len, lse, st);
  if (Dh <= 64)
    return launch_f32<2>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk, Dh,
                         causal, window, cap, scale, kv_len, lse, st);
  if (Dh <= 128)
    return launch_f32<4>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk, Dh,
                         causal, window, cap, scale, kv_len, lse, st);
  return launch_f32<8>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk, Dh,
                       causal, window, cap, scale, kv_len, lse, st);
}

// ------------------------------------------------ bf16, wgmma + TMA
constexpr int kRows = 64;     // query rows per block (one warpgroup)
constexpr int kStages = 2;    // K/V ring depth

// keys per K/V tile: 32 keeps S and P small in registers and a block's
// shared memory at 48 KB (Dh 128), so several blocks share an SM and hide
// each other's load latency (32 measured faster than 64 at both serving
// shapes on the H100)
constexpr int kKeys = 32;
constexpr int kWgThreads = 128;

// Accumulator layout of a 64 x N wgmma tile, thread t of the warpgroup:
// register 4c + 2r + e holds row 16 (t / 32) + (t % 32) / 4 + 8r, column
// 8c + 2 (t % 4) + e.

// S = Q K^T for one key tile, issued and committed, not waited for.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[kKeys / 2], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    WgmmaSS<kKeys>::run(s, desc_kmajor<DH, kRows>(q_tile, kk),
                       desc_kmajor<DH, kKeys>(k_tile, kk), kk > 0);
  wgmma_commit();
}

// O += P V for one key tile, P from registers; issued and committed.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2],
                                         const uint32_t (&pa)[kKeys / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    WgmmaRS<DH>::run(acc, pa[kk], desc_mnmajor<DH, kKeys>(v_tile, kk));
  wgmma_commit();
}

// Online softmax of one 64 x 64 score tile in base 2: s becomes p; m and
// this thread's share of l are updated; corr is the factor the output rows
// must still be scaled by. Masks are evaluated only on tiles that need them.
struct SoftmaxArgs {
  int q0, Sk, causal, window, kv_len;
  float cap, scale, scale2;  // scale2 = scale * log2(e)
};

__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row_a, int col_q,
                                             const SoftmaxArgs& a) {
  const float neg2 = kNegInf * kLog2e;
  const int q_last = a.q0 + kRows - 1, k_last = k0 + kKeys - 1;
  const bool masked = (a.causal && k_last > a.q0) ||
                      (a.window > 0 && k0 <= q_last - a.window) ||
                      k_last >= a.Sk || (a.kv_len >= 0 && k_last >= a.kv_len);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = a.q0 + row_a + 8 * r;
    float mx = m[r];
#pragma unroll
    for (int c = 0; c < kKeys / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * c + 2 * r + e];
        if (a.cap > 0.f)
          x = a.cap * tanhf(x * a.scale / a.cap) * kLog2e;
        else
          x *= a.scale2;
        if (masked) {
          const int kpos = k0 + 8 * c + col_q + e;
          bool ok = true;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && kpos > qpos - a.window;
          if (a.kv_len >= 0) ok = ok && kpos < a.kv_len;
          x = ok ? x : neg2;
          if (kpos >= a.Sk) x = -INFINITY;
        }
        s[4 * c + 2 * r + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    corr[r] = fast_exp2(m[r] - mx);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kKeys / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(s[4 * c + 2 * r + e] - mx);
        s[4 * c + 2 * r + e] = p;
        sum += p;
      }
    }
    l[r] = l[r] * corr[r] + sum;  // this thread's share of the row
  }
}

// The output rows scaled by corr, and P to bf16 A fragments (the
// reference's p.astype(v.dtype)); the m64nNk16 A layout per warp equals the
// accumulator layout of 16 score columns.
template <int DH>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[DH / 2],
                                                 const float (&corr)[2],
                                                 const float (&s)[kKeys / 2],
                                                 uint32_t (&pa)[kKeys / 16][4]) {
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    acc[4 * c] *= corr[0];
    acc[4 * c + 1] *= corr[0];
    acc[4 * c + 2] *= corr[1];
    acc[4 * c + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The loop is software-pipelined: while P_j V_j runs on the tensor cores,
// S_{j+1} (issued just before it) is already done and its softmax runs on
// the CUDA cores; the output rescale waits for P_j V_j. Head dim DH runs at
// the padded width DP; only DH columns are stored.
template <int DH>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_bf16(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               __nv_bfloat16* __restrict__ o, Strides so, int H, int KV,
               int Sq, int Sk, int causal, int window, float cap, float scale,
               int kv_len, float* __restrict__ lse) {
  constexpr int DP = kPadded<DH>;
  using QT = Tile<DP, kRows>;
  using KT = Tile<DP, kKeys>;
  extern __shared__ uint8_t smem_raw[];
  // every tile on a 1024 B boundary: the 128 B swizzle repeats every 1024 B
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = smem_addr(smem);
  const uint32_t skv = sq + QT::kBytes;  // stage s: K at +2s tiles, V at +2s+1
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + QT::kBytes +
                                               2 * kStages * KT::kBytes);
  const uint32_t bar_q = smem_addr(bars);
  const uint32_t bar_k = bar_q + 8;               // K of stage s at + 8s
  const uint32_t bar_v = bar_k + 8 * kStages;     // V of stage s at + 8s

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int k_end = Sk;
  if (kv_len >= 0) k_end = min(k_end, kv_len);
  if (causal) k_end = min(k_end, q0 + kRows);
  const int k_first = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + kKeys - 1) / kKeys : 0;

  // K_i and V_i go to stage i % 2, each with its own barrier, so each is
  // refilled as soon as its last reader is done: K one tile earlier than V.
  auto load_k = [&](int i) {
    const uint32_t bar = bar_k + 8 * (i % kStages);
    mbar_expect_tx(bar, KT::kBytes);
    load_tile<DP, kKeys>(skv + 2 * (i % kStages) * KT::kBytes, &map_k, bar, g,
                         k_first + i * kKeys, b);
  };
  auto load_v = [&](int i) {
    const uint32_t bar = bar_v + 8 * (i % kStages);
    mbar_expect_tx(bar, KT::kBytes);
    load_tile<DP, kKeys>(skv + (2 * (i % kStages) + 1) * KT::kBytes, &map_v,
                         bar, g, k_first + i * kKeys, b);
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2 * kStages; ++s) mbar_init(bar_k + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, QT::kBytes);
    load_tile<DP, kRows>(sq, &map_q, bar_q, h, q0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) {
      load_k(j);
      load_v(j);
    }
  }
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);  // this thread's rows: row_a, row_a + 8
  const int col_q = 2 * (lane & 3);
  const SoftmaxArgs args{q0, Sk, causal, window, kv_len, cap, scale,
                         scale * kLog2e};

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf * kLog2e, kNegInf * kLog2e}, l[2] = {0.f, 0.f};
  float corr[2];
  uint32_t pa[kKeys / 16][4];

  mbar_wait(bar_q, 0);
  if (n_tiles > 0) {
    mbar_wait(bar_k, 0);
    wgmma_fence();
    issue_qk<DP>(s, sq, skv);
    wgmma_wait_all();
    softmax_tile(s, m, l, corr, k_first, row_a, col_q, args);
    rescale_and_pack<DP>(acc, corr, s, pa);
    __syncthreads();  // K_0 read by every warp: its stage takes K_2
    if (tid == 0 && kStages < n_tiles) load_k(kStages);
  }
  // Tiles 0 .. n-2: S_{j+1} and P_j V_j in flight together. The branch-free
  // body lets ptxas see that each read of s follows the wait for its group.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int stage = j % kStages, nstage = (j + 1) % kStages;
    const uint32_t v_tile = skv + (2 * stage + 1) * KT::kBytes;
    mbar_wait(bar_k + 8 * nstage, ((j + 1) / kStages) & 1);
    mbar_wait(bar_v + 8 * stage, (j / kStages) & 1);
    wgmma_fence();
    issue_qk<DP>(s, sq, skv + 2 * nstage * KT::kBytes);
    issue_pv<DP>(acc, pa, v_tile);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    softmax_tile(s, m, l, corr, k_first + (j + 1) * kKeys, row_a,
                 col_q, args);
    wgmma_wait_all();

    // every warp is done with K_{j+1} and V_j: their stages take K_{j+3}
    // and V_{j+2}, each a whole tile ahead of its first reader
    __syncthreads();
    if (tid == 0) {
      if (j + 1 + kStages < n_tiles) load_k(j + 1 + kStages);
      if (j + kStages < n_tiles) load_v(j + kStages);
    }
    rescale_and_pack<DP>(acc, corr, s, pa);
  }
  if (n_tiles > 0) {  // the last tile: P V alone
    const int j = n_tiles - 1;
    mbar_wait(bar_v + 8 * (j % kStages), (j / kStages) & 1);
    wgmma_fence();
    issue_pv<DP>(acc, pa, skv + (2 * (j % kStages) + 1) * KT::kBytes);
    wgmma_wait_all();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int qpos = q0 + row_a + 8 * r;
    if (qpos >= Sq) continue;
    // the row's log-sum-exp in natural units: m and sum are in base 2
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * H + h) * Sq + qpos] =
          (m[r] + log2f(fmaxf(sum, 1e-30f))) * kLn2;
    __nv_bfloat16* orow = o + b * so.b + qpos * so.s + h * so.h;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)  // the columns past DH are not stored
      *reinterpret_cast<uint32_t*>(orow + 8 * c + col_q) =
          pack_bf16(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        Strides sq, Strides sk, Strides sv, Strides so, int B,
                        int H, int KV, int Sq, int Sk, int causal, int window,
                        float cap, float scale, int kv_len, float* lse,
                        cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map<DH, kRows>(&mq, q, H, Sq, B, sq) ||
      !make_map<DH, kKeys>(&mk, k, KV, Sk, B, sk) ||
      !make_map<DH, kKeys>(&mv, v, KV, Sk, B, sv))
    return cudaErrorInvalidValue;
  constexpr int DP = kPadded<DH>;
  const size_t smem = Tile<DP, kRows>::kBytes +
                      2 * kStages * Tile<DP, kKeys>::kBytes + 1024 + 64;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fwd_bf16<DH><<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), so, H, KV, Sq, Sk, causal,
      window, cap, scale, kv_len, lse);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                          Strides sq, Strides sk, Strides sv, Strides so,
                          int B, int H, int KV, int Sq, int Sk, int Dh,
                          int causal, int window, float cap, float scale,
                          int kv_len, float* lse, cudaStream_t st) {
  switch (Dh) {
    case 16:
      return launch_bf16<16>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk,
                             causal, window, cap, scale, kv_len, lse, st);
    case 32:
      return launch_bf16<32>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk,
                             causal, window, cap, scale, kv_len, lse, st);
    case 64:
      return launch_bf16<64>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk,
                             causal, window, cap, scale, kv_len, lse, st);
    case 120:
      return launch_bf16<120>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk,
                              causal, window, cap, scale, kv_len, lse, st);
    case 128:
      return launch_bf16<128>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk,
                              causal, window, cap, scale, kv_len, lse, st);
    case 160:
      return launch_bf16<160>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk,
                              causal, window, cap, scale, kv_len, lse, st);
    case 256:
      return launch_bf16<256>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk,
                              causal, window, cap, scale, kv_len, lse, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); `strides` holds (b, s, h) in
// elements for q, k, v, o in that order, the head dimension contiguous.
// dtype: 0 = float32 (Dh <= 256), 1 = bfloat16 (Dh in {16, 32, 64, 120, 128,
// 160, 256}). kv_len < 0 means "no kv_len mask". lse, when not NULL, gets
// each row's log-sum-exp of the scaled, capped, masked scores: fp32 (B, H,
// Sq), contiguous (the backward's input). Returns a cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides, int B,
                                         int H, int KV, int Sq, int Sk,
                                         int Dh, int causal, int window,
                                         float cap, float scale, int kv_len,
                                         int dtype, void* stream, void* lse) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      Dh <= 0 || Dh > 256 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk, Dh,
                             causal, window, cap, scale, kv_len, lf, st);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Sk,
                              Dh, causal, window, cap, scale, kv_len, lf, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
