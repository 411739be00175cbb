// Flash attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the `jax.custom_vjp` of src/repro/kernels/flash_attention/ops.py
// (:41-48), which differentiates the jnp oracle: the TPU package has no
// backward kernel, so its backward materialises the (B, H, Sq, Sk) scores.
// This is the FA2/FA3 split of the same gradients, from the forward's row
// log-sum-exp (`lse`, written by flash_attention.cu):
//
//   (a) D = rowsum(dO o O)                                   fp32 (B, H, Sq)
//   (b) per (b, kv head, 64-key tile): for the R = H / KV query heads of the
//       group and every query tile the mask reaches,
//         S^T = K Q^T, P^T = exp(S^T - lse), dP^T = V dO^T,
//         dS^T = P^T o (dP^T - D) [o (1 - (s / cap)^2) under the soft-cap],
//         dV += P^T dO, dK += dS^T Q
//       in registers: the group's heads are summed inside the block, so GQA
//       and MQA need no atomics;
//   (c) per (b, head, 64-query tile): over the key tiles the mask reaches,
//         S = Q K^T, P = exp(S - lse), dP = dO V^T, dS as above, dQ += dS K.
// dQ and dK are scaled by Dh^-0.5 when stored. No floating-point atomics:
// every sum has one fixed order, so two calls give equal gradients.
//
// Same masks and layout as the forward: causal, sliding window, tanh
// soft-cap, `kv_len`, ragged Sq and Sk masked in the kernel, Sq != Sk, the
// model's strided (B, S, H, Dh) layout read as it is. dq, dk, dv are written
// contiguous in the inputs' dtype; every sum is fp32.
//
// bf16 (the training path): the five products run on the tensor cores as
// `wgmma` chains (csrc/wgmma.cuh), one warpgroup per block, operands brought
// by TMA (hopper.cuh: the forward's tensor maps and 128-byte swizzled tiles).
// In (b) the K and V tiles (64 keys) come once; Q and dO tiles of 32 queries
// come through a 2-stage ring, so the next tile's loads overlap this one's
// products. S^T and dP^T are m64n32k16 chains with both operands in shared
// memory (K-major), P^T and dS^T go to bf16 A fragments in registers, and
// dV, dK accumulate as m64n{PW}k16 chains with dO, Q read MN-major, as the
// forward reads V. (c) mirrors the forward: Q and dO (64 rows) come once, K
// and V tiles of 32 keys through the ring, dQ += dS K with K MN-major. P
// and dS enter their products as two bf16 halves (hi + lo, two chains):
// rounded to one bf16 each, they put single elements of dK and dQ past
// the 3e-2 check against the plain version's fp32 sums at the training
// shapes; two halves keep about fp32's precision
// (scripts/flash_bwd_witness.py), at 8 chains a tile pair where 5 would
// do. Dh
// 120 and 160 run at the padded widths 128 and 192 as in the forward (zero
// columns from TMA, only columns < Dh stored). Register budget: (b) holds dK
// and dV, 2 x PW / 2 fp32 registers a thread. At padded widths up to 128, PW
// is the whole width (128 registers at Dh 128); at 192 and 256 the two
// accumulators would need 192 and 256, so the block owns a part of the
// columns, PW = 64 (3 parts) and 128 (2 parts), and each part's block
// recomputes S^T and dP^T over the whole Dh: with P parts (b) runs 2P + 2
// products where 4 would do, 1.5x at Dh 256 (RecurrentGemma, P = 2) and 2x
// at Dh 160 (StableLM-2, P = 3). (c)'s dQ is DP / 2 registers, as the
// forward's O. ptxas (the build log) fits (b) in 215 registers at Dh 128
// and 254 at Dh 256, (c) in 192 at Dh 256, no spills.
//
// fp32: CUDA-core kernels (fp32 FMAs; TF32 would not hold the fp32
// tolerance), (b) one warp per 8 keys (4 at Dh > 128) with a lane per query
// of a 32-query tile for S^T and dP^T and a lane per head-dim column for dK
// and dV; (c) one warp per 8 query rows (4 at Dh > 128), a lane per key.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), at
// StarCoder2-3B's training shape (bf16, B=4, S=512, H=24, KV=2, Dh=128,
// causal; chip_smoke._bwd_times): q, o, dO, dq read and written (4 x 12.6
// MB), k, v, dk, dv (4 x 1.0 MB), lse and D: 54.5 MB -> 16.3 us; the five
// products over the causal pairs, 10 * B * H * 131,328 * Dh = 16.1 GFLOP ->
// 16.3 us. Both bounds meet. The route this replaces, the VJP of the padded
// plain version, took 2.81 ms there (PERF.md §6), moving the fp32
// (B, H, S, S) scores through device memory several times; here no score
// leaves the registers, and what is left is the products (S and dP
// recomputed in each of (b) and (c), P and dS in two halves: 10 chains
// where the bound counts 5), the elementwise work between them, and the
// loads of Q and dO once per key tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWgThreads = 128;
constexpr int kStages = 2;

struct BwdArgs {
  int H, KV, Sq, Sk, causal, window, kv_len;
  float cap, scale;
  int split;  // (b): blocks sharing one kv head's query heads
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Whether query qpos attends to key kpos (the forward's masks; keys past Sk
// and rows past Sq count as masked).
__device__ __forceinline__ bool visible(int qpos, int kpos, const BwdArgs& a) {
  bool ok = qpos < a.Sq && kpos < a.Sk;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && kpos > qpos - a.window;
  if (a.kv_len >= 0) ok = ok && kpos < a.kv_len;
  return ok;
}

// P and dS of one (query, key) pair from the raw product s = q . k, the
// row's lse and D and dP = dO . v; returns P, sets ds (the gradient of the
// capped, scaled score times the cap's derivative; the scale comes last).
__device__ __forceinline__ float prob_and_ds(float s, float dp, float lse2,
                                             float dd, bool ok,
                                             const BwdArgs& a, float& ds) {
  float x = s * a.scale, capd = 1.f;
  if (a.cap > 0.f) {
    const float t = tanhf(x / a.cap);
    x = a.cap * t;
    capd = 1.f - t * t;
  }
  const float p = ok ? fast_exp2(x * kLog2e - lse2) : 0.f;
  ds = p * (dp - dd) * capd;
  return p;
}

// The key range [first, end) a query tile [q0, q0 + rows) sees, the first
// on a multiple of `tile`.
__device__ __forceinline__ void key_range(int q0, int rows, int tile,
                                          const BwdArgs& a, int& first,
                                          int& end) {
  end = a.Sk;
  if (a.kv_len >= 0) end = min(end, a.kv_len);
  if (a.causal) end = min(end, q0 + rows);
  first = a.window > 0 ? max(0, q0 - a.window + 1) / tile * tile : 0;
}

// The query range [first, end) that sees a key tile [k0, k0 + rows), the
// first on a multiple of `tile`; empty when kv_len masks the whole tile.
__device__ __forceinline__ void query_range(int k0, int rows, int tile,
                                            const BwdArgs& a, int& first,
                                            int& end) {
  end = a.Sq;
  if (a.window > 0) end = min(end, k0 + rows - 1 + a.window);
  if (a.kv_len >= 0 && k0 >= a.kv_len) end = 0;
  first = a.causal ? k0 / tile * tile : 0;
}

// (b)'s query heads for block `sp` of kv head g's split group: [first, end)
__device__ __forceinline__ void head_chunk(int g, int sp, const BwdArgs& a,
                                           int& first, int& end) {
  const int R = a.H / a.KV, per = (R + a.split - 1) / a.split;
  first = g * R + min(R, sp * per);
  end = g * R + min(R, (sp + 1) * per);
}

// (b)'s sums of one key row and column pair, dK already scaled: stored in
// the gradients' dtype when the group is whole, else as fp32 partial sums
// in `part` ([2][split][B][Sk][KV][Dh]: dK's, then dV's), which
// flash_bwd_sum_parts adds in order.
template <typename T>
__device__ __forceinline__ void store_kv(T* dk, T* dv, float* part, Strides sdk,
                                         Strides sdv, int b, int kpos, int g,
                                         int col, int Dh, int sp, float kx,
                                         float vx, const BwdArgs& a) {
  if (part == nullptr) {
    dk[b * sdk.b + kpos * sdk.s + g * sdk.h + col] = from_float<T>(kx);
    dv[b * sdv.b + kpos * sdv.s + g * sdv.h + col] = from_float<T>(vx);
    return;
  }
  const size_t n = (size_t)gridDim.z * a.Sk * a.KV * Dh;
  const size_t at = (((size_t)b * a.Sk + kpos) * a.KV + g) * Dh + col;
  part[sp * n + at] = kx;
  part[(a.split + sp) * n + at] = vx;
}

// ------------------------------------------------ (a) D = rowsum(dO o O)
// one warp per (b, s, h) row; D at ((b * H + h) * Sq + s)
template <typename T>
__global__ void flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
                              Strides so, Strides sd, float* __restrict__ D,
                              int H, int Sq, int Dh, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
  const T* orow = o + b * so.b + s * so.s + h * so.h;
  const T* drow = dout + b * sd.b + s * sd.s + h * sd.h;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32)
    acc = fmaf(to_float(orow[d]), to_float(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) D[((size_t)b * H + h) * Sq + s] = acc;
}

// ------------------------------------------------ bf16, wgmma + TMA
constexpr int kKeyRows = 64;  // (b): keys per block, the M of its products
constexpr int kQCols = 32;    // (b): queries per ring tile
constexpr int kQRows = 64;    // (c): query rows per block
constexpr int kKCols = 32;    // (c): keys per ring tile

// (b)'s dK/dV column part: the whole padded width up to 128, else 64 (192)
// or 128 (256), so the two accumulators stay within the register budget.
template <int DP>
constexpr int kPart = DP <= 128 ? DP : (DP == 192 ? 64 : 128);

// A 64 x 32 accumulator (register 4c + 2r + e: row 16 warp + lane / 4 + 8r,
// column 8c + 2 (lane % 4) + e) as bf16 A fragments of two k16 steps.
__device__ __forceinline__ void pack_a(const float (&x)[16], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// x less its bf16 rounding: the low half of the two-bf16 split x = hi + lo
__device__ __forceinline__ void bf16_residual(float (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] -= __bfloat162float(__float2bfloat16_rn(x[i]));
}

// X (64 x 32) = A B^T over the padded head dim, both 64-row A and 32-row B
// tiles K-major in shared memory; issued, not committed.
template <int DP>
__device__ __forceinline__ void issue_ss(float (&x)[16], uint32_t a_tile,
                                         uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    WgmmaSS<32>::run(x, desc_kmajor<DP, 64>(a_tile, kk),
                     desc_kmajor<DP, 32>(b_tile, kk), kk > 0);
}

// acc (64 x N) += A (64 x 32, registers) B (32 x N, MN-major from a 32-row
// tile starting at column slab `b_tile`); issued, not committed.
template <int DP, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N / 2],
                                         const uint32_t (&a)[2][4],
                                         uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    WgmmaRS<N>::run(acc, a[kk], desc_mnmajor<DP, 32>(b_tile, kk));
}

// (b): grid (key tiles x parts, KV, B), one warpgroup.
template <int DH>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ part, Strides sdk, Strides sdv,
                    BwdArgs a) {
  constexpr int DP = kPadded<DH>;
  constexpr int PW = kPart<DP>;
  constexpr int kParts = DP / PW;
  using KT = Tile<DP, kKeyRows>;
  using QT = Tile<DP, kQCols>;
  // byte offset of column part p inside a tile: PW / 64 slabs per part
  constexpr int kPartSlabs = PW >= 64 ? PW / 64 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sk = smem_addr(smem), sv = sk + KT::kBytes;
  const uint32_t sring = sv + KT::kBytes;  // stage s: Q at +2s tiles, dO at +2s+1
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * KT::kBytes +
                                               2 * kStages * QT::kBytes);
  const uint32_t bar_kv = smem_addr(bars);
  const uint32_t bar_q = bar_kv + 8;  // stage s at + 8s

  const int cpart = blockIdx.x % kParts, kt = blockIdx.x / kParts;
  const int g = blockIdx.y / a.split, sp = blockIdx.y % a.split;
  const int b = blockIdx.z;
  const int k0 = kt * kKeyRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int q_first, q_end, h_first, h_end;
  query_range(k0, kKeyRows, kQCols, a, q_first, q_end);
  head_chunk(g, sp, a, h_first, h_end);
  const int nq = q_end > q_first ? (q_end - q_first + kQCols - 1) / kQCols : 0;
  const int n_iter = (h_end - h_first) * nq;  // (head, query tile), heads outer

  auto load_q = [&](int i) {
    const uint32_t bar = bar_q + 8 * (i % kStages);
    const uint32_t dst = sring + 2 * (i % kStages) * QT::kBytes;
    const int h = h_first + i / nq, q0 = q_first + (i % nq) * kQCols;
    mbar_expect_tx(bar, 2 * QT::kBytes);
    load_tile<DP, kQCols>(dst, &map_q, bar, h, q0, b);
    load_tile<DP, kQCols>(dst + QT::kBytes, &map_do, bar, h, q0, b);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_q + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_iter > 0) {
      mbar_expect_tx(bar_kv, 2 * KT::kBytes);
      load_tile<DP, kKeyRows>(sk, &map_k, bar_kv, g, k0, b);
      load_tile<DP, kKeyRows>(sv, &map_v, bar_kv, g, k0, b);
    }
    for (int j = 0; j < kStages && j < n_iter; ++j) load_q(j);
  }
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);  // keys k0 + row_a, + 8
  const int col_q = 2 * (lane & 3);
  float acc_v[PW / 2], acc_k[PW / 2];
#pragma unroll
  for (int i = 0; i < PW / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
  float st[16], dpt[16];
  uint32_t pa[2][4], da[2][4];
  const uint32_t part_off = cpart * kPartSlabs * QT::kSlabBytes;

  if (n_iter > 0) mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int stage = i % kStages;
    const uint32_t qs = sring + 2 * stage * QT::kBytes, dos = qs + QT::kBytes;
    const int h = h_first + i / nq, q0 = q_first + (i % nq) * kQCols;
    mbar_wait(bar_q + 8 * stage, (i / kStages) & 1);
    wgmma_fence();
    issue_ss<DP>(st, sk, qs);    // S^T = K Q^T
    issue_ss<DP>(dpt, sv, dos);  // dP^T = V dO^T
    wgmma_commit();
    // this thread's query columns: lse (base 2) and D
    float lse2[4][2], dd[4][2];
    const size_t row0 = ((size_t)b * a.H + h) * a.Sq;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qpos = q0 + 8 * c + col_q + e;
        const bool in = qpos < a.Sq;
        lse2[c][e] = in ? lse[row0 + qpos] * kLog2e : 0.f;
        dd[c][e] = in ? D[row0 + qpos] : 0.f;
      }
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = k0 + row_a + 8 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * c + 2 * r + e, qpos = q0 + 8 * c + col_q + e;
          float ds;
          st[idx] = prob_and_ds(st[idx], dpt[idx], lse2[c][e], dd[c][e],
                                visible(qpos, kpos, a), a, ds);
          dpt[idx] = ds;
        }
    }
    // dV += P^T dO, dK += dS^T Q, P and dS as two bf16 halves each (hi,
    // then lo into the same registers): their products keep about fp32's
    // precision, as the plain version's fp32 gradients do
    pack_a(st, pa);
    pack_a(dpt, da);
    wgmma_fence();
    issue_rs<DP, PW>(acc_v, pa, dos + part_off);
    issue_rs<DP, PW>(acc_k, da, qs + part_off);
    wgmma_commit();
    bf16_residual(st);
    bf16_residual(dpt);
    wgmma_wait_all();
    pack_a(st, pa);
    pack_a(dpt, da);
    wgmma_fence();
    issue_rs<DP, PW>(acc_v, pa, dos + part_off);
    issue_rs<DP, PW>(acc_k, da, qs + part_off);
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && i + kStages < n_iter) load_q(i + kStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + row_a + 8 * r;
    if (kpos >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < PW / 8; ++c) {
      const int col = cpart * PW + 8 * c + col_q;  // columns past DH not stored
      if (col >= DH) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        store_kv(dk, dv, part, sdk, sdv, b, kpos, g, col + e, DH, sp,
                 acc_k[4 * c + 2 * r + e] * a.scale, acc_v[4 * c + 2 * r + e],
                 a);
    }
  }
}

// (c): grid (query tiles, H, B), one warpgroup.
template <int DH>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  __nv_bfloat16* __restrict__ dq, Strides sdq, BwdArgs a) {
  constexpr int DP = kPadded<DH>;
  using QT = Tile<DP, kQRows>;
  using KT = Tile<DP, kKCols>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = smem_addr(smem), sdo = sq + QT::kBytes;
  const uint32_t sring = sdo + QT::kBytes;  // stage s: K at +2s tiles, V at +2s+1
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * QT::kBytes +
                                               2 * kStages * KT::kBytes);
  const uint32_t bar_qd = smem_addr(bars);
  const uint32_t bar_k = bar_qd + 8;  // stage s at + 8s

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int q0 = qt * kQRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int k_first, k_end;
  key_range(q0, kQRows, kKCols, a, k_first, k_end);
  const int n_tiles = k_end > k_first ? (k_end - k_first + kKCols - 1) / kKCols : 0;

  auto load_kv = [&](int i) {
    const uint32_t bar = bar_k + 8 * (i % kStages);
    const uint32_t dst = sring + 2 * (i % kStages) * KT::kBytes;
    mbar_expect_tx(bar, 2 * KT::kBytes);
    load_tile<DP, kKCols>(dst, &map_k, bar, g, k_first + i * kKCols, b);
    load_tile<DP, kKCols>(dst + KT::kBytes, &map_v, bar, g,
                          k_first + i * kKCols, b);
  };
  if (tid == 0) {
    mbar_init(bar_qd, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_k + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_qd, 2 * QT::kBytes);
    load_tile<DP, kQRows>(sq, &map_q, bar_qd, h, q0, b);
    load_tile<DP, kQRows>(sdo, &map_do, bar_qd, h, q0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);  // queries q0 + row_a, + 8
  const int col_q = 2 * (lane & 3);
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + row_a + 8 * r;
    const size_t at = ((size_t)b * a.H + h) * a.Sq + qpos;
    lse2[r] = qpos < a.Sq ? lse[at] * kLog2e : 0.f;
    dd[r] = qpos < a.Sq ? D[at] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s[16], dp[16];
  uint32_t da[2][4];

  mbar_wait(bar_qd, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    const uint32_t ks = sring + 2 * stage * KT::kBytes, vs = ks + KT::kBytes;
    const int kbase = k_first + j * kKCols;
    mbar_wait(bar_k + 8 * stage, (j / kStages) & 1);
    wgmma_fence();
    issue_ss<DP>(s, sq, ks);    // S = Q K^T
    issue_ss<DP>(dp, sdo, vs);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + row_a + 8 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * c + 2 * r + e, kpos = kbase + 8 * c + col_q + e;
          float ds;
          prob_and_ds(s[idx], dp[idx], lse2[r], dd[r],
                      visible(qpos, kpos, a), a, ds);
          dp[idx] = ds;
        }
    }
    // dQ += dS K, dS as two bf16 halves (as in (b))
    pack_a(dp, da);
    wgmma_fence();
    issue_rs<DP, DP>(acc, da, ks);
    wgmma_commit();
    bf16_residual(dp);
    wgmma_wait_all();
    pack_a(dp, da);
    wgmma_fence();
    issue_rs<DP, DP>(acc, da, ks);
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + kStages < n_tiles) load_kv(j + kStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + row_a + 8 * r;
    if (qpos >= a.Sq) continue;
    __nv_bfloat16* row = dq + b * sdq.b + qpos * sdq.s + h * sdq.h;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)  // the columns past DH are not stored
      *reinterpret_cast<uint32_t*>(row + 8 * c + col_q) =
          pack_bf16(acc[4 * c + 2 * r] * a.scale, acc[4 * c + 2 * r + 1] * a.scale);
  }
}

// ------------------------------------------------ fp32, CUDA cores
constexpr int kF32Threads = 256;
constexpr int kF32Warps = 8;
constexpr int kF32Tile = 32;  // queries (b) or keys (c) per tile: a lane each

// Rows a warp owns: 8, or 4 at Dh > 128 to keep 2 x rows x NT accumulators
// in registers.
template <int NT>
constexpr int kF32Rows = NT <= 4 ? 8 : 4;

// (b): grid (key tiles, KV, B). Shared: the block's K and V rows [KB][Dh],
// then a query tile's Q and dO rows [32][Dh + 1] (padded: a lane per query
// reads a column without bank conflicts, a lane per column reads a row).
template <int NT>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   float* __restrict__ dk, float* __restrict__ dv,
                   float* __restrict__ part, Strides sq, Strides sk, Strides sv,
                   Strides sd, Strides sdk, Strides sdv, int Dh, BwdArgs a) {
  constexpr int KR = kF32Rows<NT>, KB = kF32Warps * KR;
  extern __shared__ float fsm[];
  float* ks = fsm;               // [KB][Dh]
  float* vs = ks + KB * Dh;      // [KB][Dh]
  float* qs = vs + KB * Dh;      // [32][Dh + 1]
  float* ds_ = qs + kF32Tile * (Dh + 1);  // dO, [32][Dh + 1]
  const int ld = Dh + 1;
  const int g = blockIdx.y / a.split, sp = blockIdx.y % a.split;
  const int b = blockIdx.z, k0 = blockIdx.x * KB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * KR;

  for (int i = tid; i < KB * Dh; i += kF32Threads) {
    const int j = i / Dh, d = i - j * Dh, kpos = k0 + j;
    ks[i] = kpos < a.Sk ? k[b * sk.b + kpos * sk.s + g * sk.h + d] : 0.f;
    vs[i] = kpos < a.Sk ? v[b * sv.b + kpos * sv.s + g * sv.h + d] : 0.f;
  }
  int q_first, q_end, h_first, h_end;
  query_range(k0, KB, kF32Tile, a, q_first, q_end);
  head_chunk(g, sp, a, h_first, h_end);

  float acc_k[KR][NT], acc_v[KR][NT];
#pragma unroll
  for (int j = 0; j < KR; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc_k[j][t] = acc_v[j][t] = 0.f;

  for (int h = h_first; h < h_end; ++h) {
    for (int q0 = q_first; q0 < q_end; q0 += kF32Tile) {
      __syncthreads();  // K, V staged / the previous tile consumed
      for (int i = tid; i < kF32Tile * Dh; i += kF32Threads) {
        const int r = i / Dh, d = i - r * Dh, qpos = q0 + r;
        const bool in = qpos < a.Sq;
        qs[r * ld + d] = in ? q[b * sq.b + qpos * sq.s + h * sq.h + d] : 0.f;
        ds_[r * ld + d] = in ? dout[b * sd.b + qpos * sd.s + h * sd.h + d] : 0.f;
      }
      __syncthreads();
      const int qpos = q0 + lane;
      const size_t at = ((size_t)b * a.H + h) * a.Sq + qpos;
      const float lse2 = qpos < a.Sq ? lse[at] * kLog2e : 0.f;
      const float dd = qpos < a.Sq ? D[at] : 0.f;
      float s[KR], dp[KR];
#pragma unroll
      for (int j = 0; j < KR; ++j) s[j] = dp[j] = 0.f;
      for (int d = 0; d < Dh; ++d) {
        const float qv = qs[lane * ld + d], gv = ds_[lane * ld + d];
#pragma unroll
        for (int j = 0; j < KR; ++j) {
          s[j] = fmaf(ks[(row0 + j) * Dh + d], qv, s[j]);
          dp[j] = fmaf(vs[(row0 + j) * Dh + d], gv, dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        float ds;
        s[j] = prob_and_ds(s[j], dp[j], lse2, dd,
                           visible(qpos, k0 + row0 + j, a), a, ds);
        dp[j] = ds;
      }
      // dV[j] += sum_q P^T[j][q] dO[q]; dK[j] += sum_q dS^T[j][q] Q[q]: the
      // query's values from its lane, the columns a lane each
      for (int qq = 0; qq < kF32Tile; ++qq) {
        float gx[NT], qx[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          gx[t] = d < Dh ? ds_[qq * ld + d] : 0.f;
          qx[t] = d < Dh ? qs[qq * ld + d] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < KR; ++j) {
          const float pj = __shfl_sync(kFull, s[j], qq);
          const float dj = __shfl_sync(kFull, dp[j], qq);
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            acc_v[j][t] = fmaf(pj, gx[t], acc_v[j][t]);
            acc_k[j][t] = fmaf(dj, qx[t], acc_k[j][t]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int kpos = k0 + row0 + j;
    if (kpos >= a.Sk) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh)
        store_kv(dk, dv, part, sdk, sdv, b, kpos, g, d, Dh, sp,
                 acc_k[j][t] * a.scale, acc_v[j][t], a);
    }
  }
}

// (c): grid (query tiles, H, B). Shared: the block's Q and dO rows [QB][Dh],
// then a key tile's K and V rows [32][Dh + 1].
template <int NT>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                 Strides sd, Strides sdq, int Dh, BwdArgs a) {
  constexpr int QR = kF32Rows<NT>, QB = kF32Warps * QR;
  extern __shared__ float fsm[];
  float* qs = fsm;               // [QB][Dh]
  float* gs = qs + QB * Dh;      // dO, [QB][Dh]
  float* ks = gs + QB * Dh;      // [32][Dh + 1]
  float* vs = ks + kF32Tile * (Dh + 1);
  const int ld = Dh + 1;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * QB;
  const int g = h / (a.H / a.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * QR;

  for (int i = tid; i < QB * Dh; i += kF32Threads) {
    const int r = i / Dh, d = i - r * Dh, qpos = q0 + r;
    const bool in = qpos < a.Sq;
    qs[i] = in ? q[b * sq.b + qpos * sq.s + h * sq.h + d] : 0.f;
    gs[i] = in ? dout[b * sd.b + qpos * sd.s + h * sd.h + d] : 0.f;
  }
  float lse2[QR], dd[QR];
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int qpos = q0 + row0 + i;
    const size_t at = ((size_t)b * a.H + h) * a.Sq + qpos;
    lse2[i] = qpos < a.Sq ? lse[at] * kLog2e : 0.f;
    dd[i] = qpos < a.Sq ? D[at] : 0.f;
  }
  int k_first, k_end;
  key_range(q0, QB, kF32Tile, a, k_first, k_end);

  float acc[QR][NT];
#pragma unroll
  for (int i = 0; i < QR; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[i][t] = 0.f;

  for (int kb = k_first; kb < k_end; kb += kF32Tile) {
    __syncthreads();  // Q, dO staged / the previous tile consumed
    for (int i = tid; i < kF32Tile * Dh; i += kF32Threads) {
      const int j = i / Dh, d = i - j * Dh, kpos = kb + j;
      const bool in = kpos < a.Sk;
      ks[j * ld + d] = in ? k[b * sk.b + kpos * sk.s + g * sk.h + d] : 0.f;
      vs[j * ld + d] = in ? v[b * sv.b + kpos * sv.s + g * sv.h + d] : 0.f;
    }
    __syncthreads();
    const int kpos = kb + lane;
    float s[QR], dp[QR];
#pragma unroll
    for (int i = 0; i < QR; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float kx = ks[lane * ld + d], vx = vs[lane * ld + d];
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        s[i] = fmaf(qs[(row0 + i) * Dh + d], kx, s[i]);
        dp[i] = fmaf(gs[(row0 + i) * Dh + d], vx, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < QR; ++i) {
      float ds;
      prob_and_ds(s[i], dp[i], lse2[i], dd[i],
                  visible(q0 + row0 + i, kpos, a), a, ds);
      dp[i] = ds;
    }
    for (int jj = 0; jj < kF32Tile; ++jj) {
      float kx[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int d = lane + 32 * t;
        kx[t] = d < Dh ? ks[jj * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        const float dsj = __shfl_sync(kFull, dp[i], jj);
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[i][t] = fmaf(dsj, kx[t], acc[i][t]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= a.Sq) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) dq[b * sdq.b + qpos * sdq.s + h * sdq.h + d] = acc[i][t] * a.scale;
    }
  }
}

// ------------------------------------------------ (b)'s partial sums
// dK, dV = the split blocks' fp32 partial sums added in order
template <typename T>
__global__ void flash_bwd_sum_parts(const float* __restrict__ part,
                                    T* __restrict__ dk, T* __restrict__ dv,
                                    Strides sdk, Strides sdv, int B, int Dh,
                                    BwdArgs a) {
  const size_t n = (size_t)B * a.Sk * a.KV * Dh;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d = i % Dh, g = (i / Dh) % a.KV;
  const int s = (i / ((size_t)Dh * a.KV)) % a.Sk;
  const int b = i / ((size_t)Dh * a.KV * a.Sk);
  float kx = 0.f, vx = 0.f;
  for (int sp = 0; sp < a.split; ++sp) {
    kx += part[sp * n + i];
    vx += part[(a.split + sp) * n + i];
  }
  dk[b * sdk.b + s * sdk.s + g * sdk.h + d] = from_float<T>(kx);
  dv[b * sdv.b + s * sdv.s + g * sdv.h + d] = from_float<T>(vx);
}

// ------------------------------------------------ launches
struct Ptrs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float *D, *part;
};

struct AllStrides {
  Strides q, k, v, o, dout, dq, dk, dv;
};

template <typename T>
cudaError_t launch_sum_parts(const Ptrs& p, const AllStrides& s, int B,
                             int Dh, const BwdArgs& a, cudaStream_t st) {
  if (a.split == 1) return cudaSuccess;
  const size_t n = (size_t)B * a.Sk * a.KV * Dh;
  flash_bwd_sum_parts<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      p.part, static_cast<T*>(p.dk), static_cast<T*>(p.dv), s.dk, s.dv, B,
      Dh, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dot(const Ptrs& p, const AllStrides& s, int B, int Dh,
                       const BwdArgs& a, cudaStream_t st) {
  const int rows = B * a.Sq * a.H;
  flash_bwd_dot<T><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(p.o), static_cast<const T*>(p.dout), s.o, s.dout,
      p.D, a.H, a.Sq, Dh, rows);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_f32(const Ptrs& p, const AllStrides& s, int B, int Dh,
                       const BwdArgs& a, cudaStream_t st) {
  constexpr int rows = kF32Warps * kF32Rows<NT>;
  const size_t smem = sizeof(float) * (2 * (size_t)rows * Dh +
                                       2 * (size_t)kF32Tile * (Dh + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const auto* q = static_cast<const float*>(p.q);
  const auto* k = static_cast<const float*>(p.k);
  const auto* v = static_cast<const float*>(p.v);
  const auto* g = static_cast<const float*>(p.dout);
  flash_bwd_dkdv_f32<NT><<<dim3((a.Sk + rows - 1) / rows, a.KV * a.split, B),
                           kF32Threads, smem, st>>>(
      q, k, v, g, p.lse, p.D, static_cast<float*>(p.dk), static_cast<float*>(p.dv),
      p.part, s.q, s.k, s.v, s.dout, s.dk, s.dv, Dh, a);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_sum_parts<float>(p, s, B, Dh, a, st);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<NT><<<dim3((a.Sq + rows - 1) / rows, a.H, B), kF32Threads,
                         smem, st>>>(
      q, k, v, g, p.lse, p.D, static_cast<float*>(p.dq), s.q, s.k, s.v, s.dout,
      s.dq, Dh, a);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Ptrs& p, const AllStrides& s, int B, int Dh,
                         const BwdArgs& a, cudaStream_t st) {
  if (Dh <= 32) return launch_f32<1>(p, s, B, Dh, a, st);
  if (Dh <= 64) return launch_f32<2>(p, s, B, Dh, a, st);
  if (Dh <= 128) return launch_f32<4>(p, s, B, Dh, a, st);
  return launch_f32<8>(p, s, B, Dh, a, st);
}

template <int DH>
cudaError_t launch_bf16(const Ptrs& p, const AllStrides& s, int B,
                        const BwdArgs& a, cudaStream_t st) {
  constexpr int DP = kPadded<DH>;
  constexpr int kParts = DP / kPart<DP>;
  CUtensorMap q32, do32, k64, v64, q64, do64, k32, v32;
  if (!make_map<DH, kQCols>(&q32, p.q, a.H, a.Sq, B, s.q) ||
      !make_map<DH, kQCols>(&do32, p.dout, a.H, a.Sq, B, s.dout) ||
      !make_map<DH, kKeyRows>(&k64, p.k, a.KV, a.Sk, B, s.k) ||
      !make_map<DH, kKeyRows>(&v64, p.v, a.KV, a.Sk, B, s.v) ||
      !make_map<DH, kQRows>(&q64, p.q, a.H, a.Sq, B, s.q) ||
      !make_map<DH, kQRows>(&do64, p.dout, a.H, a.Sq, B, s.dout) ||
      !make_map<DH, kKCols>(&k32, p.k, a.KV, a.Sk, B, s.k) ||
      !make_map<DH, kKCols>(&v32, p.v, a.KV, a.Sk, B, s.v))
    return cudaErrorInvalidValue;
  const size_t smem_kv = 2 * Tile<DP, kKeyRows>::kBytes +
                         2 * kStages * Tile<DP, kQCols>::kBytes + 1024 + 64;
  const size_t smem_q = 2 * Tile<DP, kQRows>::kBytes +
                        2 * kStages * Tile<DP, kKCols>::kBytes + 1024 + 64;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_bf16<DH><<<dim3((a.Sk + kKeyRows - 1) / kKeyRows * kParts,
                                 a.KV * a.split, B),
                            kWgThreads, smem_kv, st>>>(
      q32, k64, v64, do32, p.lse, p.D, static_cast<__nv_bfloat16*>(p.dk),
      static_cast<__nv_bfloat16*>(p.dv), p.part, s.dk, s.dv, a);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_sum_parts<__nv_bfloat16>(p, s, B, DH, a, st);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16<DH><<<dim3((a.Sq + kQRows - 1) / kQRows, a.H, B), kWgThreads,
                          smem_q, st>>>(q64, do64, k32, v32, p.lse, p.D,
                                        static_cast<__nv_bfloat16*>(p.dq), s.dq, a);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Ptrs& p, const AllStrides& s, int B, int Dh,
                          const BwdArgs& a, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch_bf16<16>(p, s, B, a, st);
    case 32: return launch_bf16<32>(p, s, B, a, st);
    case 64: return launch_bf16<64>(p, s, B, a, st);
    case 120: return launch_bf16<120>(p, s, B, a, st);
    case 128: return launch_bf16<128>(p, s, B, a, st);
    case 160: return launch_bf16<160>(p, s, B, a, st);
    case 256: return launch_bf16<256>(p, s, B, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, Dh); k, v, dk, dv: (B, Sk, KV, Dh); `strides`
// holds (b, s, h) in elements for q, k, v, o, dout, dq, dk, dv in that order,
// the head dimension contiguous; lse and D (scratch the kernel fills): fp32
// (B, H, Sq) contiguous. dtype: 0 = float32 (Dh <= 256), 1 = bfloat16 (Dh in
// {16, 32, 64, 120, 128, 160, 256}; every bf16 operand 16-byte aligned, as
// TMA needs). kv_len < 0 means "no kv_len mask". split: how many blocks of
// (b) share one kv head's query heads (1 <= split <= H / KV); above 1, part
// is fp32 scratch of 2 x split x B x Sk x KV x Dh for their partial sums
// (else NULL). Launches (a), (b), the sum of (b)'s parts when split > 1,
// then (c), on `stream`. Returns a cudaError_t (0 on success); the caller
// raises on anything else.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* D,
    void* part, const long long* strides, int B, int H, int KV, int Sq, int Sk,
    int Dh, int causal, int window, float cap, float scale, int kv_len,
    int split, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      Dh <= 0 || Dh > 256 || B > 65535 || H > 65535 || split < 1 || split > H / KV ||
      KV * split > 65535 || (split > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  AllStrides s;
  Strides* all[8] = {&s.q, &s.k, &s.v, &s.o, &s.dout, &s.dq, &s.dk, &s.dv};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Ptrs p{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(D), static_cast<float*>(part)};
  const BwdArgs a{H, KV, Sq, Sk, causal, window, kv_len, cap, scale, split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dot<float>(p, s, B, Dh, a, st);
    return (int)(err != cudaSuccess ? err : dispatch_f32(p, s, B, Dh, a, st));
  }
  if (dtype == 1) {
    err = launch_dot<__nv_bfloat16>(p, s, B, Dh, a, st);
    return (int)(err != cudaSuccess ? err : dispatch_bf16(p, s, B, Dh, a, st));
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
