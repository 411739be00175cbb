// Flash attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the `jax.custom_vjp` of src/repro/kernels/flash_attention/ops.py
// (:41-48), which differentiates the jnp oracle: the TPU package has no
// backward kernel, so its backward materialises the (B, H, Sq, Sk) scores.
// Here the same gradients come from the forward's row log-sum-exp (`lse`,
// written by flash_attention.cu), with every sum in fp32 and no
// floating-point atomics: every sum has one fixed order, so two calls give
// equal gradients. Same masks and layout as the forward: causal, sliding
// window, tanh soft-cap, `kv_len`, ragged Sq and Sk masked in the kernel,
// Sq != Sk, GQA and MQA, the model's strided (B, S, H, Dh) layout read as
// it is; dq, dk, dv written contiguous in the inputs' dtype.
//
// bf16 (the training path), three launches:
//   (a) rows: per (b, h, query) the pair (lse log2(e), D = rowsum(dO o O)),
//       fp32, the query axis padded to whole 64-row tiles (zeros past Sq);
//   (b) one warp-specialised kernel for dK, dV and dQ. A block per (key
//       tile, chunk of its kv head's query heads, kv head, b) walks the
//       query tiles the mask reaches, the last first, and for each its
//       heads, and computes for each (key tile, query tile) pair, once:
//         S^T = K Q^T, P^T = exp(S^T - lse), dP^T = V dO^T,
//         dS^T = P^T o (dP^T - D) [o (1 - (s / cap)^2) under the soft-cap],
//         dV += P^T dO, dK += dS^T Q (in registers, the block's keys),
//         dQ_part = dS K (added into an fp32 workspace in key-tile order);
//   (c) dq = the workspace times Dh^-0.5, in the inputs' dtype.
// The block: one producer warpgroup (setmaxnreg 24) whose warp 0 keeps TMA
// loads of Q, dO (64-query tiles) and the rows in flight through a ring of
// 3 stages (2 at Dh 256) with full and empty mbarriers, and whose warp 1
// adds each pair's dQ part into the workspace; two consumer warpgroups
// (setmaxnreg 240) run the products on `wgmma` (csrc/wgmma.cuh), every
// operand in shared memory (128-byte swizzled tiles, hopper.cuh). At
// padded widths up to 128 the key tile is 128 keys and each consumer owns
// 64 of them, all columns: it computes its S^T and dP^T (m64n64), writes
// P^T and dS^T to shared memory as bf16, and runs dV, dK and its dQ part
// over its keys; the second consumer adds its dQ part to the first's in
// shared memory. At 192 and 256 (Dh 160, 256) the registers hold half the
// columns: the key tile is 64 keys, consumer 1 computes S^T and dP^T for
// both, and each runs dV, dK and dQ on its column part (0-127 and
// 128-DP), so no part recomputes S^T or dP^T. A consumer waits its
// products with wgmma.wait_group 1 (dV, dK: the stage is free) and 0 (dQ).
// It does not issue the next tile's S^T and dP^T before this tile's
// elementwise work: at width 128 its dK, dV (128 fp32 registers), two S/dP
// tiles (128) and its dQ part do not fit the 240 it has, and at 16-64,
// where they would, ptxas serialised every wgmma of that form (a
// WARPGROUP.DEPBAR after each HGMMA in the SASS), slower than without it.
//
// dQ in a fixed order: a pair's dQ part (64 x DP fp32) is written over the
// ring stage whose Q and dO it was computed from (the same bytes), and the
// writer adds it to the workspace with one bulk reduce-add (the first key
// tile to reach a query tile stores instead) once an int semaphore per
// (slab, b, h, query tile) says every lower key tile of its slab has
// added its own; it then frees the stage and counts itself in. Blocks are
// dispatched in key-tile order, so a block only waits on blocks that are
// running or done. Non-causal shapes spread their key tiles over slabs (key
// tile n into slab n mod slabs, kernel.bwd_slabs): every key tile reaches
// every query tile at once there, and one slab would chain all their
// adds; (c) adds the slabs in order. Where one block a key tile leaves
// most of the card's SMs idle (StarCoder2-3B's 2 kv heads), the launch
// picks a `target` that splits each key tile's query heads over blocks by
// its work (choose_target, plan_key_tile: causal, the first key tiles into
// more blocks than the last); their fp32 dK, dV parts are added in chunk
// order through an int semaphore per key tile, the last chunk writing the
// gradients. A consumer's wait on that semaphore does not trap (a trap in
// the consumers' code costs them their register budget, PERF.md): after
// its time-out it sets a fault word, and (c) traps on it, so the launch
// fails instead of handing back wrong sums. P and dS
// enter their products as two bf16 halves each (hi + lo: about fp32's
// precision; one rounding of P put single dV elements past the 3e-2 check
// against the plain version, scripts/flash_bwd_witness.py): 8 product
// chains a pair where 5 would do. Dh 120 and 160 run at the padded widths
// 128 and 192 (zero columns from TMA, only columns < Dh stored).
//
// fp32: CUDA-core kernels (fp32 FMAs; TF32 would not hold the fp32
// tolerance): D by a row-dot pass, then dK/dV with one warp per 8 keys (4
// at Dh > 128) and a lane per query of a 32-query tile for S^T and dP^T
// and a lane per head-dim column for dK and dV, the group's heads summed in
// the block; dQ with one warp per 8 query rows (4 at Dh > 128), a lane per
// key.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), at
// StarCoder2-3B's training shape (bf16, B=4, S=512, H=24, KV=2, Dh=128,
// causal; chip_smoke._bwd_times): q, o, dO, dq read and written (4 x 12.6
// MB), k, v, dk, dv (4 x 1.0 MB), lse: 54.5 MB -> 16.3 us; the five
// products over the causal pairs, 10 * B * H * 131,328 * Dh = 16.1 GFLOP
// -> 16.3 us. Both bounds meet. This kernel computes 20 of the 32 (128-key,
// 64-query) tile pairs of each head, 163,840 pairs where the mask lets
// 131,328 through, in 8 chains: 2 x the bound's products, 32.6 us at the
// peak; it moves each pair's 32 KB dQ part through L2 (61 MB of
// reduce-adds) and the 25 MB workspace, with o and dO for the rows, through
// device memory once more (about 17 us at 3.35 TB/s). Its time, and what
// holds it back (shared-memory traffic of two-operand wgmma, consumers in
// step), are in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

struct BwdArgs {
  int H, KV, Sq, Sk, causal, window, kv_len;
  float cap, scale;
  // bf16: the (key tile, query tile) pairs a block aims at, which sets how
  // a key tile's query heads are split over blocks (choose_target,
  // plan_key_tile); and the dQ slabs key tiles add into. fp32: unused.
  int target, slabs;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// row's lse (base 2) and D and dP = dO . v; returns P, sets ds (the
// gradient of the capped, scaled score times the cap's derivative; the
// scale comes last). Both are 0 where the pair is masked.
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
  ds = ok ? p * (dp - dd) * capd : 0.f;
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

// ------------------------------------------------ synchronisation
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The producer's and the writer's waits give up: 2^24 polls (past the
// first few, each with a short sleep: seconds in all, where a legitimate
// wait lasts microseconds) mean a protocol fault, and a trap, an error
// the host sees, is better than a hung card. The consumers wait on
// barriers only those two threads and the consumers themselves complete,
// so a fault traps there first. No consumer code may trap: with a trap
// in the consumer branch ptxas compiles it within the kernel's 168
// registers at entry instead of setmaxnreg's 240 (spilled, every wgmma
// serialised).
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > 64) __nanosleep(32);
    if (n > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// spin until *p reaches `want` (other blocks' count); after 2^23 polls
// (an acquire load from L2 and a short sleep each, 4-10 s in all) trap,
// or in a consumer (kTrap false) set *fault and go on: the dQ cast pass
// traps on it, so a wrong sum never leaves the launch unseen
template <bool kTrap>
__device__ __forceinline__ void wait_count(const int* p, int want,
                                           int* fault = nullptr) {
  for (uint32_t n = 0; ld_acquire(p) < want; ++n) {
    __nanosleep(64);
    if (n > (1u << 23)) {
      if constexpr (kTrap)
        __trap();
      else
        *reinterpret_cast<volatile int*>(fault) = 1;
      return;
    }
  }
}

__device__ __forceinline__ void count_in(int* p) {
  __threadfence();
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(1)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy shared-memory writes made visible to wgmma and bulk copies
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 1-D bulk copy global -> shared, completing on `bar` (16-byte multiples)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, stored (add = false) or added element-wise in fp32;
// committed as one bulk group
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes, bool add) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
        "[%1], %2;\n" ::"l"(dst),
        "r"(src), "r"(bytes)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(src), "r"(bytes)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// at most N of this thread's bulk groups not yet done writing
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------ fp32 (a): D = rowsum(dO o O)
// one warp per (b, s, h) row; D at ((b * H + h) * Sq + s)
__global__ void flash_bwd_dot(const float* __restrict__ o,
                              const float* __restrict__ dout, Strides so,
                              Strides sd, float* __restrict__ D, int H, int Sq,
                              int Dh, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
  const float* orow = o + b * so.b + s * so.s + h * so.h;
  const float* drow = dout + b * sd.b + s * sd.s + h * sd.h;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) D[((size_t)b * H + h) * Sq + s] = acc;
}

// ------------------------------------------------ bf16 (a): the rows
// one warp per (b, s, h), s < Sq_pad; rows[((b * H + h) * Sq_pad + s) * 2]
// = (lse log2(e), D), zeros past Sq
__global__ void flash_bwd_rows(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, Strides so,
                               Strides sd, float* __restrict__ rows, int H,
                               int Sq, int Sq_pad, int Dh, int n_rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int h = row % H, s = (row / H) % Sq_pad, b = row / (H * Sq_pad);
  float acc = 0.f;
  if (s < Sq) {
    const __nv_bfloat16* orow = o + b * so.b + s * so.s + h * so.h;
    const __nv_bfloat16* drow = dout + b * sd.b + s * sd.s + h * sd.h;
    for (int d = lane; d < Dh; d += 32)
      acc = fmaf(to_float(orow[d]), to_float(drow[d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const size_t bh = (size_t)b * H + h;
    float2 out = make_float2(s < Sq ? lse[bh * Sq + s] * kLog2e : 0.f, acc);
    *reinterpret_cast<float2*>(rows + (bh * Sq_pad + s) * 2) = out;
  }
}

// ------------------------------------------------ bf16 (b): the fused kernel
constexpr int kQT = 64;         // queries a tile: the N of S^T and dP^T
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// keys a block: 128 (a consumer's 64 each) up to padded width 128, else 64
template <int DP>
constexpr int kKeyTile = DP <= 128 ? 128 : 64;
template <int DP>
constexpr bool kOwnKeys = DP <= 128;
template <int DP>
constexpr int kRing = DP <= 192 ? 3 : 2;

// byte offsets into the block's shared memory (1024-aligned)
template <int DP>
struct Smem {
  static constexpr int KT = kKeyTile<DP>;
  using KTile = Tile<DP, KT>;
  using QTile = Tile<DP, kQT>;
  using PTile = Tile<64, KT>;  // P^T, dS^T: keys x 64 queries (128-byte rows)
  // a stage: Q then dO; afterwards the pair's dQ part (64 x DP fp32, the
  // same bytes)
  static constexpr int kStage = 2 * QTile::kBytes;
  static constexpr int kK = 0;
  static constexpr int kV = KTile::kBytes;
  static constexpr int kRingOff = 2 * KTile::kBytes;
  static constexpr int kP = kRingOff + kRing<DP> * kStage;  // P^T, high half
  static constexpr int kPl = kP + PTile::kBytes;   // P^T, low half
  static constexpr int kDh = kPl + PTile::kBytes;  // dS^T, high half
  static constexpr int kDl = kDh + PTile::kBytes;  // dS^T, low half
  static constexpr int kRows = kDl + PTile::kBytes;  // per stage 64 x (lse2, D)
  static constexpr int kRowBytes = kQT * 8;
  static constexpr int kBars = kRows + kRing<DP> * kRowBytes;
  // kv, then per stage: full, empty, stage_free, dq_half, dq_full; then
  // ready, freed (the split-column handoff of P^T and dS^T)
  static constexpr int kNumBars = 1 + 5 * kRing<DP> + 2;
  static constexpr size_t kAlloc = kBars + 8 * kNumBars + 1024;
  static_assert(kStage == kQT * DP * 4, "a stage holds a dQ part");
  static_assert(kAlloc <= 232448, "shared memory");
};

struct Bars {
  uint32_t base;
  int stages;
  __device__ uint32_t kv() const { return base; }
  __device__ uint32_t full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return base + 8 * (1 + stages + s); }
  __device__ uint32_t stage_free(int s) const {
    return base + 8 * (1 + 2 * stages + s);
  }
  __device__ uint32_t dq_half(int s) const {
    return base + 8 * (1 + 3 * stages + s);
  }
  __device__ uint32_t dq_full(int s) const {
    return base + 8 * (1 + 4 * stages + s);
  }
  __device__ uint32_t ready() const { return base + 8 * (1 + 5 * stages); }
  __device__ uint32_t freed() const { return base + 8 * (2 + 5 * stages); }
};

// The schedule, on the host (the grid) and in each block: key tile n
// visits the query tiles [first, first + len) its keys reach
// (query_range), and its kv head's R query heads go to `chunks` blocks of
// `per` heads, as many heads a block as keep it near `target` tile pairs:
// heavy key tiles (causal: the first) split into more blocks than light
// ones. A (b, kv head) row of the grid holds each key tile's chunks in
// key-tile order, so every block a block waits on (a lower key tile's, a
// lower chunk's) was dispatched before it.
struct KeyTilePlan {
  int first, len, per, chunks;
};

__host__ __device__ inline KeyTilePlan plan_key_tile(int n, int KT, int R,
                                                     const BwdArgs& a) {
  const int k0 = n * KT;
  int end = a.Sq;
  if (a.window > 0 && k0 + KT - 1 + a.window < end)
    end = k0 + KT - 1 + a.window;
  if (a.kv_len >= 0 && k0 >= a.kv_len) end = 0;
  const int q_first = a.causal ? k0 : 0;
  KeyTilePlan t;
  t.first = q_first / kQT;
  t.len = end > q_first ? (end - 1) / kQT - t.first + 1 : 0;
  const int per = t.len > 0 ? a.target / t.len : R;
  t.per = per < 1 ? 1 : (per > R ? R : per);
  t.chunks = (R + t.per - 1) / t.per;
  return t;
}

// A block's place and its walk: iteration i takes query tile
// m_last - i / nh and head h_first + i % nh (the last query tile first, so
// the key tiles of a query tile reach it in key-tile order).
struct Walk {
  int b, g, sp, nchunks, kt, k0, h_first, nh, m_last, n_iter;
  __device__ int m(int i) const { return m_last - i / nh; }
  __device__ int h(int i) const { return h_first + i % nh; }
};

template <int DP>
__device__ __forceinline__ Walk make_walk(const BwdArgs& a) {
  constexpr int KT = kKeyTile<DP>;
  const int R = a.H / a.KV;
  Walk w;
  w.g = blockIdx.y;
  w.b = blockIdx.z;
  int x = blockIdx.x, n = 0;
  KeyTilePlan t = plan_key_tile(0, KT, R, a);
  while (x >= t.chunks) {
    x -= t.chunks;
    t = plan_key_tile(++n, KT, R, a);
  }
  w.kt = n;
  w.sp = x;
  w.nchunks = t.chunks;
  w.k0 = n * KT;
  w.h_first = w.g * R + x * t.per;
  w.nh = min(w.g * R + R, w.h_first + t.per) - w.h_first;
  w.m_last = t.first + t.len - 1;
  w.n_iter = w.nh * t.len;
  return w;
}

// The first key tile whose query range holds query tile m: the key tiles
// that add to m's dQ are that one and the ones after it (each into its
// slab, in order).
__device__ __forceinline__ int first_key_tile(int m, int KT, const BwdArgs& a) {
  if (a.window <= 0) return 0;
  const long long x = (long long)m * kQT - KT + 1 - a.window;
  return x < 0 ? 0 : (int)(x / KT) + 1;
}

// A bf16 pair into a 128-byte-swizzled tile of 128-byte rows: row `row`,
// 16-byte chunk `chunk`, 4 bytes at lane % 4.
__device__ __forceinline__ void st_swizzled(uint32_t tile, int row, int chunk,
                                            int lane, uint32_t v) {
  const uint32_t addr =
      tile + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * (lane & 3);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// S^T (64 keys from row r0 of the key tiles x 64 queries) = K Q^T and
// dP^T = V dO^T, both operands K-major; issued and committed.
template <int DP>
__device__ __forceinline__ void issue_sdp(float (&st)[32], float (&dpt)[32],
                                          uint32_t sk, uint32_t sv,
                                          uint32_t stage) {
  constexpr int KT = kKeyTile<DP>;
  using QT = Tile<DP, kQT>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    WgmmaSST<64, 0, 0>::run(st, desc_kmajor<DP, KT>(sk, kk),
                            desc_kmajor<DP, kQT>(stage, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    WgmmaSST<64, 0, 0>::run(dpt, desc_kmajor<DP, KT>(sv, kk),
                            desc_kmajor<DP, kQT>(stage + QT::kBytes, kk),
                            kk > 0);
  wgmma_commit();
}

// P^T and dS^T of one 64 x 64 tile from S^T and dP^T (rows: keys from
// key_row, the tiles' row R0; columns: queries q0..), written to the P and
// dS tiles as bf16 halves (hi, then the residual lo). kCap and kFull (the
// whole tile visible: no per-element mask) are fixed outside the unrolled
// body, so it holds no branch.
template <int R0, bool kCap, bool kFull>
__device__ __forceinline__ void softmax_grad_tile(
    const float (&st)[32], const float (&dpt)[32], const float* rows_s,
    int q0, int key_row, uint32_t sp, uint32_t spl, uint32_t sdh,
    uint32_t sdl, const BwdArgs& a) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int kr = key_row + 16 * warp + (lane >> 2);
  const int qc = 2 * (lane & 3);
  const float scale2 = a.scale * kLog2e;  // score to base-2 exponent
  const float to_cap = kCap ? a.scale / a.cap : 0.f, cap2 = a.cap * kLog2e;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 rw =
        *reinterpret_cast<const float4*>(rows_s + 2 * (8 * c + qc));
    const float lse2[2] = {rw.x, rw.z}, dd[2] = {rw.y, rw.w};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = kr + 8 * r, row = R0 + 16 * warp + (lane >> 2) + 8 * r;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * c + 2 * r + e;
        float x2, capd = 1.f;
        if (kCap) {
          const float th = tanhf(st[idx] * to_cap);
          x2 = cap2 * th;
          capd = 1.f - th * th;
        } else {
          x2 = st[idx] * scale2;
        }
        const bool ok = kFull || visible(q0 + 8 * c + qc + e, kpos, a);
        p[e] = ok ? fast_exp2(x2 - lse2[e]) : 0.f;
        // masked: p = 0 and dp - D finite (zero rows past Sq), so ds = 0
        ds[e] = p[e] * (dpt[idx] - dd[e]);
        if (kCap) ds[e] *= capd;
      }
      const __nv_bfloat162 ph = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 dh = __floats2bfloat162_rn(ds[0], ds[1]);
      st_swizzled(sp, row, c, lane, *reinterpret_cast<const uint32_t*>(&ph));
      st_swizzled(spl, row, c, lane,
                  pack_bf16(p[0] - __low2float(ph), p[1] - __high2float(ph)));
      st_swizzled(sdh, row, c, lane, *reinterpret_cast<const uint32_t*>(&dh));
      st_swizzled(sdl, row, c, lane,
                  pack_bf16(ds[0] - __low2float(dh), ds[1] - __high2float(dh)));
    }
  }
  fence_async_smem();
}

template <int R0>
__device__ __forceinline__ void softmax_grad(const float (&st)[32],
                                             const float (&dpt)[32],
                                             const float* rows_s, int q0,
                                             int key_row, uint32_t sp,
                                             uint32_t spl, uint32_t sdh,
                                             uint32_t sdl, const BwdArgs& a) {
  const bool full = q0 + kQT <= a.Sq && key_row + 64 <= a.Sk &&
                    (!a.causal || key_row + 63 <= q0) &&
                    (a.window <= 0 || key_row > q0 + kQT - 1 - a.window) &&
                    (a.kv_len < 0 || key_row + 64 <= a.kv_len);
  if (a.cap > 0.f) {
    if (full)
      softmax_grad_tile<R0, true, true>(st, dpt, rows_s, q0, key_row, sp, spl,
                                        sdh, sdl, a);
    else
      softmax_grad_tile<R0, true, false>(st, dpt, rows_s, q0, key_row, sp,
                                         spl, sdh, sdl, a);
  } else {
    if (full)
      softmax_grad_tile<R0, false, true>(st, dpt, rows_s, q0, key_row, sp,
                                         spl, sdh, sdl, a);
    else
      softmax_grad_tile<R0, false, false>(st, dpt, rows_s, q0, key_row, sp,
                                          spl, sdh, sdl, a);
  }
}

// dV += P^T dO, dK += dS^T Q (P and dS each as its two halves) over one
// query tile, on columns [COL0, COL0 + N), rows R0.. of the P and dS
// tiles; then the dQ part dq = dS K over the same keys; two commit groups.
template <int DP, int N, int R0, int COL0>
__device__ __forceinline__ void issue_products(float (&acc_v)[N / 2],
                                               float (&acc_k)[N / 2],
                                               float (&dq)[N / 2],
                                               uint32_t stage, uint32_t sk,
                                               uint32_t sp, uint32_t spl,
                                               uint32_t sdh, uint32_t sdl) {
  constexpr int KT = kKeyTile<DP>;
  using QT = Tile<DP, kQT>;
  using KTl = Tile<DP, KT>;
  using PT = Tile<64, KT>;
  const uint32_t qs = stage + (COL0 / 64) * QT::kSlabBytes;
  const uint32_t dos = qs + QT::kBytes;
  const uint32_t ks = sk + R0 * KTl::kRowBytes + (COL0 / 64) * KTl::kSlabBytes;
  const uint32_t pr = R0 * PT::kRowBytes;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kQT / 16; ++kk)
    WgmmaSST<N, 0, 1>::run(acc_v, desc_kmajor<64, KT>(sp + pr, kk),
                           desc_mnmajor<DP, kQT>(dos, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kQT / 16; ++kk)
    WgmmaSST<N, 0, 1>::run(acc_v, desc_kmajor<64, KT>(spl + pr, kk),
                           desc_mnmajor<DP, kQT>(dos, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kQT / 16; ++kk)
    WgmmaSST<N, 0, 1>::run(acc_k, desc_kmajor<64, KT>(sdh + pr, kk),
                           desc_mnmajor<DP, kQT>(qs, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kQT / 16; ++kk)
    WgmmaSST<N, 0, 1>::run(acc_k, desc_kmajor<64, KT>(sdl + pr, kk),
                           desc_mnmajor<DP, kQT>(qs, kk), 1);
  wgmma_commit();
  // 64 keys: this consumer's (own keys) or the whole tile's (split columns)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    WgmmaSST<N, 1, 1>::run(dq, desc_mnmajor<64, KT>(sdh + pr, kk),
                           desc_mnmajor<DP, KT>(ks, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    WgmmaSST<N, 1, 1>::run(dq, desc_mnmajor<64, KT>(sdl + pr, kk),
                           desc_mnmajor<DP, KT>(ks, kk), 1);
  wgmma_commit();
}

// A consumer warpgroup's accumulator (64 x N, register 4j + 2r + e: row
// 16 warp + lane / 4 + 8r, column 8j + 2 (lane % 4) + e) as float4 j of
// thread t at (j * 128 + t) * 16 bytes: the dQ part's layout in a stage,
// in the workspace, and of the dK/dV parts.
template <int N>
__device__ __forceinline__ void st_part(uint32_t dst, const float (&x)[N / 2]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + (j * 128 + t) * 16),
                 "f"(x[4 * j]), "f"(x[4 * j + 1]), "f"(x[4 * j + 2]),
                 "f"(x[4 * j + 3])
                 : "memory");
}

template <int N>
__device__ __forceinline__ void add_part(uint32_t dst, const float (&x)[N / 2]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint32_t at = dst + (j * 128 + t) * 16;
    float4 o;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(o.x), "=f"(o.y), "=f"(o.z), "=f"(o.w)
                 : "r"(at)
                 : "memory");
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                 "f"(o.x + x[4 * j]), "f"(o.y + x[4 * j + 1]),
                 "f"(o.z + x[4 * j + 2]), "f"(o.w + x[4 * j + 3])
                 : "memory");
  }
}

// dK (scaled) and dV of rows k_row.., columns [COL0, COL0 + N) into the
// gradients: directly when the key tile's heads are one block's, else
// added in head-chunk order into the fp32 parts `ws` (this consumer's
// region, dK's then dV's, KT x DP apart), the last chunk writing the
// gradients; the order held by the int at `sem` (a time-out sets *fault).
template <int DH, int N, int COL0>
__device__ __forceinline__ void store_dkdv(const float (&acc_k)[N / 2],
                                           const float (&acc_v)[N / 2],
                                           const Walk& w, int k_row,
                                           __nv_bfloat16* dk,
                                           __nv_bfloat16* dv, Strides sdk,
                                           Strides sdv, float* ws, int* sem,
                                           int* fault, const BwdArgs& a) {
  constexpr int DP = kPadded<DH>, KT = kKeyTile<DP>;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int tc = threadIdx.x - 128;  // 0..255 over both consumers
  const bool split = w.nchunks > 1, last = w.sp == w.nchunks - 1;
  if (split) {
    if (tc == 0 && w.sp > 0) wait_count<false>(sem, w.sp, fault);
    named_sync(3, 256);
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float4 xk = make_float4(acc_k[4 * j], acc_k[4 * j + 1], acc_k[4 * j + 2],
                            acc_k[4 * j + 3]);
    float4 xv = make_float4(acc_v[4 * j], acc_v[4 * j + 1], acc_v[4 * j + 2],
                            acc_v[4 * j + 3]);
    float4* pk = split ? reinterpret_cast<float4*>(ws) + j * 128 + t : nullptr;
    float4* pv = split ? reinterpret_cast<float4*>(ws + KT * DP) + j * 128 + t
                       : nullptr;
    if (split && w.sp > 0) {
      const float4 ok = __ldcg(pk), ov = __ldcg(pv);
      xk = make_float4(ok.x + xk.x, ok.y + xk.y, ok.z + xk.z, ok.w + xk.w);
      xv = make_float4(ov.x + xv.x, ov.y + xv.y, ov.z + xv.z, ov.w + xv.w);
    }
    if (!last) {
      __stcg(pk, xk);
      __stcg(pv, xv);
      continue;
    }
    const int col = COL0 + 8 * j + 2 * (lane & 3);
    if (col >= DH) continue;  // the padded columns are not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = k_row + 16 * warp + (lane >> 2) + 8 * r;
      if (kpos >= a.Sk) continue;
      const float k0 = r ? xk.z : xk.x, k1 = r ? xk.w : xk.y;
      const float v0 = r ? xv.z : xv.x, v1 = r ? xv.w : xv.y;
      *reinterpret_cast<uint32_t*>(dk + w.b * sdk.b + kpos * sdk.s +
                                   w.g * sdk.h + col) =
          pack_bf16(k0 * a.scale, k1 * a.scale);
      *reinterpret_cast<uint32_t*>(dv + w.b * sdv.b + kpos * sdv.s +
                                   w.g * sdv.h + col) = pack_bf16(v0, v1);
    }
  }
  if (!last) {
    __threadfence();
    named_sync(3, 256);
    if (tc == 0) count_in(sem);
  }
}

struct Kernel {
  const float* rows;
  float* dq_acc;  // slabs x B x H x nq query tiles of 64 x DP
  int* sems;      // dQ's: slabs x B x H x nq; dK/dV's: B x KV x nkt; fault
  float* kv_acc;  // B x KV x nkt x 2 x KT x DP, where a group has 2+ heads
  __nv_bfloat16 *dk, *dv;
  Strides sdk, sdv;
  int nq, nkt;
};

// Consumer C (0 or 1). Own keys (DP <= 128): rows 64C.. of the key tile,
// all columns. Split columns: consumer 0 columns 0-127, consumer 1 columns
// 128-DP and S^T, dP^T of the tile's 64 keys.
template <int DH, int C>
__device__ __forceinline__ void consumer(uint32_t base, const Bars& bar,
                                         const Walk& w, const Kernel& p,
                                         const BwdArgs& a,
                                         const uint8_t* smem) {
  constexpr int DP = kPadded<DH>, KT = kKeyTile<DP>, S = kRing<DP>;
  constexpr bool kOwn = kOwnKeys<DP>;
  constexpr int COL0 = kOwn || C == 0 ? 0 : 128;
  constexpr int N = kOwn ? DP : (C == 0 ? 128 : DP - 128);
  constexpr bool kSdp = kOwn || C == 1;
  constexpr int R0 = kOwn ? 64 * C : 0;
  using L = Smem<DP>;
  const uint32_t sk = base + L::kK, sv = base + L::kV;
  const uint32_t sp = base + L::kP, spl = base + L::kPl;
  const uint32_t sdh = base + L::kDh, sdl = base + L::kDl;
  const int key_row = w.k0 + R0;

  float acc_k[N / 2], acc_v[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float st[32], dpt[32];

  if (w.n_iter > 0) mbar_wait(bar.kv(), 0);
  for (int i = 0; i < w.n_iter; ++i) {
    const int s = i % S, ph = (i / S) & 1;
    const uint32_t stage = base + L::kRingOff + s * L::kStage;
    const int q0 = w.m(i) * kQT;
    float dq[N / 2];
    if constexpr (kSdp) {
      const uint32_t ksr = sk + R0 * Tile<DP, KT>::kRowBytes;
      const uint32_t vsr = sv + R0 * Tile<DP, KT>::kRowBytes;
      mbar_wait(bar.full(s), ph);
      issue_sdp<DP>(st, dpt, ksr, vsr, stage);
      wgmma_wait<0>();
      if constexpr (!kOwn) {
        // the other consumer's products of the last tile are done with
        // the P and dS tiles
        if (i > 0) mbar_wait(bar.freed(), (i - 1) & 1);
      }
      softmax_grad<R0>(st, dpt,
                       reinterpret_cast<const float*>(smem + L::kRows +
                                                      s * L::kRowBytes),
                       q0, key_row, sp, spl, sdh, sdl, a);
      if constexpr (!kOwn) mbar_arrive(bar.ready());
      named_sync(1 + C, 128);
      issue_products<DP, N, R0, COL0>(acc_v, acc_k, dq, stage, sk, sp, spl,
                                      sdh, sdl);
      wgmma_wait<1>();  // dV, dK done
    } else {
      mbar_wait(bar.full(s), ph);
      mbar_wait(bar.ready(), i & 1);
      issue_products<DP, N, R0, COL0>(acc_v, acc_k, dq, stage, sk, sp, spl,
                                      sdh, sdl);
      wgmma_wait<1>();
    }
    mbar_arrive(bar.stage_free(s));  // this consumer is done with Q, dO
    wgmma_wait<0>();
    if constexpr (!kSdp) mbar_arrive(bar.freed());
    // the dQ part over the stage: own keys, consumer 0's then consumer 1's
    // added to it; split columns, each its column region
    const uint32_t region = stage + COL0 * kQT * 4;
    if constexpr (kOwn && C == 1) {
      mbar_wait(bar.dq_half(s), ph);
      add_part<N>(region, dq);
    } else {
      mbar_wait(bar.stage_free(s), ph);
      st_part<N>(region, dq);
    }
    if constexpr (kOwn && C == 0) {
      mbar_arrive(bar.dq_half(s));
    } else {
      fence_async_smem();
      mbar_arrive(bar.dq_full(s));
    }
  }

  // the dK/dV parts of this (b, kv head, key tile): dK's then dV's, each
  // consumer's region in them; and their semaphore, after the dQ ones,
  // then the fault word
  const size_t kv_tile = ((size_t)w.b * a.KV + w.g) * p.nkt + w.kt;
  float* ws = p.kv_acc == nullptr
                  ? nullptr
                  : p.kv_acc + kv_tile * 2 * KT * DP +
                        (kOwn ? C * 64 * DP : COL0 * 64);
  int* kv_sems = p.sems + (size_t)a.slabs * gridDim.z * a.H * p.nq;
  store_dkdv<DH, N, COL0>(acc_k, acc_v, w, key_row, p.dk, p.dv, p.sdk, p.sdv,
                          ws, kv_sems + kv_tile,
                          kv_sems + (size_t)gridDim.z * a.KV * p.nkt, a);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, Kernel p,
               BwdArgs a) {
  constexpr int DP = kPadded<DH>, KT = kKeyTile<DP>, S = kRing<DP>;
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const Bars bar{base + (uint32_t)L::kBars, S};
  const Walk w = make_walk<DP>(a);

  if (threadIdx.x == 0) {
    mbar_init(bar.kv(), 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar.full(s), 1);
      mbar_init(bar.empty(s), 1);
      mbar_init(bar.stage_free(s), 256);
      mbar_init(bar.dq_half(s), 128);
      mbar_init(bar.dq_full(s), kOwnKeys<DP> ? 128 : 256);
    }
    mbar_init(bar.ready(), 128);
    mbar_init(bar.freed(), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform as the compiler sees it, so that each branch
  // is compiled to its own register budget (setmaxnreg)
  const int wg = __shfl_sync(kFull, (int)(threadIdx.x / 128), 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (lane == 0 && warp == 0 && w.n_iter > 0) {
      // the producer: K and V once, then Q, dO and the rows per iteration
      mbar_expect_tx(bar.kv(), 2 * L::KTile::kBytes);
      load_tile<DP, KT>(base + L::kK, &map_k, bar.kv(), w.g, w.k0, w.b);
      load_tile<DP, KT>(base + L::kV, &map_v, bar.kv(), w.g, w.k0, w.b);
      for (int i = 0; i < w.n_iter; ++i) {
        const int s = i % S, j = i / S;
        if (j > 0) mbar_wait_or_trap(bar.empty(s), (j - 1) & 1);
        const int h = w.h(i), q0 = w.m(i) * kQT;
        const uint32_t stage = base + L::kRingOff + s * L::kStage;
        mbar_expect_tx(bar.full(s), L::kStage + L::kRowBytes);
        load_tile<DP, kQT>(stage, &map_q, bar.full(s), h, q0, w.b);
        load_tile<DP, kQT>(stage + L::QTile::kBytes, &map_do, bar.full(s), h,
                           q0, w.b);
        bulk_load(base + L::kRows + s * L::kRowBytes,
                  p.rows + ((size_t)(w.b * a.H + h) * p.nq * kQT + q0) * 2,
                  L::kRowBytes, bar.full(s));
      }
    } else if (lane == 0 && warp == 1) {
      // the dQ writer: each pair's part, in key-tile order per query tile.
      // The stage is freed once the bulk add has read it; the add is
      // counted in (the next key tile admitted) once it is done
      for (int i = 0; i < w.n_iter; ++i) {
        const int s = i % S;
        mbar_wait_or_trap(bar.dq_full(s), (i / S) & 1);
        const int m = w.m(i);
        const size_t tile =
            (((size_t)(w.kt % a.slabs) * gridDim.z + w.b) * a.H + w.h(i)) *
                p.nq + m;
        int* sem = p.sems + tile;
        // the lower key tiles of this slab that add to m
        int before = 0;
        for (int n = w.kt - a.slabs, lo = first_key_tile(m, KT, a); n >= lo;
             n -= a.slabs)
          ++before;
        if (before > 0) wait_count<true>(sem, before);
        bulk_store(p.dq_acc + tile * kQT * DP,
                   base + L::kRingOff + s * L::kStage, L::kStage, before > 0);
        bulk_wait_read<0>();
        mbar_arrive(bar.empty(s));
        bulk_wait<0>();
        count_in(sem);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (wg == 1)
      consumer<DH, 0>(base, bar, w, p, a, smem);
    else
      consumer<DH, 1>(base, bar, w, p, a, smem);
  }
}

// ------------------------------------------------ bf16 (c): dq
// one block per (b, h, query tile): the slabs' tiles (the consumers'
// layout, st_part) added in slab order, times the scale, in bf16; a slab
// no key tile added to counts as zeros. Traps where (b) set its fault word
template <int DH>
__global__ void flash_bwd_dq_cast(const float* __restrict__ dq_acc,
                                  const int* __restrict__ sems,
                                  const int* __restrict__ fault,
                                  __nv_bfloat16* __restrict__ dq, Strides sdq,
                                  int H, int Sq, int nq, int slabs,
                                  float scale) {
  constexpr int DP = kPadded<DH>;
  if (*fault) __trap();
  constexpr int kRegion0 = kOwnKeys<DP> ? DP / 8 * 128 : 16 * 128;
  const int tile = blockIdx.x, m = tile % nq, h = (tile / nq) % H,
            b = tile / (nq * H);
  const size_t per_slab = (size_t)gridDim.x;
  for (int f = threadIdx.x; f < kQT * DP / 4; f += blockDim.x) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < slabs; ++g) {
      const size_t t = g * per_slab + tile;
      if (sems[t] == 0) continue;
      const float4 y =
          __ldg(reinterpret_cast<const float4*>(dq_acc) + t * kQT * DP / 4 + f);
      x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
    }
    const int col0 = f < kRegion0 ? 0 : 128, g = f < kRegion0 ? f : f - kRegion0;
    const int j = g / 128, t = g % 128, warp = t / 32, lane = t % 32;
    const int col = col0 + 8 * j + 2 * (lane & 3);
    if (col >= DH) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = m * kQT + 16 * warp + (lane >> 2) + 8 * r;
      if (qpos >= Sq) continue;
      *reinterpret_cast<uint32_t*>(dq + b * sdq.b + qpos * sdq.s + h * sdq.h +
                                   col) =
          r ? pack_bf16(x.z * scale, x.w * scale)
            : pack_bf16(x.x * scale, x.y * scale);
    }
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
                   float* __restrict__ dk, float* __restrict__ dv, Strides sq,
                   Strides sk, Strides sv, Strides sd, Strides sdk, Strides sdv,
                   int Dh, BwdArgs a) {
  constexpr int KR = kF32Rows<NT>, KB = kF32Warps * KR;
  extern __shared__ float fsm[];
  float* ks = fsm;               // [KB][Dh]
  float* vs = ks + KB * Dh;      // [KB][Dh]
  float* qs = vs + KB * Dh;      // [32][Dh + 1]
  float* ds_ = qs + kF32Tile * (Dh + 1);  // dO, [32][Dh + 1]
  const int ld = Dh + 1;
  const int g = blockIdx.y;
  const int b = blockIdx.z, k0 = blockIdx.x * KB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * KR;

  for (int i = tid; i < KB * Dh; i += kF32Threads) {
    const int j = i / Dh, d = i - j * Dh, kpos = k0 + j;
    ks[i] = kpos < a.Sk ? k[b * sk.b + kpos * sk.s + g * sk.h + d] : 0.f;
    vs[i] = kpos < a.Sk ? v[b * sv.b + kpos * sv.s + g * sv.h + d] : 0.f;
  }
  int q_first, q_end;
  query_range(k0, KB, kF32Tile, a, q_first, q_end);
  const int h_first = g * (a.H / a.KV), h_end = h_first + a.H / a.KV;

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
      if (d < Dh) {
        dk[b * sdk.b + kpos * sdk.s + g * sdk.h + d] = acc_k[j][t] * a.scale;
        dv[b * sdv.b + kpos * sdv.s + g * sdv.h + d] = acc_v[j][t];
      }
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

// ------------------------------------------------ launches
struct Ptrs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float *rows, *dq_acc;
  int* sems;
  float* kv_acc;
};

struct AllStrides {
  Strides q, k, v, o, dout, dq, dk, dv;
};

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
  const int n_rows = B * a.Sq * a.H;
  flash_bwd_dot<<<(n_rows + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(p.o), g, s.o, s.dout, p.rows, a.H, a.Sq, Dh,
      n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_f32<NT><<<dim3((a.Sk + rows - 1) / rows, a.KV, B),
                           kF32Threads, smem, st>>>(
      q, k, v, g, p.lse, p.rows, static_cast<float*>(p.dk),
      static_cast<float*>(p.dv), s.q, s.k, s.v, s.dout, s.dk, s.dv, Dh, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<NT><<<dim3((a.Sq + rows - 1) / rows, a.H, B), kF32Threads,
                         smem, st>>>(
      q, k, v, g, p.lse, p.rows, static_cast<float*>(p.dq), s.q, s.k, s.v,
      s.dout, s.dq, Dh, a);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Ptrs& p, const AllStrides& s, int B, int Dh,
                         const BwdArgs& a, cudaStream_t st) {
  if (Dh <= 32) return launch_f32<1>(p, s, B, Dh, a, st);
  if (Dh <= 64) return launch_f32<2>(p, s, B, Dh, a, st);
  if (Dh <= 128) return launch_f32<4>(p, s, B, Dh, a, st);
  return launch_f32<8>(p, s, B, Dh, a, st);
}

// The (key tile, query tile) pairs a block aims at: every key tile's heads
// in one block, unless that grid leaves a tenth or more of the `sms` SMs
// idle (one block an SM: the shared memory allows no second); then the
// smallest target whose grid fits them, the heaviest key tiles split the
// most.
int choose_target(int B, int nkt, int KT, BwdArgs a, int sms) {
  const int R = a.H / a.KV;
  int longest = 1;
  for (int n = 0; n < nkt; ++n) {
    const int len = plan_key_tile(n, KT, R, a).len;
    longest = len > longest ? len : longest;
  }
  if (10 * B * a.KV * nkt >= 9 * sms) return R * longest;
  for (int t = longest; t < R * longest; ++t) {
    a.target = t;
    long long blocks = 0;
    for (int n = 0; n < nkt; ++n) blocks += plan_key_tile(n, KT, R, a).chunks;
    if ((long long)B * a.KV * blocks <= sms) return t;
  }
  return R * longest;
}

template <int DH>
cudaError_t launch_bf16(const Ptrs& p, const AllStrides& s, int B,
                        BwdArgs a, cudaStream_t st) {
  constexpr int DP = kPadded<DH>, KT = kKeyTile<DP>;
  const int nq = (a.Sq + kQT - 1) / kQT, nkt = (a.Sk + KT - 1) / KT;
  CUtensorMap mq, mdo, mk, mv;
  if (!make_map<DH, kQT>(&mq, p.q, a.H, a.Sq, B, s.q) ||
      !make_map<DH, kQT>(&mdo, p.dout, a.H, a.Sq, B, s.dout) ||
      !make_map<DH, KT>(&mk, p.k, a.KV, a.Sk, B, s.k) ||
      !make_map<DH, KT>(&mv, p.v, a.KV, a.Sk, B, s.v))
    return cudaErrorInvalidValue;
  const int n_rows = B * a.H * nq * kQT;
  flash_bwd_rows<<<(n_rows + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(p.o),
      static_cast<const __nv_bfloat16*>(p.dout), p.lse, s.o, s.dout, p.rows,
      a.H, a.Sq, nq * kQT, DH, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the grid: each key tile's head chunks, in key-tile order; the dK/dV
  // parts' scratch needed where some key tile splits its heads
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  a.target = choose_target(B, nkt, KT, a, sms);
  int blocks = 0;
  bool split = false;
  for (int n = 0; n < nkt; ++n) {
    const KeyTilePlan t = plan_key_tile(n, KT, a.H / a.KV, a);
    blocks += t.chunks;
    split = split || t.chunks > 1;
  }
  if ((split && p.kv_acc == nullptr) || blocks > 65535)
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<DP>::kAlloc;
  err = cudaFuncSetAttribute(flash_bwd_bf16<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Kernel k{p.rows, p.dq_acc, p.sems, p.kv_acc,
                 static_cast<__nv_bfloat16*>(p.dk),
                 static_cast<__nv_bfloat16*>(p.dv), s.dk, s.dv, nq, nkt};
  flash_bwd_bf16<DH><<<dim3(blocks, a.KV, B), kThreads, smem, st>>>(
      mq, mdo, mk, mv, k, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int* fault =
      p.sems + (size_t)a.slabs * B * a.H * nq + (size_t)B * a.KV * nkt;
  flash_bwd_dq_cast<DH><<<B * a.H * nq, 256, 0, st>>>(
      p.dq_acc, p.sems, fault, static_cast<__nv_bfloat16*>(p.dq), s.dq, a.H,
      a.Sq, nq, a.slabs, a.scale);
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

int key_tile_of(int dh) {
  switch (dh) {
    case 16: return kKeyTile<kPadded<16>>;
    case 32: return kKeyTile<kPadded<32>>;
    case 64: return kKeyTile<kPadded<64>>;
    case 120: return kKeyTile<kPadded<120>>;
    case 128: return kKeyTile<kPadded<128>>;
    case 160: return kKeyTile<kPadded<160>>;
    case 256: return kKeyTile<kPadded<256>>;
    default: return 0;
  }
}

}  // namespace

// The bf16 kernel's tiling for head dim dh: keys a block, queries a tile,
// the padded width; returns 0, or cudaErrorInvalidValue for a head dim it
// does not take. The binding sizes its scratch from these.
extern "C" int repro_flash_bwd_tiles(int dh, int* key_tile, int* query_tile,
                                     int* width) {
  const int kt = key_tile_of(dh);
  if (kt == 0) return (int)cudaErrorInvalidValue;
  *key_tile = kt;
  *query_tile = kQT;
  *width = dh < 64 ? dh : (dh + 63) / 64 * 64;
  return 0;
}

// q, o, dout, dq: (B, Sq, H, Dh); k, v, dk, dv: (B, Sk, KV, Dh); `strides`
// holds (b, s, h) in elements for q, k, v, o, dout, dq, dk, dv in that order,
// the head dimension contiguous; lse fp32 (B, H, Sq) contiguous. dtype: 0 =
// float32 (Dh <= 256; rows = D, fp32 (B, H, Sq) scratch; dq_acc, sems,
// kv_acc NULL; slabs unused), 1 = bfloat16 (Dh in {16, 32, 64, 120, 128,
// 160, 256}; every bf16 operand 16-byte aligned, as TMA needs; with nq =
// ceil(Sq / 64) and nkt = ceil(Sk / key tile) from repro_flash_bwd_tiles:
// rows fp32 (B, H, nq * 64, 2), dq_acc fp32 (slabs, B, H, nq, 64 * width),
// sems int32 of slabs * B * H * nq + B * KV * nkt + 1 zeros, kv_acc fp32
// (B, KV, nkt, 2, key tile * width) where H > KV, else NULL: the schedule
// may then split a key tile's heads over blocks). kv_len < 0 means "no
// kv_len mask".
// Launches on `stream`; returns a cudaError_t (0 on success), the caller
// raises on anything else.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* rows, void* dq_acc, void* sems, void* kv_acc,
    const long long* strides, int B, int H, int KV, int Sq, int Sk, int Dh,
    int causal, int window, float cap, float scale, int kv_len, int slabs,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      Dh <= 0 || Dh > 256 || B > 65535 || KV > 65535 || slabs < 1 ||
      rows == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 &&
      (dq_acc != nullptr || sems != nullptr || kv_acc != nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (dq_acc == nullptr || sems == nullptr))
    return (int)cudaErrorInvalidValue;
  AllStrides s;
  Strides* all[8] = {&s.q, &s.k, &s.v, &s.o, &s.dout, &s.dq, &s.dk, &s.dv};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Ptrs p{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(rows), static_cast<float*>(dq_acc),
               static_cast<int*>(sems), static_cast<float*>(kv_acc)};
  const BwdArgs a{H, KV, Sq, Sk, causal, window, kv_len, cap, scale, 0, slabs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_f32(p, s, B, Dh, a, st);
  if (dtype == 1) return (int)dispatch_bf16(p, s, B, Dh, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
