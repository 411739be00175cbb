// WKV6 forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py, function `wkv6`
// (:52; Pallas body `_kernel`, :24-49): the RWKV-6 recurrence, per (batch,
// head), with an N x N fp32 state
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// o in r's dtype, S_T in fp32, S_{-1} = s0 or 0.
//
// What bounds it on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 on the tensor
// cores, 67 TFLOP/s fp32 on the CUDA cores). At the RWKV-6 prefill shape,
// B=4, T=500, H=64, N=64, bf16 r/k/v/o and fp32 w: bytes = r + k + v + o
// (4 * 16.4 MB) + w (32.8 MB) + s0 + S_T (2 * 4.2 MB) = 106.7 MB -> 31.9 us;
// the least work, 5 N^2 + 5 N FLOP per (b, h, t), is 2.66 GFLOP: 39.7 us on
// the CUDA cores, 5.4 us on the TF32 tensor cores. So once the products run
// on the tensor cores the bound is the bytes, 31.9 us. In decode (T = 1) it
// is the state: s0 in and S_T out, 8.4 MB -> 2.6 us.
//
// Two kernels; the entry point launches exactly one per call, the one its
// caller names (the binding's rule: the chunked one when T >= 32 and
// N >= 16).
//
// Prefill: the chunked form, `wkv6_chunked`. The recurrent
// kernel below walks T dependent steps, each a barrier and a 64-term FMA
// chain, and its latency set its pace: 0.366 ms at the prefill shape, 9.2x
// the CUDA-core bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 12). Here a
// block owns one (b, h) and walks T/32 chunks of C = 32 steps. With
// P[t] = sum_{i<t} log2 w_i inside the chunk (P[0] = 0; all powers of 2), a
// chunk's outputs and state are
//
//   o_t    = (r_t 2^{P[t]}) S_in + sum_{s<t} A[t,s] v_s + (r_t u k_t) v_t
//   A[t,s] = sum_n r_t[n] k_s[n] 2^{P[t][n] - P[s+1][n]}
//   S_out  = diag(2^{P[C]}) S_in + sum_s (k_s 2^{P[C] - P[s+1]})^T v_s
//
// Splitting 2^{P[t] - P[s+1]} into 2^{P[t]} and 2^{-P[s+1]} would overflow
// fp32 once -P passes 128 (w = 0.25 over 64 steps), so every factor is kept
// <= 1. The chunk is four sub-chunks of L = 8 steps. A block of A between
// sub-chunks a < b is factored about their boundaries: (r_t 2^{P[t] -
// P[L b]}) (2^{P[L b] - P[L (a+1)]}) (k_s 2^{P[L (a+1)] - P[s+1]}); a
// diagonal block is summed pair by pair with 2^{P[t] - P[s+1]} <= 1; the
// inter-chunk factors have exponents <= 0. The sums of log2 w are kept per
// sub-chunk, so the exponents inside one are differences of small numbers.
// A step with w = 0 (the model's w = exp(-exp(d)) is 0 in fp32 once d
// passes ~4.6) restarts those sums, and a product across it is set to 0 by
// its position: log2 0 = -inf would make the differences NaN, and a large
// finite stand-in would cost every later exponent its low bits.
// Four products run on the tensor cores as mma.sync m16n8k8 TF32 with the
// 3xTF32 split (a = a_hi + a_lo, both rounded; a_lo b_hi + a_hi b_lo +
// a_hi b_hi), so they keep fp32 accuracy (a bf16 v is exact in TF32 and
// needs two): the blocks of A between sub-chunks, A V, (r 2^{P}) S_in and
// the state update. r, k, v, w of the next chunk arrive by cp.async into a
// second buffer while this chunk computes. The state stays on chip, in the
// registers of the warps that update it and in shared memory for the
// (r 2^{P}) S_in product. One block per (b, h), 8 warps, four barriers a
// chunk; in the last phase warps 0-3 compute the outputs while warps 4-7
// update the state. 256 blocks, two resident per SM in bf16. Splitting a
// (b, h) over blocks by state columns would repeat A in each. It runs in
// 0.164-0.167 ms at the prefill shape (0.157 before steps with w = 0 were
// handled; PERF.md, PR 13): the chunk's phases are
// short and barrier-separated, so latency and shared-memory traffic, not
// the bound, set the pace.
//
// T < 32 (decode's T = 1 included) or N = 8: the recurrent kernel,
// `wkv6_kernel`, unchanged: 62 % of its bound at T = 1 (PR 12). One block
// per (b, h) with N threads; thread j keeps column j of the state in
// registers; r, k, w of a step are staged in double-buffered shared memory,
// so one barrier per step suffices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

// ------------------------------------------------ recurrent, any T
// grid (H, B), N threads; r, k, v, w, o: (B, T, H, N); u: (H, N);
// s0, s_T: (B, H, N, N) with S_ij at [i * N + j].
template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ o, float* __restrict__ s_T, int steps, int H) {
  __shared__ float sr[2][N], sk[2][N], sw[2][N], su[N];
  const int j = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;

  const size_t state = (size_t)(b * H + h) * N * N + j;
  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 != nullptr ? s0[state + i * N] : 0.f;
  su[j] = u[h * N + j];

  // element (b, t, h, j) is at x0 + t * dt
  const size_t x0 = ((size_t)b * steps * H + h) * N + j;
  const size_t dt = (size_t)H * N;
  float rn = to_float(r[x0]), kn = to_float(k[x0]), vn = to_float(v[x0]);
  float wn = w[x0];

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    const float vj = vn;
    // One barrier per step: a buffer is rewritten two steps after it was
    // read, and every thread has passed the previous step's barrier since.
    __syncthreads();
    if (t + 1 < steps) {
      const size_t x = x0 + (size_t)(t + 1) * dt;
      rn = to_float(r[x]);
      kn = to_float(k[x]);
      vn = to_float(v[x]);
      wn = w[x];
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float kv = sk[buf][i] * vj;
      acc += sr[buf][i] * (S[i] + su[i] * kv);
      S[i] = sw[buf][i] * S[i] + kv;
    }
    o[x0 + (size_t)t * dt] = from_float<T>(acc);
  }

#pragma unroll
  for (int i = 0; i < N; ++i) s_T[state + i * N] = S[i];
}

// ------------------------------------------------ chunked, T >= kChunk
constexpr int kChunk = 32;         // C: steps per chunk
constexpr int kSub = 8;            // L: steps per sub-chunk
constexpr int kNSub = kChunk / kSub;
// log2 of a sub-chunk's decay when one of its steps has w = 0: 2^x is 0 in
// fp32 (and in ex2.approx.ftz) far above it, and sums of it stay finite
constexpr float kLog2Zero = -200.f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// Shared memory of one block, in floats (raw tiles in T). Row strides are
// padded so the fragment loads hit distinct banks.
template <typename T, int N>
struct Smem {
  static constexpr int kRaw = N + 8;      // raw r, k, v, w rows
  static constexpr int kRow = N + 4;      // rhat, khat rows
  static constexpr int kP = N + 2;        // E, I rows: rows t and t + 8 in other banks
  static constexpr int kA = kChunk + 4;   // A rows
  static constexpr int kS = N + 8;        // state rows
  struct Raw {
    T r[kChunk][kRaw], k[kChunk][kRaw], v[kChunk][kRaw];
    float w[kChunk][kRaw];
  };
  Raw raw[2];
  float E[kChunk][kP];          // sum of log2 w to t - 1, from the sub-chunk's
                                // start or its last step with w = 0
  float I[kChunk][kP];          // ... to t
  float rhat[kChunk][kRow];     // r_t 2^{P[t] - P[L b(t)]} (0 past a w = 0)
  float khat[kChunk][kRow];     // k_s 2^{P[L (b(s) + 1)] - P[s + 1]}
  float A[kChunk][kA];          // intra-chunk A, bonus on the diagonal
  float S[N][kS];               // S_in
  float gR[kNSub][N];           // 2^{P[L b]}: rhat -> r_t 2^{P[t]}
  float gK[kNSub][N];           // 2^{P[C] - P[L (b + 1)]}: khat -> k_s 2^{P[C] - P[s+1]}
  float mid[kNSub][kNSub][N];   // [a][b]: 2^{P[L b] - P[L (a + 1)]} for a < b, else 0
  float gC[N];                  // 2^{P[C]}
  float u[N];
  uint8_t zmask[kNSub][N];      // bit i: step i of sub-chunk b has w = 0
};

// grid (H, B), kThreads; layouts as wkv6_kernel.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
wkv6_chunked(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ o, float* __restrict__ s_T, int steps, int H) {
  using SM = Smem<T, N>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  constexpr bool kExactV = sizeof(T) == 2;   // bf16 v is exact in TF32
  // Warps 0-3 compute the output, warps 4-7 update the state, at once.
  // Output: warp w the 16 steps 16 (w / 2).., columns kONT * 8 (w % 2)..,
  // kONT 16 x 8 tiles sharing their A fragments.
  constexpr int kONT = N / 16;
  // State: warp 4 + i the channels 16 i.. and every column, kSNT tiles it
  // keeps in registers from chunk to chunk.
  constexpr int kSNT = N / 8;
  constexpr int kSTasks = N / 16;
  static_assert(kChunk == 32 && kSub == 8 && kWarps == 8,
                "layout: a half-warp per diagonal row pair, 4 + 4 warps");

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const size_t row_stride = (size_t)H * N;                // one step
  const size_t base = ((size_t)b * steps * H + h) * N;    // (b, 0, h, 0)
  const size_t sbase = (size_t)(b * H + h) * N * N;
  const int n_chunks = (steps + kChunk - 1) / kChunk;

  auto load_chunk = [&](int c, int buf) {
    typename SM::Raw& dst = sm.raw[buf];
    constexpr int kPerRowT = N * sizeof(T) / 16, kPerRowW = N * 4 / 16;
    constexpr int kTotal = kChunk * (3 * kPerRowT + kPerRowW);
#pragma unroll
    for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      if (i >= kTotal) break;
      int t, part, which;
      if (i < 3 * kChunk * kPerRowT) {
        which = i / (kChunk * kPerRowT);
        const int rem = i % (kChunk * kPerRowT);
        t = rem / kPerRowT;
        part = rem % kPerRowT;
      } else {
        which = 3;
        const int rem = i - 3 * kChunk * kPerRowT;
        t = rem / kPerRowW;
        part = rem % kPerRowW;
      }
      const int step = c * kChunk + t;
      const bool valid = step < steps;
      const size_t off = base + (size_t)(valid ? step : 0) * row_stride;
      if (which == 3) {
        cp_async16(&dst.w[t][part * 4], w + off + part * 4, valid);
      } else {
        const T* src = which == 0 ? r : which == 1 ? k : v;
        T* d = which == 0 ? &dst.r[t][0] : which == 1 ? &dst.k[t][0] : &dst.v[t][0];
        constexpr int kElems = 16 / sizeof(T);
        cp_async16(d + part * kElems, src + off + part * kElems, valid);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  load_chunk(0, 0);

  // this warp's state tiles: rows s_n0 .. s_n0 + 15, every column
  const bool s_owner = warp >= 4 && warp - 4 < kSTasks;
  const int s_n0 = 16 * (warp - 4), s_j0 = 0;
  float Sreg[kSNT][4];
#pragma unroll
  for (int nt = 0; nt < kSNT; ++nt) {
    const int row = s_n0 + g, col = s_j0 + 8 * nt + 2 * q;
#pragma unroll
    for (int e = 0; e < 4; ++e) Sreg[nt][e] = 0.f;
    if (s_owner && s0 != nullptr) {
      Sreg[nt][0] = s0[sbase + row * N + col];
      Sreg[nt][1] = s0[sbase + row * N + col + 1];
      Sreg[nt][2] = s0[sbase + (row + 8) * N + col];
      Sreg[nt][3] = s0[sbase + (row + 8) * N + col + 1];
    }
  }
  for (int i = tid; i < N * N; i += kThreads)
    sm.S[i / N][i % N] = s0 != nullptr ? s0[sbase + i] : 0.f;
  for (int i = tid; i < N; i += kThreads) sm.u[i] = u[h * N + i];

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const typename SM::Raw& raw = sm.raw[buf];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk c landed; every read of chunk c - 1 is done
    if (c + 1 < n_chunks) load_chunk(c + 1, buf ^ 1);
    const int valid = min(kChunk, steps - c * kChunk);

    // (1) Thread (n, b): channel n, sub-chunk b. log2 w summed over the
    // sub-chunk's steps from its start (E, I: the sums before and through
    // step t, differences of small numbers inside a sub-chunk), the factors
    // rhat = r 2^{E}, khat = k 2^{tot_b - I}; then, from the four lanes of
    // channel n, the sub-chunk totals and their powers, each 2^x, x <= 0:
    //   gR = 2^{P[L b]}, gK = 2^{P[C] - P[L (b + 1)]},
    //   mid[a][b] = 2^{P[L b] - P[L (a + 1)]}, gC = 2^{P[C]},
    // with P[t] = sum_{b' < b(t)} tot_b' + E[t].
    {
      static_assert(kThreads == kNSub * 64, "four lanes per channel, N <= 64");
      const int n = tid / kNSub, sb = tid % kNSub;
      if (n < N) {  // warp-uniform: N is a multiple of 8
        // A step with w = 0 sets the state to k^T v: a product across it
        // is 0. E and I restart at 0 after such a step, so they stay small
        // and exact, and a product across one is set to 0 by its position
        // (zmask below) instead of by a huge exponent.
        float lw[kSub];
        unsigned zmask = 0;  // bit i: step i of the sub-chunk has w = 0
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = kSub * sb + i;
          const float wt = t < valid ? raw.w[t][n] : 1.f;  // padded: w = 1
          if (wt == 0.f) zmask |= 1u << i;
          lw[i] = wt == 0.f ? 0.f : log2f(wt);
        }
        float run = 0.f;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = kSub * sb + i;
          sm.E[t][n] = run;
          const bool cut = zmask & ((1u << i) - 1u);  // w = 0 before t
          sm.rhat[t][n] = cut ? 0.f : to_float(raw.r[t][n]) * pow2(run);
          run = zmask >> i & 1u ? 0.f : run + lw[i];
          sm.I[t][n] = run;
          lw[i] = run;  // I, for khat below
        }
        // the last step with w = 0, or -1: khat of an earlier step is 0
        const int last_zero = 31 - __clz(zmask);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = kSub * sb + i;
          sm.khat[t][n] =
              i >= last_zero ? to_float(raw.k[t][n]) * pow2(run - lw[i]) : 0.f;
        }
        sm.zmask[sb][n] = static_cast<uint8_t>(zmask);
        // a sub-chunk with a w = 0 step has total kLog2Zero: the totals are
        // only ever added, so each power over a sum that holds it is 0
        const float total = zmask ? kLog2Zero : run;
        float tot[kNSub];
#pragma unroll
        for (int b = 0; b < kNSub; ++b)
          tot[b] = __shfl_sync(0xffffffffu, total, b, kNSub);  // lane b of the four
        float before = 0.f, after = 0.f, all = 0.f;
#pragma unroll
        for (int b = 0; b < kNSub; ++b) {
          all += tot[b];
          if (b < sb) before += tot[b];
          if (b > sb) after += tot[b];
        }
        sm.gR[sb][n] = pow2(before);
        sm.gK[sb][n] = pow2(after);
        if (sb == 0) sm.gC[n] = pow2(all);
#pragma unroll
        for (int a = 0; a < kNSub; ++a) {
          float between = 0.f;
#pragma unroll
          for (int b = 0; b < kNSub; ++b)
            if (b > a && b < sb) between += tot[b];
          sm.mid[a][sb][n] = a < sb ? pow2(between) : 0.f;
        }
      }
#pragma unroll
      for (int it = 0; it < kChunk * kChunk / kThreads; ++it) {
        const int i = tid + it * kThreads, t = i / kChunk, s = i % kChunk;
        if (s > t) sm.A[t][s] = 0.f;  // the upper triangle of A
      }
    }
    __syncthreads();

    // (2) A, rows t, columns s <= t. Blocks between
    // sub-chunks a < b on the tensor cores, four 16 x 8 tiles (rows 16 mt..,
    // columns: sub-chunk a), one per warp 0-3:
    //   A[t][s] = sum_n (rhat[t][n] mid[a][b(t)][n]) khat[s][n]
    // where mid = 0 leaves the rows with b(t) <= a to the pairs below.
    if (warp < 4) {
      const int mt = warp == 0 ? 0 : 1, a = warp == 0 ? 0 : warp - 1;
      const int t0 = 16 * mt, s0c = kSub * a;
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      tile_mma<N / 8, 1, false, false>(
          acc,
          [&](int i, int n) {
            return sm.rhat[t0 + i][n] * sm.mid[a][(t0 + i) / kSub][n];
          },
          [&](int n, int j) { return sm.khat[s0c + j][n]; });
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + g + 8 * half;
        if (t / kSub > a) {
          sm.A[t][s0c + 2 * q] = acc[0][2 * half];
          sm.A[t][s0c + 2 * q + 1] = acc[0][2 * half + 1];
        }
      }
    }
    // Diagonal blocks pair by pair, each exponent P[t] - P[s+1] = E[t] - I[s]
    // <= 0. A
    // half-warp owns rows t1 = L sb + p and t2 = L sb + L-1 - p of one
    // sub-chunk (9 pairs, bonuses included), lane c of it the channels
    // c, c + 16, ...; p is the same across the warp, so the loop bounds are.
    {
      const int p = warp % 4, sb = 2 * (warp / 4) + lane / 16, c = lane % 16;
      const int t1 = kSub * sb + p, t2 = kSub * sb + kSub - 1 - p;
      float acc1[kSub], acc2[kSub];
#pragma unroll
      for (int s_ = 0; s_ < kSub; ++s_) acc1[s_] = acc2[s_] = 0.f;
#pragma unroll
      for (int n = c; n < N; n += 16) {
        const float r1 = to_float(raw.r[t1][n]), p1 = sm.E[t1][n];
        const float r2 = to_float(raw.r[t2][n]), p2 = sm.E[t2][n];
        const float un = sm.u[n];
        // the last step before t1 (t2) with w = 0, or -1: a pair with an
        // earlier s spans it, and its power is 2^kLog2Zero = 0
        const unsigned zm = sm.zmask[sb][n];
        const int z1 = 31 - __clz(zm & ((1u << p) - 1u));
        const int z2 = 31 - __clz(zm & ((1u << (kSub - 1 - p)) - 1u));
#pragma unroll
        for (int s_ = 0; s_ < kSub; ++s_) {
          const float ks = to_float(raw.k[kSub * sb + s_][n]);
          const float ps = sm.I[kSub * sb + s_][n];
          if (s_ < p)
            acc1[s_] += r1 * ks * pow2(s_ >= z1 ? p1 - ps : kLog2Zero);
          if (s_ == p) acc1[s_] += r1 * un * ks;
          if (s_ < kSub - 1 - p)
            acc2[s_] += r2 * ks * pow2(s_ >= z2 ? p2 - ps : kLog2Zero);
          if (s_ == kSub - 1 - p) acc2[s_] += r2 * un * ks;
        }
      }
#pragma unroll
      for (int s_ = 0; s_ < kSub; ++s_) {
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
          acc1[s_] += __shfl_xor_sync(0xffffffffu, acc1[s_], off);
          acc2[s_] += __shfl_xor_sync(0xffffffffu, acc2[s_], off);
        }
        if (c == 0 && s_ <= p) sm.A[t1][kSub * sb + s_] = acc1[s_];
        if (c == 0 && s_ <= kSub - 1 - p) sm.A[t2][kSub * sb + s_] = acc2[s_];
      }
    }
    __syncthreads();

    // (4) o = A v + (r 2^{P}) S_in, by warps 0-3
    if (warp < 4) {
      const int mt = warp / 2;
      const int t0 = 16 * mt, j0 = 8 * kONT * (warp % 2);
      float acc[kONT][4] = {};
      tile_mma<kChunk / 8, kONT, false, kExactV>(
          acc, [&](int i, int s) { return sm.A[t0 + i][s]; },
          [&](int s, int j) { return to_float(raw.v[s][j0 + j]); });
      tile_mma<N / 8, kONT, false, false>(
          acc,
          [&](int i, int n) {
            return sm.rhat[t0 + i][n] * sm.gR[(t0 + i) / kSub][n];
          },
          [&](int n, int j) { return sm.S[n][j0 + j]; });
#pragma unroll
      for (int nt = 0; nt < kONT; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = t0 + g + 8 * half;
          if (t < valid) {
            T* dst = o + base + (size_t)(c * kChunk + t) * row_stride + j0 +
                     8 * nt + 2 * q;
            dst[0] = from_float<T>(acc[nt][2 * half]);
            dst[1] = from_float<T>(acc[nt][2 * half + 1]);
          }
        }
      }
    }

    // (5) S_out = diag(2^{P[C]}) S_in + sum_s (k_s 2^{P[C] - P[s+1]})^T v_s,
    // in the registers of the owning warp (4-7), beside (4)
    if (s_owner) {
      float acc[kSNT][4];
#pragma unroll
      for (int nt = 0; nt < kSNT; ++nt) {
        const float d0 = sm.gC[s_n0 + g], d1 = sm.gC[s_n0 + g + 8];
        acc[nt][0] = d0 * Sreg[nt][0];
        acc[nt][1] = d0 * Sreg[nt][1];
        acc[nt][2] = d1 * Sreg[nt][2];
        acc[nt][3] = d1 * Sreg[nt][3];
      }
      tile_mma<kChunk / 8, kSNT, false, kExactV>(
          acc,
          [&](int n, int s) {
            return sm.khat[s][s_n0 + n] * sm.gK[s / kSub][s_n0 + n];
          },
          [&](int s, int j) { return to_float(raw.v[s][s_j0 + j]); });
#pragma unroll
      for (int nt = 0; nt < kSNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) Sreg[nt][e] = acc[nt][e];
    }
    __syncthreads();  // every read of S_in is done
    if (s_owner) {
#pragma unroll
      for (int nt = 0; nt < kSNT; ++nt) {
        const int n = s_n0 + g, j = s_j0 + 8 * nt + 2 * q;
        sm.S[n][j] = Sreg[nt][0];
        sm.S[n][j + 1] = Sreg[nt][1];
        sm.S[n + 8][j] = Sreg[nt][2];
        sm.S[n + 8][j + 1] = Sreg[nt][3];
      }
    }
  }

  if (s_owner) {
#pragma unroll
    for (int nt = 0; nt < kSNT; ++nt) {
      const int n = s_n0 + g, j = s_j0 + 8 * nt + 2 * q;
      s_T[sbase + n * N + j] = Sreg[nt][0];
      s_T[sbase + n * N + j + 1] = Sreg[nt][1];
      s_T[sbase + (n + 8) * N + j] = Sreg[nt][2];
      s_T[sbase + (n + 8) * N + j + 1] = Sreg[nt][3];
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, void* o,
                   float* s_T, int B, int steps, int H, bool chunked,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  if constexpr (N >= 16) {
    if (chunked) {
      const size_t smem = sizeof(Smem<T, N>);
      cudaError_t err = cudaFuncSetAttribute(
          wkv6_chunked<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
      wkv6_chunked<T, N><<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), w, u, s0, static_cast<T*>(o), s_T, steps,
          H);
      return cudaGetLastError();
    }
  }
  if (chunked) return cudaErrorInvalidValue;  // no chunked form at N = 8
  wkv6_kernel<T, N><<<grid, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(o), s_T, steps, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const float* w, const float* u, const float* s0, void* o,
                     float* s_T, int B, int steps, int H, int N,
                     bool chunked, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<T, 8>(r, k, v, w, u, s0, o, s_T, B, steps, H, chunked,
                            stream);
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, o, s_T, B, steps, H, chunked,
                            stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, o, s_T, B, steps, H, chunked,
                            stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, o, s_T, B, steps, H, chunked,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v, o): 0 = float32, 1 = bfloat16; w, u, s0, s_T are fp32.
// s0 may be NULL (zeros). chunked != 0 launches the chunked kernel (N >= 16),
// else the recurrent one: the caller picks (repro_torch.kernels.wkv6.kernel,
// `chunked`). Returns a cudaError_t (0 on success); the caller raises on
// anything else.
extern "C" int repro_wkv6_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* o, void* s_T, int B, int T, int H, int N,
                              int dtype, int chunked, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_T);
  if (dtype == 0)
    return (int)dispatch<float>(r, k, v, wf, uf, sf, o, so, B, T, H, N,
                                chunked != 0, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(r, k, v, wf, uf, sf, o, so, B, T, H,
                                        N, chunked != 0, st);
  return (int)cudaErrorInvalidValue;
}

// The chunked kernel's steps per chunk and per sub-chunk, which the binding
// and the plain chunked form (ref.py) take as theirs.
extern "C" void repro_wkv6_chunk_shape(int* chunk, int* sub) {
  *chunk = kChunk;
  *sub = kSub;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
