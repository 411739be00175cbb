// WKV6 backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the `jax.custom_vjp` of src/repro/kernels/wkv6/ops.py (:31-36),
// which differentiates the jnp oracle (the TPU package has no backward
// kernel). For the recurrence of wkv6.cu,
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//
// with the cotangents do_t and dS_T, and G_t the gradient of S_t:
//
//   G_{t-1} = diag(w_t) G_t + r_t^T do_t                       (G_T = dS_T)
//   dr_t = do_t (S_{t-1} + diag(u) k_t^T v_t)^T
//   dk_t = G_t v_t + u o r_t (v_t . do_t)
//   dv_t = k_t G_t + (r_t . (u o k_t)) do_t
//   dw_t[n] = sum_m G_t[n, m] S_{t-1}[n, m]
//   du = sum_t r_t o k_t (v_t . do_t),   ds0 = G_{-1}
//
// over chunks of C = 32 steps (the forward's chunk). Two routes; the binding
// picks one by the forward's rule (`kernel.chunked`: T >= 32 and N >= 16).
//
// Chunked route, three launches:
//
//   (ab) `wkv6_bwd_states`, grid (H, B, 2 x 2 at N = 64): both state passes
//       at once, one block per (b, h, direction, half of the state's rows)
//       walking the chunks. Direction 0: each chunk's S_in from s0,
//       S_out = diag(W) S_in + sum_s (k_s prod_{i>s} w_i)^T v_s; direction
//       1: each chunk's G_out from dS_T, last chunk first, G_in = diag(W)
//       G_out + sum_s (r_s prod_{i<s} w_i)^T do_s, and ds0 = the first
//       chunk's G_in. W = prod_s w_s over the chunk. The products run on the
//       tensor cores in 3xTF32 (mma_tf32.cuh), the state in registers; the
//       next chunk's tiles arrive by cp.async while this one multiplies.
//       The decay factors are products of w, each <= 1, by multiplication
//       alone (a step with w = 0 zeroes every factor across it exactly; no
//       log), four lanes a channel: 8-step products inside each sub-chunk,
//       the sub-chunk totals swapped by shuffles.
//   (c) `wkv6_bwd_chunk_tc`, one block per (b, h, chunk). Given S_in and
//       G_out, with P[t] = sum_{i<t} log2 w_i inside the chunk, D[t,s] =
//       do_t . v_s and A the forward's intra-chunk matrix:
//         dr_t = 2^{P[t]} o (S_in do_t) + sum_{s<t} 2^{P[t]-P[s+1]} o k_s D[t,s]
//                + u o k_t D[t,t]
//         dk_t = 2^{P[C]-P[t+1]} o (G_out v_t)
//                + sum_{s>t} 2^{P[s]-P[t+1]} o r_s D[s,t] + u o r_t D[t,t]
//         dv_t = (k_t o 2^{P[C]-P[t+1]}) G_out + sum_{s>=t} A[s,t] do_s
//       as products on the tensor cores (3xTF32, a bf16 operand exact;
//       mma.sync: the products are 16-32 rows deep, below wgmma's 64).
//       Every power keeps its exponent <= 0 by the forward's factoring
//       about the sub-chunk boundaries (L = 8): a block between sub-chunks
//       a < b is (t's part) 2^{P[L b]-P[L(a+1)]} (s's part), the middle
//       factor applied to that block's product; a pair inside a sub-chunk
//       is taken on its own, 2^{E[t]-I[s]}; a step with w = 0 restarts the
//       sums and zeroes a power across it by its position, as the forward
//       does. dw has the same form: S_{t-1} and G_t are each an S_in (G_out)
//       term and a sum over the chunk's steps, so
//         dw_t = 2^{P[t]} 2^{P[C]-P[t+1]} sum_m S_in o G_out
//                + 2^{P[t]} sum_{s>t} 2^{P[s]-P[t+1]} r_s Z_s
//                + 2^{P[C]-P[t+1]} sum_{s<t} 2^{P[t]-P[s+1]} k_s Y_s
//                + sum_{s<t<s'} 2^{P[t]-P[s+1]} 2^{P[s']-P[t+1]} k_s r_{s'} D[s',s]
//       with Z_s = S_in do_s and Y_s = G_out v_s, dr's and dk's first
//       products. Factored about the boundaries, the sums over steps outside
//       t's sub-chunk are dr's and dk's products between sub-chunks, kept
//       raw, and sums over a sub-chunk; inside it they run pair by pair
//       (28 pairs, and 56 triples s < t < s'). So dw needs no step
//       recurrence over the N x N state, no shuffles over m and no state
//       history, and divides by no w (exact at w = 0); a thread per
//       (channel, sub-chunk) finishes dr, dk and dw, and sums du's part.
//       (Built first as the step recurrence, each thread on 8 columns of a
//       state row with the 8-step history in registers and a reduction that
//       halves the values at each shuffle: 0.65 ms in all at RWKV-6's
//       training shape, this kernel 0.51 ms of it; PERF.md.)
//   (d) du by batch row: the per-chunk rows summed in order.
//
// Recurrent route (T < 32, or N = 8, where the forward has no chunked form):
// the state passes run one thread a state element, step by step, and (c)
// runs the step recurrence for every gradient (S forward with an 8-step
// register history, G backward; sums over m by shuffles, over n through
// shared memory); then (d).
//
// No atomics on either route: two calls give equal gradients.
//
// What bounds it on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32, 67 TFLOP/s
// fp32 off the tensor cores), at RWKV-6's training shape (B=4, T=512, H=64,
// N=64, bf16 r/k/v/do, fp32 w; chip_smoke._bwd_times): the inputs, both
// cotangents and every gradient once, 197.2 MB -> 58.9 us, the bound; twice
// the forward's least work, 5.45 GFLOP, takes 11.0 us at the TF32 rate on
// which this route runs its products (81.4 us at the fp32 rate, the bound
// earlier kernels of this backward were held to).
// Besides, the chunk-boundary states: 2 x 67 MB written by (ab) and read by
// (c), 268 MB, some 80 us of traffic the bound does not count. (ab) moves
// 268 MB in all and is bound by that traffic; (c) moves about 330 MB and
// runs in latency-bound phases (loads, the factors, the products, the
// finishing pass), two blocks resident an SM in bf16 (110 KB of shared
// memory each) so that one block's phases overlap the other's. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): about 0.49 ms, (ab) 0.136 and
// (c) 0.35, where the parent's four launches took 1.11.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kChunk = 32;  // C: steps per chunk (the forward's)
constexpr int kSub = 8;     // L: steps per sub-chunk
constexpr int kNSub = kChunk / kSub;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // the chunked route's blocks
// log2 of a sub-chunk's decay when one of its steps has w = 0: 2^x is 0 in
// fp32 (and in ex2.approx.ftz) far above it, and sums of it stay finite
constexpr float kLog2Zero = -200.f;

// a [kChunk][N] tile of E from rows t0 .. t0 + kChunk of a (B, T, H, N)
// tensor (element (t, n) at src + base + t * row_stride + n), by cp.async;
// rows past `steps` are zero-filled
template <int N, int THREADS = kThreads, class E, int LD>
__device__ __forceinline__ void load_tile(E (*dst)[LD], const E* src,
                                          size_t base, size_t row_stride,
                                          int t0, int steps) {
  constexpr int kElems = 16 / sizeof(E);
  constexpr int kPer = N / kElems;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < kChunk * kPer; i += THREADS) {
    const int t = i / kPer, part = i % kPer;
    const bool valid = t0 + t < steps;
    const size_t off = base + (size_t)(valid ? t0 + t : 0) * row_stride;
    cp_async16(&dst[t][part * kElems], src + off + part * kElems, valid);
  }
}

// an N x N fp32 state (row-major at src) into rows of stride LD
template <int N, int LD>
__device__ __forceinline__ void load_state(float (*dst)[LD], const float* src) {
  constexpr int kPer = N / 4;
  for (int i = threadIdx.x; i < N * kPer; i += kThreads) {
    const int row = i / kPer, part = i % kPer;
    cp_async16(&dst[row][part * 4], src + row * N + part * 4, true);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's cp.async groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// log2 x for x > 0 by the SFU (absolute error ~2^-22; subnormals kept)
__device__ __forceinline__ float log2_fast(float x) {
  float y;
  asm("lg2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two consecutive outputs (p 4-byte aligned for bf16, 8 for fp32)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------ (ab): both state passes
// grid (H, B, 2 kSplit), kStateThreads: block z = kSplit dir + part owns
// direction dir and the state rows part kRows.. . The state in registers:
// warp i holds rows 16 (i % kRowTiles).. and columns kCols (i / kRowTiles)..
// as kNT tiles. Splitting a state's rows over blocks puts twice the blocks
// (and their loads) in flight at N = 64: the pass is bound by its traffic.
constexpr int kStateThreads = 128;

template <int N>
struct StateShape {
  static constexpr int kSplit = N == 64 ? 2 : 1;
  static constexpr int kRows = N / kSplit;
  static constexpr int kRowTiles = kRows / 16;
  static constexpr int kWarps = kStateThreads / 32;
  static constexpr int kColGroups =
      kWarps / kRowTiles < N / 8 ? kWarps / kRowTiles : N / 8;
  static constexpr int kNT = N / 8 / kColGroups;
  static constexpr int kCols = 8 * kNT;
  static constexpr int kOwners = kRowTiles * kColGroups;
  static_assert(kRows * kNSub <= kStateThreads, "four lanes a channel");
};

template <typename T, int N>
struct StateSmem {
  using SS = StateShape<N>;
  static constexpr int kRawA = SS::kRows + 8;  // T rows, 16-byte multiples
  static constexpr int kRawB = N + 8;
  static constexpr int kRow = SS::kRows + 4;   // fp32 rows
  struct Raw {
    T a[kChunk][kRawA], b[kChunk][kRawB];
    float w[kChunk][kRow];  // w, then a_s times its decay factor
  };
  Raw raw[2];
  float gC[SS::kRows];      // W = prod over the chunk
};

// REVERSE = false: (a), A = k, B = v, S_in of each chunk into `states` in
// order; true: (b), A = r, B = do, G_out of each chunk in reverse, and the
// first chunk's G_in into ds0. states: (B, nC, H, N, N).
template <typename T, int N, bool REVERSE>
__device__ __forceinline__ void state_pass(const T* __restrict__ a_in,
                                           const T* __restrict__ b_in,
                                           const float* __restrict__ w,
                                           const float* __restrict__ init,
                                           float* __restrict__ states,
                                           float* __restrict__ ds0, int part,
                                           int steps, int H, uint8_t* smem_raw) {
  using SM = StateSmem<T, N>;
  using SS = StateShape<N>;
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  constexpr bool kExact = sizeof(T) == 2;  // a bf16 B operand is exact in TF32
  constexpr int kNT = SS::kNT;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool owner = warp < SS::kOwners;
  const int rows = SS::kRows * part;  // this block's first state row
  const int n0 = 16 * (warp % SS::kRowTiles), c0 = SS::kCols * (warp / SS::kRowTiles);
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  const size_t row_stride = (size_t)H * N;
  const size_t base = ((size_t)b * steps * H + h) * N;
  const size_t sbase = (size_t)(b * H + h) * N * N + (size_t)rows * N;

  auto load = [&](int c, int buf) {
    load_tile<SS::kRows, kStateThreads>(sm.raw[buf].a, a_in, base + rows,
                                        row_stride, c * kChunk, steps);
    load_tile<N, kStateThreads>(sm.raw[buf].b, b_in, base, row_stride,
                                c * kChunk, steps);
    load_tile<SS::kRows, kStateThreads>(sm.raw[buf].w, w, base + rows,
                                        row_stride, c * kChunk, steps);
    cp_async_commit();
  };
  load(REVERSE ? n_chunks - 1 : 0, 0);

  float X[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int row = n0 + g, col = c0 + 8 * nt + 2 * q;
    const bool have = owner && init != nullptr;
    X[nt][0] = have ? init[sbase + row * N + col] : 0.f;
    X[nt][1] = have ? init[sbase + row * N + col + 1] : 0.f;
    X[nt][2] = have ? init[sbase + (row + 8) * N + col] : 0.f;
    X[nt][3] = have ? init[sbase + (row + 8) * N + col + 1] : 0.f;
  }

  for (int it = 0; it < n_chunks; ++it) {
    const int c = REVERSE ? n_chunks - 1 - it : it;
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every read of the previous one done
    if (it + 1 < n_chunks) load(REVERSE ? c - 1 : c + 1, buf ^ 1);
    if (owner) {
      float* out = states + ((size_t)(b * n_chunks + c) * H + h) * N * N +
                   (size_t)rows * N;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int row = n0 + g, col = c0 + 8 * nt + 2 * q;
        store2(out + row * N + col, X[nt][0], X[nt][1]);
        store2(out + (row + 8) * N + col, X[nt][2], X[nt][3]);
      }
    }
    const bool last = it + 1 == n_chunks;
    if (last && !REVERSE) break;  // the last chunk's S_out is not needed
    typename SM::Raw& raw = sm.raw[buf];
    const int valid = min(kChunk, steps - c * kChunk);
    {
      // thread (n, sb): the decay factors of channel n in sub-chunk sb, as
      // 8-step products of w, then the other sub-chunks' totals from the
      // four lanes of the channel; a_s times its factor over the w it read
      const int n = tid / kNSub, sb = tid % kNSub;
      if (n < SS::kRows) {  // warp-uniform: kRows is a multiple of 8
        float f[kSub], run = 1.f;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int i = REVERSE ? j : kSub - 1 - j;  // prefix : suffix
          const int t = kSub * sb + i;
          f[i] = run;
          run *= t < valid ? raw.w[t][n] : 1.f;  // a padded step: w = 1
        }
        float other = 1.f, all = 1.f;
#pragma unroll
        for (int bb = 0; bb < kNSub; ++bb) {
          const float tot = __shfl_sync(kFull, run, bb, kNSub);
          all *= tot;
          if (REVERSE ? bb < sb : bb > sb) other *= tot;
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = kSub * sb + i;
          raw.w[t][n] = to_float(raw.a[t][n]) * (f[i] * other);
        }
        if (sb == 0) sm.gC[n] = all;
      }
    }
    __syncthreads();
    if (owner) {
      float acc[kNT][4];
      const float d0 = sm.gC[n0 + g], d1 = sm.gC[n0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[nt][0] = d0 * X[nt][0];
        acc[nt][1] = d0 * X[nt][1];
        acc[nt][2] = d1 * X[nt][2];
        acc[nt][3] = d1 * X[nt][3];
      }
      tile_mma<kChunk / 8, kNT, false, kExact>(
          acc, [&](int i, int s) { return raw.w[s][n0 + i]; },
          [&](int s, int j) { return to_float(raw.b[s][c0 + j]); });
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) X[nt][e] = acc[nt][e];
      if (last) {  // REVERSE: the gradient of s0
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int row = n0 + g, col = c0 + 8 * nt + 2 * q;
          store2(ds0 + sbase + row * N + col, X[nt][0], X[nt][1]);
          store2(ds0 + sbase + (row + 8) * N + col, X[nt][2], X[nt][3]);
        }
      }
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kStateThreads, sizeof(T) == 2 ? 8 : 4)
wkv6_bwd_states(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ w, const float* __restrict__ s0,
                const float* __restrict__ ds_T, float* __restrict__ states_s,
                float* __restrict__ states_g, float* __restrict__ ds0,
                int steps, int H) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  constexpr int kSplit = StateShape<N>::kSplit;
  const int part = blockIdx.z % kSplit;
  if (blockIdx.z < kSplit)
    state_pass<T, N, false>(k, v, w, s0, states_s, nullptr, part, steps, H,
                            smem_raw);
  else
    state_pass<T, N, true>(r, dout, w, ds_T, states_g, ds0, part, steps, H,
                           smem_raw);
}

// ------------------------------------------------ (c): one chunk's gradients
template <typename T, int N>
struct TcSmem {
  static constexpr int kRaw = N + 8;      // raw r, k, v, do rows
  static constexpr int kRow = N + 4;      // fp32 rows
  static constexpr int kP = N + 2;        // E, I rows
  static constexpr int kA = kChunk + 4;   // A, D rows
  T r[kChunk][kRaw], k[kChunk][kRaw], v[kChunk][kRaw], o[kChunk][kRaw];
  float w[kChunk][kRow];
  union {
    struct {
      float S[N][kRow];  // S_in
      float G[N][kRow];  // G_out
    } st;
    struct {  // (4)'s products that (5) finishes, rows t, columns n
      float Z[kChunk][kRow];   // (S_in do_t)[n]
      float Y[kChunk][kRow];   // (G_out v_t)[n]
      float M2[kChunk][kRow];  // dr's blocks a < b(t) before e[t]
      float M1[kChunk][kRow];  // dk's blocks b > a(t) before kf[t]
    } pr;
  } y;
  // sum of log2 w before (E) and through (I) step t from the sub-chunk's
  // start or its last step with w = 0
  float E[kChunk][kP], I[kChunk][kP];
  float e[kChunk][kRow];   // 2^{P[t] - P[L b(t)]} (0 past a w = 0)
  float kf[kChunk][kRow];  // 2^{P[L (b(t) + 1)] - P[t + 1]}
  float A[kChunk][kA];     // the forward's A, bonus on the diagonal
  float D[kChunk][kA];     // D[t][s] = do_t . v_s
  float gR[kNSub][N];          // 2^{P[L b]}
  float gK[kNSub][N];          // 2^{P[C] - P[L (b + 1)]}
  float mid[kNSub][kNSub][N];  // [a][b]: 2^{P[L b] - P[L (a + 1)]} for a < b, else 0
  float cS[N];                 // sum_m S_in[n, m] G_out[n, m]
  float u[N];
  uint8_t zmask[kNSub][N];     // bit i: step i of sub-chunk b has w = 0
};

// (5) of `wkv6_bwd_chunk_tc`: thread (n, sb) finishes dr, dk and dw of
// channel n over sub-chunk sb's steps from (4)'s products and the pairs
// inside the sub-chunk, and sums its part of du. With t in sub-chunk c,
// pre_t = 2^{P[t]} = gR[c] e[t] and suf_t = 2^{P[C]-P[t+1]} = gK[c] kf[t],
// pr[t][s] = 2^{P[t]-P[s+1]} for s < t inside c, kk_s = k_s kf[s], re_s =
// r_s e[s]:
//   dr_t = e[t] (gR[c] Z_t + M2_t) + sum_{s<t} pr[t][s] D[t][s] k_s + u k_t D[t][t]
//   dk_t = kf[t] (gK[c] Y_t + M1_t) + sum_{s>t} pr[s][t] D[s][t] r_s + u r_t D[t][t]
//   dw_t = pre_t suf_t cS + pre_t (kf[t] sum_{b>c} mid[c][b] RZ_b + sum_{s>t} pr[s][t] r_s Z_s)
//          + suf_t (e[t] sum_{a<c} mid[a][c] KY_a + sum_{s<t} pr[t][s] k_s Y_s)
//          + e[t] kf[t] sum_{a<c<b} mid[a][c] mid[c][b] Q[a][b]
//          + kf[t] sum_{s<t} pr[t][s] k_s M1_s + e[t] sum_{s>t} pr[s][t] r_s M2_s
//          + sum_{s<t<s'} pr[t][s] pr[s'][t] k_s r_{s'} D[s'][s]
// with the sub-chunk sums RZ_b = sum_{s in b} re_s Z_s, KY_a = sum_{s in a}
// kk_s Y_s, Q[a][b] = sum_{s in a, s' in b} kk_s re_{s'} D[s'][s] shared by
// the four lanes of the channel. Sums inside c run over its valid steps
// only: padded steps have r = k = v = do = 0.
template <typename T, int N>
__device__ __forceinline__ void finish_rows(TcSmem<T, N>& sm, T* __restrict__ dr,
                                            T* __restrict__ dk,
                                            float* __restrict__ dw,
                                            float* __restrict__ du_part,
                                            size_t base, size_t row_stride,
                                            int t0c, int valid) {
  const int tid = threadIdx.x, n = tid / kNSub, sb = tid % kNSub;
  if (n >= N) return;  // warp-uniform: N is a multiple of 8
  const int t0 = kSub * sb;
  const unsigned zm = sm.zmask[sb][n];
  float pr[kSub][kSub];  // [t][s], s < t
  {
    float Et[kSub], Is[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      Et[i] = sm.E[t0 + i][n];
      Is[i] = sm.I[t0 + i][n];
    }
#pragma unroll
    for (int ti = 1; ti < kSub; ++ti) {
      // the last step before t with w = 0, or -1: a pair across it is 0
      const int z = 31 - __clz(zm & ((1u << ti) - 1u));
#pragma unroll
      for (int si = 0; si < ti; ++si)
        pr[ti][si] = pow2(si >= z ? Et[ti] - Is[si] : kLog2Zero);
    }
  }
  float ev[kSub], kv[kSub], rv[kSub];
  float rz[kSub], rm2[kSub], ky[kSub], km1[kSub];  // r Z, r M2, k Y, k M1
  float rzs = 0.f, kys = 0.f;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int t = t0 + i;
    ev[i] = sm.e[t][n];
    rv[i] = to_float(sm.r[t][n]);
    kv[i] = to_float(sm.k[t][n]);
    rz[i] = rv[i] * sm.y.pr.Z[t][n];
    rm2[i] = rv[i] * sm.y.pr.M2[t][n];
    ky[i] = kv[i] * sm.y.pr.Y[t][n];
    km1[i] = kv[i] * sm.y.pr.M1[t][n];
    rzs = fmaf(ev[i], rz[i], rzs);
    kys = fmaf(sm.kf[t][n], ky[i], kys);  // kk_s Y_s
  }
  // Q[a][b] for the pairs a < c < b: (0, 2), (0, 3), (1, 3) by lanes 0-2
  float qv = 0.f;
  if (sb < 3) {
    const int qa = sb == 2 ? 1 : 0, qb = sb == 0 ? 2 : 3;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int sp = kSub * qb + j;
      float inner = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int sq = kSub * qa + i;
        inner = fmaf(sm.D[sp][sq], to_float(sm.k[sq][n]) * sm.kf[sq][n], inner);
      }
      qv = fmaf(to_float(sm.r[sp][n]) * sm.e[sp][n], inner, qv);
    }
  }
  float RZ[kNSub], KY[kNSub], Q[3];
#pragma unroll
  for (int bb = 0; bb < kNSub; ++bb) {
    RZ[bb] = __shfl_sync(kFull, rzs, bb, kNSub);
    KY[bb] = __shfl_sync(kFull, kys, bb, kNSub);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) Q[j] = __shfl_sync(kFull, qv, j, kNSub);
  float late = 0.f, early = 0.f, both = 0.f;
#pragma unroll
  for (int bb = 0; bb < kNSub; ++bb) {
    if (bb > sb) late = fmaf(sm.mid[sb][bb][n], RZ[bb], late);
    if (bb < sb) early = fmaf(sm.mid[bb][sb][n], KY[bb], early);
  }
  if (sb == 1)
    both = sm.mid[0][1][n] * (sm.mid[1][2][n] * Q[0] + sm.mid[1][3][n] * Q[1]);
  if (sb == 2)
    both = sm.mid[2][3][n] * (sm.mid[0][2][n] * Q[1] + sm.mid[1][2][n] * Q[2]);
  const float gRv = sm.gR[sb][n], gKv = sm.gK[sb][n], cSv = sm.cS[n];
  const float un = sm.u[n];
  float du = 0.f;
#pragma unroll
  for (int ti = 0; ti < kSub; ++ti) {
    const int t = t0 + ti;
    const float kft = sm.kf[t][n], et = ev[ti], dd = sm.D[t][t];
    // pairs s < t: pr[t][s]; s' > t: pr[s'][t]
    float b_k = 0.f, b_y = 0.f, b_m = 0.f, a_r = 0.f, a_z = 0.f, a_m = 0.f;
    float tri = 0.f;
#pragma unroll
    for (int si = 0; si < ti; ++si) {
      const float p = pr[ti][si];
      b_k = fmaf(p * sm.D[t][t0 + si], kv[si], b_k);
      b_y = fmaf(p, ky[si], b_y);
      b_m = fmaf(p, km1[si], b_m);
    }
#pragma unroll
    for (int ui = ti + 1; ui < kSub; ++ui) {
      const float p = pr[ui][ti];
      a_r = fmaf(p * sm.D[t0 + ui][t], rv[ui], a_r);
      a_z = fmaf(p, rz[ui], a_z);
      a_m = fmaf(p, rm2[ui], a_m);
      float inner = 0.f;
#pragma unroll
      for (int si = 0; si < ti; ++si)
        inner = fmaf(pr[ti][si] * kv[si], sm.D[t0 + ui][t0 + si], inner);
      tri = fmaf(p * rv[ui], inner, tri);
    }
    const float drt = fmaf(et, fmaf(gRv, sm.y.pr.Z[t][n], sm.y.pr.M2[t][n]),
                           fmaf(un * kv[ti], dd, b_k));
    const float dkt = fmaf(kft, fmaf(gKv, sm.y.pr.Y[t][n], sm.y.pr.M1[t][n]),
                           fmaf(un * rv[ti], dd, a_r));
    const float pre = gRv * et, suf = gKv * kft;
    const float dwt = pre * fmaf(suf, cSv, fmaf(kft, late, a_z)) +
                      suf * fmaf(et, early, b_y) + et * kft * both +
                      kft * b_m + et * a_m + tri;
    du = fmaf(rv[ti] * kv[ti], dd, du);
    if (t < valid) {
      const size_t at = base + (size_t)(t0c + t) * row_stride + n;
      dr[at] = from_float<T>(drt);
      dk[at] = from_float<T>(dkt);
      dw[at] = dwt;
    }
  }
  // du: the four sub-chunks of the channel, lanes 4n .. 4n + 3
  du += __shfl_xor_sync(kFull, du, 1);
  du += __shfl_xor_sync(kFull, du, 2);
  if (sb == 0) du_part[n] = du;
}

// grid (nC, H, B), kThreads; layouts as the entry point's.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
wkv6_bwd_chunk_tc(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const T* __restrict__ dout,
                  const float* __restrict__ states_s,
                  const float* __restrict__ states_g, T* __restrict__ dr,
                  T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw,
                  float* __restrict__ du_part, int steps, int H) {
  using SM = TcSmem<T, N>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  constexpr bool kExact = sizeof(T) == 2;  // bf16 inputs are exact in TF32
  constexpr int kCQ = N / 16;              // 16-column groups
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int t0c = c * kChunk, valid = min(kChunk, steps - t0c);
  const size_t row_stride = (size_t)H * N;
  const size_t base = ((size_t)b * steps * H + h) * N;
  const size_t st = ((size_t)(b * n_chunks + c) * H + h) * N * N;

  // (0) the chunk's tiles, then its states in a second group: (1)-(3a)
  // need only the tiles, so the states arrive while they run
  load_tile<N>(sm.r, r, base, row_stride, t0c, steps);
  load_tile<N>(sm.k, k, base, row_stride, t0c, steps);
  load_tile<N>(sm.v, v, base, row_stride, t0c, steps);
  load_tile<N>(sm.o, dout, base, row_stride, t0c, steps);
  load_tile<N>(sm.w, w, base, row_stride, t0c, steps);
  cp_async_commit();
  load_state<N>(sm.y.st.S, states_s + st);
  load_state<N>(sm.y.st.G, states_g + st);
  cp_async_commit();
  for (int i = tid; i < N; i += kThreads) sm.u[i] = u[h * N + i];
  cp_async_wait<1>();
  __syncthreads();

  // (1) thread (n, sb): channel n, sub-chunk sb. The forward's factors:
  // log2 w summed from the sub-chunk's start (E, I), e = 2^E, kf = 2^{tot -
  // I}, then from the four lanes of channel n the sub-chunk totals and
  // gR, gK, mid, each 2^x with x <= 0. A step with w = 0 restarts the
  // sums, and a power across it is 0 by its position (zmask).
  {
    const int n = tid / kNSub, sb = tid % kNSub;
    if (n < N) {  // warp-uniform
      float lw[kSub];
      unsigned zmask = 0;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = kSub * sb + i;
        const float wt = t < valid ? sm.w[t][n] : 1.f;  // padded: w = 1
        if (wt == 0.f) zmask |= 1u << i;
        lw[i] = wt == 0.f ? 0.f : log2_fast(wt);
      }
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = kSub * sb + i;
        sm.E[t][n] = run;
        const bool cut = zmask & ((1u << i) - 1u);  // w = 0 before t
        sm.e[t][n] = cut ? 0.f : pow2(run);
        run = zmask >> i & 1u ? 0.f : run + lw[i];
        sm.I[t][n] = run;
        lw[i] = run;
      }
      const int last_zero = 31 - __clz(zmask);  // -1: none
#pragma unroll
      for (int i = 0; i < kSub; ++i)
        sm.kf[kSub * sb + i][n] = i >= last_zero ? pow2(run - lw[i]) : 0.f;
      sm.zmask[sb][n] = static_cast<uint8_t>(zmask);
      const float total = zmask ? kLog2Zero : run;
      float tot[kNSub];
#pragma unroll
      for (int bb = 0; bb < kNSub; ++bb) tot[bb] = __shfl_sync(kFull, total, bb, kNSub);
      float before = 0.f, after = 0.f;
#pragma unroll
      for (int bb = 0; bb < kNSub; ++bb) {
        if (bb < sb) before += tot[bb];
        if (bb > sb) after += tot[bb];
      }
      sm.gR[sb][n] = pow2(before);
      sm.gK[sb][n] = pow2(after);
#pragma unroll
      for (int a = 0; a < kNSub; ++a) {
        float between = 0.f;
#pragma unroll
        for (int bb = 0; bb < kNSub; ++bb)
          if (bb > a && bb < sb) between += tot[bb];
        sm.mid[a][sb][n] = a < sb ? pow2(between) : 0.f;
      }
    }
    for (int i = tid; i < kChunk * kChunk; i += kThreads) {
      const int t = i / kChunk, s = i % kChunk;
      if (s > t) sm.A[t][s] = 0.f;  // the upper triangle of A
    }
  }
  __syncthreads();

  // (2) warps 0-3: A's blocks between sub-chunks a < b (the forward's four
  // 16 x 8 tiles); warps 4-5: D = dO V^T, a 16-row tile each
  if (warp < 4) {
    const int mt = warp == 0 ? 0 : 1, a = warp == 0 ? 0 : warp - 1;
    const int t0 = 16 * mt, s0c = kSub * a;
    float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    tile_mma<N / 8, 1, false, false>(
        acc,
        [&](int i, int n) {
          const int t = t0 + i;
          return to_float(sm.r[t][n]) * sm.e[t][n] * sm.mid[a][t / kSub][n];
        },
        [&](int n, int j) {
          return to_float(sm.k[s0c + j][n]) * sm.kf[s0c + j][n];
        });
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + g + 8 * half;
      if (t / kSub > a) {
        sm.A[t][s0c + 2 * q] = acc[0][2 * half];
        sm.A[t][s0c + 2 * q + 1] = acc[0][2 * half + 1];
      }
    }
  } else if (warp < 6) {
    const int t0 = 16 * (warp - 4);
    float acc[kChunk / 8][4] = {};
    tile_mma<N / 8, kChunk / 8, kExact, kExact>(
        acc, [&](int i, int m) { return to_float(sm.o[t0 + i][m]); },
        [&](int m, int j) { return to_float(sm.v[j][m]); });
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      const int t = t0 + g, s = 8 * nt + 2 * q;
      sm.D[t][s] = acc[nt][0];
      sm.D[t][s + 1] = acc[nt][1];
      sm.D[t + 8][s] = acc[nt][2];
      sm.D[t + 8][s + 1] = acc[nt][3];
    }
  }
  __syncthreads();

  // (3a) A's diagonal blocks pair by pair (the forward's), each exponent
  // P[t] - P[s+1] = E[t] - I[s] <= 0: a half-warp owns rows t1 = L sb + p
  // and t2 = L sb + L-1 - p of one sub-chunk, lane cc of it the channels
  // cc, cc + 16, ...
  {
    const int p = warp % 4, sb = 2 * (warp / 4) + lane / 16, cc = lane % 16;
    const int t1 = kSub * sb + p, t2 = kSub * sb + kSub - 1 - p;
    float acc1[kSub], acc2[kSub];
#pragma unroll
    for (int s_ = 0; s_ < kSub; ++s_) acc1[s_] = acc2[s_] = 0.f;
#pragma unroll
    for (int n = cc; n < N; n += 16) {
      const float r1 = to_float(sm.r[t1][n]), p1 = sm.E[t1][n];
      const float r2 = to_float(sm.r[t2][n]), p2 = sm.E[t2][n];
      const float un = sm.u[n];
      const unsigned zm = sm.zmask[sb][n];
      const int z1 = 31 - __clz(zm & ((1u << p) - 1u));
      const int z2 = 31 - __clz(zm & ((1u << (kSub - 1 - p)) - 1u));
#pragma unroll
      for (int s_ = 0; s_ < kSub; ++s_) {
        const float ks = to_float(sm.k[kSub * sb + s_][n]);
        const float ps = sm.I[kSub * sb + s_][n];
        if (s_ < p) acc1[s_] += r1 * ks * pow2(s_ >= z1 ? p1 - ps : kLog2Zero);
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
        acc1[s_] += __shfl_xor_sync(kFull, acc1[s_], off);
        acc2[s_] += __shfl_xor_sync(kFull, acc2[s_], off);
      }
      if (cc == 0 && s_ <= p) sm.A[t1][kSub * sb + s_] = acc1[s_];
      if (cc == 0 && s_ <= kSub - 1 - p) sm.A[t2][kSub * sb + s_] = acc2[s_];
    }
  }
  cp_async_wait<0>();  // the states
  __syncthreads();

  // (4) the products on the tensor cores: warp i the 16 x 16 tile (rows
  // 16 (i / kCQ).., columns 16 (i % kCQ)..) of dr's, dk's and dv's
  // products. dv is whole here: (k_t kf[t] gK[a(t)]) G_out + A^T do. dr's
  // and dk's stay raw for (5): Z = do S_in^T and M2 = the blocks a < b(t),
  // mid[a][b(t)] (D_{t,a} (k kf)_a); Y = v G_out^T and M1 = the blocks
  // b > a(t), mid[a(t)][b] (D^T_{t,b} (r e)_b). Meanwhile every thread
  // adds its quarter of a row of cS = rowsum(S_in o G_out).
  float Zr[2][4] = {}, M2r[2][4] = {}, Yr[2][4] = {}, M1r[2][4] = {};
  const bool tiler = warp < 2 * kCQ;
  const int mt = warp / kCQ, t0 = 16 * mt, n0 = 16 * (warp % kCQ);
  if (tiler) {
    tile_mma<N / 8, 2, kExact, false>(
        Zr, [&](int i, int m) { return to_float(sm.o[t0 + i][m]); },
        [&](int m, int j) { return sm.y.st.S[n0 + j][m]; });
    for (int a = 0; a <= (mt == 0 ? 0 : 2); ++a) {
      float tmp[2][4] = {};
      tile_mma<1, 2, false, false>(
          tmp, [&](int i, int s) { return sm.D[t0 + i][kSub * a + s]; },
          [&](int s, int j) {
            return to_float(sm.k[kSub * a + s][n0 + j]) * sm.kf[kSub * a + s][n0 + j];
          });
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + g + 8 * (e >> 1), nn = n0 + 8 * nt + 2 * q + (e & 1);
          M2r[nt][e] = fmaf(sm.mid[a][t / kSub][nn], tmp[nt][e], M2r[nt][e]);
        }
    }
    tile_mma<N / 8, 2, kExact, false>(
        Yr, [&](int i, int m) { return to_float(sm.v[t0 + i][m]); },
        [&](int m, int j) { return sm.y.st.G[n0 + j][m]; });
    for (int bb = mt == 0 ? 1 : 3; bb < kNSub; ++bb) {
      float tmp[2][4] = {};
      tile_mma<1, 2, false, false>(
          tmp, [&](int i, int s) { return sm.D[kSub * bb + s][t0 + i]; },
          [&](int s, int j) {
            return to_float(sm.r[kSub * bb + s][n0 + j]) * sm.e[kSub * bb + s][n0 + j];
          });
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + g + 8 * (e >> 1), nn = n0 + 8 * nt + 2 * q + (e & 1);
          M1r[nt][e] = fmaf(sm.mid[t / kSub][bb][nn], tmp[nt][e], M1r[nt][e]);
        }
    }
    float acc[2][4] = {};
    tile_mma<N / 8, 2, false, false>(
        acc,
        [&](int i, int n) {
          const int t = t0 + i;
          return to_float(sm.k[t][n]) * sm.kf[t][n] * sm.gK[t / kSub][n];
        },
        [&](int n, int j) { return sm.y.st.G[n][n0 + j]; });
    if (mt == 0)
      tile_mma<kChunk / 8, 2, false, kExact>(
          acc, [&](int i, int s) { return sm.A[s][i]; },
          [&](int s, int j) { return to_float(sm.o[s][n0 + j]); });
    else
      tile_mma<kChunk / 16, 2, false, kExact>(
          acc, [&](int i, int s) { return sm.A[16 + s][16 + i]; },
          [&](int s, int j) { return to_float(sm.o[16 + s][n0 + j]); });
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + g + 8 * half, nn = n0 + 8 * nt + 2 * q;
        if (t < valid)
          store2(dv + base + (size_t)(t0c + t) * row_stride + nn,
                 acc[nt][2 * half], acc[nt][2 * half + 1]);
      }
  }
  for (int row = tid / 4; row < N; row += kThreads / 4) {
    float part = 0.f;
#pragma unroll
    for (int m = (tid % 4) * (N / 4); m < (tid % 4 + 1) * (N / 4); ++m)
      part = fmaf(sm.y.st.S[row][m], sm.y.st.G[row][m], part);
    part += __shfl_xor_sync(kFull, part, 1);
    part += __shfl_xor_sync(kFull, part, 2);
    if (tid % 4 == 0) sm.cS[row] = part;
  }
  __syncthreads();  // every read of S_in and G_out done: they take Z, Y, M2, M1
  if (tiler) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + g + 8 * (e >> 1), nn = n0 + 8 * nt + 2 * q + (e & 1);
        sm.y.pr.Z[t][nn] = Zr[nt][e];
        sm.y.pr.M2[t][nn] = M2r[nt][e];
        sm.y.pr.Y[t][nn] = Yr[nt][e];
        sm.y.pr.M1[t][nn] = M1r[nt][e];
      }
  }
  __syncthreads();

  // (5) dr, dk, dw and du by thread (n, sb)
  finish_rows<T, N>(sm, dr, dk, dw,
                    du_part + ((size_t)(b * n_chunks + c) * H + h) * N, base,
                    row_stride, t0c, valid);
}

// ------------------------------------------------ recurrent route: (a), (b)
// grid (H, B); thread per state element(s), the steps one at a time.
template <typename T, int N, bool REVERSE>
__global__ void __launch_bounds__(256)
wkv6_state_pass_rec(const T* __restrict__ a_in, const T* __restrict__ b_in,
                    const float* __restrict__ w, const float* __restrict__ init,
                    float* __restrict__ states, int steps, int H) {
  constexpr int kPer = (N * N + 255) / 256;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  const size_t row_stride = (size_t)H * N;
  const size_t base = ((size_t)b * steps * H + h) * N;
  const size_t sbase = (size_t)(b * H + h) * N * N;
  float X[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + 256 * i;
    X[i] = e < N * N && init != nullptr ? init[sbase + e] : 0.f;
  }
  for (int it = 0; it < n_chunks; ++it) {
    const int c = REVERSE ? n_chunks - 1 - it : it;
    float* out = states + ((size_t)(b * n_chunks + c) * H + h) * N * N;
    const int t0 = c * kChunk, valid = min(kChunk, steps - t0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + 256 * i;
      if (e >= N * N) continue;
      out[e] = X[i];
      if (it + 1 == n_chunks) continue;  // the last chunk's steps are not needed
      const int n = e / N, m = e % N;
      for (int j = 0; j < valid; ++j) {
        const int t = REVERSE ? t0 + valid - 1 - j : t0 + j;
        const size_t at = base + (size_t)t * row_stride;
        X[i] = fmaf(w[at + n], X[i], to_float(a_in[at + n]) * to_float(b_in[at + m]));
      }
    }
  }
}

// ------------------------------------------------ recurrent route: (c)
// grid (nC, H, B). A thread owns row n and columns m0 .. m0 + 3 of the
// state; kLanes = N / 4 lanes share a row, a block holds kRowsPerPass rows
// at once and walks the N rows in kPasses passes.
template <int N>
struct ChunkShape {
  static constexpr int kLanes = N / 4;
  static constexpr int kThreads = N * N / 4 < 32 ? 32 : (N * N / 4 > 256 ? 256 : N * N / 4);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowsPerPass = kThreads / kLanes;
  static constexpr int kPasses = N > kRowsPerPass ? N / kRowsPerPass : 1;
  static constexpr int kLd = N + 4;  // shared rows: float4 aligned
};

template <int N>
struct ChunkSmem {
  using CS = ChunkShape<N>;
  float r[kChunk][CS::kLd], k[kChunk][CS::kLd], v[kChunk][CS::kLd],
      w[kChunk][CS::kLd], dout[kChunk][CS::kLd];
  float dr[kChunk][CS::kLd], dk[kChunk][CS::kLd], dw[kChunk][CS::kLd],
      dv[kChunk][CS::kLd];
  float part[CS::kWarps][kSub][CS::kLd];  // dv of one sub-chunk, per warp
  float vd[kChunk], ruk[kChunk], u[N];
};

template <typename T, int N>
__global__ void __launch_bounds__(ChunkShape<N>::kThreads)
wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const T* __restrict__ dout,
               const float* __restrict__ states_s, const float* __restrict__ states_g,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ds0, int steps, int H) {
  using CS = ChunkShape<N>;
  using SM = ChunkSmem<N>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  constexpr int kLanes = CS::kLanes;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * kChunk, valid = min(kChunk, steps - t0);
  const size_t row_stride = (size_t)H * N;
  const size_t base = ((size_t)b * steps * H + h) * N;
  const size_t st = ((size_t)(b * n_chunks + c) * H + h) * N * N;

  for (int i = tid; i < kChunk * N; i += CS::kThreads) {
    const int t = i / N, n = i % N;
    const bool in = t < valid;
    const size_t at = base + (size_t)(t0 + t) * row_stride + n;
    sm.r[t][n] = in ? to_float(r[at]) : 0.f;
    sm.k[t][n] = in ? to_float(k[at]) : 0.f;
    sm.v[t][n] = in ? to_float(v[at]) : 0.f;
    sm.dout[t][n] = in ? to_float(dout[at]) : 0.f;
    sm.w[t][n] = in ? w[at] : 1.f;
    sm.dv[t][n] = 0.f;
  }
  for (int i = tid; i < N; i += CS::kThreads) sm.u[i] = u[h * N + i];
  __syncthreads();
  // per step: v . do and r . (u o k), one warp a step
  for (int t = warp; t < kChunk; t += CS::kWarps) {
    float a = 0.f, e = 0.f;
    for (int n = lane; n < N; n += 32) {
      a = fmaf(sm.v[t][n], sm.dout[t][n], a);
      e = fmaf(sm.r[t][n] * sm.u[n], sm.k[t][n], e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(kFull, a, off);
      e += __shfl_xor_sync(kFull, e, off);
    }
    if (lane == 0) {
      sm.vd[t] = a;
      sm.ruk[t] = e;
    }
  }

  const int m0 = 4 * (tid % kLanes);
  for (int pass = 0; pass < CS::kPasses; ++pass) {
    const int n = pass * CS::kRowsPerPass + tid / kLanes;
    const bool act = n < N;
    float S[4], G[4], ck[kNSub][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      S[j] = act ? states_s[st + n * N + m0 + j] : 0.f;
      G[j] = act ? states_g[st + n * N + m0 + j] : 0.f;
    }
    __syncthreads();  // vd, ruk ready; the previous pass's dv folded in
    // S at each sub-chunk's start
#pragma unroll
    for (int sb = 0; sb < kNSub; ++sb) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ck[sb][j] = S[j];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = kSub * sb + i;
        if (t < valid && act) {
          const float wn = sm.w[t][n], kn = sm.k[t][n];
#pragma unroll
          for (int j = 0; j < 4; ++j) S[j] = fmaf(wn, S[j], kn * sm.v[t][m0 + j]);
        }
      }
    }
#pragma unroll
    for (int sb = kNSub - 1; sb >= 0; --sb) {
      if (kSub * sb >= valid) continue;  // block-uniform
      // S_{t-1} for the sub-chunk's steps, from its checkpoint
      float hist[kSub][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) S[j] = ck[sb][j];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = kSub * sb + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) hist[i][j] = S[j];
        if (t < valid && act) {
          const float wn = sm.w[t][n], kn = sm.k[t][n];
#pragma unroll
          for (int j = 0; j < 4; ++j) S[j] = fmaf(wn, S[j], kn * sm.v[t][m0 + j]);
        }
      }
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int t = kSub * sb + i;
        if (t >= valid) continue;  // block-uniform
        const float wn = act ? sm.w[t][n] : 0.f, kn = act ? sm.k[t][n] : 0.f;
        const float rn = act ? sm.r[t][n] : 0.f;
        float pk = 0.f, pw = 0.f, pr = 0.f, cv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float vm = sm.v[t][m0 + j], om = sm.dout[t][m0 + j];
          pk = fmaf(G[j], vm, pk);
          pw = fmaf(G[j], hist[i][j], pw);
          pr = fmaf(om, hist[i][j], pr);
          cv[j] = kn * G[j];
          G[j] = fmaf(wn, G[j], rn * om);
        }
        // sums over m: the kLanes lanes of the row
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
          pk += __shfl_xor_sync(kFull, pk, off);
          pw += __shfl_xor_sync(kFull, pw, off);
          pr += __shfl_xor_sync(kFull, pr, off);
        }
        if (act && tid % kLanes == 0) {
          sm.dk[t][n] = pk;
          sm.dw[t][n] = pw;
          sm.dr[t][n] = pr;
        }
        // sums over n: the warp's rows, then the warps below
#pragma unroll
        for (int off = kLanes; off < 32; off <<= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j) cv[j] += __shfl_xor_sync(kFull, cv[j], off);
        if (lane < kLanes)
#pragma unroll
          for (int j = 0; j < 4; ++j) sm.part[warp][i][m0 + j] = cv[j];
      }
      __syncthreads();
      for (int idx = tid; idx < kSub * N; idx += CS::kThreads) {
        const int i = idx / N, m = idx % N, t = kSub * sb + i;
        if (t >= valid) continue;
        float sum = sm.dv[t][m];
        for (int wp = 0; wp < CS::kWarps; ++wp) sum += sm.part[wp][i][m];
        sm.dv[t][m] = sum;
      }
      __syncthreads();
    }
    if (c == 0 && act) {  // G is now the gradient of S_in = s0
      const size_t s0at = (size_t)(b * H + h) * N * N + n * N + m0;
#pragma unroll
      for (int j = 0; j < 4; ++j) ds0[s0at + j] = G[j];
    }
  }
  __syncthreads();

  for (int i = tid; i < kChunk * N; i += CS::kThreads) {
    const int t = i / N, n = i % N;
    if (t >= valid) continue;
    const size_t at = base + (size_t)(t0 + t) * row_stride + n;
    const float bonus = sm.u[n] * sm.vd[t];
    dr[at] = from_float<T>(sm.dr[t][n] + bonus * sm.k[t][n]);
    dk[at] = from_float<T>(sm.dk[t][n] + bonus * sm.r[t][n]);
    dv[at] = from_float<T>(sm.dv[t][n] + sm.ruk[t] * sm.dout[t][n]);
    dw[at] = sm.dw[t][n];
  }
  for (int n = tid; n < N; n += CS::kThreads) {
    float acc = 0.f;
    for (int t = 0; t < valid; ++t) acc = fmaf(sm.r[t][n] * sm.k[t][n], sm.vd[t], acc);
    du_part[((size_t)(b * n_chunks + c) * H + h) * N + n] = acc;
  }
}

// ------------------------------------------------ (d): du by batch row
// du_rows[b, h, n] = sum over the chunks, in order, of du_part[b, c, h, n]
// (the caller sums the rows: a vmapped call folds its axis into the batch)
__global__ void wkv6_du_reduce(const float* __restrict__ du_part,
                               float* __restrict__ du_rows, int B, int n_chunks,
                               int HN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * HN) return;
  const int b = i / HN, j = i % HN;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += du_part[((size_t)b * n_chunks + c) * HN + j];
  du_rows[i] = acc;
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, const void* dout,
                   const float* ds_T, void* dr, void* dk, void* dv, float* dw,
                   float* du, float* ds0, float* states_s, float* states_g,
                   float* du_part, int B, int steps, int H, bool chunked,
                   cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  const dim3 grid(H, B);
  cudaError_t err;
  bool done = false;
  if constexpr (N >= 16) {
    if (chunked) {
      const size_t smem_ab = sizeof(StateSmem<T, N>);
      err = cudaFuncSetAttribute(wkv6_bwd_states<T, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_ab);
      if (err != cudaSuccess) return err;
      wkv6_bwd_states<T, N><<<dim3(H, B, 2 * StateShape<N>::kSplit),
                              kStateThreads, smem_ab, stream>>>(
          rt, kt, vt, ot, w, s0, ds_T, states_s, states_g, ds0, steps, H);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      const size_t smem_c = sizeof(TcSmem<T, N>);
      err = cudaFuncSetAttribute(wkv6_bwd_chunk_tc<T, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_c);
      if (err != cudaSuccess) return err;
      wkv6_bwd_chunk_tc<T, N><<<dim3(n_chunks, H, B), kThreads, smem_c, stream>>>(
          rt, kt, vt, w, u, ot, states_s, states_g, static_cast<T*>(dr),
          static_cast<T*>(dk), static_cast<T*>(dv), dw, du_part, steps, H);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      done = true;
    }
  }
  if (!done) {
    if (chunked) return cudaErrorInvalidValue;  // no chunked form at N = 8
    wkv6_state_pass_rec<T, N, false><<<grid, 256, 0, stream>>>(
        kt, vt, w, s0, states_s, steps, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    wkv6_state_pass_rec<T, N, true><<<grid, 256, 0, stream>>>(
        rt, ot, w, ds_T, states_g, steps, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t smem = sizeof(ChunkSmem<N>);
    err = cudaFuncSetAttribute(wkv6_bwd_chunk<T, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    wkv6_bwd_chunk<T, N><<<dim3(n_chunks, H, B), ChunkShape<N>::kThreads, smem, stream>>>(
        rt, kt, vt, w, u, ot, states_s, states_g, static_cast<T*>(dr),
        static_cast<T*>(dk), static_cast<T*>(dv), dw, du_part, ds0, steps, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  wkv6_du_reduce<<<(B * H * N + 255) / 256, 256, 0, stream>>>(du_part, du, B,
                                                              n_chunks, H * N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const float* w,
                     const float* u, const float* s0, const void* dout,
                     const float* ds_T, void* dr, void* dk, void* dv, float* dw,
                     float* du, float* ds0, float* states_s, float* states_g,
                     float* du_part, int B, int steps, int H, int N, bool chunked,
                     cudaStream_t st) {
#define WKV6_BWD_N(NN)                                                          \
  case NN:                                                                      \
    return launch<T, NN>(r, k, v, w, u, s0, dout, ds_T, dr, dk, dv, dw, du, ds0, \
                         states_s, states_g, du_part, B, steps, H, chunked, st);
  switch (N) {
    WKV6_BWD_N(8)
    WKV6_BWD_N(16)
    WKV6_BWD_N(32)
    WKV6_BWD_N(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef WKV6_BWD_N
}

}  // namespace

// r, k, v, dout, dr, dk, dv: (B, T, H, N) in `dtype` (0 = float32, 1 =
// bfloat16); w, dw: (B, T, H, N) fp32; u (H, N), du (B, H, N): fp32, du
// by batch row; s0 (may be NULL: zeros), ds_T, ds0: (B, H, N, N) fp32.
// Scratch the kernels fill: states_s and states_g (B, nC, H, N, N) fp32
// and du_part (B, nC, H, N) fp32, nC = ceil(T / 32). chunked != 0 takes
// the chunked route (N >= 16: (ab), (c) with the chunk products, (d)),
// else the recurrent one ((a), (b), (c) elementwise, (d)): the caller
// picks (repro_torch.kernels.wkv6.kernel, `chunked`). Launches on
// `stream`. Returns a cudaError_t (0 on success); the caller raises on
// anything else.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* dout, const void* ds_T, void* dr,
                              void* dk, void* dv, void* dw, void* du, void* ds0,
                              void* states_s, void* states_g, void* du_part,
                              int B, int T, int H, int N, int dtype,
                              int chunked, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  const float* gf = static_cast<const float*>(ds_T);
  float* dwf = static_cast<float*>(dw);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  float* ss = static_cast<float*>(states_s);
  float* sg = static_cast<float*>(states_g);
  float* dp = static_cast<float*>(du_part);
  if (dtype == 0)
    return (int)dispatch<float>(r, k, v, wf, uf, sf, dout, gf, dr, dk, dv, dwf,
                                duf, ds0f, ss, sg, dp, B, T, H, N, chunked != 0, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(r, k, v, wf, uf, sf, dout, gf, dr, dk, dv,
                                        dwf, duf, ds0f, ss, sg, dp, B, T, H, N,
                                        chunked != 0, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
