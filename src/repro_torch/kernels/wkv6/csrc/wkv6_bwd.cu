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
// in three passes over chunks of C = 32 steps (the forward's chunk):
//
//   (a) forward state pass: S_in of every chunk, from s0, one block per
//       (b, h) walking the chunks in order:
//         S_out = diag(W) S_in + sum_s (k_s prod_{i>s} w_i)^T v_s;
//   (b) reverse state pass: G_out of every chunk, from dS_T, the chunks in
//       reverse, the same product transposed in time:
//         G_in = diag(W) G_out + sum_s (r_s prod_{i<s} w_i)^T do_s,
//       W = prod_s w_s over the chunk. Both are (N x C) (C x N) products on
//       the tensor cores in 3xTF32 (mma_tf32.cuh, as the forward's), the
//       state in the registers of N / 16 warps. The decay factors are
//       products of w, each <= 1 and formed by multiplication alone, so a
//       step with w = 0 zeroes every factor across it exactly and nothing
//       can overflow; no log or exponent is taken.
//   (c) intra-chunk pass, one block per (b, h, chunk): 4 x 64 x 16 = 4096
//       blocks at RWKV-6's training shape, against the forward's 256. Given
//       the chunk's S_in and G_out it runs the step recurrence itself, each
//       state element (n, m) on its own: S forward, G backward, and the
//       step's contributions to dr, dk, dw (sums over m) and dv (a sum over
//       n). dw_t needs S_{t-1} and G_t elementwise; the chunked matrix form
//       would give it only through the log-space identity w_t dw_t =
//       (G_{t-1} o S_{t-1}) sum - r_t o (S_{t-1} do_t), which divides by w
//       (w = 0 is a real input: the model's exp(-exp(x)) underflows), or
//       through a C^3 N triple sum. The elementwise recurrence is exact at
//       w = 0 and costs a few FMAs an element and step. A thread owns 4
//       columns of one state row; the states S_{t-1} of one sub-chunk of 8
//       steps are kept in its registers (checkpoints at the sub-chunk starts,
//       each sub-chunk recomputed once), so the backward sweep reads them in
//       reverse. Sums over m go through warp shuffles, sums over n through
//       shared memory in a fixed order; the per-chunk du goes to a scratch
//       row;
//   (d) du by batch row: the scratch rows summed over the chunks in order
//       (the binding's caller sums the batch rows).
// No atomics: two calls give equal gradients.
//
// The binding picks the state passes' form by the forward's rule
// (`kernel.chunked`): the tensor-core form when T >= 32 and N >= 16, else
// (T < 32, or N = 8) a recurrent CUDA-core pass, one thread per state
// element (T < 32 is one chunk, where it only stores s0 and dS_T).
//
// What bounds it on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32, 67 TFLOP/s
// fp32 off the tensor cores), at RWKV-6's training shape (B=4, T=512, H=64,
// N=64, bf16 r/k/v/do, fp32 w; chip_smoke._bwd_times): the inputs, both
// cotangents and every gradient once, 197.2 MB -> 58.9 us; twice the
// forward's least work at the fp32 rate, 5.45 GFLOP -> 81.4 us, the bound.
// The chunk-boundary states (2 x 67 MB, written once and read once) add
// 268 MB of traffic that the bound does not count, and (c)'s elementwise
// work, about 7 FMAs per state element and step (3.8 G at that shape),
// runs on the CUDA cores: some 110 us at the fp32 peak. The route this
// replaces, the VJP of the chunk-checkpointed plain loop, took 610.9 ms
// there (PERF.md §6): a Python loop of small launches per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kChunk = 32;  // C: steps per chunk (the forward's)
constexpr int kSub = 8;     // steps per sub-chunk of (c)'s register history
constexpr int kNSub = kChunk / kSub;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------ (a), (b): tensor cores
// grid (H, B), 2N threads: warp i holds state rows 16i.. in registers.
// REVERSE = false: (a), A = k, B = v, factors the suffix products, the
// chunks in order; true: (b), A = r, B = do, the prefix products, in
// reverse. states: (B, nC, H, N, N), chunk c's incoming state (S_in for
// (a), G_out for (b)).
template <typename T, int N>
struct PassSmem {
  static constexpr int kRaw = N + 8;
  static constexpr int kRow = N + 4;
  T a[kChunk][kRaw], b[kChunk][kRaw];
  float w[kChunk][kRaw];
  float ahat[kChunk][kRow];
  float gC[N];
};

template <typename T, int N, bool REVERSE>
__global__ void __launch_bounds__(2 * N)
wkv6_state_pass(const T* __restrict__ a_in, const T* __restrict__ b_in,
                const float* __restrict__ w, const float* __restrict__ init,
                float* __restrict__ states, int steps, int H) {
  using SM = PassSmem<T, N>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  constexpr bool kExact = sizeof(T) == 2;  // a bf16 B operand is exact in TF32
  constexpr int kNT = N / 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = 16 * warp;
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  const size_t row_stride = (size_t)H * N;
  const size_t base = ((size_t)b * steps * H + h) * N;
  const size_t sbase = (size_t)(b * H + h) * N * N;

  float X[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int row = n0 + g, col = 8 * nt + 2 * q;
    X[nt][0] = init != nullptr ? init[sbase + row * N + col] : 0.f;
    X[nt][1] = init != nullptr ? init[sbase + row * N + col + 1] : 0.f;
    X[nt][2] = init != nullptr ? init[sbase + (row + 8) * N + col] : 0.f;
    X[nt][3] = init != nullptr ? init[sbase + (row + 8) * N + col + 1] : 0.f;
  }

  for (int it = 0; it < n_chunks; ++it) {
    const int c = REVERSE ? n_chunks - 1 - it : it;
    float* out = states + ((size_t)(b * n_chunks + c) * H + h) * N * N;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int row = n0 + g, col = 8 * nt + 2 * q;
      out[row * N + col] = X[nt][0];
      out[row * N + col + 1] = X[nt][1];
      out[(row + 8) * N + col] = X[nt][2];
      out[(row + 8) * N + col + 1] = X[nt][3];
    }
    if (it + 1 == n_chunks) break;  // the last chunk's product is not needed
    const int valid = min(kChunk, steps - c * kChunk);
    for (int i = tid; i < kChunk * N; i += 2 * N) {
      const int t = i / N, n = i % N;
      const bool in = t < valid;
      const size_t at = base + (size_t)(c * kChunk + t) * row_stride + n;
      sm.a[t][n] = in ? a_in[at] : from_float<T>(0.f);
      sm.b[t][n] = in ? b_in[at] : from_float<T>(0.f);
      sm.w[t][n] = in ? w[at] : 1.f;  // a padded step: w = 1, a = b = 0
    }
    __syncthreads();
    if (tid < N) {
      float f = 1.f;
      if (REVERSE) {
        for (int s = 0; s < kChunk; ++s) {  // prod_{i<s} w_i
          sm.ahat[s][tid] = to_float(sm.a[s][tid]) * f;
          f *= sm.w[s][tid];
        }
      } else {
        for (int s = kChunk - 1; s >= 0; --s) {  // prod_{i>s} w_i
          sm.ahat[s][tid] = to_float(sm.a[s][tid]) * f;
          f *= sm.w[s][tid];
        }
      }
      sm.gC[tid] = f;
    }
    __syncthreads();
    float acc[kNT][4];
    const float d0 = sm.gC[n0 + g], d1 = sm.gC[n0 + g + 8];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[nt][0] = d0 * X[nt][0];
      acc[nt][1] = d0 * X[nt][1];
      acc[nt][2] = d1 * X[nt][2];
      acc[nt][3] = d1 * X[nt][3];
    }
    tile_mma<kChunk / 8, kNT, kExact>(
        acc, [&](int i, int s) { return sm.ahat[s][n0 + i]; },
        [&](int s, int j) { return to_float(sm.b[s][j]); });
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) X[nt][e] = acc[nt][e];
    __syncthreads();  // every read of this chunk's tiles is done
  }
}

// ------------------------------------------------ (a), (b): recurrent
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

// ------------------------------------------------ (c): one chunk's gradients
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
  const dim3 grid(H, B);
  cudaError_t err;
  bool done = false;
  if constexpr (N >= 16) {
    if (chunked) {
      const size_t smem = sizeof(PassSmem<T, N>);
      err = cudaFuncSetAttribute(wkv6_state_pass<T, N, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(wkv6_state_pass<T, N, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      wkv6_state_pass<T, N, false><<<grid, 2 * N, smem, stream>>>(
          kt, vt, w, s0, states_s, steps, H);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      wkv6_state_pass<T, N, true><<<grid, 2 * N, smem, stream>>>(
          rt, ot, w, ds_T, states_g, steps, H);
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
  }
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  const size_t smem = sizeof(ChunkSmem<N>);
  err = cudaFuncSetAttribute(wkv6_bwd_chunk<T, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wkv6_bwd_chunk<T, N><<<dim3(n_chunks, H, B), ChunkShape<N>::kThreads, smem, stream>>>(
      rt, kt, vt, w, u, ot, states_s, states_g, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dw, du_part, ds0, steps, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
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
// by batch row; s0 (may be NULL:
// zeros), ds_T, ds0: (B, H, N, N) fp32. Scratch the kernels fill: states_s
// and states_g (B, nC, H, N, N) fp32 and du_part (B, nC, H, N) fp32, nC =
// ceil(T / 32). chunked != 0 runs the state passes on the tensor cores (N >=
// 16), else the recurrent ones: the caller picks
// (repro_torch.kernels.wkv6.kernel, `chunked`). Launches (a), (b), (c), (d)
// on `stream`. Returns a cudaError_t (0 on success); the caller raises on
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
