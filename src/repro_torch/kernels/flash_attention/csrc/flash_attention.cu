// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// function `flash_attention` (Pallas body `_kernel`): attention forward with
// causal, sliding-window and tanh soft-cap masks, GQA (kv head = h / (H/KV))
// and a `kv_len` pad mask, fp32 online softmax (m, l, acc), fully masked
// key tiles skipped.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense). At the
// serving path's prefill shape, B=4, S=512 (500 padded), H=24, KV=2, Dh=128,
// causal, bf16:
//   operations ~ 4*B*H*S^2*Dh/2        ~ 6.4 GFLOP   -> 6.5 us at 989 TFLOP/s
//   bytes      ~ q + o + k + v          ~ 27.3 MB    -> 8.1 us at 3.35 TB/s
// so the card's bound is memory, at about 8 us.
//
// What this design does about it. Each thread block owns one (b, h, 64-row
// query tile); the TPU's sequential key-block grid axis with its VMEM
// scratch (kernel.py:33-37, 82-85) becomes a loop inside the block. The
// block stages each 64-key K/V tile in shared memory once for all its 64
// query rows, keeps scores, m, l and acc on chip (the S x S scores never
// reach device memory), and its loop bounds skip the key tiles that the
// causal mask, the window or kv_len rule out. So device-memory traffic is
// close to the bound: q and o once, k and v once per query tile (the
// 12 GQA heads sharing a kv head hit L2 for it).
//
// This first version computes QK^T and PV in fp32 on the CUDA cores, as
// the TPU kernel does after `astype(float32)` (kernel.py:51-53). Those
// cores give 67 TFLOP/s, so the same 6.4 GFLOP take at least ~96 us here:
// this kernel is bounded by its own fp32 FMA rate and shared-memory reads,
// not by the card's bound. Tensor cores (mma.sync / wgmma) and TMA are the
// later step that closes that gap.
//
// Layout: q, o (B, H, Sq, Dh); k, v (B, KV, Sk, Dh); all contiguous.
// Numerics: scale = Dh^-0.5 applied before the softcap; finite NEG_INF =
// -1e30 for masked keys as in the TPU kernel; keys past the tensor's end
// (the ragged last tile) get -inf and never count; l is clamped at 1e-30,
// so no NaN arises, not even in padded rows. Output in the input dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * kRowsPerWarp;   // 64 query rows per block
constexpr int kBK = 64;                      // 64 keys per tile: 2 per lane
constexpr int kKStride = kBK + 1;            // padded K^T row: no bank conflicts
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int Sq, int Sk, int Dh, int causal, int window, float cap,
                 float scale, int kv_len) {
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

  const T* qb = q + (size_t)(b * H + h) * Sq * Dh;
  const T* kb = k + (size_t)(b * KV + g) * Sk * Dh;
  const T* vb = v + (size_t)(b * KV + g) * Sk * Dh;
  T* ob = o + (size_t)(b * H + h) * Sq * Dh;

  for (int i = tid; i < kBQ * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    const int qpos = q0 + r;
    qs[i] = qpos < Sq ? to_float(qb[(size_t)qpos * Dh + d]) : 0.f;
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
        kx = to_float(kb[(size_t)kpos * Dh + d]);
        vx = to_float(vb[(size_t)kpos * Dh + d]);
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
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) ob[(size_t)qpos * Dh + d] = from_float<T>(acc[r][t] / denom);
    }
  }
}

template <typename T, int NT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int Sq, int Sk, int Dh, int causal,
                   int window, float cap, float scale, int kv_len,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)Dh * kKStride + (size_t)kBK * Dh +
                       (size_t)kBQ * Dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, Dh, causal,
      window, cap, scale, kv_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int Sq, int Sk, int Dh, int causal,
                     int window, float cap, float scale, int kv_len,
                     cudaStream_t stream) {
  if (Dh <= 32)
    return launch<T, 1>(q, k, v, o, B, H, KV, Sq, Sk, Dh, causal, window, cap,
                        scale, kv_len, stream);
  if (Dh <= 64)
    return launch<T, 2>(q, k, v, o, B, H, KV, Sq, Sk, Dh, causal, window, cap,
                        scale, kv_len, stream);
  if (Dh <= 128)
    return launch<T, 4>(q, k, v, o, B, H, KV, Sq, Sk, Dh, causal, window, cap,
                        scale, kv_len, stream);
  return launch<T, 8>(q, k, v, o, B, H, KV, Sq, Sk, Dh, causal, window, cap,
                      scale, kv_len, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len < 0 means "no pad mask".
// Returns a cudaError_t (0 on success); the caller raises on anything else.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int H,
                                         int KV, int Sq, int Sk, int Dh,
                                         int causal, int window, float cap,
                                         float scale, int kv_len, int dtype,
                                         void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      Dh <= 0 || Dh > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, H, KV, Sq, Sk, Dh, causal,
                                window, cap, scale, kv_len, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, Dh,
                                        causal, window, cap, scale, kv_len,
                                        st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
