// WKV6 forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py, function `wkv6`
// (Pallas body `_kernel`): the RWKV-6 recurrence, per (batch, head), with an
// N x N fp32 state
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// o in r's dtype, S_T in fp32, S_{-1} = s0 or 0.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA
// cores). At the serving path's prefill shape, B=4, T=500, H=64, N=64, bf16
// r/k/v/o and fp32 w: bytes = r + k + v + o (4 * 16.4 MB) + w (32.8 MB)
// + s0 + S_T (2 * 4.2 MB) ~ 106.7 MB -> ~32 us; operations ~ 7 N^2 per
// (b, h, t) ~ 3.7 GFLOP -> ~55 us. So the card's bound is the fp32
// arithmetic, at about 55 us. In decode (T = 1) it is the state: s0 in and
// S_T out, 8.4 MB -> ~2.5 us.
//
// What this design does about it. The recurrence is sequential in t; the
// parallelism is (b, h) and, inside one step, the N x N state. One block
// owns one (b, h) with N threads; thread j keeps column j of the state
// (S_ij, i < N) in registers for the whole sequence, so the state never
// touches device memory between s0 and S_T. The TPU's sequential chunk
// grid axis with the state in VMEM scratch (kernel.py:26-49) becomes the
// time loop inside the block. Each step, thread j loads element j of r_t,
// k_t, v_t and w_t (N contiguous values per tensor: coalesced), r, k, w go
// to shared memory (double-buffered, so one barrier per step), and thread j
// computes o_j = sum_i r_i (S_ij + u_i k_i v_j) and S_ij <- w_i S_ij + k_i
// v_j, reading r_i, k_i, w_i, u_i as shared-memory broadcasts. The next
// step's loads are issued before this step's arithmetic. At B*H = 256
// blocks of 64 threads the card holds every block at once; the time loop's
// barrier and load latency, not the bound, will set this kernel's pace.
// Chunked forms (intra-chunk products on the tensor cores) are the later
// step.
//
// Any T (T = 1 in decode). N in {8, 16, 32, 64}: the state column is an
// array of N registers, so N is a template argument.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, void* o,
                   float* s_T, int B, int steps, int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_kernel<T, N><<<grid, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(o), s_T, steps, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const float* w, const float* u, const float* s0, void* o,
                     float* s_T, int B, int steps, int H, int N,
                     cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<T, 8>(r, k, v, w, u, s0, o, s_T, B, steps, H, stream);
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, o, s_T, B, steps, H, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, o, s_T, B, steps, H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, o, s_T, B, steps, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v, o): 0 = float32, 1 = bfloat16; w, u, s0, s_T are fp32.
// s0 may be NULL (zeros). Returns a cudaError_t (0 on success); the caller
// raises on anything else.
extern "C" int repro_wkv6_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* o, void* s_T, int B, int T, int H, int N,
                              int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_T);
  if (dtype == 0)
    return (int)dispatch<float>(r, k, v, wf, uf, sf, o, so, B, T, H, N, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(r, k, v, wf, uf, sf, o, so, B, T, H,
                                        N, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
