// LRU scan forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/lru_scan/kernel.py, function
// `lru_scan` (Pallas body `_kernel`): the RG-LRU linear recurrence
//
//   h_t = a_t * h_{t-1} + b_t        per (batch, channel), fp32 state
//
// with y_t = h_t written in a's dtype and h_last = y[:, -1] widened to fp32
// (kernel.py:67), h_{-1} = h0 or 0.
//
// What bounds it on an H100 SXM (3.35 TB/s). At the serving path's prefill
// shape, B=4, S=500, D=4096, fp32: bytes = a + b + y + h0 + h_last
// = 3 * 32.77 MB + 2 * 65.5 KB ~ 98.4 MB -> ~29 us; operations are 2 per
// element (16.4 MFLOP), nothing. So the card's bound is memory.
//
// What this design does about it. The recurrence is sequential in t and
// independent across channels, so one thread owns one (b, d) channel and
// keeps h in a register for the whole sequence: the TPU's sequential
// chunk grid axis with its VMEM carry (kernel.py:26-39) becomes the loop
// inside the thread, and every element crosses device memory exactly once.
// A warp reads 32 consecutive channels of one time step: coalesced 128-byte
// loads. The loop is cut into 16-step groups whose loads come before the
// group's arithmetic, so loads of later steps can be in flight while the
// earlier ones are summed: with only B*D = 16,384 threads, the memory's
// latency, not its rate, is what a one-load-at-a-time loop would hit. There
// is no parallelism in t to add without a two-pass scan; that is a later
// step if the kernel shows up in the profile.
//
// Any S and D (the TPU kernel's chunk / block divisibility does not carry
// over). Numerics: one fp32 multiply then one fp32 add per step, each
// rounded (no fused multiply-add), which is the plain PyTorch version's
// order, so in fp32 the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels per block: 256 blocks at B=4, D=4096
constexpr int kGroup = 16;     // time steps whose loads are issued together

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

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// grid (ceil(D / kThreads), B); thread -> channel d of batch row blockIdx.y.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                const float* __restrict__ h0, TA* __restrict__ y,
                float* __restrict__ h_last, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)bi * S * D + d;
  const TA* ap = a + base;
  const TB* bp = b + base;
  TA* yp = y + base;
  float h = h0 != nullptr ? h0[(size_t)bi * D + d] : 0.f;

  int t = 0;
  for (; t + kGroup <= S; t += kGroup) {
    float av[kGroup], bv[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      av[u] = to_float(ap[(size_t)(t + u) * D]);
      bv[u] = to_float(bp[(size_t)(t + u) * D]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      h = step(av[u], h, bv[u]);
      yp[(size_t)(t + u) * D] = from_float<TA>(h);
    }
  }
  for (; t < S; ++t) {
    h = step(to_float(ap[(size_t)t * D]), h, to_float(bp[(size_t)t * D]));
    yp[(size_t)t * D] = from_float<TA>(h);
  }
  h_last[(size_t)bi * D + d] = to_float(from_float<TA>(h));
}

template <typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, const float* h0, void* y,
                   float* h_last, int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  lru_scan_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), h0,
      static_cast<TA*>(y), h_last, S, D);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t dispatch_b(const void* a, const void* b, const float* h0, void* y,
                       float* h_last, int B, int S, int D, int b_dtype,
                       cudaStream_t stream) {
  if (b_dtype == 0)
    return launch<TA, float>(a, b, h0, y, h_last, B, S, D, stream);
  if (b_dtype == 1)
    return launch<TA, __nv_bfloat16>(a, b, h0, y, h_last, B, S, D, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16. h0 may be NULL (zeros).
// Returns a cudaError_t (0 on success); the caller raises on anything else.
extern "C" int repro_lru_scan_fwd(const void* a, const void* b,
                                  const void* h0, void* y, void* h_last,
                                  int B, int S, int D, int a_dtype,
                                  int b_dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (a_dtype == 0)
    return (int)dispatch_b<float>(a, b, h0f, y, hl, B, S, D, b_dtype, st);
  if (a_dtype == 1)
    return (int)dispatch_b<__nv_bfloat16>(a, b, h0f, y, hl, B, S, D, b_dtype,
                                          st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
