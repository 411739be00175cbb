// What the LRU scan's forward (lru_scan.cu) and backward (lru_scan_bwd.cu)
// TMA kernels share: the element conversions, the rounded step, the
// mbarrier and TMA (cp.async.bulk.tensor) instruction forms, and the host
// side's tensor maps over a contiguous (B, S, D) tensor with a box of
// kChannels channels by kSteps steps of one batch row.
//
// The TMA encoder (`cuTensorMapEncodeTiled`, a driver-API call) is fetched
// with `cudaGetDriverEntryPoint`, so neither library links -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kChannels = 128;  // per block = consumer threads
constexpr int kSteps = 32;      // time steps per tile
static_assert(kChannels % 32 == 0 && kChannels <= 256 && kSteps <= 256,
              "a TMA box side is at most 256 elements; whole warps");

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

// a * h + b as one rounded multiply, then one rounded add (no fused
// multiply-add): the plain PyTorch versions' order
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// the full and done barriers of a ring of `stages` stages: one arrival
// (the producer's expect_tx) completes `full`, kChannels arrivals `done`
__device__ __forceinline__ void ring_barriers_init(uint32_t full,
                                                   uint32_t done,
                                                   int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(done + 8 * s, kChannels);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a consumer's writes to its stage, then seen by the TMA store (the async
// proxy), then its arrival on the stage's `done` barrier
__device__ __forceinline__ void release_stage(uint32_t done) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(done);
}

// box (kChannels, kSteps, 1) of a 3-D map (d, s, b) at (d0, t0, bi). A box
// reaching past the tensor on any side, t0 < 0 included, reads zeros there
// and still completes the box's full byte count on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int t0,
                                         int bi) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(t0), "r"(bi),
      "r"(bar)
      : "memory");
}

// the box back to global memory (clipped to the tensor), as one bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int d0, int t0, int bi) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d0), "r"(t0), "r"(bi)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the producer waits until every store issued so far has read its stage
__device__ __forceinline__ void stores_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and until every store has landed
__device__ __forceinline__ void stores_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType map_dtype() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Errors of the TMA path's own, apart from cudaError_t's (which are >= 0).
constexpr int kErrNoEncoder = -1;   // the driver has no cuTensorMapEncodeTiled
constexpr int kErrMapRefused = -2;  // cuTensorMapEncodeTiled refused a map

// 3-D map over (d, s, b) of a contiguous (B, S, D) tensor, box (kChannels,
// kSteps, 1), no swizzle; out-of-range elements read as zeros and are not
// written. Returns 0, or kErrNoEncoder / kErrMapRefused (the encoder refuses
// a base or row stride that is not a multiple of 16 bytes).
template <typename T>
int make_map(CUtensorMap* map, const void* base, int B, int S, int D) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)S * D * sizeof(T)};
  const cuuint32_t box[3] = {kChannels, kSteps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, map_dtype<T>(), 3, const_cast<void*>(base), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrMapRefused;
}

// A ring needs more dynamic shared memory than the default 48 KB; the limit
// is raised once per kernel instance and device (bit d of `raised`).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<uint64_t>& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (raised.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) raised.fetch_or(bit);
  return err;
}

// an entry point's return code as text; `map_refused` names its maps
const char* error_string(int err, const char* map_refused) {
  if (err == kErrNoEncoder)
    return "TMA: the CUDA driver offers no cuTensorMapEncodeTiled";
  if (err == kErrMapRefused) return map_refused;
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
