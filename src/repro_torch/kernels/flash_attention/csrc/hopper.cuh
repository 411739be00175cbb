// Hopper building blocks shared by the flash attention kernels
// (flash_attention.cu, the forward; flash_attention_bwd.cu, the backward):
// the strided layout, the shared-memory tile geometry that TMA writes and
// `wgmma` reads, `wgmma` descriptors, mbarriers, TMA loads and tensor maps.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // in elements; the head dimension is contiguous
  long long b, s, h;
};

// The width the bf16 kernel runs head dim DH at: DH below 64, else DH
// rounded up to whole 64-column slabs (120 -> 128, 160 -> 192).
template <int DH>
constexpr int kPadded = DH < 64 ? DH : (DH + 63) / 64 * 64;

// Shared-memory geometry of a ROWS-row tile of (padded) head dim DH. A row
// of one slab is one swizzle row: 128 B (64 bf16) when DH >= 64, else DH * 2
// bytes.
template <int DH, int ROWS>
struct Tile {
  static constexpr int kCols = DH >= 64 ? 64 : DH;      // columns per slab
  static constexpr int kSlabs = DH / kCols;
  static constexpr int kRowBytes = kCols * 2;           // 128, 64 or 32
  static constexpr int kSlabBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kSlabs * kSlabBytes;    // = ROWS * DH * 2
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = DH >= 64 ? 1 : (DH == 32 ? 2 : 3);
  static constexpr int kGroupBytes = 8 * kRowBytes;     // 8 rows: one atom
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// start address, leading and stride byte offsets (all in 16 B units), and
// the swizzle mode (bits 62-63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// K-major operand (Q or K tile, ROWS x DH): k-step kk covers head-dim
// columns 16kk..16kk+15, 32 bytes into a swizzle row.
template <int DH, int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t base, int kk) {
  using G = Tile<DH, ROWS>;
  constexpr int kPerSlab = G::kCols / 16;
  const uint32_t addr =
      base + (kk / kPerSlab) * G::kSlabBytes + (kk % kPerSlab) * 32;
  return make_desc(addr, 16, G::kGroupBytes, G::kLayout);
}

// MN-major operand (V tile as B of P V: K = keys, N = head dim): k-step kk
// covers keys 16kk..16kk+15, i.e. 16 swizzle rows further; the N direction
// crosses slabs at the leading byte offset.
template <int DH, int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t base, int kk) {
  using G = Tile<DH, ROWS>;
  return make_desc(base + kk * 16 * G::kRowBytes, G::kSlabBytes,
                   G::kGroupBytes, G::kLayout);
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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box of a 4-D map (dh, head, s, b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row0,
                                          int b) {
  using G = Tile<DH, ROWS>;
#pragma unroll
  for (int s = 0; s < G::kSlabs; ++s)
    tma_load(dst + s * G::kSlabBytes, map, bar, s * G::kCols, head, row0, b);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x by the SFU alone (relative error ~2^-22, subnormal results flushed to
// zero): enough for probabilities rounded to bf16 before P V.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

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

// 4-D map over (dh, head, s, b) of a bf16 tensor, box (slab cols, 1, ROWS,
// 1); out-of-range rows, and the padded columns past DH, read as zeros.
template <int DH, int ROWS>
bool make_map(CUtensorMap* map, const void* base, int heads, int S, int B,
              Strides st) {
  constexpr int DP = kPadded<DH>;
  using G = Tile<DP, ROWS>;
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::kCols, 1, ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = DP >= 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : DP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
