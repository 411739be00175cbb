// Pieces shared by the WKV6 kernels (wkv6.cu, the forward; wkv6_bwd.cu, the
// backward): dtype conversions, the 3xTF32 tile product on the tensor cores
// (mma.sync m16n8k8), cp.async and the SFU's 2^x.
#pragma once

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

// mma.sync m16n8k8 TF32 fragments, lane = 4g + q:
//   A (16 x 8, row-major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4),
//                          a3 (g + 8, q + 4)
//   B (8 x 8):             b0 (k = q, n = g), b1 (k = q + 4, n = g)
//   C (16 x 8):            c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q),
//                          c3 (g + 8, 2q + 1)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[nt] (16 x 8) += A (16 x 8 KSTEPS) B (8 KSTEPS x 8 NT, columns 8 nt..)
// in 3xTF32; a_at(i, kk) and b_at(kk, j) give the fp32 operands, each A
// fragment loaded once for the NT tiles. A_EXACT, B_EXACT: every A (B)
// value is exact in TF32 (a bf16 input), so its low part is zero and the
// product with it is skipped. The small products go to their own
// accumulator, added at the end: two independent chains of MMAs instead
// of one.
template <int KSTEPS, int NT, bool A_EXACT, bool B_EXACT, class FA, class FB>
__device__ __forceinline__ void tile_mma(float (&c)[NT][4], FA a_at, FB b_at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float d[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int kk = 8 * ks + q;
    uint32_t ah[4], al[4];
    if (A_EXACT) {
      ah[0] = __float_as_uint(a_at(g, kk));
      ah[1] = __float_as_uint(a_at(g + 8, kk));
      ah[2] = __float_as_uint(a_at(g, kk + 4));
      ah[3] = __float_as_uint(a_at(g + 8, kk + 4));
    } else {
      split_tf32(a_at(g, kk), ah[0], al[0]);
      split_tf32(a_at(g + 8, kk), ah[1], al[1]);
      split_tf32(a_at(g, kk + 4), ah[2], al[2]);
      split_tf32(a_at(g + 8, kk + 4), ah[3], al[3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh0, bh1, bl0, bl1;
      if (B_EXACT) {
        bh0 = __float_as_uint(b_at(kk, 8 * nt + g));
        bh1 = __float_as_uint(b_at(kk + 4, 8 * nt + g));
      } else {
        split_tf32(b_at(kk, 8 * nt + g), bh0, bl0);
        split_tf32(b_at(kk + 4, 8 * nt + g), bh1, bl1);
      }
      if (!A_EXACT) mma_tf32(d[nt], al, bh0, bh1);
      if (!B_EXACT) mma_tf32(d[nt], ah, bl0, bl1);
      mma_tf32(c[nt], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] += d[nt][e];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 2^x for x <= 0 by the SFU alone (relative error ~2^-22; results below
// 2^-126, negligible beside the terms they multiply, flush to zero).
__device__ __forceinline__ float pow2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
