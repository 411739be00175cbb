// LRU scan forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/lru_scan/kernel.py, function
// `lru_scan` (:42; `pallas_call` at :53, body `_kernel`): the RG-LRU linear
// recurrence
//
//   h_t = a_t * h_{t-1} + b_t        per (batch, channel), fp32 state
//
// with y_t = h_t written in a's dtype and h_last = y[:, -1] widened to fp32
// (kernel.py:67), h_{-1} = h0 or 0.
//
// What bounds it on an H100 SXM (3.35 TB/s). At the serving path's prefill
// shape, B=4, S=500, D=4096, fp32: bytes = a + b + y + h0 + h_last
// = 3 * 32.77 MB + 2 * 65.5 KB = 98.4 MB -> 29.4 us; operations are 2 per
// element (16.4 MFLOP), nothing. The dependent chain is no limit either:
// 500 steps of a multiply and an add, ~8 cycles each, are ~2.3 us. So the
// bound is the bytes.
//
// Why the first kernel (`lru_scan_thread` below) sat at 2.2x that bound
// (0.0638 ms; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6). One thread
// owns one (b, d) channel; at the prefill shape that is 16,384 threads,
// about 4 warps an SM. Each issues 16 steps of loads (2 x 16 x 4 B), waits,
// runs them and stores, and only then issues the next 16. By Little's law
// the card needs ~2-2.7 MB in flight (3.35 TB/s times a device-memory
// latency of ~0.6-0.8 us), ~15-20 KB an SM; that kernel has ~16 KB an SM in
// flight at the start of each group and none while it computes, about half
// of what it needs on average.
//
// What the TMA kernel (`lru_scan_tma`) does about it. One block owns one
// batch row and a tile of kChannels = 128 channels (128 blocks at the
// prefill shape: one wave on 132 SMs). One producer thread keeps TMA loads
// of [kSteps = 32 steps x 128 channels] tiles of a and of b in flight, into
// a ring of kStages = 6 stages in shared memory (32 KB a stage in fp32), so
// up to 160 KB an SM are in flight while the threads compute, several
// times what Little's law asks. (Other tile shapes, 2 to 8 stages, 64 or
// 128 channels and 16 to 64 steps, measured within 2 % of this one; PERF.md
// §6, NVIDIA H100 80GB HBM3, 700 W.) 128 consumer threads, one per channel,
// keep h in a register and run the recurrence in time order, exactly as the
// first kernel does; each writes y_t over a_t in the stage (y has a's
// dtype), and the producer sends the tile back with a TMA store, then
// reloads the stage once the store has read it. Nothing is reassociated,
// so the kernel stays bit-equal to its plain version. TMA zero-fills loads
// past S or D and clips stores there; the step loop stops at S, so h never
// advances on fill, and h_last comes from step S-1.
//
// Which kernel runs is decided by the binding (kernel.py::use_tma) and
// passed in `use_tma`. TMA needs 16-byte aligned bases and row strides
// (D * element size) that are multiples of 16 bytes, for a and b alike;
// every model shape meets that (D = 4096). Other shapes take
// `lru_scan_thread`, so any S and D still runs (the TPU kernel's chunk /
// block divisibility does not carry over). The TMA encoder
// (`cuTensorMapEncodeTiled`, a driver-API call) is fetched with
// `cudaGetDriverEntryPoint`, so the library links no -lcuda.
//
// Numerics: one fp32 multiply then one fp32 add per step, each rounded (no
// fused multiply-add), which is the plain PyTorch version's order, so the
// two agree bit for bit, y rounded to a's dtype from the same fp32 h.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// ------------------------------------------------ the per-thread kernel
constexpr int kThreads = 64;   // channels per block: 256 blocks at B=4, D=4096
constexpr int kGroup = 16;     // time steps whose loads are issued together

// grid (ceil(D / kThreads), B); thread -> channel d of batch row blockIdx.y.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
lru_scan_thread(const TA* __restrict__ a, const TB* __restrict__ b,
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

// ------------------------------------------------ the TMA kernel
constexpr int kChannels = 128;  // per block = consumer threads
constexpr int kSteps = 32;      // time steps per tile
constexpr int kStages = 6;      // tiles of a and b in the ring
static_assert(kChannels % 32 == 0 && kChannels <= 256 && kSteps <= 256,
              "a TMA box side is at most 256 elements; whole warps");

template <typename TA, typename TB>
struct Ring {
  static constexpr uint32_t kABytes = kSteps * kChannels * sizeof(TA);
  static constexpr uint32_t kBBytes = kSteps * kChannels * sizeof(TB);
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  // the stages, then a full and a done mbarrier per stage; 128 B of slack
  // to align the base
  static constexpr size_t kSmem = kStages * kStageBytes + 16 * kStages + 128;
};

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

// box (kChannels, kSteps, 1) of a 3-D map (d, s, b) at (d0, t0, bi)
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

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int d0, int t0, int bi) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d0), "r"(t0), "r"(bi)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// grid (ceil(D / kChannels), B), kChannels + 32 threads: threads
// 0..kChannels-1 each own channel d0 + threadIdx.x; thread kChannels (the
// first of the last warp) is the producer. Tile j (steps 32j..32j+31) sits
// in stage j % kStages: `full` completes when its loads land, `done` when
// every consumer has written its y over a.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kChannels + 32)
lru_scan_tma(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ CUtensorMap map_y,
             const float* __restrict__ h0, float* __restrict__ h_last, int S,
             int D) {
  using R = Ring<TA, TB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + kStages * R::kStageBytes;  // stage s at + 8s
  const uint32_t done = full + 8 * kStages;
  const int d0 = blockIdx.x * kChannels, bi = blockIdx.y;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(done + 8 * s, kChannels);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kChannels) {
    if (tid != kChannels) return;
    auto load = [&](int j) {
      const int s = j % kStages;
      const uint32_t dst = ring + s * R::kStageBytes;
      mbar_expect_tx(full + 8 * s, R::kStageBytes);
      tma_load(dst, &map_a, full + 8 * s, d0, j * kSteps, bi);
      tma_load(dst + R::kABytes, &map_b, full + 8 * s, d0, j * kSteps, bi);
    };
    for (int j = 0; j < kStages && j < n_tiles; ++j) load(j);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(done + 8 * s, (j / kStages) & 1);
      tma_store(&map_y, ring + s * R::kStageBytes, d0, j * kSteps, bi);
      if (j + kStages < n_tiles) {
        // the stage is reloaded once the store has read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load(j + kStages);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  const int d = d0 + tid;
  float h = (h0 != nullptr && d < D) ? h0[(size_t)bi * D + d] : 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    TA* at = reinterpret_cast<TA*>(smem + s * R::kStageBytes) + tid;
    const TB* bt =
        reinterpret_cast<const TB*>(smem + s * R::kStageBytes + R::kABytes) +
        tid;
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    const int steps = min(kSteps, S - j * kSteps);
    if (steps == kSteps) {
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        h = step(to_float(at[t * kChannels]), h, to_float(bt[t * kChannels]));
        at[t * kChannels] = from_float<TA>(h);
      }
    } else {
      for (int t = 0; t < steps; ++t) {
        h = step(to_float(at[t * kChannels]), h, to_float(bt[t * kChannels]));
        at[t * kChannels] = from_float<TA>(h);
      }
    }
    // y written by this thread, then seen by the TMA store (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(done + 8 * s);
  }
  if (d < D) h_last[(size_t)bi * D + d] = to_float(from_float<TA>(h));
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

// The ring needs more dynamic shared memory than the default 48 KB; the
// limit is raised once per template instance and device (bit d of `raised`).
template <typename TA, typename TB>
cudaError_t allow_ring_smem() {
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (raised.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(lru_scan_tma<TA, TB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Ring<TA, TB>::kSmem);
  if (err == cudaSuccess) raised.fetch_or(bit);
  return err;
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, const float* h0, void* y,
           float* h_last, int B, int S, int D, int use_tma,
           cudaStream_t stream) {
  if (!use_tma) {
    const dim3 grid((D + kThreads - 1) / kThreads, B);
    lru_scan_thread<TA, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const TA*>(a), static_cast<const TB*>(b), h0,
        static_cast<TA*>(y), h_last, S, D);
    return (int)cudaGetLastError();
  }
  CUtensorMap ma, mb, my;
  int err = make_map<TA>(&ma, a, B, S, D);
  if (err == 0) err = make_map<TB>(&mb, b, B, S, D);
  if (err == 0) err = make_map<TA>(&my, y, B, S, D);
  if (err == 0) err = (int)allow_ring_smem<TA, TB>();
  if (err != 0) return err;
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  lru_scan_tma<TA, TB><<<grid, kChannels + 32, Ring<TA, TB>::kSmem, stream>>>(
      ma, mb, my, h0, h_last, S, D);
  return (int)cudaGetLastError();
}

template <typename TA>
int dispatch_b(const void* a, const void* b, const float* h0, void* y,
               float* h_last, int B, int S, int D, int b_dtype, int use_tma,
               cudaStream_t stream) {
  if (b_dtype == 0)
    return launch<TA, float>(a, b, h0, y, h_last, B, S, D, use_tma, stream);
  if (b_dtype == 1)
    return launch<TA, __nv_bfloat16>(a, b, h0, y, h_last, B, S, D, use_tma,
                                     stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, b, y: contiguous (B, S, D); h0, h_last: (B, D) fp32, h0 may be NULL
// (zeros). a_dtype, b_dtype: 0 = float32, 1 = bfloat16 (y has a's). use_tma:
// 1 runs the TMA kernel (16-byte aligned bases and row strides), 0 the
// per-thread kernel (any shape). Returns 0 on success, else a cudaError_t or
// one of the TMA path's negative codes; the caller raises with
// repro_cuda_error_string's text.
extern "C" int repro_lru_scan_fwd(const void* a, const void* b,
                                  const void* h0, void* y, void* h_last,
                                  int B, int S, int D, int a_dtype,
                                  int b_dtype, int use_tma, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (a_dtype == 0)
    return dispatch_b<float>(a, b, h0f, y, hl, B, S, D, b_dtype, use_tma, st);
  if (a_dtype == 1)
    return dispatch_b<__nv_bfloat16>(a, b, h0f, y, hl, B, S, D, b_dtype,
                                     use_tma, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  if (err == kErrNoEncoder)
    return "TMA: the CUDA driver offers no cuTensorMapEncodeTiled";
  if (err == kErrMapRefused)
    return "TMA: cuTensorMapEncodeTiled refused a tensor map of a, b or y";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
