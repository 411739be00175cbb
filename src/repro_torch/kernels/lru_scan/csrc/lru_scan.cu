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
// block divisibility does not carry over). The instruction forms and the
// tensor maps are tma_ring.cuh's, which the backward (lru_scan_bwd.cu)
// shares.
//
// Numerics: one fp32 multiply then one fp32 add per step, each rounded (no
// fused multiply-add), which is the plain PyTorch version's order, so the
// two agree bit for bit, y rounded to a's dtype from the same fp32 h.

#include "tma_ring.cuh"

namespace {

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
constexpr int kStages = 6;      // tiles of a and b in the ring

template <typename TA, typename TB>
struct Ring {
  static constexpr uint32_t kABytes = kSteps * kChannels * sizeof(TA);
  static constexpr uint32_t kBBytes = kSteps * kChannels * sizeof(TB);
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  // the stages, then a full and a done mbarrier per stage; 128 B of slack
  // to align the base
  static constexpr size_t kSmem = kStages * kStageBytes + 16 * kStages + 128;
};

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

  if (tid == 0) ring_barriers_init(full, done, kStages);
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
        stores_read();
        load(j + kStages);
      }
    }
    stores_done();
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
    release_stage(done + 8 * s);
  }
  if (d < D) h_last[(size_t)bi * D + d] = to_float(from_float<TA>(h));
}

// ------------------------------------------------ host side
template <typename TA, typename TB>
cudaError_t allow_ring_smem() {
  static std::atomic<uint64_t> raised{0};
  return allow_smem(lru_scan_tma<TA, TB>, Ring<TA, TB>::kSmem, raised);
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
  return error_string(
      err, "TMA: cuTensorMapEncodeTiled refused a tensor map of a, b or y");
}
