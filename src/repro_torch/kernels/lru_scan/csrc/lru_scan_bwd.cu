// LRU scan backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the reference's analytic backward of the RG-LRU scan,
// src/repro/kernels/lru_scan/ops.py, `_scan_bwd` (:36), which runs the
// forward Pallas kernel once more on reversed time with elementwise work
// around it. For the forward h_t = a_t * h_{t-1} + b_t (y_t = h_t, h_last
// = y_{S-1}, h_{-1} = h0 or 0) and the cotangents gy (of y) and gh_last:
//
//   c_t   = gy_t (t < S-1),   c_{S-1} = gy_{S-1} + gh_last          (fp32)
//   lam_{S-1} = c_{S-1},      lam_t = a_{t+1} * lam_{t+1} + c_t     (fp32)
//   da_t  = lam_t * y_{t-1}   (y_{-1} = h0, or 0)  in a's dtype
//   db_t  = lam_t                                  in b's dtype
//   dh0   = a_0 * lam_0                            fp32, when h0 was given
//
// One pass over time, walking backwards: gy, a and y are read once, da and
// db written once.
//
// What bounds it on an H100 SXM (3.35 TB/s). At RecurrentGemma-9B's
// training shape, B=4, S=512, D=4096, fp32: bytes = gy + a + y + da + db +
// h0 + gh_last + dh0 = 5 * 33.55 MB + 3 * 65.5 KB = 168.0 MB -> 50.1 us;
// operations are 3 per element (the multiply-add and the da product), 25
// MFLOP, nothing. So the bound is the bytes.
//
// The TMA kernel (`lru_scan_bwd_tma`) is the forward's ring (lru_scan.cu)
// run from the last tile to the first. One block owns one batch row and
// kChannels = 128 channels; one producer thread keeps TMA loads of
// [kSteps = 32 steps x 128 channels] tiles of gy, a and y in flight in a
// ring of kStages = 3 stages, 48 KB of loads a stage in fp32 (144 KB an SM
// in flight, several times what Little's law asks of ~26 GB/s an SM).
// 128 consumer threads, one per channel, keep lam in a register and walk
// each tile's steps backwards. The two off-by-one operands:
//   - a_{t+1} is the a read one step before in the walk, carried in a
//     register (across tiles too);
//   - y_{t-1}: tile j's y is loaded one step early, rows 32j-1 .. 32j+30,
//     so that step t finds y_{t-1} in its own row. Tile 0's box starts at
//     row -1, which TMA fills with zeros; the consumer takes h0 (or 0)
//     there instead.
// Each consumer writes da_t over gy_t in the stage (both in a's dtype) and
// db_t into the stage's fourth tile; the producer sends both back with TMA
// stores and reloads the stage once the stores have read it. gh_last folds
// into c_{S-1} before anything else, as one fp32 add. TMA zero-fills loads
// past S or D and clips stores there; the walk starts at step S-1.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 0.063 ms at that
// shape, 80 % of the bound and the time of one PyTorch op with the same
// traffic (torch._fused_sgd_: three tensors in, two out), where the forward
// kernel on reversed time with elementwise passes around it took 0.310 ms.
// Other tile shapes are timed against this one by
// scripts/lru_scan_bwd_tiles.py (PERF.md §6).
//
// Shapes TMA refuses (a base or a row stride, D * element size, that is
// not a multiple of 16 bytes, for gy, a, y or db) take `lru_scan_bwd_thread`
// (one thread per channel, loads issued 16 steps at a time), so any S and
// D runs. The binding (kernel.py::use_tma_bwd) decides and passes `use_tma`.
//
// Numerics: one rounded fp32 multiply, then one rounded add, per step (no
// contraction), and da as one rounded fp32 product then one rounding to
// a's dtype: the order of the plain version (ref.py::lru_scan_bwd_ref) and
// of the reference, so the two agree bit for bit. The one difference
// allowed against the older route (the forward kernel on reversed time) is
// the sign of a zero at t = S-1, where that route computed +0 + c.

#include "tma_ring.cuh"

namespace {

// ------------------------------------------------ the per-thread kernel
constexpr int kThreads = 64;   // channels per block
constexpr int kGroup = 16;     // time steps whose loads are issued together

// grid (ceil(D / kThreads), B); thread -> channel d of batch row blockIdx.y.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_thread(const TA* __restrict__ a, const float* __restrict__ h0,
                    const TA* __restrict__ y, const TA* __restrict__ gy,
                    const float* __restrict__ gh_last, TA* __restrict__ da,
                    TB* __restrict__ db, float* __restrict__ dh0, int S,
                    int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)bi * S * D + d;
  const TA* ap = a + base;
  const TA* yp = y + base;
  const TA* gp = gy + base;
  TA* dap = da + base;
  TB* dbp = db + base;
  const float h_init = h0 != nullptr ? h0[(size_t)bi * D + d] : 0.f;
  auto prev_y = [&](int t) {
    return t > 0 ? to_float(yp[(size_t)(t - 1) * D]) : h_init;
  };

  // t = S-1: lam = c_{S-1}
  int t = S - 1;
  float lam = __fadd_rn(to_float(gp[(size_t)t * D]),
                        gh_last[(size_t)bi * D + d]);
  float a_next = to_float(ap[(size_t)t * D]);
  dap[(size_t)t * D] = from_float<TA>(__fmul_rn(lam, prev_y(t)));
  dbp[(size_t)t * D] = from_float<TB>(lam);
  // steps t0 + kGroup - 1 down to t0, loads first
  for (; t - kGroup >= 0; t -= kGroup) {
    const int t0 = t - kGroup;
    float av[kGroup], gv[kGroup], yv[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      av[u] = to_float(ap[(size_t)(t0 + u) * D]);
      gv[u] = to_float(gp[(size_t)(t0 + u) * D]);
      yv[u] = prev_y(t0 + u);
    }
#pragma unroll
    for (int u = kGroup - 1; u >= 0; --u) {
      lam = step(a_next, lam, gv[u]);
      a_next = av[u];
      dap[(size_t)(t0 + u) * D] = from_float<TA>(__fmul_rn(lam, yv[u]));
      dbp[(size_t)(t0 + u) * D] = from_float<TB>(lam);
    }
  }
  for (--t; t >= 0; --t) {
    lam = step(a_next, lam, to_float(gp[(size_t)t * D]));
    a_next = to_float(ap[(size_t)t * D]);
    dap[(size_t)t * D] = from_float<TA>(__fmul_rn(lam, prev_y(t)));
    dbp[(size_t)t * D] = from_float<TB>(lam);
  }
  // a_next is a_0 now, lam lam_0
  if (dh0 != nullptr) dh0[(size_t)bi * D + d] = __fmul_rn(a_next, lam);
}

// ------------------------------------------------ the TMA kernel
constexpr int kStages = 3;     // stages of gy, a, y (loaded) and db

template <typename TA, typename TB>
struct BwdRing {
  // a stage: gy (da written over it), a, y, then db
  static constexpr uint32_t kTileBytes = kSteps * kChannels * sizeof(TA);
  static constexpr uint32_t kLoadBytes = 3 * kTileBytes;
  static constexpr uint32_t kStageBytes =
      kLoadBytes + kSteps * kChannels * sizeof(TB);
  // the stages, then a full and a done mbarrier per stage; 128 B of slack
  // to align the base
  static constexpr size_t kSmem = kStages * kStageBytes + 16 * kStages + 128;
  static_assert(kSmem <= 227 * 1024, "the ring fits an SM's shared memory");
};

// grid (ceil(D / kChannels), B), kChannels + 32 threads: threads
// 0..kChannels-1 each own channel d0 + threadIdx.x; thread kChannels (the
// first of the last warp) is the producer. The k-th tile of the walk is
// tile j = n_tiles-1-k (steps 32j..32j+31) and sits in stage k % kStages:
// `full` completes when its three loads land, `done` when every consumer
// has written its da and db.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kChannels + 32)
lru_scan_bwd_tma(const __grid_constant__ CUtensorMap map_gy,
                 const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_y,
                 const __grid_constant__ CUtensorMap map_da,
                 const __grid_constant__ CUtensorMap map_db,
                 const float* __restrict__ h0,
                 const float* __restrict__ gh_last, float* __restrict__ dh0,
                 int S, int D) {
  using R = BwdRing<TA, TB>;
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
    auto load = [&](int k) {
      const int s = k % kStages, t0 = (n_tiles - 1 - k) * kSteps;
      const uint32_t dst = ring + s * R::kStageBytes;
      mbar_expect_tx(full + 8 * s, R::kLoadBytes);
      tma_load(dst, &map_gy, full + 8 * s, d0, t0, bi);
      tma_load(dst + R::kTileBytes, &map_a, full + 8 * s, d0, t0, bi);
      // y one step early: row t of the tile holds y_{t-1}
      tma_load(dst + 2 * R::kTileBytes, &map_y, full + 8 * s, d0, t0 - 1,
               bi);
    };
    for (int k = 0; k < kStages && k < n_tiles; ++k) load(k);
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % kStages, t0 = (n_tiles - 1 - k) * kSteps;
      const uint32_t src = ring + s * R::kStageBytes;
      mbar_wait(done + 8 * s, (k / kStages) & 1);
      tma_store(&map_da, src, d0, t0, bi);
      tma_store(&map_db, src + R::kLoadBytes, d0, t0, bi);
      if (k + kStages < n_tiles) {
        // the stage is reloaded once the stores have read it
        stores_read();
        load(k + kStages);
      }
    }
    stores_done();
    return;
  }

  const int d = d0 + tid;
  const size_t row = (size_t)bi * D + d;
  const float h_init = (h0 != nullptr && d < D) ? h0[row] : 0.f;
  float lam = 0.f, a_next = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kStages, j = n_tiles - 1 - k;
    uint8_t* stage = smem + s * R::kStageBytes;
    TA* gt = reinterpret_cast<TA*>(stage) + tid;  // gy, then da
    const TA* at = reinterpret_cast<const TA*>(stage + R::kTileBytes) + tid;
    const TA* yt =
        reinterpret_cast<const TA*>(stage + 2 * R::kTileBytes) + tid;
    TB* bt = reinterpret_cast<TB*>(stage + R::kLoadBytes) + tid;
    mbar_wait(full + 8 * s, (k / kStages) & 1);
    // y_{t-1} at row u; tile 0's row 0 is y_{-1} = h0 (the load's fill)
    auto prev_y = [&](int u) {
      return (j == 0 && u == 0) ? h_init : to_float(yt[u * kChannels]);
    };
    auto put = [&](int u) {
      gt[u * kChannels] = from_float<TA>(__fmul_rn(lam, prev_y(u)));
      bt[u * kChannels] = from_float<TB>(lam);
    };
    int u = min(kSteps, S - j * kSteps) - 1;
    if (k == 0) {
      // t = S-1: lam = c_{S-1} = gy_{S-1} + gh_last
      lam = __fadd_rn(to_float(gt[u * kChannels]),
                      d < D ? gh_last[row] : 0.f);
      a_next = to_float(at[u * kChannels]);
      put(u);
      for (--u; u >= 0; --u) {
        lam = step(a_next, lam, to_float(gt[u * kChannels]));
        a_next = to_float(at[u * kChannels]);
        put(u);
      }
    } else {
#pragma unroll
      for (u = kSteps - 1; u >= 0; --u) {
        lam = step(a_next, lam, to_float(gt[u * kChannels]));
        a_next = to_float(at[u * kChannels]);
        put(u);
      }
    }
    release_stage(done + 8 * s);
  }
  // a_next is a_0 now, lam lam_0
  if (dh0 != nullptr && d < D) dh0[row] = __fmul_rn(a_next, lam);
}

// ------------------------------------------------ host side
template <typename TA, typename TB>
cudaError_t allow_ring_smem() {
  static std::atomic<uint64_t> raised{0};
  return allow_smem(lru_scan_bwd_tma<TA, TB>, BwdRing<TA, TB>::kSmem, raised);
}

template <typename TA, typename TB>
int launch(const void* a, const float* h0, const void* y, const void* gy,
           const float* gh_last, void* da, void* db, float* dh0, int B,
           int S, int D, int use_tma, cudaStream_t stream) {
  if (!use_tma) {
    const dim3 grid((D + kThreads - 1) / kThreads, B);
    lru_scan_bwd_thread<TA, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const TA*>(a), h0, static_cast<const TA*>(y),
        static_cast<const TA*>(gy), gh_last, static_cast<TA*>(da),
        static_cast<TB*>(db), dh0, S, D);
    return (int)cudaGetLastError();
  }
  CUtensorMap mgy, ma, my, mda, mdb;
  int err = make_map<TA>(&mgy, gy, B, S, D);
  if (err == 0) err = make_map<TA>(&ma, a, B, S, D);
  if (err == 0) err = make_map<TA>(&my, y, B, S, D);
  if (err == 0) err = make_map<TA>(&mda, da, B, S, D);
  if (err == 0) err = make_map<TB>(&mdb, db, B, S, D);
  if (err == 0) err = (int)allow_ring_smem<TA, TB>();
  if (err != 0) return err;
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  lru_scan_bwd_tma<TA, TB>
      <<<grid, kChannels + 32, BwdRing<TA, TB>::kSmem, stream>>>(
          mgy, ma, my, mda, mdb, h0, gh_last, dh0, S, D);
  return (int)cudaGetLastError();
}

template <typename TA>
int dispatch_b(const void* a, const float* h0, const void* y, const void* gy,
               const float* gh_last, void* da, void* db, float* dh0, int B,
               int S, int D, int b_dtype, int use_tma, cudaStream_t stream) {
  if (b_dtype == 0)
    return launch<TA, float>(a, h0, y, gy, gh_last, da, db, dh0, B, S, D,
                             use_tma, stream);
  if (b_dtype == 1)
    return launch<TA, __nv_bfloat16>(a, h0, y, gy, gh_last, da, db, dh0, B,
                                     S, D, use_tma, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, y, gy, da: contiguous (B, S, D) in a_dtype; db: (B, S, D) in b_dtype;
// h0, gh_last, dh0: (B, D) fp32, h0 and dh0 NULL together or not (the
// forward had no h0: y_{-1} = 0 and no dh0). a_dtype, b_dtype: 0 = float32,
// 1 = bfloat16. use_tma: 1 runs the TMA kernel (16-byte aligned bases and
// row strides), 0 the per-thread kernel (any shape). Returns 0 on success,
// else a cudaError_t or one of the TMA path's negative codes; the caller
// raises with repro_cuda_error_string's text.
extern "C" int repro_lru_scan_bwd(const void* a, const void* h0,
                                  const void* y, const void* gy,
                                  const void* gh_last, void* da, void* db,
                                  void* dh0, int B, int S, int D, int a_dtype,
                                  int b_dtype, int use_tma, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 || (h0 == nullptr) !=
      (dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  const float* ghl = static_cast<const float*>(gh_last);
  float* dh0f = static_cast<float*>(dh0);
  if (a_dtype == 0)
    return dispatch_b<float>(a, h0f, y, gy, ghl, da, db, dh0f, B, S, D,
                             b_dtype, use_tma, st);
  if (a_dtype == 1)
    return dispatch_b<__nv_bfloat16>(a, h0f, y, gy, ghl, da, db, dh0f, B, S,
                                     D, b_dtype, use_tma, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return error_string(err,
                      "TMA: cuTensorMapEncodeTiled refused a tensor map of "
                      "gy, a, y, da or db");
}
