// The design search of the temporal-masking scan (csrc/temporal_mask.cu):
// every design computes thr[t] = max(in[t], thr[t - 1] * 0.7f) along the hop
// axis of in [R, T, 25] float32 with the plain loop's bits; the cuts leave a
// part out and are only timed. Built and run by design_search.py (`scan`).
//
//  0  a thread a chain (lane, band): the next 32 hops' inputs in flight in
//     registers while it walks the 32 it holds; torch.maximum's NaN rule as
//     two compares and two selects on the chain
//  1  a block a lane: tiles of 128 hops through shared memory, coalesced,
//     the next tile's loads in flight; 25 threads walk the chain from one
//     shared array into another, 16 hops unrolled; NaN as a sticky flag off
//     the chain
//  2  1 with the chain's 128 inputs of a tile taken into registers first and
//     its 128 results stored after
//  3  1 with tiles of 32 hops and one warp a block (the barriers cost
//     nothing, the loads ahead are a quarter as far)
//  4  cut: 1 without the chain (the tiles' way in and out alone)
//  5  cut: 1 without the global loads and stores after the first tile (the
//     chain and the barriers alone)
//
// The segmented scan (exact: a block a chunk of a lane; the carry found by
// walking a lower and an upper chain over a window before the chunk until
// they meet, first 32 hops, then kWarm, then from the lane's start; the
// chains' starts from a first kernel's facts, a block of 32 hops' largest
// input a band; see csrc/temporal_mask.cu):
//  6  chunks of 32 hops, warm window 384, 256 threads
//  7  chunks of 64 hops, warm window 384, 256 threads
//  8  chunks of 128 hops, warm window 320, 256 threads
//  9  chunks of 64 hops, warm window 384, 128 threads
// 10  cut: 7's facts kernel alone
// 11  cut: 7's scan kernel alone, on the facts a run before it left

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBands = 25;
constexpr float kDecay = 0.7f;
constexpr int kDesigns = 12;

__device__ __forceinline__ float maximum_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

constexpr int kChunk = 32;

__global__ void __launch_bounds__(32)
chain_a_thread(const float* __restrict__ in, float* __restrict__ out, int64_t chains, int64_t T) {
  const int64_t chain = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x;
  if (chain >= chains) return;
  const int64_t base = (chain / kBands) * T * kBands + chain % kBands;
  const float* src = in + base;
  float* dst = out + base;
  float cur[kChunk], nxt[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) cur[u] = u < T ? __ldg(src + u * kBands) : 0.0f;
  float prev = 0.0f;
  for (int64_t t0 = 0; t0 < T; t0 += kChunk) {
    const int64_t ahead = t0 + kChunk;
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      nxt[u] = ahead + u < T ? __ldg(src + (ahead + u) * kBands) : 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (t0 + u < T) {
        prev = maximum_nan(cur[u], __fmul_rn(prev, kDecay));
        dst[(t0 + u) * kBands] = prev;
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) cur[u] = nxt[u];
  }
}

// kHops a tile, and as many threads (a thread then moves 25 floats a tile);
// kFromRegs: design 2; kChain, kMove: the cuts.
template <int kHops, bool kFromRegs, bool kChain, bool kMove>
__global__ void __launch_bounds__(kHops)
tile_kernel(const float* __restrict__ in, float* __restrict__ out, int64_t T) {
  constexpr int kThreads = kHops;
  constexpr int kTile = kHops * kBands;
  constexpr int kPer = kBands;
  __shared__ float s_in[kTile];
  __shared__ float s_out[kTile];

  const int tid = threadIdx.x;
  const int64_t total = T * kBands;
  const float* src = in + static_cast<int64_t>(blockIdx.x) * total;
  float* dst = out + static_cast<int64_t>(blockIdx.x) * total;

  float regs[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int64_t g = m * kThreads + tid;
    s_in[m * kThreads + tid] = g < total ? __ldg(src + g) : 0.0f;
    if (!kChain) s_out[m * kThreads + tid] = 0.0f;
  }
  __syncthreads();

  float prev = 0.0f;
  bool seen_nan = false;
  for (int64_t base = 0; base < total; base += kTile) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int64_t g = base + kTile + m * kThreads + tid;
      regs[m] = kMove && g < total ? __ldg(src + g) : 0.0f;
    }
    if (kChain && tid < kBands) {
      if constexpr (kFromRegs) {
        float v[kHops];
#pragma unroll
        for (int t = 0; t < kHops; ++t) v[t] = s_in[t * kBands + tid];
#pragma unroll
        for (int t = 0; t < kHops; ++t) {
          seen_nan |= v[t] != v[t];
          prev = fmaxf(v[t], __fmul_rn(prev, kDecay));
          v[t] = seen_nan ? CUDART_NAN_F : prev;
        }
#pragma unroll
        for (int t = 0; t < kHops; ++t) s_out[t * kBands + tid] = v[t];
      } else {
#pragma unroll 16
        for (int t = 0; t < kHops; ++t) {
          const float cur = s_in[t * kBands + tid];
          seen_nan |= cur != cur;
          prev = fmaxf(cur, __fmul_rn(prev, kDecay));
          s_out[t * kBands + tid] = seen_nan ? CUDART_NAN_F : prev;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = m * kThreads + tid;
      if (kMove || base == 0) {
        if (base + i < total) dst[base + i] = s_out[i];
      }
      s_in[i] = regs[m];
    }
    __syncthreads();
  }
}


// ---------------- the segmented scan ----------------

constexpr int kFact = 32;  // hops a fact covers, and a group of the walk
constexpr int kNear = 32;  // first window

__global__ void __launch_bounds__(128)
facts_kernel(const float* __restrict__ in, float* __restrict__ facts, int64_t T, int64_t nblk) {
  const int tid = threadIdx.x;
  if (tid >= 4 * kBands) return;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * 4 + tid / kBands;
  const int b = tid % kBands;
  if (blk >= nblk) return;
  const int64_t lane = blockIdx.y;
  const float* src = in + (lane * T + blk * kFact) * kBands + b;
  const int64_t left = T - blk * kFact;
  float v[kFact];
#pragma unroll
  for (int u = 0; u < kFact; ++u) v[u] = u < left ? __ldg(src + u * kBands) : -CUDART_INF_F;
  float m = -CUDART_INF_F;
  bool nan = false;
#pragma unroll
  for (int u = 0; u < kFact; ++u) {
    nan |= v[u] != v[u];
    m = fmaxf(m, v[u]);
  }
  facts[(lane * nblk + blk) * kBands + b] = nan ? CUDART_NAN_F : m;
}

__device__ __forceinline__ void walk_window(const float* s, int64_t origin, int64_t from,
                                            int64_t to, int band, float& lo, float& up,
                                            bool& nan) {
  for (int64_t h = from; h < to; h += kFact) {
    float v[kFact];
    const float* p = s + (h - origin) * kBands + band;
#pragma unroll
    for (int u = 0; u < kFact; ++u) v[u] = p[u * kBands];
#pragma unroll
    for (int u = 0; u < kFact; ++u) {
      nan |= v[u] != v[u];
      lo = fmaxf(v[u], __fmul_rn(lo, kDecay));
      up = fmaxf(v[u], __fmul_rn(up, kDecay));
    }
  }
}

__device__ __forceinline__ void starts(float hist, float& lo, float& up, bool& nan) {
  nan = hist != hist;
  const bool positive = hist > 0.0f;
  lo = positive ? __int_as_float(1) : 0.0f;
  up = positive ? hist : 0.0f;
}

template <int kChunk, int kWarm, int kThreads>
__global__ void __launch_bounds__(kThreads)
segmented_kernel(const float* __restrict__ in, const float* __restrict__ facts,
                 float* __restrict__ out, int64_t T, int64_t nblk) {
  constexpr int kParts = kThreads / kBands;
  static_assert((kWarm + kChunk) * kBands * 4 + (2 * kParts + 2) * kBands * 4 + 64 <= 48 * 1024,
                "static shared memory");
  __shared__ float s[(kWarm + kChunk) * kBands];
  __shared__ float s_part[2][kParts][kBands];
  __shared__ float s_hist[2][kBands];
  __shared__ int s_retry;

  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t t1 = t0 + kChunk < T ? t0 + kChunk : T;
  const int64_t origin = t0 - kWarm;
  const int64_t near0 = t0 > kNear ? t0 - kNear : 0;
  const int64_t warm0 = t0 > kWarm ? t0 - kWarm : 0;
  const float* src = in + lane * T * kBands;
  float* dst = out + lane * T * kBands;

  {
    float* to = s + (near0 - origin) * kBands;
    const float* from = src + near0 * kBands;
    const int count = static_cast<int>(t1 - near0) * kBands;
    for (int i = tid; i < count; i += kThreads) __pipeline_memcpy_async(to + i, from + i, 4);
    __pipeline_commit();
  }
  if (tid == 0) s_retry = 0;

  if (tid < kParts * kBands) {
    const int part = tid / kBands, b = tid % kBands;
    const int64_t nb_warm = warm0 / kFact, nb_near = near0 / kFact;
    const float* f = facts + lane * nblk * kBands + b;
    float m_warm = -CUDART_INF_F, m_near = -CUDART_INF_F;
    bool nan_warm = false, nan_near = false;
    // Eight facts' loads in flight at once: a load's latency each would be
    // most of the kernel.
    for (int64_t j0 = part; j0 < nb_near; j0 += 8 * kParts) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int64_t j = j0 + u * kParts;
        v[u] = j < nb_near ? __ldg(f + j * kBands) : -CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool before_warm = j0 + u * kParts < nb_warm;
        nan_near |= v[u] != v[u];
        m_near = fmaxf(m_near, v[u]);
        nan_warm |= before_warm && v[u] != v[u];
        m_warm = before_warm ? fmaxf(m_warm, v[u]) : m_warm;
      }
    }
    s_part[0][part][b] = nan_near ? CUDART_NAN_F : m_near;
    s_part[1][part][b] = nan_warm ? CUDART_NAN_F : m_warm;
  }
  __syncthreads();
  if (tid < 2 * kBands) {
    const int w = tid / kBands, b = tid % kBands;
    float m = -CUDART_INF_F;
    bool nan = false;
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const float v = s_part[w][p][b];
      nan |= v != v;
      m = fmaxf(m, v);
    }
    s_hist[w][b] = nan ? CUDART_NAN_F : m;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  float lo = 0.0f, up = 0.0f;
  bool nan = false;
  if (tid < 32) {
    bool met = true;
    if (tid < kBands) {
      if (near0 > 0) starts(s_hist[0][tid], lo, up, nan);
      walk_window(s, origin, near0, t0, tid, lo, up, nan);
      met = nan || __float_as_int(lo) == __float_as_int(up);
    }
    if (!__all_sync(0xffffffffu, met) && tid == 0) s_retry = 1;
  }
  __syncthreads();

  if (s_retry) {
    float* to = s + (warm0 - origin) * kBands;
    const float* from = src + warm0 * kBands;
    const int count = static_cast<int>(near0 - warm0) * kBands;
    for (int i = tid; i < count; i += kThreads) __pipeline_memcpy_async(to + i, from + i, 4);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (tid < kBands && !(nan || __float_as_int(lo) == __float_as_int(up))) {
      lo = up = 0.0f;
      nan = false;
      if (warm0 > 0) starts(s_hist[1][tid], lo, up, nan);
      walk_window(s, origin, warm0, t0, tid, lo, up, nan);
      if (!(nan || __float_as_int(lo) == __float_as_int(up))) {
        float prev = 0.0f;
#pragma unroll 8
        for (int64_t t = 0; t < warm0; ++t) {
          const float v = __ldg(src + t * kBands + tid);
          nan |= v != v;
          prev = fmaxf(v, __fmul_rn(prev, kDecay));
        }
        lo = up = prev;
        walk_window(s, origin, warm0, t0, tid, lo, up, nan);
      }
    }
  }

  if (tid < kBands) {
    float prev = lo;
    for (int64_t h = t0; h < t1; h += kFact) {
      float v[kFact];
      float* p = s + (h - origin) * kBands + tid;
#pragma unroll
      for (int u = 0; u < kFact; ++u) v[u] = p[u * kBands];
#pragma unroll
      for (int u = 0; u < kFact; ++u) {
        nan |= v[u] != v[u];
        prev = fmaxf(v[u], __fmul_rn(prev, kDecay));
        v[u] = nan ? CUDART_NAN_F : prev;
      }
#pragma unroll
      for (int u = 0; u < kFact; ++u) p[u * kBands] = v[u];
    }
  }
  __syncthreads();
  {
    const float* from = s + kWarm * kBands;
    float* to = dst + t0 * kBands;
    const int count = static_cast<int>(t1 - t0) * kBands;
    for (int i = tid; i < count; i += kThreads) to[i] = from[i];
  }
}

template <int kChunk, int kWarm, int kThreads>
void launch_segmented(const float* in, float* facts, float* out, int64_t R, int64_t T,
                      bool with_facts, bool with_scan, cudaStream_t st) {
  const int64_t nblk = (T + kFact - 1) / kFact;
  if (with_facts) {
    const dim3 fgrid(static_cast<unsigned int>((nblk + 3) / 4), static_cast<unsigned int>(R));
    facts_kernel<<<fgrid, 128, 0, st>>>(in, facts, T, nblk);
  }
  if (with_scan) {
    const dim3 grid(static_cast<unsigned int>((T + kChunk - 1) / kChunk),
                    static_cast<unsigned int>(R));
    segmented_kernel<kChunk, kWarm, kThreads><<<grid, kThreads, 0, st>>>(in, facts, out, T, nblk);
  }
}

}  // namespace

extern "C" int flo_scan_designs() { return kDesigns; }

// in, out [R, T, 25] float32, contiguous, distinct; scratch [R, ceil(T / 32),
// 25] float32 (the segmented designs' facts). Launches `design` on `stream`;
// returns cudaGetLastError(), or -1 for an unknown design.
extern "C" int flo_scan_design(const void* in, void* out, void* scratch, int64_t R, int64_t T,
                               int32_t design, void* stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  float* f = static_cast<float*>(scratch);
  const unsigned int lanes = static_cast<unsigned int>(R);
  switch (design) {
    case 0: {
      const int64_t chains = R * kBands;
      chain_a_thread<<<static_cast<unsigned int>((chains + 31) / 32), 32, 0, st>>>(i, o, chains, T);
      break;
    }
    case 1: tile_kernel<128, false, true, true><<<lanes, 128, 0, st>>>(i, o, T); break;
    case 2: tile_kernel<128, true, true, true><<<lanes, 128, 0, st>>>(i, o, T); break;
    case 3: tile_kernel<32, false, true, true><<<lanes, 32, 0, st>>>(i, o, T); break;
    case 4: tile_kernel<128, false, false, true><<<lanes, 128, 0, st>>>(i, o, T); break;
    case 5: tile_kernel<128, false, true, false><<<lanes, 128, 0, st>>>(i, o, T); break;
    case 6: launch_segmented<32, 384, 256>(i, f, o, R, T, true, true, st); break;
    case 7: launch_segmented<64, 384, 256>(i, f, o, R, T, true, true, st); break;
    case 8: launch_segmented<128, 320, 256>(i, f, o, R, T, true, true, st); break;
    case 9: launch_segmented<64, 384, 128>(i, f, o, R, T, true, true, st); break;
    case 10: launch_segmented<64, 384, 256>(i, f, o, R, T, true, false, st); break;
    case 11: launch_segmented<64, 384, 256>(i, f, o, R, T, false, true, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
