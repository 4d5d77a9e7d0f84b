// Temporal-masking scan of the psychoacoustic model.
//
// Replaces the `lax.scan` of flo_tpu/ops/psycho.py:126-133 (inside the XLA
// program `smr`): along the hop axis of in [R, T, 25] float32 (dB values),
//   thr[t] = max(in[t], thr[t - 1] * 0.7f),  thr[-1] = 0,
// one float32 multiply and one maximum a step, so there is nothing to fuse
// into a multiply-add and the result has the bits of the plain version,
// flo_torch/ops/psycho.py `temporal_mask_plain` (a Python loop of T steps of
// small ops). NaN propagates as torch.maximum has it (fmaxf alone would drop
// it): a NaN input gives NaN from there to the lane's end.
//
// What bounds it on the card: by bytes it is nothing (2 * R * T * 25 * 4, a
// few microseconds at 16 lanes of 2,585 hops). What held the first kernel (a
// block a lane, one chain of T steps a band) was the chain, T dependent steps
// of a multiply and a maximum, and the few blocks that moved the data.
//
// What the design does about it: the chain need not be T long, and the lane
// need not be one block's.
//  - Write g(x) = fl(0.7f * x). g is monotone on non-NaN floats and so is the
//    step f_t(p) = max(in[t], g(p)). If the true thr[s - 1] lies between a
//    lower start lo and an upper start up, the two chains walked from s stay
//    around the true one, and where they meet (the same bits) the true one is
//    there too, for good. So a block owns a chunk of kChunk hops of a lane
//    and finds its carry by walking both chains over a window before the
//    chunk: first kNear hops; if they have not met, kWarm hops; if not then
//    (an infinity behind, or a start over about 1e4), one chain from the
//    lane's first hop, from global memory, slow and exact. On music-like
//    input the near window meets; after a loud hop the decay reaches the
//    float32 floor (g of the smallest denormal is itself: a positive value
//    never dies) within kWarm hops.
//  - The starts come from a first small kernel, `facts_kernel`: for every
//    block of 32 hops and band, the largest input (NaN if it holds one). No
//    thr exceeds the largest input behind it (or 0), so that is `up`; `lo` is
//    +0 where nothing behind is positive (thr is then exactly +0) and the
//    smallest denormal where something is; a NaN behind makes the band NaN.
//  - R * ceil(T / kChunk) blocks move the data, each its chunk and window
//    with every load in flight at once (4-byte cp.async into shared memory),
//    and 25 threads of a block walk at most kNear + kChunk steps in the usual
//    case: 32 hops' inputs into registers, the steps, 32 results back, so no
//    shared-memory access lies between two steps.
//  - NaN is kept off the chain: a product or a maximum of non-NaN floats is
//    never NaN, so a NaN comes from the input alone and lasts. A flag a chain
//    remembers it and the stored value is NaN from there on, while the chain
//    goes on with fmaxf, which passes the other operand.
// csrc/probes/scan_designs.cu has the designs tried (the first kernel's and
// this one's chunk sizes) and design_search.py times them.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBands = 25;
constexpr int kThreads = 256;
constexpr int kFact = 32;    // hops a fact covers, and a group of the walk
constexpr int kChunk = 128;  // hops a block owns
constexpr int kNear = 32;    // first window
constexpr int kWarm = 320;   // second window
constexpr int kParts = kThreads / kBands;  // threads a band that reduce the facts
constexpr float kDecay = 0.7f;

static_assert(kBands <= 32, "the chains are walked by one warp");
static_assert(kChunk % kFact == 0 && kNear % kFact == 0 && kWarm % kFact == 0 && kNear <= kWarm,
              "windows and chunks are whole groups");
static_assert((kWarm + kChunk) * kBands * 4 + (2 * kParts + 2) * kBands * 4 + 64 <= 48 * 1024,
              "static shared memory");

// in [R, T, 25] -> facts [R, ceil(T / 32), 25]: a block of 32 hops' largest
// input a band, NaN if it holds one. Four fact blocks a CTA.
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

// Both chains over hops [from, to) of the window in shared memory (whole
// groups of 32); hop t of the lane is at s[(t - origin) * 25 + band].
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

// The starts of the two chains at a window that begins behind `hist`, the
// largest input before it (NaN if there is one).
__device__ __forceinline__ void starts(float hist, float& lo, float& up, bool& nan) {
  nan = hist != hist;
  const bool positive = hist > 0.0f;
  lo = positive ? __int_as_float(1) : 0.0f;
  up = positive ? hist : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
temporal_mask_kernel(const float* __restrict__ in, const float* __restrict__ facts,
                     float* __restrict__ out, int64_t T, int64_t nblk) {
  __shared__ float s[(kWarm + kChunk) * kBands];
  __shared__ float s_part[2][kParts][kBands];
  __shared__ float s_hist[2][kBands];
  __shared__ int s_retry;

  const int tid = threadIdx.x;
  const int64_t lane = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t t1 = t0 + kChunk < T ? t0 + kChunk : T;
  const int64_t origin = t0 - kWarm;                 // hop of s[0], may be negative
  const int64_t near0 = t0 > kNear ? t0 - kNear : 0;  // the windows' first hops
  const int64_t warm0 = t0 > kWarm ? t0 - kWarm : 0;
  const float* src = in + lane * T * kBands;
  float* dst = out + lane * T * kBands;

  // The chunk and the near window, every load in flight at once.
  {
    float* to = s + (near0 - origin) * kBands;
    const float* from = src + near0 * kBands;
    const int count = static_cast<int>(t1 - near0) * kBands;
    for (int i = tid; i < count; i += kThreads) __pipeline_memcpy_async(to + i, from + i, 4);
    __pipeline_commit();
  }
  if (tid == 0) s_retry = 0;

  // Meanwhile the largest input before each window, from the facts.
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

  // The carry: both chains over the near window.
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

  if (s_retry) {  // the whole block: the rest of the warm window
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
        // Not met within the warm window: one chain from the lane's start.
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

  // The chunk, in place in shared memory. Hops past the lane's end hold
  // whatever the memory held; they come after every stored hop.
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

}  // namespace

// Hops a fact covers: the wrapper sizes `facts` [R, ceil(T / 32), 25] by it.
extern "C" int flo_temporal_mask_fact_hops() { return kFact; }
extern "C" int flo_temporal_mask_chunk_hops() { return kChunk; }
extern "C" int flo_temporal_mask_warm_hops() { return kWarm; }

// in, out [R, T, 25] float32, contiguous, distinct; facts [R, ceil(T / 32),
// 25] float32 scratch, written here. Launches both kernels on `stream`;
// returns cudaGetLastError().
extern "C" int flo_temporal_mask(const void* in, void* facts, void* out, int64_t R, int64_t T,
                                 void* stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblk = (T + kFact - 1) / kFact;
  const dim3 fgrid(static_cast<unsigned int>((nblk + 3) / 4), static_cast<unsigned int>(R));
  facts_kernel<<<fgrid, 128, 0, st>>>(static_cast<const float*>(in), static_cast<float*>(facts), T,
                                      nblk);
  const dim3 grid(static_cast<unsigned int>((T + kChunk - 1) / kChunk),
                  static_cast<unsigned int>(R));
  temporal_mask_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(in),
                                                  static_cast<const float*>(facts),
                                                  static_cast<float*>(out), T, nblk);
  return static_cast<int>(cudaGetLastError());
}
