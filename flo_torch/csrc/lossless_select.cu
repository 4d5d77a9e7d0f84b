// Lossless candidate search: every candidate predictor of a lane, its exact
// Rice size, the strict-< winner and the winner's residual row.
//
// Replaces the XLA program flo_tpu/ops/select.py:187 `encode_select_step`
// (with `residuals_one` :35, `rice_k_exact` :76 and `candidate_size` :166).
// Bit-identical to the plain version, flo_torch/ops/select.py
// `encode_select_step`. Per lane of n valid samples and per candidate c
// (c = 0 is raw, size 2n; then fixed and LPC predictors in the reference's
// evaluation order):
//
//     r[i] = wrap32(s[i] - wrap32((sum_j coef[j] * s[i-1-j]) >> shift))
//
// with the warm-up: for i < order an LPC candidate emits s[i] and a fixed
// one predicts with FIXED[min(i, 4)] (shift 0). Then max|r| (wrapping at
// i32::MIN; an LPC candidate is out above 1e6 or when cand_ok is false),
// k = clamp(max(min_k, bitlen(mean|r|)), 0, 15) (0 when max|r| == 0), and
// size = (sum min(u >> k, 255) + n * (1 + k) + 7) >> 3 with u the zigzag.
// A candidate wins only with a size strictly below the best so far. All
// statistics are exact integers: the TPU program steered the choice with
// float32 approximations, this kernel does not.
//
// What bounds it on the card: integer arithmetic. A sample costs 12
// 32x32->64-bit multiply-adds per candidate, up to 13 candidates, and the
// residuals are computed three times (statistics, sizes at k, the winner's
// row) because they are never stored: 960 x 44,100 samples read from L2 are
// cheap next to that.
//
// What the design does about it (a simple first design; staging the lane in
// shared memory and tuning are later work):
//  - one block per lane; its threads take a strided set of samples, so a
//    warp's loads are coalesced rows of the lane-major input, which stays in
//    L1/L2 across the three passes;
//  - the lane's candidate table (coefficients, shifts, orders, flags) sits in
//    shared memory and is read as broadcast 16-byte loads;
//  - pass 1 loads the 12 lags once per sample and accumulates every
//    candidate's max|r| and sum|r| in registers (the candidate loop is
//    unrolled to kMaxCand); a warp-shuffle reduction and shared-memory
//    atomics combine the block, then one thread per candidate computes k;
//  - pass 2 accumulates sum min(u >> k, 255) the same way, then one thread
//    takes the strict-< argmin in order;
//  - pass 3 writes the winner's residual row (raw winners: the samples),
//    zero past n.
// The MAC is a native multiply summed in uint64, so it wraps like the plain
// version's int64 and is exact for every sum that fits in 64 bits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 12;     // flo_torch/ops/lpc.py MAX_ORDER
constexpr int kMaxCand = 16;  // raw + fixed 0..4 + LPC 5..12 = 14 at most
constexpr int kThreads = 256;
constexpr int32_t kMaxStable = 1000000;  // encoder.rs:269-271

// flo_torch/ops/lpc.py _FIXED_COEFFS: fixed predictors 0..4.
__constant__ int32_t kFixed[5][kTaps] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, -3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, -6, 4, -1, 0, 0, 0, 0, 0, 0, 0, 0},
};

struct SharedTable {
  int4 coef[kMaxCand][kTaps / 4];
  int shift[kMaxCand];
  int order[kMaxCand];
  int fixed[kMaxCand];
  int ok[kMaxCand];
  int k[kMaxCand];
  int max_wrap[kMaxCand];
  unsigned int max_uabs[kMaxCand];
  unsigned long long sum_abs[kMaxCand];
  unsigned long long sum_q[kMaxCand];
  int best;
};

__device__ __forceinline__ int bit_length(unsigned long long v) {
  return v == 0 ? 0 : 64 - __clzll(static_cast<long long>(v));
}

// Residual of candidate c at sample i, given s = s[i] and lag[j] = s[i-1-j]
// (0 before the lane's start).
__device__ __forceinline__ int32_t residual(const SharedTable& t, int c, int64_t i, int32_t s,
                                            const int32_t (&lag)[kTaps]) {
  uint64_t acc = 0;
  int shift = t.shift[c];
  if (i < t.order[c]) {
    if (!t.fixed[c]) return s;
    const int ramp = i < 4 ? static_cast<int>(i) : 4;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      acc += static_cast<uint64_t>(static_cast<int64_t>(kFixed[ramp][j]) * lag[j]);
    }
    shift = 0;
  } else {
#pragma unroll
    for (int q = 0; q < kTaps / 4; ++q) {
      const int4 c4 = t.coef[c][q];
      acc += static_cast<uint64_t>(static_cast<int64_t>(c4.x) * lag[4 * q + 0]);
      acc += static_cast<uint64_t>(static_cast<int64_t>(c4.y) * lag[4 * q + 1]);
      acc += static_cast<uint64_t>(static_cast<int64_t>(c4.z) * lag[4 * q + 2]);
      acc += static_cast<uint64_t>(static_cast<int64_t>(c4.w) * lag[4 * q + 3]);
    }
  }
  const uint32_t pred = static_cast<uint32_t>(static_cast<int64_t>(acc) >> shift);
  return static_cast<int32_t>(static_cast<uint32_t>(s) - pred);
}

__device__ __forceinline__ void load_lags(const int32_t* __restrict__ row, int64_t i,
                                          int32_t (&lag)[kTaps]) {
#pragma unroll
  for (int j = 0; j < kTaps; ++j) lag[j] = i - 1 - j >= 0 ? __ldg(row + i - 1 - j) : 0;
}

__device__ __forceinline__ uint32_t zigzag(int32_t r) {
  return (static_cast<uint32_t>(r) << 1) ^ static_cast<uint32_t>(r >> 31);
}

__device__ __forceinline__ uint32_t warp_max(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const int32_t* __restrict__ lanes, const int32_t* __restrict__ nvalid,
              const int32_t* __restrict__ coeffs_all, const int32_t* __restrict__ shifts_all,
              const int32_t* __restrict__ orders_all, const uint8_t* __restrict__ fixed_all,
              const uint8_t* __restrict__ cand_ok, uint32_t lpc_mask, int nc, int64_t S,
              int32_t* __restrict__ sel_out, int32_t* __restrict__ k_out,
              int32_t* __restrict__ size_out, int32_t* __restrict__ res_out,
              int32_t* __restrict__ win_coeffs, int32_t* __restrict__ win_shift) {
  __shared__ SharedTable t;
  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* row = lanes + lane * S;
  int64_t n = nvalid[lane];
  n = n < 0 ? 0 : (n > S ? S : n);

  if (tid < nc) {
    const int64_t base = lane * nc + tid;
    int* dst = reinterpret_cast<int*>(t.coef[tid]);
    for (int j = 0; j < kTaps; ++j) dst[j] = coeffs_all[base * kTaps + j];
    t.shift[tid] = shifts_all[base];
    t.order[tid] = orders_all[base];
    t.fixed[tid] = fixed_all[base];
    t.ok[tid] = cand_ok[base];
    t.max_wrap[tid] = 0;
    t.max_uabs[tid] = 0;
    t.sum_abs[tid] = 0;
    t.sum_q[tid] = 0;
  }
  __syncthreads();

  // Pass 1: max|r| (wrapping and unsigned) and sum|r| of every candidate.
  int max_wrap[kMaxCand];
  uint32_t max_uabs[kMaxCand];
  unsigned long long sum_abs[kMaxCand];
#pragma unroll
  for (int c = 0; c < kMaxCand; ++c) {
    max_wrap[c] = 0;
    max_uabs[c] = 0;
    sum_abs[c] = 0;
  }
  for (int64_t i = tid; i < n; i += kThreads) {
    const int32_t s = __ldg(row + i);
    int32_t lag[kTaps];
    load_lags(row, i, lag);
#pragma unroll
    for (int c = 1; c < kMaxCand; ++c) {
      if (c < nc) {
        const int32_t r = residual(t, c, i, s, lag);
        const uint32_t ua = r < 0 ? 0u - static_cast<uint32_t>(r) : static_cast<uint32_t>(r);
        // Rust's release .abs(): i32::MIN stays negative and never raises the max.
        max_wrap[c] = max(max_wrap[c], static_cast<int>(ua));
        max_uabs[c] = max(max_uabs[c], ua);
        sum_abs[c] += ua;
      }
    }
  }
#pragma unroll
  for (int c = 1; c < kMaxCand; ++c) {
    if (c < nc) {
      const int mw = warp_max(max_wrap[c]);
      const uint32_t mu = warp_max(max_uabs[c]);
      const unsigned long long sa = warp_sum(sum_abs[c]);
      if ((tid & 31) == 0) {
        atomicMax(&t.max_wrap[c], mw);
        atomicMax(&t.max_uabs[c], mu);
        atomicAdd(&t.sum_abs[c], sa);
      }
    }
  }
  __syncthreads();

  // Rice k per candidate (rice.rs:29-69), and which candidates may win.
  if (tid > 0 && tid < nc) {
    const unsigned long long mu = t.max_uabs[tid];
    const unsigned long long mean = t.sum_abs[tid] / static_cast<unsigned long long>(n > 0 ? n : 1);
    int min_k = 2 * mu > 255 ? bit_length(2 * mu) - 8 : 0;
    min_k = min_k < 0 ? 0 : min_k;
    int k = max(min_k, bit_length(mean));
    k = k > 15 ? 15 : k;
    t.k[tid] = mu == 0 ? 0 : k;
    const bool is_lpc = (lpc_mask >> tid) & 1u;
    t.ok[tid] = t.ok[tid] && (!is_lpc || t.max_wrap[tid] <= kMaxStable);
  }
  __syncthreads();

  // Pass 2: sum min(u >> k, 255) of every candidate that may win.
  uint32_t sum_q[kMaxCand];
#pragma unroll
  for (int c = 0; c < kMaxCand; ++c) sum_q[c] = 0;
  for (int64_t i = tid; i < n; i += kThreads) {
    const int32_t s = __ldg(row + i);
    int32_t lag[kTaps];
    load_lags(row, i, lag);
#pragma unroll
    for (int c = 1; c < kMaxCand; ++c) {
      if (c < nc && t.ok[c]) {
        const uint32_t q = zigzag(residual(t, c, i, s, lag)) >> t.k[c];
        sum_q[c] += q < 255u ? q : 255u;
      }
    }
  }
#pragma unroll
  for (int c = 1; c < kMaxCand; ++c) {
    if (c < nc && t.ok[c]) {
      const unsigned long long sq = warp_sum(static_cast<unsigned long long>(sum_q[c]));
      if ((tid & 31) == 0) atomicAdd(&t.sum_q[c], sq);
    }
  }
  __syncthreads();

  // Strict-< argmin in evaluation order; raw (size 2n) is the baseline.
  if (tid == 0) {
    int64_t best_size = 2 * n;
    int best = 0;
    for (int c = 1; c < nc; ++c) {
      if (!t.ok[c]) continue;
      const int64_t bits = static_cast<int64_t>(t.sum_q[c]) + n * (1 + t.k[c]);
      const int64_t size = (bits + 7) >> 3;
      if (size < best_size) {
        best_size = size;
        best = c;
      }
    }
    t.best = best;
    sel_out[lane] = best;
    k_out[lane] = best == 0 ? 0 : t.k[best];
    size_out[lane] = static_cast<int32_t>(best_size);
    win_shift[lane] = shifts_all[lane * nc + best];
  }
  __syncthreads();
  const int best = t.best;
  if (tid < kTaps) win_coeffs[lane * kTaps + tid] = coeffs_all[(lane * nc + best) * kTaps + tid];

  // Pass 3: the winner's residual row, zero past n.
  int32_t* out = res_out + lane * S;
  for (int64_t i = tid; i < S; i += kThreads) {
    int32_t v = 0;
    if (i < n) {
      const int32_t s = __ldg(row + i);
      if (best == 0) {
        v = s;
      } else {
        int32_t lag[kTaps];
        load_lags(row, i, lag);
        v = residual(t, best, i, s, lag);
      }
    }
    out[i] = v;
  }
}

}  // namespace

// lanes [L, S] int32 lane-major; nvalid [L] int32; coeffs_all [L, nc, 12]
// int32; shifts_all, orders_all [L, nc] int32; fixed_all, cand_ok [L, nc]
// bool (one byte each); lpc_mask bit c set where candidate c is LPC. Outputs
// sel, k, size [L] int32, residuals [L, S] int32, win_coeffs [L, 12] int32,
// win_shift [L] int32. All on the device, contiguous; 1 <= nc <= 16.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flo_lossless_select(const void* lanes, const void* nvalid, const void* coeffs_all,
                                   const void* shifts_all, const void* orders_all,
                                   const void* fixed_all, const void* cand_ok, uint32_t lpc_mask,
                                   int32_t nc, int64_t L, int64_t S, void* sel, void* k,
                                   void* size, void* residuals, void* win_coeffs,
                                   void* win_shift, void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  if (nc < 1 || nc > kMaxCand) return static_cast<int>(cudaErrorInvalidValue);
  select_kernel<<<static_cast<unsigned int>(L), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lanes), static_cast<const int32_t*>(nvalid),
      static_cast<const int32_t*>(coeffs_all), static_cast<const int32_t*>(shifts_all),
      static_cast<const int32_t*>(orders_all), static_cast<const uint8_t*>(fixed_all),
      static_cast<const uint8_t*>(cand_ok), lpc_mask, nc, S, static_cast<int32_t*>(sel),
      static_cast<int32_t*>(k), static_cast<int32_t*>(size), static_cast<int32_t*>(residuals),
      static_cast<int32_t*>(win_coeffs), static_cast<int32_t*>(win_shift));
  return static_cast<int>(cudaGetLastError());
}
