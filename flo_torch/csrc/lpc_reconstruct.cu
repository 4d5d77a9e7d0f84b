// Integer LPC / fixed-predictor reconstruction for the lossless decoder.
//
// Replaces the TPU kernel flo_tpu/ops/pallas_lpc.py `_kernel` (wrapped by
// `reconstruct_pallas`). Per lane, for i in [0, S):
//
//     s[i] = wrap32(r[i] + ((sum_j c_eff[j] * s[i-1-j]) >> shift))
//
// with the decoder's warm-up: while i < order, a fixed lane uses the ramp row
// FIXED[min(i, 4)] and an LPC lane uses zero coefficients. Bit-identical to
// the plain version, flo_torch/ops/lpc.py `reconstruct`.
//
// What bounds it on the card: neither bandwidth nor arithmetic throughput.
// Each step of a lane depends on the step before (MAC -> shift -> add -> next
// MAC), so a lane is a chain of S dependent steps, and the only parallelism
// is across lanes: 960 at the headline geometry, 30 warps for a 132-SM card,
// one warp per SM. A warp issues its instructions in order, so the time is
// S times one step's instructions (a few dozen: twelve 64-bit multiplies,
// their 64-bit adds, the shift, the add, a load and a store), each waiting
// on the latency of what it reads, with no other warp to fill the gaps.
//
// What the design does about it:
//  - one thread per lane, 32 lanes (one warp) per block, so the 960 lanes
//    spread over 30 SMs instead of queueing on a few;
//  - the 12-sample history lives in registers as a fully unrolled shift
//    register: a step touches no memory but its residual and its output;
//  - the MAC is a native 32x32->64 multiply summed in uint64 (wrapping, so an
//    overflowing sum of full-range products is still exact in the low 47 bits
//    that reach the output) instead of the TPU's 15-bit limbs;
//  - residuals and output are time-major ([S, L]), so a warp's 32 loads or
//    stores at step i are one coalesced 128-byte row, and the next chunk of
//    residuals is loaded while the current one is reconstructed, which keeps
//    the load latency off the chain;
//  - the 5x12 ramp table sits in __constant__ memory: all lanes of a warp
//    read the same row at the same step, which the constant cache broadcasts.
// Making a step shorter is later work (see PERF.md, open questions).
// The TPU kernel's [8, 128] lane tiles, 512-step time tiles and VMEM carry
// hand-off have no counterpart: the loop over time inside the thread takes
// the place of the TPU's sequential grid axis.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 12;   // flo_torch/ops/lpc.py MAX_ORDER
constexpr int kLanesPerBlock = 32;
constexpr int kChunk = 16;  // residuals per lane loaded ahead of use

// flo_torch/ops/lpc.py _FIXED_COEFFS: fixed predictors 0..4.
__constant__ int32_t kFixed[5][kTaps] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, -3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, -6, 4, -1, 0, 0, 0, 0, 0, 0, 0, 0},
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// One step: returns s[i] and pushes it into the history (hist[j] = s[i-1-j]).
__device__ __forceinline__ int32_t step(const int32_t (&c)[kTaps], int32_t (&hist)[kTaps],
                                        int shift, int32_t r) {
  // Oldest tap first, the newest sample's product last. The reverse order
  // measured 4.86 ms against this order's 3.57 ms at [960, 44100] on an
  // NVIDIA H100 80GB HBM3 at its 700 W power limit (PERF.md).
  uint64_t acc = 0;
#pragma unroll
  for (int j = kTaps - 1; j >= 0; --j) {
    acc += static_cast<uint64_t>(static_cast<int64_t>(c[j]) * hist[j]);
  }
  const uint32_t pred = static_cast<uint32_t>(static_cast<int64_t>(acc) >> shift);
  const int32_t s = static_cast<int32_t>(pred + static_cast<uint32_t>(r));
#pragma unroll
  for (int j = kTaps - 1; j > 0; --j) hist[j] = hist[j - 1];
  hist[0] = s;
  return s;
}

__global__ void __launch_bounds__(kLanesPerBlock)
lpc_reconstruct_kernel(const int32_t* __restrict__ res_t, const int32_t* __restrict__ coeffs,
                       const int32_t* __restrict__ shifts, const int32_t* __restrict__ orders,
                       const uint8_t* __restrict__ is_fixed, int32_t* __restrict__ out_t,
                       int64_t L, int64_t S) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanesPerBlock + threadIdx.x;
  if (lane >= L) return;

  int32_t c[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) c[j] = coeffs[lane * kTaps + j];
  const int shift = shifts[lane];
  const int64_t order = orders[lane];
  const bool fixed = is_fixed[lane] != 0;

  int32_t hist[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) hist[j] = 0;

  // Head: every lane runs the warm-up-aware step for the first max(order, 12)
  // samples, so lanes of real streams (order <= 12) all leave it at the same
  // step and stay in step, and coalesced, through the steady loop.
  const int64_t head = min64(S, max64(order, kTaps));
  int64_t i = 0;
  for (; i < head; ++i) {
    int32_t c_eff[kTaps];
    const int ramp = static_cast<int>(min64(i, 4));
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      c_eff[j] = i < order ? (fixed ? kFixed[ramp][j] : 0) : c[j];
    }
    out_t[i * L + lane] = step(c_eff, hist, shift, res_t[i * L + lane]);
  }

  // Steady state, in chunks: the next chunk's loads are issued before the
  // current chunk is reconstructed.
  int32_t next[kChunk] = {};
  if (i + kChunk <= S) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) next[k] = res_t[(i + k) * L + lane];
  }
  for (; i + kChunk <= S; i += kChunk) {
    int32_t cur[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) cur[k] = next[k];
    if (i + 2 * kChunk <= S) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) next[k] = res_t[(i + kChunk + k) * L + lane];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) out_t[(i + k) * L + lane] = step(c, hist, shift, cur[k]);
  }
  for (; i < S; ++i) out_t[i * L + lane] = step(c, hist, shift, res_t[i * L + lane]);
}

}  // namespace

// res_t, out_t: [S, L] int32, time-major. coeffs: [L, 12] int32. shifts,
// orders: [L] int32. is_fixed: [L] bool (one byte each). All on the device,
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int flo_lpc_reconstruct(const void* res_t, const void* coeffs, const void* shifts,
                                   const void* orders, const void* is_fixed, void* out_t,
                                   int64_t L, int64_t S, void* stream) {
  if (L <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  lpc_reconstruct_kernel<<<static_cast<unsigned int>(blocks), kLanesPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res_t), static_cast<const int32_t*>(coeffs),
      static_cast<const int32_t*>(shifts), static_cast<const int32_t*>(orders),
      static_cast<const uint8_t*>(is_fixed), static_cast<int32_t*>(out_t), L, S);
  return static_cast<int>(cudaGetLastError());
}
