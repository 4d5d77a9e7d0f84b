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
// few microseconds at 16 lanes of 2,585 hops). What it is held to is the
// chain: T dependent steps of a multiply and a maximum in each of the R * 25
// chains, and, with so few chains, the latency of whatever a step waits for.
//
// What the design does about it: nothing but the multiply and the maximum is
// on the chain.
//  - A block a lane. The lane's [T, 25] values are contiguous, so the block
//    moves them in tiles of 128 hops (12.8 KB) with coalesced loads and
//    stores by all its threads, through shared memory; the next tile's loads
//    are started, into registers, before the chain is walked over the tile at
//    hand, so their latency passes meanwhile.
//  - 25 threads of the first warp walk the chain, a band each. A thread
//    takes its 128 inputs of the tile from shared memory into registers
//    first and stores its 128 results after, so that no shared-memory access
//    lies between two steps (walked straight from shared memory the loop
//    takes twice the time: csrc/probes/scan_designs.cu has the designs tried
//    and design_search.py times them; this is its design 2).
//  - NaN is kept off the chain: a product or a maximum of non-NaN floats is
//    never NaN, so a NaN comes from the input alone and lasts. A flag a chain
//    remembers it and the stored value is NaN from there on, while the chain
//    goes on with fmaxf, which passes the other operand.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBands = 25;
constexpr int kThreads = 128;
constexpr int kTileHops = 128;
constexpr int kTile = kTileHops * kBands;  // floats a tile
constexpr int kPer = kTile / kThreads;     // floats a thread moves a tile
constexpr float kDecay = 0.7f;

static_assert(kTile % kThreads == 0, "a tile is a whole number of floats a thread");
static_assert(kBands <= 32, "the chains are walked by one warp");

__global__ void __launch_bounds__(kThreads)
temporal_mask_kernel(const float* __restrict__ in, float* __restrict__ out, int64_t T) {
  __shared__ float s_in[kTile];
  __shared__ float s_out[kTile];

  const int tid = threadIdx.x;
  const int64_t total = T * kBands;  // floats of the lane
  const float* src = in + static_cast<int64_t>(blockIdx.x) * total;
  float* dst = out + static_cast<int64_t>(blockIdx.x) * total;

  // A tile past the lane's end reads as zeros; the chain walks over them and
  // nothing of it is stored.
  float regs[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int64_t g = m * kThreads + tid;
    s_in[m * kThreads + tid] = g < total ? __ldg(src + g) : 0.0f;
  }
  __syncthreads();

  float prev = 0.0f;
  bool seen_nan = false;
  for (int64_t base = 0; base < total; base += kTile) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int64_t g = base + kTile + m * kThreads + tid;
      regs[m] = g < total ? __ldg(src + g) : 0.0f;
    }
    if (tid < kBands) {
      float v[kTileHops];
#pragma unroll
      for (int t = 0; t < kTileHops; ++t) v[t] = s_in[t * kBands + tid];
#pragma unroll
      for (int t = 0; t < kTileHops; ++t) {
        seen_nan |= v[t] != v[t];
        prev = fmaxf(v[t], __fmul_rn(prev, kDecay));
        v[t] = seen_nan ? CUDART_NAN_F : prev;
      }
#pragma unroll
      for (int t = 0; t < kTileHops; ++t) s_out[t * kBands + tid] = v[t];
    }
    __syncthreads();
    // Each thread stores and refills the same elements, so the refill needs
    // no barrier of its own before it.
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = m * kThreads + tid;
      if (base + i < total) dst[base + i] = s_out[i];
      s_in[i] = regs[m];
    }
    __syncthreads();
  }
}

}  // namespace

// in, out [R, T, 25] float32, contiguous, distinct. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int flo_temporal_mask(const void* in, void* out, int64_t R, int64_t T, void* stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  temporal_mask_kernel<<<static_cast<unsigned int>(R), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), T);
  return static_cast<int>(cudaGetLastError());
}
