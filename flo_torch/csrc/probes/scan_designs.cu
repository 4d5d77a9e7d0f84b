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

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBands = 25;
constexpr float kDecay = 0.7f;
constexpr int kDesigns = 6;

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

}  // namespace

extern "C" int flo_scan_designs() { return kDesigns; }

// in, out [R, T, 25] float32, contiguous, distinct. Launches `design` on
// `stream`; returns cudaGetLastError(), or -1 for an unknown design.
extern "C" int flo_scan_design(const void* in, void* out, int64_t R, int64_t T, int32_t design,
                               void* stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
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
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
