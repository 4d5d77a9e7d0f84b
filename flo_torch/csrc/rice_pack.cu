// Rice / raw-LE16 bitstream pack of many lanes into one word-aligned buffer.
//
// Replaces the XLA programs flo_tpu/ops/blockspread.py:117 `pack_stage1`
// and :402 `pack_stage2` (as `pack_lanes_words`, :647). Byte-identical to
// the plain version, flo_torch/ops/blockspread.py `pack_lanes_words`: lane
// l's bytes at [lane_off[l], lane_off[l] + lane_bytes[l]) are
// rice_host.encode(residuals[l, :n], k[l]), or the samples as little-endian
// int16 for a raw lane. A Rice code is min(u >> k, 255) one bits, a zero and
// the low k bits of the zigzag u, MSB first: up to 271 bits over up to 10
// 32-bit words, every one written whole (the TPU packer's patch list,
// `bad` lanes and host re-pack have no counterpart).
//
// What bounds it on the card: memory traffic and atomics. Each code is a
// handful of integer operations; the input is 4 bytes a sample read twice,
// the bit offsets 4 bytes a sample written and read once, and the output
// about a byte a sample, ORed in by atomics that neighbouring codes share.
//
// What the design does about it (simple first; the TPU's superrows and
// barrel-shift merges, built because indexed stores cost ~7 ns there, have
// no counterpart on a card whose atomics and scatters run at memory speed):
//  - pass 1 (`lengths_kernel`), one block per lane: code lengths and their
//    exclusive scan with CUB's BlockScan over tiles of 2,048 samples, a
//    running carry between tiles; the lane's bit count at the end;
//  - between the passes the wrapper turns bit counts into word-aligned lane
//    offsets (a cumsum over lanes);
//  - pass 2 (`scatter_kernel`), one thread per code: its absolute start bit
//    in 64 bits, then for each word it touches the word's slice of the unary
//    run and of the tail, ORed in with atomicOr (bits of different codes are
//    disjoint); words at or past the buffer's end are skipped;
//  - pass 3 (`byteswap_kernel`) puts each MSB-first word in byte order, so
//    the buffer's little-endian bytes are the stream.

#include <cstdint>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // samples per thread per scan tile

struct Code {
  int ones;       // unary one bits (the Rice quotient, at most 255)
  int tail_len;   // bits after the ones: 1 + k, or 16 for a raw sample
  uint32_t tail;  // zero terminator + low k bits of u, or the two LE16 bytes
};

__device__ __forceinline__ Code make_code(int32_t r, int k, bool raw) {
  Code c;
  if (raw) {
    const uint32_t v = static_cast<uint32_t>(r) & 0xFFFFu;
    c.ones = 0;
    c.tail_len = 16;
    c.tail = ((v & 0xFFu) << 8) | (v >> 8);
  } else {
    const uint32_t u = (static_cast<uint32_t>(r) << 1) ^ static_cast<uint32_t>(r >> 31);
    const uint32_t q = u >> k;
    c.ones = q < 255u ? static_cast<int>(q) : 255;
    c.tail_len = 1 + k;
    c.tail = u & ((1u << k) - 1u);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
lengths_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
               const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
               int32_t* __restrict__ bitoff, int64_t* __restrict__ lane_bits, int64_t S) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage temp;
  const int64_t lane = blockIdx.x;
  int64_t n = nvalid[lane];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int kk = k[lane];
  const bool raw = is_raw[lane] != 0;
  const int32_t* row = res + lane * S;
  int32_t* out = bitoff + lane * S;

  int carry = 0;  // a lane has at most 271 * S < 2**31 bits (checked by the wrapper)
  for (int64_t base = 0; base < n; base += kThreads * kItems) {
    int len[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + threadIdx.x * kItems + j;
      len[j] = 0;
      if (i < n) {
        const Code c = make_code(row[i], kk, raw);
        len[j] = c.ones + c.tail_len;
      }
    }
    int tile_bits;
    Scan(temp).ExclusiveSum(len, len, tile_bits);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + threadIdx.x * kItems + j;
      if (i < n) out[i] = carry + len[j];
    }
    carry += tile_bits;
    __syncthreads();  // temp is reused by the next tile
  }
  if (threadIdx.x == 0) lane_bits[lane] = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
               const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
               const int32_t* __restrict__ bitoff, const int64_t* __restrict__ lane_woff,
               uint32_t* __restrict__ words, int64_t S, int64_t NW) {
  const int64_t lane = blockIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (i >= S || i >= nvalid[lane]) return;
  const Code c = make_code(res[lane * S + i], k[lane], is_raw[lane] != 0);
  const int64_t start = (lane_woff[lane] << 5) + bitoff[lane * S + i];
  const int64_t first = start >> 5;
  const int64_t last = (start + c.ones + c.tail_len - 1) >> 5;
  for (int64_t w = first; w <= last && w < NW; ++w) {
    const int64_t off = (w << 5) - start;  // code-relative bit at the word's MSB
    // The unary run [0, ones) covers word bits [lo, hi), counted from the MSB.
    const int64_t lo = off < 0 ? -off : 0;
    int64_t hi = c.ones - off;
    hi = hi < 0 ? 0 : (hi > 32 ? 32 : hi);
    const uint64_t run = lo >= hi ? 0 : ((1ull << (32 - lo)) - 1) - ((1ull << (32 - hi)) - 1);
    // The tail's MSB falls on word bit a.
    const int64_t a = c.ones - off;
    uint64_t placed = 0;
    if (a < 32 && a + c.tail_len > 0) {
      const int64_t sh = 32 - a - c.tail_len;
      placed = sh >= 0 ? static_cast<uint64_t>(c.tail) << sh : static_cast<uint64_t>(c.tail) >> -sh;
    }
    const uint32_t v = static_cast<uint32_t>((run | placed) & 0xFFFFFFFFull);
    if (v) atomicOr(words + w, v);
  }
}

__global__ void byteswap_kernel(uint32_t* __restrict__ words, int64_t NW) {
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; w < NW;
       w += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    words[w] = __byte_perm(words[w], 0, 0x0123);
  }
}

}  // namespace

// Pass 1. res [L, S] int32; k, nvalid [L] int32; is_raw [L] bool (one byte);
// outputs bitoff [L, S] int32 (each code's bit offset in its lane) and
// lane_bits [L] int64. Launches on `stream`; returns cudaGetLastError().
extern "C" int flo_rice_pack_lengths(const void* res, const void* k, const void* nvalid,
                                     const void* is_raw, void* bitoff, void* lane_bits,
                                     int64_t L, int64_t S, void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  lengths_kernel<<<static_cast<unsigned int>(L), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(nvalid), static_cast<const uint8_t*>(is_raw),
      static_cast<int32_t*>(bitoff), static_cast<int64_t*>(lane_bits), S);
  return static_cast<int>(cudaGetLastError());
}

// Passes 2 and 3. lane_woff [L] int64 word offsets; words [NW] zeroed on
// entry, the byte stream on return. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int flo_rice_pack_scatter(const void* res, const void* k, const void* nvalid,
                                     const void* is_raw, const void* bitoff,
                                     const void* lane_woff, void* words, int64_t L, int64_t S,
                                     int64_t NW, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L > 0 && S > 0) {
    const int64_t tiles = (S + kThreads - 1) / kThreads;
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    scatter_kernel<<<dim3(static_cast<unsigned int>(L), static_cast<unsigned int>(tiles)),
                     kThreads, 0, st>>>(
        static_cast<const int32_t*>(res), static_cast<const int32_t*>(k),
        static_cast<const int32_t*>(nvalid), static_cast<const uint8_t*>(is_raw),
        static_cast<const int32_t*>(bitoff), static_cast<const int64_t*>(lane_woff),
        static_cast<uint32_t*>(words), S, NW);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (NW > 0) {
    const int64_t blocks = (NW + kThreads - 1) / kThreads;
    byteswap_kernel<<<static_cast<unsigned int>(blocks < 65535 ? blocks : 65535), kThreads, 0,
                      st>>>(static_cast<uint32_t*>(words), NW);
  }
  return static_cast<int>(cudaGetLastError());
}
