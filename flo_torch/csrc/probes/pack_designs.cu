// Every step of the Rice pack kernel's design search, in one library, so that
// the steps can be timed against each other on one card in one run
// (design_search.py drives it). Not built with the port: csrc/rice_pack.cu
// carries the design that ships.
//
// Design 0 is the port's first packer, entry point by entry point so that
// each pass can be timed apart: a per-lane scan that writes every code's bit
// offset (an int32 a sample), one thread a code ORing its words into a zeroed
// buffer with global atomics, and a byte-order pass over the whole buffer.
//
// The later designs share one frame and differ in how a tile's bits are put
// together:
//  - `count_kernel`, a block a lane, leaves only the lane's bit count;
//  - `layout_kernel`, one block, turns bit counts (or the caller's byte
//    counts, the one-read form) into word-aligned lane offsets and their sum;
//  - `pack_kernel<A>`, a block a lane, walks the lane in tiles of 2,048
//    codes: coalesced loads into shared memory, code lengths scanned in the
//    block with a running bit position, the tile's words assembled and
//    stored whole, in byte order, each exactly once; the partial word at a
//    tile's end is carried to the next tile in the block. A is
//      1  scatter: every code ORs its words into a shared-memory window
//         with shared atomics (design 0's arithmetic, moved on chip);
//      2  runs: a thread concatenates its 8 consecutive codes in a 64-bit
//         register and stores whole words to the window, touching only its
//         first and last word with an atomic;
//      3  gather: a thread owns an output word, finds the first code that
//         reaches it by binary search of the scanned offsets and ORs in the
//         codes that overlap it; no atomics and no window.
//    Designs 1 and 2 walk a tile whose bits pass the window (2,048 words) in
//    several windows; design 3 takes any density as it comes.
//  - `pack_direct_kernel<THREADS, ITEMS>` is design 2 with fewer
//    instructions a code (see its comment): design 4 with 256 threads of 8
//    samples, 5 with 128 of 16, 6 with 128 of 8.
//  - `pack_flat_kernel<THREADS, ITEMS, MINBLOCKS>` takes the branches out of
//    a code's step and caps the registers (see its comment): design 7 with
//    128 threads of 8 samples and 8 blocks an SM, 8 with 256 threads and 4
//    blocks, 9 with 256 threads and registers as the compiler likes.
//  - `pack_quiet_kernel<THREADS, ITEMS, MINBLOCKS, FAST>` takes the shared
//    atomics out (see its comment): design 10 with two atomics a thread and
//    tile, 11 with none in a tile whose threads all have 32 bits or more,
//    12 the same with 128 threads of 16 samples.
//  - `pack_lean_kernel<THREADS, ITEMS, MINBLOCKS>` is design 11 with fewer
//    instructions a code (see its comment): design 13 with 4 blocks of 256
//    threads an SM, 14 with 5, 15 with 8 blocks of 128 threads, 16 with 128
//    threads of 16 samples, 17 with 256 of 16, 18 with 512 of 8.

#include <cstdint>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // samples per thread per tile
constexpr int kTile = kThreads * kItems;
constexpr int kWindow = 2048;  // words of a tile assembled at a time
constexpr int kLayoutThreads = 1024;
constexpr int kScatter = 1, kRuns = 2, kGather = 3;

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

// The 32 bits of a word whose MSB lies `off` bits after the code's first bit
// (negative: the code starts inside the word).
__device__ __forceinline__ uint32_t word_slice(const Code& c, int off) {
  // The unary run [0, ones) covers word bits [lo, hi), counted from the MSB.
  const int lo = off < 0 ? -off : 0;
  int hi = c.ones - off;
  hi = hi < 0 ? 0 : (hi > 32 ? 32 : hi);
  const uint64_t run = lo >= hi ? 0 : ((1ull << (32 - lo)) - 1) - ((1ull << (32 - hi)) - 1);
  // The tail's MSB falls on word bit a.
  const int a = c.ones - off;
  uint64_t placed = 0;
  if (a < 32 && a + c.tail_len > 0) {
    const int sh = 32 - a - c.tail_len;
    placed = sh >= 0 ? static_cast<uint64_t>(c.tail) << sh : static_cast<uint64_t>(c.tail) >> -sh;
  }
  return static_cast<uint32_t>((run | placed) & 0xFFFFFFFFull);
}

// ---------------------------------------------------------------- design 0

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

  int carry = 0;
  for (int64_t base = 0; base < n; base += kTile) {
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
    __syncthreads();
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
    const uint32_t v = word_slice(c, static_cast<int>((w << 5) - start));
    if (v) atomicOr(words + w, v);
  }
}

__global__ void byteswap_kernel(uint32_t* __restrict__ words, int64_t NW) {
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; w < NW;
       w += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    words[w] = __byte_perm(words[w], 0, 0x0123);
  }
}

// ------------------------------------------------------------ designs 1-3

// A lane's bit count and nothing else. A raw lane is 16 bits a sample and is
// not read.
__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
             const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
             int64_t* __restrict__ lane_bits, int64_t S) {
  using Reduce = cub::BlockReduce<unsigned int, kThreads>;
  __shared__ typename Reduce::TempStorage temp;
  const int64_t lane = blockIdx.x;
  int64_t n = nvalid[lane];
  n = n < 0 ? 0 : (n > S ? S : n);
  if (is_raw[lane] != 0) {
    if (threadIdx.x == 0) lane_bits[lane] = 16 * n;
    return;
  }
  const int kk = k[lane];
  const int32_t* row = res + lane * S;
  auto quotient = [kk](int32_t r) {
    const uint32_t u = (static_cast<uint32_t>(r) << 1) ^ static_cast<uint32_t>(r >> 31);
    const uint32_t q = u >> kk;
    return q < 255u ? q : 255u;
  };
  // Scalar loads up to the first 16-byte boundary, 16-byte loads after it,
  // scalar loads for what is left.
  int64_t head = static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2;
  head = head < n ? head : n;
  const int64_t nvec = (n - head) >> 2;
  unsigned int ones = 0;
  if (threadIdx.x < head) ones += quotient(row[threadIdx.x]);
  const int4* vec = reinterpret_cast<const int4*>(row + head);
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
    const int4 v = vec[i];
    ones += quotient(v.x) + quotient(v.y) + quotient(v.z) + quotient(v.w);
  }
  const int64_t done = head + 4 * nvec;
  if (done + threadIdx.x < n) ones += quotient(row[done + threadIdx.x]);
  const unsigned int total = Reduce(temp).Sum(ones);
  if (threadIdx.x == 0) lane_bits[lane] = static_cast<int64_t>(total) + n * (1 + kk);
}

// Lane spans in words, from bit counts or (hint_bytes not null) from the
// caller's byte counts; their exclusive sum as byte offsets; their total.
__global__ void __launch_bounds__(kLayoutThreads)
layout_kernel(const int64_t* __restrict__ lane_bits, const int32_t* __restrict__ hint_bytes,
              int64_t L, int64_t* __restrict__ lane_off, int64_t* __restrict__ lane_span,
              int64_t* __restrict__ total) {
  using Scan = cub::BlockScan<int64_t, kLayoutThreads>;
  __shared__ typename Scan::TempStorage temp;
  int64_t carry = 0;
  for (int64_t base = 0; base < L; base += kLayoutThreads) {
    const int64_t l = base + threadIdx.x;
    int64_t w = 0;
    if (l < L) {
      if (hint_bytes != nullptr) {
        const int64_t b = hint_bytes[l];
        w = ((b < 0 ? 0 : b) + 3) >> 2;
      } else {
        w = (lane_bits[l] + 31) >> 5;
      }
    }
    int64_t before, sum;
    Scan(temp).ExclusiveSum(w, before, sum);
    if (l < L) {
      lane_off[l] = (carry + before) << 2;
      lane_span[l] = w;
    }
    carry += sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// Shared-memory index of a tile's sample i: a pad word every 32, so that a
// thread's 8 consecutive samples and its neighbours' fall in distinct banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// CUT, for timing only (the words come out wrong): 1 leaves out the assembly
// of the tile's bits, 2 also the stores of its words, 3 everything after the
// scan.
template <int A, int CUT = 0>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
            const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
            const int64_t* __restrict__ lane_off, const int64_t* __restrict__ lane_span,
            uint32_t* __restrict__ words, int64_t* __restrict__ lane_bytes, int64_t S,
            int64_t NW) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_temp;
  __shared__ int32_t vals[kTile + kTile / 32];
  __shared__ int offs[A == kGather ? kTile + 1 : 1];
  // The window of designs 1 and 2; the gather's two carry slots.
  __shared__ uint32_t buf[A == kGather ? 2 : kWindow];

  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  int64_t n = nvalid[lane];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int kk = k[lane];
  const bool raw = is_raw[lane] != 0;
  const int32_t* row = res + lane * S;
  // The lane writes words [woff, woff + limit): its span, cut at the buffer.
  const int64_t woff = lane_off[lane] >> 2;
  int64_t room = NW - woff;
  room = room < lane_span[lane] ? room : lane_span[lane];
  const int limit = room < 0 ? 0 : (room > (1 << 30) ? (1 << 30) : static_cast<int>(room));

  int pos = 0;         // bits of the lane before this tile (< 2**31, checked by the caller)
  uint32_t carry = 0;  // designs 1, 2: the partial word the last tile left
  int parity = 0;      // design 3: which slot holds it
  if (A == kGather && tid == 0) buf[0] = 0;

  for (int64_t base = 0; base < n; base += kTile) {
    const int nv = static_cast<int>(n - base < kTile ? n - base : kTile);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      vals[padded(i)] = i < nv ? row[base + i] : 0;
    }
    __syncthreads();

    int32_t r[kItems];
    int start[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid * kItems + j;
      r[j] = vals[padded(i)];
      start[j] = 0;
      if (i < nv) {
        const Code c = make_code(r[j], kk, raw);
        start[j] = c.ones + c.tail_len;
      }
    }
    int tile_bits;
    Scan(scan_temp).ExclusiveSum(start, start, tile_bits);

    // Tile word 0 is lane word wbase; the tile's first code starts `shift`
    // bits into it, and the tile completes words [0, full).
    const int shift = pos & 31;
    const int wbase = pos >> 5;
    const int end = shift + tile_bits;
    const int full = end >> 5;
    if constexpr (CUT == 3) {
      carry += start[kItems - 1];
      pos += tile_bits;
      __syncthreads();
      continue;
    }

    if constexpr (A == kGather) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) offs[tid * kItems + j] = shift + start[j];
      if (tid == kThreads - 1) offs[kTile] = end;
      __syncthreads();
      for (int w = tid; w <= full; w += kThreads) {
        const int bit0 = w << 5;
        int lo = 0, hi = nv;  // the first code that ends past bit0
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (offs[mid + 1] > bit0) hi = mid; else lo = mid + 1;
        }
        uint32_t v = w == 0 ? buf[parity] : 0u;
        for (int c = lo; c < nv && offs[c] < bit0 + 32; ++c) {
          v |= word_slice(make_code(vals[padded(c)], kk, raw), bit0 - offs[c]);
        }
        if (w < full) {
          if (wbase + w < limit) words[woff + wbase + w] = __byte_perm(v, 0, 0x0123);
        } else {
          buf[parity ^ 1] = v;
        }
      }
      parity ^= 1;
      __syncthreads();  // vals, offs and the carry slot are reused by the next tile
    } else {
      for (int w0 = 0; w0 <= full; w0 += kWindow) {
        const int nwin = full + 1 - w0 < kWindow ? full + 1 - w0 : kWindow;
        for (int i = tid; i < nwin; i += kThreads) buf[i] = (w0 == 0 && i == 0) ? carry : 0u;
        __syncthreads();
        if constexpr (A == kScatter) {
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            if (tid * kItems + j >= nv) continue;
            const Code c = make_code(r[j], kk, raw);
            const int s = shift + start[j];
            int first = s >> 5;
            int last = (s + c.ones + c.tail_len - 1) >> 5;
            first = first < w0 ? w0 : first;
            last = last > w0 + nwin - 1 ? w0 + nwin - 1 : last;
            for (int w = first; w <= last; ++w) {
              const uint32_t v = word_slice(c, (w << 5) - s);
              if (v) atomicOr(buf + (w - w0), v);
            }
          }
        } else if (CUT == 0 && tid * kItems < nv) {
          // The thread's codes, one after the other, in the low `nacc` bits
          // of `acc`; a word leaves as soon as 32 bits are there.
          const int p = shift + start[0];
          int w = (p >> 5) - w0;  // window index of the word being filled
          int nacc = p & 31;
          uint64_t acc = 0;
          bool shared_word = true;  // the first word may hold a neighbour's bits
          auto push = [&](uint32_t val, int len) {
            acc = (acc << len) | val;
            nacc += len;
            if (nacc >= 32) {
              nacc -= 32;
              const uint32_t word = static_cast<uint32_t>(acc >> nacc);
              if (static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
                if (shared_word) atomicOr(buf + w, word); else buf[w] = word;
              }
              shared_word = false;
              ++w;
            }
          };
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            if (tid * kItems + j >= nv) break;
            const Code c = make_code(r[j], kk, raw);
            if (c.ones + c.tail_len <= 32) {
              push((((1u << c.ones) - 1u) << c.tail_len) | c.tail, c.ones + c.tail_len);
            } else {
              int o = c.ones;
              for (; o >= 32; o -= 32) push(0xFFFFFFFFu, 32);
              push((1u << o) - 1u, o);
              push(c.tail, c.tail_len);
            }
          }
          if (nacc > 0 && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
            atomicOr(buf + w, static_cast<uint32_t>(acc << (32 - nacc)));
          }
        }
        __syncthreads();
        const int nstore = full - w0 < kWindow ? full - w0 : kWindow;
        for (int i = tid; CUT < 2 && i < nstore; i += kThreads) {
          const int lw = wbase + w0 + i;
          if (lw < limit) words[woff + lw] = __byte_perm(buf[i], 0, 0x0123);
        }
        if (CUT == 1) carry += start[0];  // keeps the scan alive
        if (full - w0 < kWindow) carry = buf[full - w0];
        __syncthreads();  // buf (and vals) are rewritten by the next window or tile
      }
    }
    pos += tile_bits;
  }

  if (tid == 0) {
    if (A == kGather) carry = buf[parity];
    if ((pos & 31) != 0 && (pos >> 5) < limit) {
      words[woff + (pos >> 5)] = __byte_perm(carry, 0, 0x0123);
    }
    lane_bytes[lane] = (static_cast<int64_t>(pos) + 7) >> 3;
  }
}

// ------------------------------------------------------------ designs 4-6

// Design 2 again with fewer instructions a code (it is bound by them, not by
// memory): tiles are cut from the 16-byte boundary at or before the row's
// start, so a thread loads its ITEMS consecutive samples as aligned int4
// straight into registers (the next tile's before this tile's work); a code
// of up to 32 bits is made once, as one value and a length; only a thread's
// bit total is scanned; two neighbouring codes of under 32 bits together
// leave as one; two windows take turns, which saves a barrier a tile.
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
pack_direct_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
                   const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
                   const int64_t* __restrict__ lane_off, const int64_t* __restrict__ lane_span,
                   uint32_t* __restrict__ words, int64_t* __restrict__ lane_bytes, int64_t S,
                   int64_t NW) {
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WINDOW = TILE;  // words: a tile of raw samples is half of it
  constexpr int VECS = ITEMS / 4;
  using Scan = cub::BlockScan<int, THREADS, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_temp;
  __shared__ uint32_t buf[2][WINDOW];

  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  int64_t n = nvalid[lane];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int kk = k[lane];
  const bool raw = is_raw[lane] != 0;
  const int tl = raw ? 16 : 1 + kk;
  const uint32_t kmask = (1u << kk) - 1u;
  const int32_t* row = res + lane * S;
  const int64_t woff = lane_off[lane] >> 2;
  int64_t room = NW - woff;
  room = room < lane_span[lane] ? room : lane_span[lane];
  const int limit = room < 0 ? 0 : (room > (1 << 30) ? (1 << 30) : static_cast<int>(room));

  // Sample i of the row is item i + mis of the tiles; items before mis and
  // from nend on carry no code. An aligned 16-byte load that holds one
  // sample of the row stays inside the row's allocation.
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) >> 2);
  const int32_t* vrow = row - mis;
  const int64_t nend = n > 0 ? n + mis : 0;
  auto load = [&](int64_t base, int4 (&v)[VECS]) {
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
      const int64_t i = base + tid * ITEMS + 4 * q;
      v[q] = i < nend ? *reinterpret_cast<const int4*>(vrow + i) : make_int4(0, 0, 0, 0);
    }
  };

  int pos = 0;
  uint32_t carry = 0;
  int which = 0;
  int4 cur[VECS], next[VECS];
  load(0, cur);
  for (int64_t base = 0; base < nend; base += TILE) {
    load(base + TILE, next);
    int32_t r[ITEMS];
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
      r[4 * q] = cur[q].x, r[4 * q + 1] = cur[q].y, r[4 * q + 2] = cur[q].z, r[4 * q + 3] = cur[q].w;
    }
    // This thread's items [jlo, jhi) carry codes.
    const int64_t i0 = base + tid * ITEMS;
    const int jlo = i0 < mis ? static_cast<int>(mis - i0) : 0;
    const int64_t left = nend - i0;
    const int jhi = left >= ITEMS ? ITEMS : (left < 0 ? 0 : static_cast<int>(left));
    uint32_t cv[ITEMS];  // a code of up to 32 bits, right-aligned
    int len[ITEMS];      // its length; past 32 the code is made again from r
    int bits = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      cv[j] = 0;
      len[j] = 0;
      if (j >= jlo && j < jhi) {
        if (raw) {
          const uint32_t v = static_cast<uint32_t>(r[j]) & 0xFFFFu;
          cv[j] = ((v & 0xFFu) << 8) | (v >> 8);
          len[j] = 16;
        } else {
          const uint32_t u =
              (static_cast<uint32_t>(r[j]) << 1) ^ static_cast<uint32_t>(r[j] >> 31);
          const uint32_t q = u >> kk;
          len[j] = static_cast<int>(q < 255u ? q : 255u) + tl;
          if (len[j] <= 32) cv[j] = (((1u << q) - 1u) << tl) | (u & kmask);
        }
      }
      bits += len[j];
    }
    int before, tile_bits;
    Scan(scan_temp).ExclusiveSum(bits, before, tile_bits);

    const int shift = pos & 31;
    const int wbase = pos >> 5;
    const int end = shift + tile_bits;
    const int full = end >> 5;
    uint32_t* win = buf[which];
    for (int w0 = 0; w0 <= full; w0 += WINDOW) {
      const int nwin = full + 1 - w0 < WINDOW ? full + 1 - w0 : WINDOW;
      for (int i = tid; i < nwin; i += THREADS) win[i] = (w0 == 0 && i == 0) ? carry : 0u;
      __syncthreads();
      if (bits > 0) {
        const int p = shift + before;
        int w = (p >> 5) - w0;
        int nacc = p & 31;
        uint64_t acc = 0;
        bool shared_word = true;
        auto push = [&](uint32_t val, int l) {
          acc = (acc << l) | val;
          nacc += l;
          if (nacc >= 32) {
            nacc -= 32;
            const uint32_t word = static_cast<uint32_t>(acc >> nacc);
            if (static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
              if (shared_word) atomicOr(win + w, word); else win[w] = word;
            }
            shared_word = false;
            ++w;
          }
        };
        auto emit = [&](int j) {
          if (len[j] <= 32) {
            push(cv[j], len[j]);
          } else {
            const Code c = make_code(r[j], kk, raw);
            int o = c.ones;
            for (; o >= 32; o -= 32) push(0xFFFFFFFFu, 32);
            push((1u << o) - 1u, o);
            push(c.tail, c.tail_len);
          }
        };
#pragma unroll
        for (int j = 0; j < ITEMS; j += 2) {
          const int both = len[j] + len[j + 1];
          if (both < 32) {
            push((cv[j] << len[j + 1]) | cv[j + 1], both);
          } else {
            emit(j);
            emit(j + 1);
          }
        }
        if (nacc > 0 && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
          atomicOr(win + w, static_cast<uint32_t>(acc << (32 - nacc)));
        }
      }
      __syncthreads();
      const int nstore = full - w0 < WINDOW ? full - w0 : WINDOW;
      for (int i = tid; i < nstore; i += THREADS) {
        const int lw = wbase + w0 + i;
        if (lw < limit) words[woff + lw] = __byte_perm(win[i], 0, 0x0123);
      }
      if (full - w0 < WINDOW) carry = win[full - w0];
      if (w0 + WINDOW <= full) __syncthreads();  // this window again for the tile's next words
    }
    // The next tile fills the other window; this one is zeroed again only
    // after the next tile's barriers.
    which ^= 1;
    pos += tile_bits;
#pragma unroll
    for (int q = 0; q < VECS; ++q) cur[q] = next[q];
  }

  if (tid == 0) {
    if ((pos & 31) != 0 && (pos >> 5) < limit) {
      words[woff + (pos >> 5)] = __byte_perm(carry, 0, 0x0123);
    }
    lane_bytes[lane] = (static_cast<int64_t>(pos) + 7) >> 3;
  }
}

// ------------------------------------------------------------ designs 7-8

// Designs 4-6 spend their time in branches that the threads of a warp take
// at different codes (a word leaves one thread's register at its third code
// and its neighbour's at its fourth), and in registers: 87-151 a thread,
// two to five blocks an SM. Here a code's step has no branch: the word that
// may leave is computed every time and ORed into the window under a
// predicate, with a shared atomic whether or not a neighbour shares it;
// codes are not paired; only a code past 32 bits branches. MINBLOCKS caps
// the registers so that MINBLOCKS blocks fit an SM.
template <int THREADS, int ITEMS, int MINBLOCKS, int CUT = 0>
__global__ void __launch_bounds__(THREADS, MINBLOCKS)
pack_flat_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
                 const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
                 const int64_t* __restrict__ lane_off, const int64_t* __restrict__ lane_span,
                 uint32_t* __restrict__ words, int64_t* __restrict__ lane_bytes, int64_t S,
                 int64_t NW) {
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WINDOW = TILE;  // words: a tile of raw samples is half of it
  constexpr int VECS = ITEMS / 4;
  using Scan = cub::BlockScan<int, THREADS, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_temp;
  __shared__ uint32_t buf[2][WINDOW];

  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  int64_t n = nvalid[lane];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int kk = k[lane];
  const bool raw = is_raw[lane] != 0;
  const int tl = raw ? 16 : 1 + kk;
  const uint32_t kmask = (1u << kk) - 1u;
  const int32_t* row = res + lane * S;
  const int64_t woff = lane_off[lane] >> 2;
  int64_t room = NW - woff;
  room = room < lane_span[lane] ? room : lane_span[lane];
  const int limit = room < 0 ? 0 : (room > (1 << 30) ? (1 << 30) : static_cast<int>(room));

  // Sample i of the row is item i + mis of the tiles; items before mis and
  // from nend on carry no code. An aligned 16-byte load that holds one
  // sample of the row stays inside the row's allocation.
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) >> 2);
  const int32_t* vrow = row - mis;
  const int64_t nend = n > 0 ? n + mis : 0;
  auto load = [&](int64_t base, int4 (&v)[VECS]) {
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
      const int64_t i = base + tid * ITEMS + 4 * q;
      v[q] = i < nend ? *reinterpret_cast<const int4*>(vrow + i) : make_int4(0, 0, 0, 0);
    }
  };

  int pos = 0;
  uint32_t carry = 0;
  int which = 0;
  int4 cur[VECS], next[VECS];
  load(0, cur);
  for (int64_t base = 0; base < nend; base += TILE) {
    load(base + TILE, next);
    int32_t r[ITEMS];
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
      r[4 * q] = cur[q].x, r[4 * q + 1] = cur[q].y, r[4 * q + 2] = cur[q].z, r[4 * q + 3] = cur[q].w;
    }
    const int64_t i0 = base + tid * ITEMS;
    const int jlo = i0 < mis ? static_cast<int>(mis - i0) : 0;
    const int64_t left = nend - i0;
    const int jhi = left >= ITEMS ? ITEMS : (left < 0 ? 0 : static_cast<int>(left));
    uint32_t cv[ITEMS];  // a code of up to 32 bits, right-aligned
    int len[ITEMS];      // its length; past 32 the code is made again from r
    int bits = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      uint32_t v;
      int l;
      if (raw) {
        v = __byte_perm(static_cast<uint32_t>(r[j]), 0, 0x4401);  // the two LE16 bytes
        l = 16;
      } else {
        const uint32_t u = (static_cast<uint32_t>(r[j]) << 1) ^ static_cast<uint32_t>(r[j] >> 31);
        const uint32_t q = u >> kk;
        l = static_cast<int>(q < 255u ? q : 255u) + tl;
        v = (((1u << (q & 31u)) - 1u) << tl) | (u & kmask);
      }
      const bool on = j >= jlo && j < jhi;
      len[j] = on ? l : 0;
      cv[j] = on && l <= 32 ? v : 0u;
      bits += len[j];
    }
    int before, tile_bits;
    Scan(scan_temp).ExclusiveSum(bits, before, tile_bits);

    const int shift = pos & 31;
    const int wbase = pos >> 5;
    const int end = shift + tile_bits;
    const int full = end >> 5;
    uint32_t* win = buf[which];
    if constexpr (CUT == 3) {
      carry += before + cv[0];
      pos += tile_bits;
#pragma unroll
      for (int q = 0; q < VECS; ++q) cur[q] = next[q];
      continue;
    }
    for (int w0 = 0; w0 <= full; w0 += WINDOW) {
      const int nwin = full + 1 - w0 < WINDOW ? full + 1 - w0 : WINDOW;
      for (int i = tid; i < nwin; i += THREADS) win[i] = (w0 == 0 && i == 0) ? carry : 0u;
      __syncthreads();
      if (CUT == 0 && bits > 0) {
        const int p = shift + before;
        int w = (p >> 5) - w0;  // window index of the word being filled
        int nacc = p & 31;      // bits of it that are there, in the low end of acc
        uint64_t acc = 0;
        auto push = [&](uint32_t val, int l) {  // l <= 32
          acc = (acc << l) | val;
          nacc += l;
          const bool leaves = nacc >= 32;
          nacc &= 31;
          if (leaves && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
            atomicOr(win + w, static_cast<uint32_t>(acc >> nacc));
          }
          w += leaves ? 1 : 0;
        };
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          if (len[j] <= 32) {
            push(cv[j], len[j]);
          } else {
            const Code c = make_code(r[j], kk, raw);
            int o = c.ones;
            for (; o >= 32; o -= 32) push(0xFFFFFFFFu, 32);
            push((1u << o) - 1u, o);
            push(c.tail, c.tail_len);
          }
        }
        if (nacc > 0 && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
          atomicOr(win + w, static_cast<uint32_t>(acc << (32 - nacc)));
        }
      }
      __syncthreads();
      const int nstore = full - w0 < WINDOW ? full - w0 : WINDOW;
      for (int i = tid; CUT < 2 && i < nstore; i += THREADS) {
        const int lw = wbase + w0 + i;
        if (lw < limit) words[woff + lw] = __byte_perm(win[i], 0, 0x0123);
      }
      if (CUT == 1) carry += before + cv[0];  // keeps the scan alive
      if (full - w0 < WINDOW) carry = win[full - w0];
      if (w0 + WINDOW <= full) __syncthreads();  // this window again for the tile's next words
    }
    which ^= 1;
    pos += tile_bits;
#pragma unroll
    for (int q = 0; q < VECS; ++q) cur[q] = next[q];
  }

  if (tid == 0) {
    if ((pos & 31) != 0 && (pos >> 5) < limit) {
      words[woff + (pos >> 5)] = __byte_perm(carry, 0, 0x0123);
    }
    lane_bytes[lane] = (static_cast<int64_t>(pos) + 7) >> 3;
  }
}

// ---------------------------------------------------------- designs 10-12

// Cutting parts out of designs 2 and 8 shows where their time goes: loads,
// codes and scan take 0.067-0.074 ms, the stores 0.01-0.02 ms, the assembly
// 0.07-0.11 ms, and more in design 8, where every word that leaves is a
// shared atomic. So here the atomics go. A thread keeps the first word that
// leaves (the one a neighbour may share) in a register and stores the others
// plainly; after its last code it ORs in that first word and its last,
// partial one: two atomics a thread and tile, issued by whole warps. With
// FAST, a tile in which every thread has 32 bits or more (or none) needs no
// atomic and no zeroed window at all: then a word has at most two writers,
// the thread whose bits end in it and the thread whose bits begin in it, so
// the ends are stored first and, after a barrier, the beginnings ORed in by
// a plain read and write. Other tiles (short threads, or bits past the
// window) take the atomic route, in the same launch.
template <int THREADS, int ITEMS, int MINBLOCKS, bool FAST>
__global__ void __launch_bounds__(THREADS, MINBLOCKS)
pack_quiet_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
                 const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
                 const int64_t* __restrict__ lane_off, const int64_t* __restrict__ lane_span,
                 uint32_t* __restrict__ words, int64_t* __restrict__ lane_bytes, int64_t S,
                 int64_t NW) {
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WINDOW = TILE;  // words: a tile of raw samples is half of it
  constexpr int VECS = ITEMS / 4;
  using Scan = cub::BlockScan<int, THREADS, cub::BLOCK_SCAN_WARP_SCANS>;
  __shared__ typename Scan::TempStorage scan_temp;
  __shared__ uint32_t buf[2][WINDOW];

  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  int64_t n = nvalid[lane];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int kk = k[lane];
  const bool raw = is_raw[lane] != 0;
  const int tl = raw ? 16 : 1 + kk;
  const uint32_t kmask = (1u << kk) - 1u;
  const int32_t* row = res + lane * S;
  const int64_t woff = lane_off[lane] >> 2;
  int64_t room = NW - woff;
  room = room < lane_span[lane] ? room : lane_span[lane];
  const int limit = room < 0 ? 0 : (room > (1 << 30) ? (1 << 30) : static_cast<int>(room));

  // Sample i of the row is item i + mis of the tiles; items before mis and
  // from nend on carry no code. An aligned 16-byte load that holds one
  // sample of the row stays inside the row's allocation.
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) >> 2);
  const int32_t* vrow = row - mis;
  const int64_t nend = n > 0 ? n + mis : 0;
  auto load = [&](int64_t base, int4 (&v)[VECS]) {
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
      const int64_t i = base + tid * ITEMS + 4 * q;
      v[q] = i < nend ? *reinterpret_cast<const int4*>(vrow + i) : make_int4(0, 0, 0, 0);
    }
  };

  int pos = 0;
  uint32_t carry = 0;
  int which = 0;
  int4 cur[VECS], next[VECS];
  load(0, cur);
  for (int64_t base = 0; base < nend; base += TILE) {
    load(base + TILE, next);
    int32_t r[ITEMS];
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
      r[4 * q] = cur[q].x, r[4 * q + 1] = cur[q].y, r[4 * q + 2] = cur[q].z, r[4 * q + 3] = cur[q].w;
    }
    const int64_t i0 = base + tid * ITEMS;
    const int jlo = i0 < mis ? static_cast<int>(mis - i0) : 0;
    const int64_t left = nend - i0;
    const int jhi = left >= ITEMS ? ITEMS : (left < 0 ? 0 : static_cast<int>(left));
    uint32_t cv[ITEMS];  // a code of up to 32 bits, right-aligned
    int len[ITEMS];      // its length; past 32 the code is made again from r
    int bits = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      uint32_t v;
      int l;
      if (raw) {
        v = __byte_perm(static_cast<uint32_t>(r[j]), 0, 0x4401);  // the two LE16 bytes
        l = 16;
      } else {
        const uint32_t u = (static_cast<uint32_t>(r[j]) << 1) ^ static_cast<uint32_t>(r[j] >> 31);
        const uint32_t q = u >> kk;
        l = static_cast<int>(q < 255u ? q : 255u) + tl;
        v = (((1u << (q & 31u)) - 1u) << tl) | (u & kmask);
      }
      const bool on = j >= jlo && j < jhi;
      len[j] = on ? l : 0;
      cv[j] = on && l <= 32 ? v : 0u;
      bits += len[j];
    }
    int before, tile_bits;
    Scan(scan_temp).ExclusiveSum(bits, before, tile_bits);

    const int shift = pos & 31;
    const int wbase = pos >> 5;
    const int end = shift + tile_bits;
    const int full = end >> 5;
    uint32_t* win = buf[which];
    // The thread's codes, one after the other, in the low `nacc` bits of
    // `acc`; a word leaves as soon as 32 bits are there. The first word to
    // leave stays in `head`; the others go to the window's words [0, nwin).
    auto assemble = [&](int w, int nwin, uint32_t& head, bool& first, int& nacc,
                        uint64_t& acc) -> int {
      auto push = [&](uint32_t val, int l) {  // l <= 32
        acc = (acc << l) | val;
        nacc += l;
        const bool leaves = nacc >= 32;
        nacc &= 31;
        const uint32_t word = static_cast<uint32_t>(acc >> nacc);
        if (leaves && !first && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
          win[w] = word;
        }
        head = leaves && first ? word : head;
        first = first && !leaves;
        w += leaves ? 1 : 0;
      };
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (len[j] <= 32) {
          push(cv[j], len[j]);
        } else {
          const Code c = make_code(r[j], kk, raw);
          int o = c.ones;
          for (; o >= 32; o -= 32) push(0xFFFFFFFFu, 32);
          push((1u << o) - 1u, o);
          push(c.tail, c.tail_len);
        }
      }
      return w;
    };
    const int p = shift + before;
    const bool no_short = __syncthreads_and(bits == 0 || bits >= 32);
    if (FAST && no_short && full < WINDOW) {
      uint32_t head = 0;
      bool first = true;
      int nacc = p & 31;
      uint64_t acc = 0;
      if (tid == 0 && shift != 0) win[0] = carry;
      if (bits > 0) {
        const int w = assemble(p >> 5, WINDOW, head, first, nacc, acc);
        if (nacc > 0) win[w] = static_cast<uint32_t>(acc << (32 - nacc));
        if ((p & 31) == 0) win[p >> 5] = head;  // whole, and this thread's alone
      }
      __syncthreads();
      if (bits > 0 && (p & 31) != 0) win[p >> 5] |= head;
      __syncthreads();
      for (int i = tid; i < full; i += THREADS) {
        if (wbase + i < limit) words[woff + wbase + i] = __byte_perm(win[i], 0, 0x0123);
      }
      carry = (end & 31) != 0 ? win[full] : 0u;
    } else {
      for (int w0 = 0; w0 <= full; w0 += WINDOW) {
        const int nwin = full + 1 - w0 < WINDOW ? full + 1 - w0 : WINDOW;
        for (int i = tid; i < nwin; i += THREADS) win[i] = (w0 == 0 && i == 0) ? carry : 0u;
        __syncthreads();
        if (bits > 0) {
          uint32_t head = 0;
          bool first = true;
          int nacc = p & 31;
          uint64_t acc = 0;
          const int w_head = (p >> 5) - w0;
          const int w = assemble(w_head, nwin, head, first, nacc, acc);
          if (!first && static_cast<unsigned int>(w_head) < static_cast<unsigned int>(nwin)) {
            atomicOr(win + w_head, head);
          }
          if (nacc > 0 && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
            atomicOr(win + w, static_cast<uint32_t>(acc << (32 - nacc)));
          }
        }
        __syncthreads();
        const int nstore = full - w0 < WINDOW ? full - w0 : WINDOW;
        for (int i = tid; i < nstore; i += THREADS) {
          const int lw = wbase + w0 + i;
          if (lw < limit) words[woff + lw] = __byte_perm(win[i], 0, 0x0123);
        }
        if (full - w0 < WINDOW) carry = win[full - w0];
        if (w0 + WINDOW <= full) __syncthreads();  // this window again for the tile's next words
      }
    }
    which ^= 1;
    pos += tile_bits;
#pragma unroll
    for (int q = 0; q < VECS; ++q) cur[q] = next[q];
  }

  if (tid == 0) {
    if ((pos & 31) != 0 && (pos >> 5) < limit) {
      words[woff + (pos >> 5)] = __byte_perm(carry, 0, 0x0123);
    }
    lane_bytes[lane] = (static_cast<int64_t>(pos) + 7) >> 3;
  }
}

// ---------------------------------------------------------- designs 13-18

// Design 11 with fewer instructions a code, which is what it is held to once
// the atomics are gone (about 63 a code by the SASS of design 8, of which 10
// are the long codes' fields, computed for every code because the compiler
// hoists them out of their branch):
//  - a thread whose 8 samples are all inside the lane (every thread of every
//    tile but the first and last) makes its codes without the per-sample
//    bounds;
//  - a long code's sample passes through an empty `asm volatile`, which pins
//    its fields inside the branch;
//  - the scan is five shuffles and the warps' totals, and its barrier is the
//    one that votes on the tile's route;
//  - on the fast route every word that leaves is stored plainly, the first
//    too (the first thread starts from the carried bits, the others from
//    zeros above their first bit), and what is deferred to after the barrier
//    is the thread's last, partial word, ORed into the word its successor has
//    begun: no flag and no bounds in a code's step;
//  - the other route (a thread with fewer than 32 bits, or more bits than the
//    window holds) is design 7's, every leaving word a shared atomic.
template <int THREADS, int ITEMS, int MINBLOCKS>
__global__ void __launch_bounds__(THREADS, MINBLOCKS)
pack_lean_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
                 const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
                 const int64_t* __restrict__ lane_off, const int64_t* __restrict__ lane_span,
                 uint32_t* __restrict__ words, int64_t* __restrict__ lane_bytes, int64_t S,
                 int64_t NW) {
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WINDOW = TILE;  // words: a tile of raw samples is half of it
  constexpr int VECS = ITEMS / 4;
  constexpr int WARPS = THREADS / 32;
  __shared__ int warp_bits[2][WARPS];
  __shared__ uint32_t buf[2][WINDOW];

  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  int64_t n = nvalid[lane];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int kk = k[lane];
  const bool raw = is_raw[lane] != 0;
  const int tl = raw ? 16 : 1 + kk;
  const uint32_t kmask = (1u << kk) - 1u;
  const int32_t* row = res + lane * S;
  const int64_t woff = lane_off[lane] >> 2;
  int64_t room = NW - woff;
  room = room < lane_span[lane] ? room : lane_span[lane];
  const int limit = room < 0 ? 0 : (room > (1 << 30) ? (1 << 30) : static_cast<int>(room));

  // Sample i of the row is item i + mis of the tiles; items before mis and
  // from nend on carry no code. An aligned 16-byte load that holds one
  // sample of the row stays inside the row's allocation.
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) >> 2);
  const int32_t* vrow = row - mis;
  const int64_t nend = n > 0 ? n + mis : 0;
  auto load = [&](int64_t base, int4 (&v)[VECS]) {
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
      const int64_t i = base + tid * ITEMS + 4 * q;
      v[q] = i < nend ? *reinterpret_cast<const int4*>(vrow + i) : make_int4(0, 0, 0, 0);
    }
  };

  int pos = 0;
  uint32_t carry = 0;
  int which = 0;
  int4 cur[VECS], next[VECS];
  load(0, cur);
  for (int64_t base = 0; base < nend; base += TILE) {
    load(base + TILE, next);
    int32_t r[ITEMS];
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
      r[4 * q] = cur[q].x, r[4 * q + 1] = cur[q].y, r[4 * q + 2] = cur[q].z, r[4 * q + 3] = cur[q].w;
    }
    uint32_t cv[ITEMS];  // a code of up to 32 bits, right-aligned (else unspecified)
    int len[ITEMS];      // its length; past 32 the code is made again from r
    auto code = [&](int j) {
      if (raw) {
        cv[j] = __byte_perm(static_cast<uint32_t>(r[j]), 0, 0x4401);  // the two LE16 bytes
        len[j] = 16;
      } else {
        const uint32_t u = (static_cast<uint32_t>(r[j]) << 1) ^ static_cast<uint32_t>(r[j] >> 31);
        const uint32_t q = u >> kk;
        len[j] = static_cast<int>(q < 255u ? q : 255u) + tl;
        cv[j] = (((1u << (q & 31u)) - 1u) << tl) | (u & kmask);
      }
    };
    const int64_t i0 = base + tid * ITEMS;
    int bits = 0;
    if (i0 >= mis && nend - i0 >= ITEMS) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        code(j);
        bits += len[j];
      }
    } else {
      const int jlo = i0 < mis ? static_cast<int>(mis - i0) : 0;
      const int64_t left = nend - i0;
      const int jhi = left >= ITEMS ? ITEMS : (left < 0 ? 0 : static_cast<int>(left));
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        code(j);
        if (j < jlo || j >= jhi) len[j] = 0, cv[j] = 0u;
        bits += len[j];
      }
    }

    // Exclusive scan of the threads' bits: within the warp by shuffles, then
    // the totals of the warps before this one.
    int incl = bits;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if ((tid & 31) >= d) incl += up;
    }
    if ((tid & 31) == 31) warp_bits[which][tid >> 5] = incl;
    const bool no_short = __syncthreads_and(bits == 0 || bits >= 32);
    int before = incl - bits;
    int tile_bits = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = warp_bits[which][w];
      before += w < (tid >> 5) ? t : 0;
      tile_bits += t;
    }

    const int shift = pos & 31;
    const int wbase = pos >> 5;
    const int end = shift + tile_bits;
    const int full = end >> 5;
    const int p = shift + before;
    uint32_t* win = buf[which];
    // A code past 32 bits, piece by piece; its sample goes through an empty
    // asm so that its fields are made here and not for every code.
    auto long_code = [&](int j, auto&& push) {
      int32_t rr = r[j];
      asm volatile("" : "+r"(rr));
      const Code c = make_code(rr, kk, raw);
      int o = c.ones;
      for (; o >= 32; o -= 32) push(0xFFFFFFFFu, 32);
      push((1u << o) - 1u, o);
      push(c.tail, c.tail_len);
    };
    if (no_short && full < WINDOW) {
      int w = p >> 5;
      int nacc = p & 31;
      // The tile's first bits follow the carried ones in their word.
      uint64_t acc = (before == 0 && shift != 0) ? carry >> (32 - shift) : 0u;
      const bool last = p + bits == end;
      if (bits > 0) {
        auto push = [&](uint32_t val, int l) {  // l <= 32
          acc = (acc << l) | val;
          nacc += l;
          if (nacc >= 32) {
            nacc -= 32;
            win[w++] = static_cast<uint32_t>(acc >> nacc);
          }
        };
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          if (len[j] <= 32) push(cv[j], len[j]); else long_code(j, push);
        }
        if (nacc > 0 && last) win[w] = static_cast<uint32_t>(acc << (32 - nacc));
      }
      __syncthreads();
      if (bits > 0 && nacc > 0 && !last) win[w] |= static_cast<uint32_t>(acc << (32 - nacc));
      __syncthreads();
      for (int i = tid; i < full; i += THREADS) {
        if (wbase + i < limit) words[woff + wbase + i] = __byte_perm(win[i], 0, 0x0123);
      }
      carry = (end & 31) != 0 ? win[full] : 0u;
    } else {
      for (int w0 = 0; w0 <= full; w0 += WINDOW) {
        const int nwin = full + 1 - w0 < WINDOW ? full + 1 - w0 : WINDOW;
        for (int i = tid; i < nwin; i += THREADS) win[i] = (w0 == 0 && i == 0) ? carry : 0u;
        __syncthreads();
        if (bits > 0) {
          int w = (p >> 5) - w0;
          int nacc = p & 31;
          uint64_t acc = 0;
          auto push = [&](uint32_t val, int l) {  // l <= 32
            acc = (acc << l) | val;
            nacc += l;
            const bool leaves = nacc >= 32;
            nacc &= 31;
            if (leaves && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
              atomicOr(win + w, static_cast<uint32_t>(acc >> nacc));
            }
            w += leaves ? 1 : 0;
          };
#pragma unroll
          for (int j = 0; j < ITEMS; ++j) {
            if (len[j] <= 32) push(cv[j], len[j]); else long_code(j, push);
          }
          if (nacc > 0 && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
            atomicOr(win + w, static_cast<uint32_t>(acc << (32 - nacc)));
          }
        }
        __syncthreads();
        const int nstore = full - w0 < WINDOW ? full - w0 : WINDOW;
        for (int i = tid; i < nstore; i += THREADS) {
          const int lw = wbase + w0 + i;
          if (lw < limit) words[woff + lw] = __byte_perm(win[i], 0, 0x0123);
        }
        if (full - w0 < WINDOW) carry = win[full - w0];
        if (w0 + WINDOW <= full) __syncthreads();  // this window again for the tile's next words
      }
    }
    which ^= 1;
    pos += tile_bits;
#pragma unroll
    for (int q = 0; q < VECS; ++q) cur[q] = next[q];
  }

  if (tid == 0) {
    if ((pos & 31) != 0 && (pos >> 5) < limit) {
      words[woff + (pos >> 5)] = __byte_perm(carry, 0, 0x0123);
    }
    lane_bytes[lane] = (static_cast<int64_t>(pos) + 7) >> 3;
  }
}

}  // namespace

extern "C" int flo_pack_designs() { return 19; }

// Design 0, pass 1: bitoff [L, S] int32 (each code's bit offset in its lane)
// and lane_bits [L] int64.
extern "C" int flo_pack_d0_lengths(const void* res, const void* k, const void* nvalid,
                                   const void* is_raw, void* bitoff, void* lane_bits, int64_t L,
                                   int64_t S, void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  lengths_kernel<<<static_cast<unsigned int>(L), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(nvalid), static_cast<const uint8_t*>(is_raw),
      static_cast<int32_t*>(bitoff), static_cast<int64_t*>(lane_bits), S);
  return static_cast<int>(cudaGetLastError());
}

// Design 0, pass 2: words [NW] zeroed on entry, MSB-first words on return.
extern "C" int flo_pack_d0_scatter(const void* res, const void* k, const void* nvalid,
                                   const void* is_raw, const void* bitoff,
                                   const void* lane_woff, void* words, int64_t L, int64_t S,
                                   int64_t NW, void* stream) {
  if (L <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tiles = (S + kThreads - 1) / kThreads;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  scatter_kernel<<<dim3(static_cast<unsigned int>(L), static_cast<unsigned int>(tiles)),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(nvalid), static_cast<const uint8_t*>(is_raw),
      static_cast<const int32_t*>(bitoff), static_cast<const int64_t*>(lane_woff),
      static_cast<uint32_t*>(words), S, NW);
  return static_cast<int>(cudaGetLastError());
}

// Design 0, pass 3: every word of the buffer into byte order.
extern "C" int flo_pack_d0_byteswap(void* words, int64_t NW, void* stream) {
  if (NW <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (NW + kThreads - 1) / kThreads;
  byteswap_kernel<<<static_cast<unsigned int>(blocks < 65535 ? blocks : 65535), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(words), NW);
  return static_cast<int>(cudaGetLastError());
}

// Designs 1-18: lane_bits [L] int64 from one read of the residuals.
extern "C" int flo_pack_count(const void* res, const void* k, const void* nvalid,
                              const void* is_raw, void* lane_bits, int64_t L, int64_t S,
                              void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  count_kernel<<<static_cast<unsigned int>(L), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(nvalid), static_cast<const uint8_t*>(is_raw),
      static_cast<int64_t*>(lane_bits), S);
  return static_cast<int>(cudaGetLastError());
}

// Designs 1-18: lane_off [L] int64 (bytes), lane_span [L] int64 (words) and
// total [1] int64 (words) from lane_bits, or from hint_bytes [L] int32 where
// that is not null.
extern "C" int flo_pack_layout(const void* lane_bits, const void* hint_bytes, int64_t L,
                               void* lane_off, void* lane_span, void* total, void* stream) {
  layout_kernel<<<1, kLayoutThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(lane_bits), static_cast<const int32_t*>(hint_bytes), L,
      static_cast<int64_t*>(lane_off), static_cast<int64_t*>(lane_span),
      static_cast<int64_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

// Designs 1-18: the pack itself. words [NW] needs no initial value; every
// word of a lane's stream inside its span and the buffer is stored once.
// lane_bytes [L] int64 is the pack's own count.
extern "C" int flo_pack_pack(int32_t design, const void* res, const void* k, const void* nvalid,
                             const void* is_raw, const void* lane_off, const void* lane_span,
                             void* words, void* lane_bytes, int64_t L, int64_t S, int64_t NW,
                             void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned int>(L));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLO_PACK_ARGS                                                                     \
  static_cast<const int32_t*>(res), static_cast<const int32_t*>(k),                       \
      static_cast<const int32_t*>(nvalid), static_cast<const uint8_t*>(is_raw),           \
      static_cast<const int64_t*>(lane_off), static_cast<const int64_t*>(lane_span),      \
      static_cast<uint32_t*>(words), static_cast<int64_t*>(lane_bytes), S, NW
  switch (design) {
    case kScatter: pack_kernel<kScatter><<<grid, kThreads, 0, st>>>(FLO_PACK_ARGS); break;
    case kRuns: pack_kernel<kRuns><<<grid, kThreads, 0, st>>>(FLO_PACK_ARGS); break;
    case kGather: pack_kernel<kGather><<<grid, kThreads, 0, st>>>(FLO_PACK_ARGS); break;
    case 4: pack_direct_kernel<256, 8><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 5: pack_direct_kernel<128, 16><<<grid, 128, 0, st>>>(FLO_PACK_ARGS); break;
    case 6: pack_direct_kernel<128, 8><<<grid, 128, 0, st>>>(FLO_PACK_ARGS); break;
    case 7: pack_flat_kernel<128, 8, 8><<<grid, 128, 0, st>>>(FLO_PACK_ARGS); break;
    case 8: pack_flat_kernel<256, 8, 4><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 9: pack_flat_kernel<256, 8, 2><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 10: pack_quiet_kernel<256, 8, 4, false><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 11: pack_quiet_kernel<256, 8, 4, true><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 12: pack_quiet_kernel<128, 16, 5, true><<<grid, 128, 0, st>>>(FLO_PACK_ARGS); break;
    case 13: pack_lean_kernel<256, 8, 4><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 14: pack_lean_kernel<256, 8, 5><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 15: pack_lean_kernel<128, 8, 8><<<grid, 128, 0, st>>>(FLO_PACK_ARGS); break;
    case 16: pack_lean_kernel<128, 16, 4><<<grid, 128, 0, st>>>(FLO_PACK_ARGS); break;
    case 17: pack_lean_kernel<256, 16, 2><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 18: pack_lean_kernel<512, 8, 2><<<grid, 512, 0, st>>>(FLO_PACK_ARGS); break;
    // Timing only: designs 2 and 8 with parts cut out (10 * design + CUT).
    case 21: pack_kernel<kRuns, 1><<<grid, kThreads, 0, st>>>(FLO_PACK_ARGS); break;
    case 22: pack_kernel<kRuns, 2><<<grid, kThreads, 0, st>>>(FLO_PACK_ARGS); break;
    case 23: pack_kernel<kRuns, 3><<<grid, kThreads, 0, st>>>(FLO_PACK_ARGS); break;
    case 81: pack_flat_kernel<256, 8, 4, 1><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 82: pack_flat_kernel<256, 8, 4, 2><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    case 83: pack_flat_kernel<256, 8, 4, 3><<<grid, 256, 0, st>>>(FLO_PACK_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLO_PACK_ARGS
  return static_cast<int>(cudaGetLastError());
}
