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
// What bounds it on the card: by bytes, 4 a sample in and about one out.
// What it is held to in fact is instructions: with the assembly of a tile's
// bits cut out the kernel runs near memory speed, shared-memory atomics are
// the dearest way to assemble, and after them every instruction a code
// counts (csrc/probes/pack_designs.cu has every design tried and what each
// took; this is its design 16).
//
// What the design does about it (the TPU's superrows and barrel-shift
// merges, built because indexed stores cost ~7 ns there, have no
// counterpart):
//  - the residuals are read once where the caller knows the lanes' byte
//    counts (the search does), else twice: `count_kernel`, a block a lane,
//    leaves only the lane's bit count, 8 bytes a lane;
//  - `layout_kernel`, one block, turns the lanes' bit counts (or the
//    caller's byte counts) into word-aligned lane offsets and their total,
//    on the device;
//  - `pack_kernel`, a block a lane, walks the lane in tiles of 2,048 codes.
//    Tiles are cut from the 16-byte boundary at or before the row's start, so
//    a thread loads its 16 consecutive samples as four aligned int4 straight
//    into registers, the next tile's before this tile's work. A code of up to
//    32 bits is made once, as a value and a length (a thread whose samples
//    are all inside the lane skips the per-sample bounds; a longer code is
//    made again where it is written, its fields pinned inside that branch).
//    The threads' bit totals are scanned with shuffles and the warps' totals,
//    with a running bit position between tiles. The thread then concatenates
//    its codes in a 64-bit register and stores each word that fills to a
//    shared-memory window. The tile's finished words go to the buffer with
//    coalesced stores, already in byte order, each exactly once; the partial
//    word at a tile's end is carried to the next tile in the block, and the
//    lane's last partial word is stored zero-padded. So the buffer needs no
//    initial value, and there is no global atomic, no array the size of the
//    input and no byte-order pass;
//  - the words that two threads share: in a tile in which every thread has 32
//    bits or more (or none), a word has at most two writers, the thread whose
//    bits end in it and the thread whose bits begin in it. Every word that
//    leaves a thread's register is stored plainly, its first one too (the
//    tile's first thread starts from the carried bits, the others from zeros
//    above their first bit), and after a barrier each thread ORs its last,
//    partial word into the word its successor has begun, by a plain read and
//    write: no atomic, no zeroed window, no flag or bounds in a code's step.
//    A tile with a shorter thread (near-silence at small k) or with more
//    bits than the window holds (codes past 32 bits on average; walked in
//    several windows) zeroes the window and ORs every leaving word in with a
//    shared atomic. The barrier of the scan votes on the route; both are in
//    the one launch and give the same bytes;
//  - two windows take turns, which saves a barrier a tile.

#include <cstdint>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 16;  // samples per thread per tile
constexpr int kVecs = kItems / 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWindow = kTile;  // words: a tile of raw samples is half of it
constexpr int kMinBlocks = 4;   // 16 warps an SM, up to 128 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kCountThreads = 256;
constexpr int kLayoutThreads = 1024;

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

// A lane's bit count and nothing else. A raw lane is 16 bits a sample and is
// not read.
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
             const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
             int64_t* __restrict__ lane_bits, int64_t S) {
  using Reduce = cub::BlockReduce<unsigned int, kCountThreads>;
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
  for (int64_t i = threadIdx.x; i < nvec; i += kCountThreads) {
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

// The pack of one lane a block; see the head of the file. Writes words
// [woff, woff + min(span, NW - woff)) of the lane's stream and nothing else,
// and the lane's own byte count.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pack_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ k,
            const int32_t* __restrict__ nvalid, const uint8_t* __restrict__ is_raw,
            const int64_t* __restrict__ lane_off, const int64_t* __restrict__ lane_span,
            uint32_t* __restrict__ words, int64_t* __restrict__ lane_bytes, int64_t S,
            int64_t NW) {
  __shared__ int warp_bits[2][kWarps];
  __shared__ uint32_t buf[2][kWindow];

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
  auto load = [&](int64_t base, int4 (&v)[kVecs]) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int64_t i = base + tid * kItems + 4 * q;
      v[q] = i < nend ? *reinterpret_cast<const int4*>(vrow + i) : make_int4(0, 0, 0, 0);
    }
  };

  int pos = 0;
  uint32_t carry = 0;
  int which = 0;
  int4 cur[kVecs], next[kVecs];
  load(0, cur);
  for (int64_t base = 0; base < nend; base += kTile) {
    load(base + kTile, next);
    int32_t r[kItems];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      r[4 * q] = cur[q].x, r[4 * q + 1] = cur[q].y, r[4 * q + 2] = cur[q].z, r[4 * q + 3] = cur[q].w;
    }
    uint32_t cv[kItems];  // a code of up to 32 bits, right-aligned (else unspecified)
    int len[kItems];      // its length; past 32 the code is made again from r
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
    const int64_t i0 = base + tid * kItems;
    int bits = 0;
    if (i0 >= mis && nend - i0 >= kItems) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        code(j);
        bits += len[j];
      }
    } else {
      const int jlo = i0 < mis ? static_cast<int>(mis - i0) : 0;
      const int64_t left = nend - i0;
      const int jhi = left >= kItems ? kItems : (left < 0 ? 0 : static_cast<int>(left));
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
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
    for (int w = 0; w < kWarps; ++w) {
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
    if (no_short && full < kWindow) {
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
        for (int j = 0; j < kItems; ++j) {
          if (len[j] <= 32) push(cv[j], len[j]); else long_code(j, push);
        }
        if (nacc > 0 && last) win[w] = static_cast<uint32_t>(acc << (32 - nacc));
      }
      __syncthreads();
      if (bits > 0 && nacc > 0 && !last) win[w] |= static_cast<uint32_t>(acc << (32 - nacc));
      __syncthreads();
      for (int i = tid; i < full; i += kThreads) {
        if (wbase + i < limit) words[woff + wbase + i] = __byte_perm(win[i], 0, 0x0123);
      }
      carry = (end & 31) != 0 ? win[full] : 0u;
    } else {
      // The other route: the window zeroed, every leaving word ORed in with a
      // shared atomic, the tile's words walked a window at a time.
      for (int w0 = 0; w0 <= full; w0 += kWindow) {
        const int nwin = full + 1 - w0 < kWindow ? full + 1 - w0 : kWindow;
        for (int i = tid; i < nwin; i += kThreads) win[i] = (w0 == 0 && i == 0) ? carry : 0u;
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
          for (int j = 0; j < kItems; ++j) {
            if (len[j] <= 32) push(cv[j], len[j]); else long_code(j, push);
          }
          if (nacc > 0 && static_cast<unsigned int>(w) < static_cast<unsigned int>(nwin)) {
            atomicOr(win + w, static_cast<uint32_t>(acc << (32 - nacc)));
          }
        }
        __syncthreads();
        const int nstore = full - w0 < kWindow ? full - w0 : kWindow;
        for (int i = tid; i < nstore; i += kThreads) {
          const int lw = wbase + w0 + i;
          if (lw < limit) words[woff + lw] = __byte_perm(win[i], 0, 0x0123);
        }
        if (full - w0 < kWindow) carry = win[full - w0];
        if (w0 + kWindow <= full) __syncthreads();  // this window again for the tile's next words
      }
    }
    which ^= 1;
    pos += tile_bits;
#pragma unroll
    for (int q = 0; q < kVecs; ++q) cur[q] = next[q];
  }

  if (tid == 0) {
    if ((pos & 31) != 0 && (pos >> 5) < limit) {
      words[woff + (pos >> 5)] = __byte_perm(carry, 0, 0x0123);
    }
    lane_bytes[lane] = (static_cast<int64_t>(pos) + 7) >> 3;
  }
}

}  // namespace

// Geometry the wrapper mirrors: [codes a tile, words a window].
extern "C" int flo_rice_pack_geometry(int32_t* out) {
  out[0] = kTile;
  out[1] = kWindow;
  return 0;
}

// res [L, S] int32; k, nvalid [L] int32; is_raw [L] bool (one byte);
// hint_bytes [L] int32 or null. Outputs, all int64: lane_bits [L] (scratch;
// untouched with a hint), lane_off [L] (bytes), lane_span [L] (words), total
// [1] (words). With a hint a lane's span is ceil(hint / 4) words and the
// residuals are not read. Launches on `stream`; returns cudaGetLastError().
extern "C" int flo_rice_pack_layout(const void* res, const void* k, const void* nvalid,
                                    const void* is_raw, const void* hint_bytes, void* lane_bits,
                                    void* lane_off, void* lane_span, void* total, int64_t L,
                                    int64_t S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L > 0 && hint_bytes == nullptr) {
    count_kernel<<<static_cast<unsigned int>(L), kCountThreads, 0, st>>>(
        static_cast<const int32_t*>(res), static_cast<const int32_t*>(k),
        static_cast<const int32_t*>(nvalid), static_cast<const uint8_t*>(is_raw),
        static_cast<int64_t*>(lane_bits), S);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  layout_kernel<<<1, kLayoutThreads, 0, st>>>(
      static_cast<const int64_t*>(lane_bits), static_cast<const int32_t*>(hint_bytes), L,
      static_cast<int64_t*>(lane_off), static_cast<int64_t*>(lane_span),
      static_cast<int64_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

// The pack itself, after flo_rice_pack_layout on the same stream. words [NW]
// needs no initial value: every word of a lane's stream inside its span and
// the buffer is stored once, the rest is left as it was. lane_bytes [L]
// int64 is the pack's own count. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int flo_rice_pack(const void* res, const void* k, const void* nvalid,
                             const void* is_raw, const void* lane_off, const void* lane_span,
                             void* words, void* lane_bytes, int64_t L, int64_t S, int64_t NW,
                             void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  pack_kernel<<<static_cast<unsigned int>(L), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(nvalid), static_cast<const uint8_t*>(is_raw),
      static_cast<const int64_t*>(lane_off), static_cast<const int64_t*>(lane_span),
      static_cast<uint32_t*>(words), static_cast<int64_t*>(lane_bytes), S, NW);
  return static_cast<int>(cudaGetLastError());
}
