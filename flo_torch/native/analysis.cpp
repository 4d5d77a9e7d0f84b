// Host analysis hot paths (C++/OpenMP): the native equivalents of the
// reference's analysis subsystem inner loops so bulk encode can afford to
// auto-embed analysis metadata (lib.rs:219-283) at throughput:
//
//  - blake3_digest: from-spec BLAKE3 (the reference fingerprints audio with
//    the Rust blake3 crate, analysis.rs:245-262). Chunks are independent by
//    construction, so they hash in parallel; parents merge level-wise
//    (equivalent to the spec's left-complete tree; validated against the
//    official test vectors via tests/test_analysis.py).
//  - kweight_cascade: the two BS.1770 K-weighting biquads (ebu_r128.rs:57-101)
//    applied in-place, f64, parallel over independent lanes.
//  - fir_absmax: per-lane max|conv(x, h)| for the reference's "4x" true peak
//    (which truncates its fractional index, so one convolution suffices —
//    see core/ebu_r128.py).
//
// Built lazily by flo_tpu/native/__init__.py; numpy/scipy fallbacks exist.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX2__) && defined(__FMA__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------- BLAKE3

static const uint32_t IV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                               0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                               0x1F83D9ABu, 0x5BE0CD19u};
static const int PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};
enum { CHUNK_START = 1, CHUNK_END = 2, PARENT = 4, ROOT = 8 };
enum { CHUNK_LEN = 1024, BLOCK_LEN = 64 };

static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static inline void g(uint32_t* v, int a, int b, int c, int d, uint32_t x,
                     uint32_t y) {
  v[a] += v[b] + x;
  v[d] = rotr32(v[d] ^ v[a], 16);
  v[c] += v[d];
  v[b] = rotr32(v[b] ^ v[c], 12);
  v[a] += v[b] + y;
  v[d] = rotr32(v[d] ^ v[a], 8);
  v[c] += v[d];
  v[b] = rotr32(v[b] ^ v[c], 7);
}

static void compress(const uint32_t cv[8], const uint32_t block[16],
                     uint64_t counter, uint32_t block_len, uint32_t flags,
                     uint32_t out[8]) {
  uint32_t v[16];
  uint32_t m[16];
  std::memcpy(v, cv, 32);
  std::memcpy(v + 8, IV, 16);
  v[12] = (uint32_t)(counter & 0xFFFFFFFFu);
  v[13] = (uint32_t)(counter >> 32);
  v[14] = block_len;
  v[15] = flags;
  std::memcpy(m, block, 64);
  for (int r = 0; r < 7; r++) {
    g(v, 0, 4, 8, 12, m[0], m[1]);
    g(v, 1, 5, 9, 13, m[2], m[3]);
    g(v, 2, 6, 10, 14, m[4], m[5]);
    g(v, 3, 7, 11, 15, m[6], m[7]);
    g(v, 0, 5, 10, 15, m[8], m[9]);
    g(v, 1, 6, 11, 12, m[10], m[11]);
    g(v, 2, 7, 8, 13, m[12], m[13]);
    g(v, 3, 4, 9, 14, m[14], m[15]);
    if (r < 6) {
      uint32_t t[16];
      for (int i = 0; i < 16; i++) t[i] = m[PERM[i]];
      std::memcpy(m, t, 64);
    }
  }
  for (int i = 0; i < 8; i++) out[i] = v[i] ^ v[i + 8];
}

static void chunk_cv(const uint8_t* data, int64_t nbytes, uint64_t counter,
                     uint32_t extra_flags_last, uint32_t out[8]) {
  uint32_t cv[8];
  std::memcpy(cv, IV, 32);
  int64_t n_blocks = nbytes <= 0 ? 1 : (nbytes + BLOCK_LEN - 1) / BLOCK_LEN;
  for (int64_t b = 0; b < n_blocks; b++) {
    uint8_t buf[BLOCK_LEN] = {0};
    int64_t off = b * BLOCK_LEN;
    int64_t len = std::max<int64_t>(0, std::min<int64_t>(BLOCK_LEN, nbytes - off));
    if (len > 0) std::memcpy(buf, data + off, (size_t)len);
    uint32_t block[16];
    std::memcpy(block, buf, 64);  // little-endian hosts only (x86/arm64)
    uint32_t flags = 0;
    if (b == 0) flags |= CHUNK_START;
    if (b == n_blocks - 1) flags |= CHUNK_END | extra_flags_last;
    uint32_t next[8];
    compress(cv, block, counter, (uint32_t)len, flags, next);
    std::memcpy(cv, next, 32);
  }
  std::memcpy(out, cv, 32);
}

// ---- SIMD chunk batch: BW full chunks hashed in lockstep, state kept
// column-major (state row i = uint32[BW], one lane per chunk) so every
// g-function line is a BW-wide elementwise loop gcc auto-vectorizes at
// -O3 -march=native (AVX2/AVX-512 on this host). Message words are read
// through a per-round schedule table instead of permuting the block.
enum { BW = 16 };

static const uint8_t* sched_table() {
  static uint8_t s[7][16];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 16; i++) s[0][i] = (uint8_t)i;
    for (int r = 1; r < 7; r++)
      for (int i = 0; i < 16; i++) s[r][i] = s[r - 1][PERM[i]];
    init = true;
  }
  return &s[0][0];
}

// GCC vector extension: one value = BW u32 lanes (gcc lowers to AVX-512 /
// 2x AVX2 on this host; the auto-vectorizer left these loops scalar).
typedef uint32_t vBWu __attribute__((vector_size(BW * 4)));

static inline vBWu rotrv(vBWu x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void gv(vBWu* v, int a, int b, int c, int d, vBWu x, vBWu y) {
  v[a] += v[b] + x;
  v[d] = rotrv(v[d] ^ v[a], 16);
  v[c] += v[d];
  v[b] = rotrv(v[b] ^ v[c], 12);
  v[a] += v[b] + y;
  v[d] = rotrv(v[d] ^ v[a], 8);
  v[c] += v[d];
  v[b] = rotrv(v[b] ^ v[c], 7);
}

// data: BW contiguous FULL 1024-byte chunks; out: BW chaining values.
static void chunks_cv_batch(const uint8_t* data, uint64_t counter0,
                            uint32_t* out) {
  const uint8_t* sched = sched_table();
  vBWu cv[8];
  for (int i = 0; i < 8; i++)
    for (int w = 0; w < BW; w++) cv[i][w] = IV[i];
  vBWu vcounter_lo, vcounter_hi;
  for (int w = 0; w < BW; w++) {
    uint64_t ctr = counter0 + (uint64_t)w;
    vcounter_lo[w] = (uint32_t)(ctr & 0xFFFFFFFFu);
    vcounter_hi[w] = (uint32_t)(ctr >> 32);
  }
  for (int b = 0; b < CHUNK_LEN / BLOCK_LEN; b++) {
    vBWu m[16];
    for (int w = 0; w < BW; w++) {
      const uint8_t* src = data + (size_t)w * CHUNK_LEN + (size_t)b * BLOCK_LEN;
      for (int i = 0; i < 16; i++) {
        uint32_t word;
        std::memcpy(&word, src + i * 4, 4);  // little-endian hosts only
        m[i][w] = word;
      }
    }
    uint32_t flags = (b == 0 ? CHUNK_START : 0) |
                     (b == CHUNK_LEN / BLOCK_LEN - 1 ? CHUNK_END : 0);
    vBWu v[16];
    for (int i = 0; i < 8; i++) v[i] = cv[i];
    for (int i = 0; i < 4; i++) v[8 + i] = vBWu{} + IV[i];
    v[12] = vcounter_lo;
    v[13] = vcounter_hi;
    v[14] = vBWu{} + (uint32_t)BLOCK_LEN;
    v[15] = vBWu{} + flags;
    for (int r = 0; r < 7; r++) {
      const uint8_t* s = sched + r * 16;
      gv(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
      gv(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
      gv(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
      gv(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
      gv(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
      gv(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
      gv(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
      gv(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; i++) cv[i] = v[i] ^ v[8 + i];
  }
  for (int w = 0; w < BW; w++)
    for (int i = 0; i < 8; i++) out[(size_t)w * 8 + i] = cv[i][w];
}

void blake3_digest(const uint8_t* data, int64_t n, uint8_t out32[32]) {
  int64_t n_chunks = n <= 0 ? 1 : (n + CHUNK_LEN - 1) / CHUNK_LEN;
  if (n_chunks == 1) {
    uint32_t cv[8];
    chunk_cv(data, n, 0, ROOT, cv);
    std::memcpy(out32, cv, 32);
    return;
  }
  std::vector<uint32_t> cvs((size_t)n_chunks * 8);
  const int64_t full = n / CHUNK_LEN;  // complete 1024-byte chunks
  const int64_t batches = full / BW;
#pragma omp parallel for schedule(static)
  for (int64_t g = 0; g < batches; g++) {
    int64_t c = g * BW;
    chunks_cv_batch(data + c * CHUNK_LEN, (uint64_t)c, &cvs[(size_t)c * 8]);
  }
#pragma omp parallel for schedule(static)
  for (int64_t c = batches * BW; c < n_chunks; c++) {
    int64_t off = c * CHUNK_LEN;
    int64_t len = std::min<int64_t>(CHUNK_LEN, n - off);
    chunk_cv(data + off, len, (uint64_t)c, 0, &cvs[(size_t)c * 8]);
  }
  // Level-wise pairwise merge, odd node carried (== the spec's tree). Each
  // level is written to the other of two buffers: merged in place, pair p
  // would overwrite cvs[p] while another thread still reads it as half of
  // pair p / 2.
  std::vector<uint32_t> next((size_t)((n_chunks + 1) / 2) * 8);
  int64_t m = n_chunks;
  while (m > 2) {
    int64_t pairs = m / 2;
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < pairs; p++) {
      uint32_t block[16];
      std::memcpy(block, &cvs[(size_t)(2 * p) * 8], 32);
      std::memcpy(block + 8, &cvs[(size_t)(2 * p + 1) * 8], 32);
      compress(IV, block, 0, BLOCK_LEN, PARENT, &next[(size_t)p * 8]);
    }
    if (m & 1) std::memcpy(&next[(size_t)pairs * 8], &cvs[(size_t)(m - 1) * 8], 32);
    m = pairs + (m & 1);
    cvs.swap(next);
  }
  uint32_t block[16];
  std::memcpy(block, &cvs[0], 32);
  std::memcpy(block + 8, &cvs[8], 32);
  uint32_t root[8];
  compress(IV, block, 0, BLOCK_LEN, PARENT | ROOT, root);
  std::memcpy(out32, root, 32);
}

// --------------------------------------------------- K-weighting biquads

// x: [lanes, n] f64 in-place; coefs: shelf_b0..2, shelf_a1..2, hp_b0..2,
// hp_a1..2 (a0 normalized to 1). Direct form I, sequential per lane —
// bit-identical to scipy.signal.lfilter's recurrence.
void kweight_cascade(double* x, int64_t lanes, int64_t n, const double* cf) {
  const double sb0 = cf[0], sb1 = cf[1], sb2 = cf[2], sa1 = cf[3], sa2 = cf[4];
  const double hb0 = cf[5], hb1 = cf[6], hb2 = cf[7], ha1 = cf[8], ha2 = cf[9];
#pragma omp parallel for schedule(static)
  for (int64_t l = 0; l < lanes; l++) {
    double* row = x + l * n;
    double x1 = 0, x2 = 0, y1 = 0, y2 = 0;     // stage 1 state
    double u1 = 0, u2 = 0, w1 = 0, w2 = 0;     // stage 2 state
    for (int64_t i = 0; i < n; i++) {
      double xi = row[i];
      double yi = sb0 * xi + sb1 * x1 + sb2 * x2 - sa1 * y1 - sa2 * y2;
      x2 = x1; x1 = xi; y2 = y1; y1 = yi;
      double wi = hb0 * yi + hb1 * u1 + hb2 * u2 - ha1 * w1 - ha2 * w2;
      u2 = u1; u1 = yi; w2 = w1; w1 = wi;
      row[i] = wi;
    }
  }
}

// ------------------------------------------------------- true-peak FIR

// One output position, scalar (boundary samples where the tap window clips).
static inline double fir_one(const double* row, int64_t n, const double* h,
                             int64_t taps, int64_t center, int64_t i) {
  double acc = 0.0;
  int64_t k0 = std::max<int64_t>(0, center - i);
  int64_t k1 = std::min<int64_t>(taps, n - i + center);
  const double* src = row + i - center;
  for (int64_t k = k0; k < k1; k++) acc += h[k] * src[k];
  return acc < 0 ? -acc : acc;
}

// out_max[l] = max_i |sum_k h[k] * x[l, i - center + k]| (zeros outside).
// Interior positions (full tap window) vectorize across i — each vector lane
// is one output, so the per-output tap summation order is identical to the
// scalar loop (and FMA matches gcc's default -ffp-contract on this TU).
void fir_absmax(const double* x, int64_t lanes, int64_t n, const double* h,
                int64_t taps, int64_t center, double* out_max) {
  const int64_t lo = std::min(center, n);               // first full-window i
  const int64_t hi = std::max(lo, n - taps + center + 1);  // one past last
#pragma omp parallel for schedule(static)
  for (int64_t l = 0; l < lanes; l++) {
    const double* row = x + l * n;
    double best = 0.0;
    for (int64_t i = 0; i < lo; i++) best = std::max(best, fir_one(row, n, h, taps, center, i));
    int64_t i = lo;
#if defined(__AVX2__) && defined(__FMA__)
    const __m256d signmask = _mm256_set1_pd(-0.0);
    __m256d vbest0 = _mm256_setzero_pd(), vbest1 = _mm256_setzero_pd();
    for (; i + 8 <= hi; i += 8) {
      const double* src = row + i - center;
      __m256d a0 = _mm256_setzero_pd(), a1 = _mm256_setzero_pd();
      for (int64_t k = 0; k < taps; k++) {
        const __m256d hk = _mm256_set1_pd(h[k]);
        a0 = _mm256_fmadd_pd(hk, _mm256_loadu_pd(src + k), a0);
        a1 = _mm256_fmadd_pd(hk, _mm256_loadu_pd(src + k + 4), a1);
      }
      vbest0 = _mm256_max_pd(vbest0, _mm256_andnot_pd(signmask, a0));
      vbest1 = _mm256_max_pd(vbest1, _mm256_andnot_pd(signmask, a1));
    }
    alignas(32) double tmp[4];
    _mm256_store_pd(tmp, _mm256_max_pd(vbest0, vbest1));
    for (int t = 0; t < 4; t++) best = std::max(best, tmp[t]);
#endif
    for (; i < hi; i++) best = std::max(best, fir_one(row, n, h, taps, center, i));
    for (i = hi; i < n; i++) best = std::max(best, fir_one(row, n, h, taps, center, i));
    out_max[l] = best;
  }
}

// ----------------------------------------------- fused bulk loudness pass

// One call per file: interleaved f32 -> per-hop K-weighted energies (summed
// over channels, trailing partial hop in seg_out[nseg]) + true-peak and
// sample-peak linear maxima. Replaces four separate Python passes (f64
// transpose copy, |x| max, kk = kw*kw, reshape-sum) with one C++ pass per
// channel; the biquad/FIR inner loops are the exact kernels above, so the
// numbers match the portable path to the last ulp ordering differences.
// Two independent K-weighting chains interleaved in one loop: the biquad
// recurrence is latency-bound (a serial FMA chain per lane), so running two
// lanes through the loop hides ~half the chain latency. Arithmetic order
// per lane is IDENTICAL to kweight_cascade.
static void kweight_pair(double* r0, double* r1, int64_t n, const double* cf) {
  const double sb0 = cf[0], sb1 = cf[1], sb2 = cf[2], sa1 = cf[3], sa2 = cf[4];
  const double hb0 = cf[5], hb1 = cf[6], hb2 = cf[7], ha1 = cf[8], ha2 = cf[9];
  double x1a = 0, x2a = 0, y1a = 0, y2a = 0, u1a = 0, u2a = 0, w1a = 0, w2a = 0;
  double x1b = 0, x2b = 0, y1b = 0, y2b = 0, u1b = 0, u2b = 0, w1b = 0, w2b = 0;
  for (int64_t i = 0; i < n; i++) {
    double xa = r0[i], xb = r1[i];
    double ya = sb0 * xa + sb1 * x1a + sb2 * x2a - sa1 * y1a - sa2 * y2a;
    double yb = sb0 * xb + sb1 * x1b + sb2 * x2b - sa1 * y1b - sa2 * y2b;
    x2a = x1a; x1a = xa; y2a = y1a; y1a = ya;
    x2b = x1b; x1b = xb; y2b = y1b; y1b = yb;
    double wa = hb0 * ya + hb1 * u1a + hb2 * u2a - ha1 * w1a - ha2 * w2a;
    double wb = hb0 * yb + hb1 * u1b + hb2 * u2b - ha1 * w1b - ha2 * w2b;
    u2a = u1a; u1a = ya; w2a = w1a; w1a = wa;
    u2b = u1b; u1b = yb; w2b = w1b; w1b = wb;
    r0[i] = wa;
    r1[i] = wb;
  }
}

void loudness_pass(const float* interleaved, int64_t n, int64_t C,
                   const double* cf, const double* h, int64_t taps,
                   int64_t center, int64_t hop, double* seg_out,
                   double* peaks_out) {
  const int64_t nseg = hop > 0 ? n / hop : 0;
  for (int64_t s = 0; s <= nseg; s++) seg_out[s] = 0.0;
  double tp = 0.0, sp = 0.0;
  std::vector<double> lanes((size_t)std::max<int64_t>(n * C, 1));
  for (int64_t c = 0; c < C; c++) {
    double* ln = lanes.data() + c * n;
    const float* src = interleaved + c;
    for (int64_t i = 0; i < n; i++) ln[i] = (double)src[i * C];
    for (int64_t i = 0; i < n; i++) sp = std::max(sp, std::fabs(ln[i]));
  }
  std::vector<double> tmax((size_t)C, 0.0);
  fir_absmax(lanes.data(), C, n, h, taps, center, tmax.data());
  for (int64_t c = 0; c < C; c++) tp = std::max(tp, tmax[(size_t)c]);
  int64_t c = 0;
  for (; c + 2 <= C; c += 2)
    kweight_pair(lanes.data() + c * n, lanes.data() + (c + 1) * n, n, cf);
  if (c < C) kweight_cascade(lanes.data() + c * n, 1, n, cf);
  for (int64_t cc = 0; cc < C; cc++) {
    const double* ln = lanes.data() + cc * n;
    for (int64_t s = 0; s < nseg; s++) {
      const double* p = ln + s * hop;
      double acc = 0.0;
      for (int64_t i = 0; i < hop; i++) acc += p[i] * p[i];
      seg_out[s] += acc;
    }
    double acc = 0.0;
    for (int64_t i = nseg * hop; i < n; i++) acc += ln[i] * ln[i];
    seg_out[nseg] += acc;
  }
  peaks_out[0] = tp;
  peaks_out[1] = sp;
}

// f64-accumulated sum of squares of an f32 buffer (fingerprint avg
// loudness, analysis.rs:341-356) — one pass, 8 accumulators so the loop
// vectorizes while keeping near-pairwise accumulation error.
double sumsq_f32(const float* x, int64_t n) {
  double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t i = 0;
  for (; i + 8 <= n; i += 8)
    for (int k = 0; k < 8; k++) {
      double d = (double)x[i + k];
      acc[k] += d * d;
    }
  double total = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                 ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  for (; i < n; i++) {
    double d = (double)x[i];
    total += d * d;
  }
  return total;
}

}  // extern "C"
