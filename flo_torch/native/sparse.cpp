// Native sparse run-length coefficient coder.
//
// Wire format (libflo lossy encoder.rs:284-329): repeated runs of
// [zero_count varint][non_zero_count u8][i16 LE values], non-zero runs capped
// at 255 per chunk; an all-trailing-zero tail emits [varint][0]. Rows are
// independent -> OpenMP across rows.
//
// Build: g++ -O3 -fopenmp -shared -fPIC sparse.cpp -o libsparse.so

#include <cstdint>
#include <cstring>

namespace {

inline int varint_len(uint32_t v) {
    int n = 1;
    while (v >= 0x80) {
        v >>= 7;
        ++n;
    }
    return n;
}

inline int64_t put_varint(uint8_t* out, int64_t pos, uint32_t v) {
    while (true) {
        uint8_t b = v & 0x7F;
        v >>= 7;
        if (v) {
            out[pos++] = b | 0x80;
        } else {
            out[pos++] = b;
            return pos;
        }
    }
}

// Walk one row's runs; if out != nullptr, emit; returns byte size.
inline int64_t walk_row(const int16_t* q, int64_t width, uint8_t* out) {
    int64_t pos = 0;
    int64_t i = 0;
    while (i < width) {
        int64_t zero_start = i;
        while (i < width && q[i] == 0) ++i;
        uint32_t zeros = static_cast<uint32_t>(i - zero_start);
        int64_t nz_start = i;
        while (i < width && q[i] != 0 && (i - nz_start) < 255) ++i;
        uint32_t nz = static_cast<uint32_t>(i - nz_start);
        if (out) {
            pos = put_varint(out, pos, zeros);
            out[pos++] = static_cast<uint8_t>(nz);
            std::memcpy(out + pos, q + nz_start, nz * 2);
            pos += nz * 2;
        } else {
            pos += varint_len(zeros) + 1 + nz * 2;
        }
    }
    return pos;
}

}  // namespace

extern "C" {

void sparse_sizes(const int16_t* rows, int64_t n, int64_t width, int64_t* sizes) {
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t r = 0; r < n; ++r) sizes[r] = walk_row(rows + r * width, width, nullptr);
}

void sparse_encode(const int16_t* rows, int64_t n, int64_t width,
                   const int64_t* offsets, uint8_t* out) {
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t r = 0; r < n; ++r) walk_row(rows + r * width, width, out + offsets[r]);
}

// ---- Encode straight FROM (col << 16 | value) entries (CSR rows) ----
//
// The device compaction already yields each row's nonzeros as sorted
// entries; walking those emits the exact byte stream of walk_row on the
// dense row without ever materializing it (the bulk encoder's dense
// scatter + 2x full-grid scans were ~70% of its host collect time).
namespace {

inline int64_t walk_row_csr(const int32_t* e, int64_t nnz, int64_t width,
                            uint8_t* out) {
    int64_t pos = 0;
    int64_t col = 0;  // first column not yet emitted
    int64_t i = 0;
    while (i < nnz) {
        int32_t c0 = e[i] >> 16;
        uint32_t zeros = static_cast<uint32_t>(c0 - col);
        int64_t j = i;
        int32_t prev = c0 - 1;
        while (j < nnz && (j - i) < 255) {
            int32_t cj = e[j] >> 16;
            if (cj != prev + 1) break;
            prev = cj;
            ++j;
        }
        uint32_t nz = static_cast<uint32_t>(j - i);
        if (out) {
            pos = put_varint(out, pos, zeros);
            out[pos++] = static_cast<uint8_t>(nz);
            for (int64_t k = i; k < j; ++k) {
                int16_t v = static_cast<int16_t>(static_cast<uint16_t>(e[k] & 0xFFFF));
                std::memcpy(out + pos, &v, 2);
                pos += 2;
            }
        } else {
            pos += varint_len(zeros) + 1 + nz * 2;
        }
        col = prev + 1;
        i = j;
    }
    if (col < width) {  // trailing zeros chunk, as walk_row emits
        uint32_t zeros = static_cast<uint32_t>(width - col);
        if (out) {
            pos = put_varint(out, pos, zeros);
            out[pos++] = 0;
        } else {
            pos += varint_len(zeros) + 1;
        }
    }
    return pos;
}

}  // namespace

void sparse_sizes_csr(const int32_t* entries, const int64_t* row_off,
                      const int32_t* row_nnz, int64_t n, int64_t width,
                      int64_t* sizes) {
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < n; ++r)
        sizes[r] = walk_row_csr(entries + row_off[r], row_nnz[r], width, nullptr);
}

void sparse_encode_csr(const int32_t* entries, const int64_t* row_off,
                       const int32_t* row_nnz, int64_t n, int64_t width,
                       const int64_t* out_offsets, uint8_t* out) {
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < n; ++r)
        walk_row_csr(entries + row_off[r], row_nnz[r], width, out + out_offsets[r]);
}

// Decode mirrors lossy/decoder.rs:134-188 incl. truncation tolerance.
void sparse_decode(const uint8_t* blob, const int64_t* offsets, const int64_t* lens,
                   int64_t n, int64_t width, int16_t* out) {
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* d = blob + offsets[r];
        const int64_t len = lens[r];
        int16_t* dst = out + r * width;
        int64_t pos = 0, idx = 0;
        while (pos < len && idx < width) {
            uint32_t zeros = 0;
            int shift = 0;
            while (pos < len) {
                uint8_t b = d[pos++];
                zeros |= static_cast<uint32_t>(b & 0x7F) << shift;
                if (!(b & 0x80)) break;
                shift += 7;
                if (shift >= 32) break;
            }
            idx += zeros;
            if (pos >= len) break;
            uint32_t nz = d[pos++];
            for (uint32_t j = 0; j < nz; ++j) {
                if (pos + 2 > len || idx >= width) break;
                int16_t v;
                std::memcpy(&v, d + pos, 2);
                dst[idx] = v;
                pos += 2;
                ++idx;
            }
        }
    }
}

// Decode straight to (col << 16 | value) entries — the device-upload form
// (ops/compact.py) — skipping the dense i16 grid, host-side
// np.nonzero, and entry packing entirely. Two passes: counts, then fill.
void sparse_entry_counts(const uint8_t* blob, const int64_t* offsets,
                         const int64_t* lens, int64_t n, int64_t width,
                         int64_t* counts) {
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* d = blob + offsets[r];
        const int64_t len = lens[r];
        int64_t pos = 0, idx = 0, cnt = 0;
        while (pos < len && idx < width) {
            uint32_t zeros = 0;
            int shift = 0;
            while (pos < len) {
                uint8_t b = d[pos++];
                zeros |= static_cast<uint32_t>(b & 0x7F) << shift;
                if (!(b & 0x80)) break;
                shift += 7;
                if (shift >= 32) break;
            }
            idx += zeros;
            if (pos >= len) break;
            uint32_t nz = d[pos++];
            for (uint32_t j = 0; j < nz; ++j) {
                if (pos + 2 > len || idx >= width) break;
                int16_t v;
                std::memcpy(&v, d + pos, 2);
                pos += 2;
                if (v != 0) ++cnt;  // mirror dense+nonzero: zero values drop
                ++idx;
            }
        }
        counts[r] = cnt;
    }
}

void sparse_decode_entries(const uint8_t* blob, const int64_t* offsets,
                           const int64_t* lens, const int64_t* entry_off,
                           int64_t n, int64_t width, int32_t* entries) {
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* d = blob + offsets[r];
        const int64_t len = lens[r];
        int32_t* dst = entries + entry_off[r];
        int64_t pos = 0, idx = 0, w = 0;
        while (pos < len && idx < width) {
            uint32_t zeros = 0;
            int shift = 0;
            while (pos < len) {
                uint8_t b = d[pos++];
                zeros |= static_cast<uint32_t>(b & 0x7F) << shift;
                if (!(b & 0x80)) break;
                shift += 7;
                if (shift >= 32) break;
            }
            idx += zeros;
            if (pos >= len) break;
            uint32_t nz = d[pos++];
            for (uint32_t j = 0; j < nz; ++j) {
                if (pos + 2 > len || idx >= width) break;
                int16_t v;
                std::memcpy(&v, d + pos, 2);
                pos += 2;
                if (v != 0)
                    dst[w++] = (static_cast<int32_t>(idx) << 16) |
                               (static_cast<uint16_t>(v));
                ++idx;
            }
        }
    }
}

}  // extern "C"
