"""Pure-Python/numpy Ogg Vorbis decoder for foreign-format ingest.

The reference CLI ingests MP3/WAV/FLAC/OGG/AAC through Symphonia
(reflo/src/audio.rs:57-166). This environment has no audio-codec libraries,
so ingest implements the formats that are decodable faithfully from their
specifications: WAV/AIFF (containers), FLAC (flo_torch.flac), and — here —
Ogg Vorbis. Vorbis is uniquely suited to a from-spec offline build: the
format is SELF-DESCRIBING (every Huffman codebook, floor configuration and
residue configuration travels in the stream's setup header, and the window
is a closed-form formula), so unlike MP3/AAC there are no large fixed
tables to transcribe. The one fixed table, floor1's inverse-dB curve, is
generated from its defining geometric progression (10^((i-255)*7/256));
worst-case deviation from the spec's printed floats is ~2e-6 relative —
far below the codec's own quantization noise.

Scope (Vorbis I spec):
* Ogg framing: page parse, CRC-32 (poly 0x04C11DB7) verification, packet
  reassembly across lacing segments and page continuations.
* Header decode: identification, comment (tags -> AudioMetadata), setup
  (codebooks with all three VQ lookup types, floor type 1, residue types
  0/1/2, mappings with channel coupling and multiplexing, modes).
* Audio decode: floor1 curve synthesis (neighbor prediction + Bresenham
  render), residue decode, inverse channel coupling, IMDCT (FFT-based,
  verified against the direct O(n^2) spec formula), long/short window
  lapping, final overlap-add.
* Floor type 0 (LSP, deprecated by every known encoder) raises a clear
  UnsupportedFormatError.

Ground truth: tests/vorbis_writer.py is a from-spec *encoder* (shared
nothing with this decoder beyond the format constants) that synthesizes
conformance vectors — the same strategy used to verify flo_torch.flac.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .audio_io import AudioMetadata, UnsupportedFormatError


class VorbisError(UnsupportedFormatError):
    pass


def ilog(x: int) -> int:
    """Vorbis ilog: bit length of x (ilog(0) = 0)."""
    return x.bit_length() if x > 0 else 0


def float32_unpack(x: int) -> float:
    """Vorbis packed float: mantissa * 2^(exponent - 788), sign bit 31."""
    mantissa = x & 0x1FFFFF
    exponent = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mantissa = -mantissa
    return float(mantissa) * (2.0 ** (exponent - 788))


def lookup1_values(entries: int, dims: int) -> int:
    """Largest v with v**dims <= entries."""
    if dims <= 0:
        raise VorbisError("VQ lookup on a zero-dimension codebook")
    v = int(round(entries ** (1.0 / dims)))
    while (v + 1) ** dims <= entries:
        v += 1
    while v > 0 and v**dims > entries:
        v -= 1
    return v


#: floor1_inverse_dB_table: geometric progression ending at 1.0 (see module
#: docstring for the fidelity note).
_INVERSE_DB = (10.0 ** ((np.arange(256) - 255.0) * (7.0 / 256.0))).astype(np.float64)
_FLOOR1_RANGE = (256, 128, 86, 64)  # by multiplier-1


# ---------------------------------------------------------------------------
# Ogg framing
# ---------------------------------------------------------------------------

_BITREV8 = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8
)


def _ogg_crc_ref(data: bytes) -> int:
    """Per-byte table CRC — the readable spec transcription, kept as the
    test oracle for :func:`ogg_crc`."""
    tab = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) & 0xFFFFFFFF) ^ (0x04C11DB7 if r & 0x80000000 else 0)
        tab.append(r)
    r = 0
    for b in data:
        r = ((r << 8) & 0xFFFFFFFF) ^ tab[(r >> 24) ^ b]
    return r


def ogg_crc(data: bytes) -> int:
    """Ogg page CRC: poly 0x04C11DB7, init 0, no reflection, no final xor.

    Computed at C speed via zlib: bit-reversing every message byte turns
    the MSB-first CRC over 0x04C11DB7 into the LSB-first CRC over the
    reversed poly 0xEDB88320 (zlib's), with the register bit-reversed too;
    zlib's init/final-xor convention is undone by seeding 0xFFFFFFFF and
    complementing. Equality vs the per-byte oracle is fuzz-tested. The
    former numpy-scalar per-byte loop cost ~10 s on a 4 MB file — longer
    than the decode it was guarding."""
    import zlib

    rev = _BITREV8[np.frombuffer(data, np.uint8)].tobytes()
    r = (~zlib.crc32(rev, 0xFFFFFFFF)) & 0xFFFFFFFF
    b = _BITREV8
    return (
        (int(b[r & 0xFF]) << 24)
        | (int(b[(r >> 8) & 0xFF]) << 16)
        | (int(b[(r >> 16) & 0xFF]) << 8)
        | int(b[(r >> 24) & 0xFF])
    )


def ogg_packets(
    data: bytes, verify_crc: bool = True, with_granule: bool = False
):
    """Reassemble the first logical stream's packets from an Ogg byte string.

    with_granule=True returns (packets, last_granule): the last page's
    granule position (PCM sample count through its last completed packet —
    the spec's final-page length truncation input; framing.html §granule
    position), or None if no page carried one (-1 pages excluded).
    """
    packets: List[bytes] = []
    partial = bytearray()
    serial = None
    last_granule = None
    pos = 0
    n = len(data)
    while pos + 27 <= n:
        if data[pos : pos + 4] != b"OggS":
            raise VorbisError("bad Ogg capture pattern")
        version, htype = data[pos + 4], data[pos + 5]
        if version != 0:
            raise VorbisError(f"unsupported Ogg version {version}")
        (granule,) = struct.unpack_from("<q", data, pos + 6)
        (page_serial,) = struct.unpack_from("<I", data, pos + 14)
        (crc,) = struct.unpack_from("<I", data, pos + 22)
        nsegs = data[pos + 26]
        lacing = data[pos + 27 : pos + 27 + nsegs]
        body_start = pos + 27 + nsegs
        body_len = int(sum(lacing))
        if body_start + body_len > n:
            raise VorbisError("truncated Ogg page")
        page = bytearray(data[pos : body_start + body_len])
        page[22:26] = b"\x00\x00\x00\x00"
        if verify_crc and ogg_crc(bytes(page)) != crc:
            raise VorbisError("Ogg page CRC mismatch")
        if serial is None:
            serial = page_serial
        if page_serial == serial:
            if granule >= 0:
                last_granule = granule
            if not (htype & 0x01):
                partial = bytearray()  # fresh packet boundary on this page
            off = body_start
            for seg in lacing:
                partial += data[off : off + seg]
                off += seg
                if seg < 255:
                    packets.append(bytes(partial))
                    partial = bytearray()
        pos = body_start + body_len
    if with_granule:
        return packets, last_granule
    return packets


# ---------------------------------------------------------------------------
# LSB-first bit reader (Vorbis packs bits little-endian within bytes)
# ---------------------------------------------------------------------------


class _Bits:
    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = len(data) * 8

    def read(self, n: int) -> int:
        """Read n bits LSB-first; past-end reads raise (spec: end of packet
        ends decode — callers treat it as end-of-stream)."""
        if n == 0:
            return 0
        if self.pos + n > self.nbits:
            raise EOFError
        byte0 = self.pos >> 3
        nbytes = (self.pos + n + 7 >> 3) - byte0
        window = int.from_bytes(self.data[byte0 : byte0 + nbytes], "little")
        v = (window >> (self.pos & 7)) & ((1 << n) - 1)
        self.pos += n
        return v

    def peek(self, n: int) -> int:
        """Peek up to n bits (zero-padded past the end)."""
        byte0 = self.pos >> 3
        nbytes = (self.pos + n + 7 >> 3) - byte0
        window = int.from_bytes(self.data[byte0 : byte0 + nbytes], "little")
        return (window >> (self.pos & 7)) & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# Codebooks
# ---------------------------------------------------------------------------

_FAST_BITS = 12


class Codebook:
    __slots__ = (
        "dims", "entries", "lengths", "codes", "lookup_type", "vectors",
        "_fast", "_fastlen", "_slow", "maxlen",
    )

    def __init__(self, br: _Bits):
        if br.read(24) != 0x564342:  # 'BCV' sync
            raise VorbisError("bad codebook sync")
        self.dims = br.read(16)
        self.entries = br.read(24)
        lengths = np.zeros(self.entries, np.int32)  # 0 = unused
        if br.read(1) == 0:  # unordered
            sparse = br.read(1)
            for i in range(self.entries):
                if sparse:
                    if br.read(1):
                        lengths[i] = br.read(5) + 1
                else:
                    lengths[i] = br.read(5) + 1
        else:  # ordered
            current_length = br.read(5) + 1
            current_entry = 0
            while current_entry < self.entries:
                number = br.read(ilog(self.entries - current_entry))
                if current_entry + number > self.entries:
                    raise VorbisError("ordered codebook overflow")
                lengths[current_entry : current_entry + number] = current_length
                current_entry += number
                current_length += 1
        self.lengths = lengths
        self._assign_codewords()

        self.lookup_type = br.read(4)
        if self.lookup_type == 0:
            self.vectors = None
        elif self.lookup_type in (1, 2):
            minimum = float32_unpack(br.read(32))
            delta = float32_unpack(br.read(32))
            value_bits = br.read(4) + 1
            sequence_p = br.read(1)
            if self.lookup_type == 1:
                count = lookup1_values(self.entries, self.dims)
            else:
                count = self.entries * self.dims
            mults = np.array([br.read(value_bits) for _ in range(count)], np.float64)
            vec = np.zeros((self.entries, self.dims), np.float64)
            if self.lookup_type == 1:
                for e in range(self.entries):
                    last = 0.0
                    idiv = 1
                    for d in range(self.dims):
                        off = (e // idiv) % count
                        v = mults[off] * delta + minimum + last
                        if sequence_p:
                            last = v
                        vec[e, d] = v
                        idiv *= count
            else:
                for e in range(self.entries):
                    last = 0.0
                    for d in range(self.dims):
                        v = mults[e * self.dims + d] * delta + minimum + last
                        if sequence_p:
                            last = v
                        vec[e, d] = v
            self.vectors = vec
        else:
            raise VorbisError(f"reserved codebook lookup type {self.lookup_type}")

    def _assign_codewords(self):
        """Spec 3.2.1: entry-order assignment of the lowest unused codeword
        of each entry's length (the classic 'available' algorithm)."""
        lengths = self.lengths
        used = np.flatnonzero(lengths > 0)
        self.codes = np.zeros(self.entries, np.uint32)
        self._fast = np.full(1 << _FAST_BITS, -1, np.int64)
        fast_len = np.zeros(1 << _FAST_BITS, np.int32)
        self._slow = {}
        self.maxlen = int(lengths.max(initial=0))
        self._fastlen = fast_len
        if len(used) == 0:
            return
        available = [0] * 33
        first = used[0]
        l0 = int(lengths[first])
        # First entry takes codeword 0.
        self.codes[first] = 0
        for i in range(1, l0 + 1):
            available[i] = 1 << (32 - i)
        for e in used[1:]:
            z = int(lengths[e])
            while z > 0 and available[z] == 0:
                z -= 1
            if z == 0:
                raise VorbisError("over-subscribed codebook")
            res = available[z]
            available[z] = 0
            self.codes[e] = res >> (32 - int(lengths[e]))
            for y in range(int(lengths[e]), z, -1):
                available[y] = res + (1 << (32 - y))
            # note: res's top `z` bits extended to length[e] with zeros
        # (Under-specified trees are legal only for single-entry books; the
        # spec says a 1-entry book uses the single codeword '0'.)

        # Decode acceleration: LSB-first lookup of the next _FAST_BITS bits.
        # The stream delivers codeword bits tree-descent (MSB of the code)
        # first, each at the LSB end of the read order, so the fast index is
        # the REVERSED code placed in the low bits.
        for e in used:
            l = int(lengths[e])
            code = int(self.codes[e])
            rev = int(f"{code:0{l}b}"[::-1], 2)  # bit-reverse within l bits
            if l <= _FAST_BITS:
                step = 1 << l
                for fill in range(rev, 1 << _FAST_BITS, step):
                    self._fast[fill] = e
                    fast_len[fill] = l
            else:
                self._slow[(l, code)] = int(e)

    def decode_scalar(self, br: _Bits) -> int:
        peek = br.peek(_FAST_BITS)
        e = self._fast[peek]
        if e >= 0:
            br.pos += int(self._fastlen[peek])
            if br.pos > br.nbits:
                raise EOFError
            return int(e)
        # Slow path: walk bit by bit beyond the fast prefix.
        acc = 0
        for i in range(self.maxlen):
            acc = (acc << 1) | br.read(1)
            hit = self._slow.get((i + 1, acc))
            if hit is not None:
                return hit
        raise VorbisError("invalid Huffman code")

    def decode_vector(self, br: _Bits) -> np.ndarray:
        e = self.decode_scalar(br)
        if self.vectors is None:
            raise VorbisError("scalar codebook used in VQ context")
        return self.vectors[e]


# ---------------------------------------------------------------------------
# Floor type 1
# ---------------------------------------------------------------------------


@dataclass
class Floor1:
    partition_classes: List[int]
    class_dims: List[int]
    class_subclasses: List[int]
    class_masterbooks: List[int]
    subclass_books: List[List[int]]
    multiplier: int
    x_list: List[int]
    # sorted index order and neighbor tables, precomputed
    sort_order: List[int] = field(default_factory=list)
    lo_neighbor: List[int] = field(default_factory=list)
    hi_neighbor: List[int] = field(default_factory=list)

    @classmethod
    def parse(cls, br: _Bits, codebooks: List[Codebook]) -> "Floor1":
        partitions = br.read(5)
        partition_classes = [br.read(4) for _ in range(partitions)]
        maxclass = max(partition_classes, default=-1)
        class_dims, class_subclasses = [], []
        class_masterbooks, subclass_books = [], []
        for _ in range(maxclass + 1):
            dims = br.read(3) + 1
            sub = br.read(2)
            master = br.read(8) if sub else -1
            if master >= len(codebooks):
                raise VorbisError("floor1 masterbook out of range")
            books = [br.read(8) - 1 for _ in range(1 << sub)]
            for b in books:
                if b >= len(codebooks):
                    raise VorbisError("floor1 subclass book out of range")
            class_dims.append(dims)
            class_subclasses.append(sub)
            class_masterbooks.append(master)
            subclass_books.append(books)
        multiplier = br.read(2) + 1
        rangebits = br.read(4)
        x_list = [0, 1 << rangebits]
        for p in range(partitions):
            cls_ = partition_classes[p]
            for _ in range(class_dims[cls_]):
                x_list.append(br.read(rangebits))
        if len(set(x_list)) != len(x_list):
            raise VorbisError("floor1 duplicate X coordinates")
        f = cls(partition_classes, class_dims, class_subclasses,
                class_masterbooks, subclass_books, multiplier, x_list)
        n = len(x_list)
        f.sort_order = sorted(range(n), key=lambda i: x_list[i])
        f.lo_neighbor = [0] * n
        f.hi_neighbor = [0] * n
        for i in range(2, n):
            # low: index of the largest X[j] < X[i] with j < i (spec 9.2.4).
            lo, hi = 0, 1
            for j in range(i):
                if x_list[j] < x_list[i] and x_list[j] >= x_list[lo]:
                    lo = j
                if x_list[j] > x_list[i] and x_list[j] <= x_list[hi]:
                    hi = j
            f.lo_neighbor[i] = lo
            f.hi_neighbor[i] = hi
        return f

    def decode(self, br: _Bits, codebooks: List[Codebook]) -> Optional[List[int]]:
        """Read one channel's floor data -> final Y list (None = unused)."""
        if br.read(1) == 0:
            return None
        rng = _FLOOR1_RANGE[self.multiplier - 1]
        ybits = ilog(rng - 1)
        y = [br.read(ybits), br.read(ybits)]
        for p, cls_ in enumerate(self.partition_classes):
            cdim = self.class_dims[cls_]
            cbits = self.class_subclasses[cls_]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits > 0:
                cval = codebooks[self.class_masterbooks[cls_]].decode_scalar(br)
            for _ in range(cdim):
                book = self.subclass_books[cls_][cval & csub]
                cval >>= cbits
                if book >= 0:
                    y.append(codebooks[book].decode_scalar(br))
                else:
                    y.append(0)
        return y

    def synthesize(self, y: List[int], n2: int) -> np.ndarray:
        """Floor curve [n2] from decoded Y values (spec 7.2.4: amplitude
        prediction + Bresenham render + inverse-dB lookup)."""
        rng = _FLOOR1_RANGE[self.multiplier - 1]
        npts = len(self.x_list)
        final_y = [0] * npts
        step2 = [False] * npts
        final_y[0] = y[0]
        final_y[1] = y[1]
        step2[0] = step2[1] = True
        for i in range(2, npts):
            lo, hi = self.lo_neighbor[i], self.hi_neighbor[i]
            pred = _render_point(
                self.x_list[lo], final_y[lo], self.x_list[hi], final_y[hi],
                self.x_list[i],
            )
            val = y[i]
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                step2[lo] = True
                step2[hi] = True
                step2[i] = True
                if val >= room:
                    if highroom > lowroom:
                        final_y[i] = val - lowroom + pred
                    else:
                        final_y[i] = pred - val + highroom - 1
                else:
                    if val & 1:
                        final_y[i] = pred - ((val + 1) >> 1)
                    else:
                        final_y[i] = pred + (val >> 1)
            else:
                step2[i] = False
                final_y[i] = pred
        # Clamp into range (defensive; spec guarantees in-range).
        final_y = [min(max(v, 0), rng - 1) for v in final_y]

        curve = np.zeros(n2, np.int32)
        xs = self.sort_order
        # Render lines between consecutive step2-flagged points.
        lx, ly = 0, final_y[xs[0]] * self.multiplier
        for idx in xs[1:]:
            if not step2[idx]:
                continue
            hx = self.x_list[idx]
            hy = final_y[idx] * self.multiplier
            _render_line(lx, ly, hx, hy, curve, n2)
            lx, ly = hx, hy
        if lx < n2:
            curve[lx:n2] = ly
        np.clip(curve, 0, 255, out=curve)
        return _INVERSE_DB[curve]


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, out, n):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    base = dy // adx
    sy = base + 1 if dy >= 0 else base - 1
    ady -= abs(base) * adx
    x = x0
    y = y0
    err = 0
    if x0 < n:
        out[x0] = y0
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        out[x] = y


# ---------------------------------------------------------------------------
# Residues
# ---------------------------------------------------------------------------


@dataclass
class Residue:
    rtype: int
    begin: int
    end: int
    partition_size: int
    classifications: int
    classbook: int
    books: List[List[int]]  # [class][pass] -> book index or -1

    @classmethod
    def parse(cls, rtype: int, br: _Bits, codebooks: List[Codebook]) -> "Residue":
        begin = br.read(24)
        end = br.read(24)
        partition_size = br.read(24) + 1
        classifications = br.read(6) + 1
        classbook = br.read(8)
        if classbook >= len(codebooks):
            raise VorbisError("residue classbook out of range")
        cascade = []
        for _ in range(classifications):
            high = 0
            low = br.read(3)
            if br.read(1):
                high = br.read(5)
            cascade.append((high << 3) | low)
        books: List[List[int]] = []
        for c in range(classifications):
            row = []
            for p in range(8):
                if cascade[c] & (1 << p):
                    b = br.read(8)
                    if b >= len(codebooks) or codebooks[b].vectors is None:
                        raise VorbisError("residue book invalid")
                    row.append(b)
                else:
                    row.append(-1)
            books.append(row)
        return cls(rtype, begin, end, partition_size, classifications,
                   classbook, books)

    def decode(self, br: _Bits, codebooks: List[Codebook], n2: int,
               do_not_decode: List[bool]) -> np.ndarray:
        """Decode residue vectors [ch, n2] f64 for the submap's channels."""
        ch = len(do_not_decode)
        if self.rtype == 2:
            out = np.zeros((1, n2 * ch), np.float64)
            if all(do_not_decode):
                return out.reshape(ch, n2) if ch else out
            self._decode_inner(br, codebooks, out, [False], n2 * ch)
            # de-interleave
            return out.reshape(n2, ch).T.copy() if ch else out
        out = np.zeros((ch, n2), np.float64)
        self._decode_inner(br, codebooks, out, do_not_decode, n2)
        return out

    def _decode_inner(self, br, codebooks, vectors, do_not_decode, actual_size):
        limit_begin = min(self.begin, actual_size)
        limit_end = min(self.end, actual_size)
        to_read = limit_end - limit_begin
        if to_read <= 0:
            return
        cbook = codebooks[self.classbook]
        cw_per = cbook.dims
        parts = to_read // self.partition_size
        ch = len(do_not_decode)
        cls_arr = [[0] * (parts + cw_per) for _ in range(ch)]
        for p in range(8):
            pcount = 0
            try:
                while pcount < parts:
                    if p == 0:
                        for j in range(ch):
                            if do_not_decode[j]:
                                continue
                            temp = cbook.decode_scalar(br)
                            for i in range(cw_per - 1, -1, -1):
                                cls_arr[j][pcount + i] = temp % self.classifications
                                temp //= self.classifications
                    for _ in range(cw_per):
                        if pcount >= parts:
                            break
                        for j in range(ch):
                            if do_not_decode[j]:
                                continue
                            vq = cls_arr[j][pcount]
                            book = self.books[vq][p]
                            if book < 0:
                                continue
                            offset = limit_begin + pcount * self.partition_size
                            self._decode_partition(
                                br, codebooks[book], vectors[j], offset
                            )
                        pcount += 1
            except EOFError:
                return  # end of packet ends residue decode (spec)

    def _decode_partition(self, br, book, vec, offset):
        psize = self.partition_size
        if self.rtype == 0:
            step = psize // book.dims
            for i in range(step):
                v = book.decode_vector(br)
                vec[offset + i : offset + i + book.dims * step : step] += v
        else:  # formats 1 and 2 read identically within a partition
            i = 0
            while i < psize:
                v = book.decode_vector(br)
                vec[offset + i : offset + i + book.dims] += v
                i += book.dims


# ---------------------------------------------------------------------------
# Mapping / mode
# ---------------------------------------------------------------------------


@dataclass
class Mapping:
    submaps: int
    coupling: List[tuple]
    mux: List[int]
    submap_floor: List[int]
    submap_residue: List[int]

    @classmethod
    def parse(cls, br: _Bits, channels: int, nfloors: int, nresidues: int) -> "Mapping":
        if br.read(16) != 0:
            raise VorbisError("unsupported mapping type")
        submaps = br.read(4) + 1 if br.read(1) else 1
        coupling = []
        if br.read(1):
            steps = br.read(8) + 1
            bits = ilog(channels - 1)
            for _ in range(steps):
                m = br.read(bits)
                a = br.read(bits)
                if m == a or m >= channels or a >= channels:
                    raise VorbisError("bad coupling step")
                coupling.append((m, a))
        if br.read(2) != 0:
            raise VorbisError("mapping reserved bits set")
        if submaps > 1:
            mux = [br.read(4) for _ in range(channels)]
            if any(m >= submaps for m in mux):
                raise VorbisError("mapping mux out of range")
        else:
            mux = [0] * channels
        submap_floor, submap_residue = [], []
        for _ in range(submaps):
            br.read(8)  # unused time config
            fl = br.read(8)
            rs = br.read(8)
            if fl >= nfloors or rs >= nresidues:
                raise VorbisError("mapping floor/residue out of range")
            submap_floor.append(fl)
            submap_residue.append(rs)
        return cls(submaps, coupling, mux, submap_floor, submap_residue)


# ---------------------------------------------------------------------------
# IMDCT (FFT-based, numpy) + windows
# ---------------------------------------------------------------------------

_IMDCT_CACHE: dict = {}


def imdct(spec: np.ndarray) -> np.ndarray:
    """Vorbis inverse MDCT: spec [n2] -> time [n = 2*n2], no window.

    y[i] = sum_k spec[k] * cos(pi/(2n) * (2i + 1 + n2) * (2k + 1)); computed
    via an n/4-point complex FFT (same factorization as ops/mdct.py),
    verified against the direct formula in tests."""
    n2 = spec.shape[-1]
    n = 2 * n2
    n4 = n2 // 2
    key = n2
    tw = _IMDCT_CACHE.get(key)
    if tw is None:
        k = np.arange(n4)
        tw = np.exp(-2j * np.pi * (k + 0.125) / n)
        _IMDCT_CACHE[key] = tw
    # Pre-twiddle: pair spectrum into n/4 complex points.
    ev = spec[..., 0:n2:2]
    od = spec[..., n2 - 1 : 0 : -2]
    c = (ev + 1j * od) * tw
    f = np.fft.fft(c, axis=-1)
    post = f * tw
    re = post.real
    im = post.imag
    out = np.empty(spec.shape[:-1] + (n,), np.float64)
    t = np.arange(n4 // 2)
    h = n4 // 2
    # Output mapping of the n/4-FFT factorization, derived against (and
    # pinned in tests to) the direct Vorbis IMDCT formula
    # y[i] = sum_k X[k] cos(pi/(2n) (2i+1+n/2)(2k+1)).
    out[..., 2 * t] = re[..., h + t]
    out[..., 2 * t + 1] = -im[..., h - 1 - t]
    out[..., n4 + 2 * t] = im[..., t]
    out[..., n4 + 2 * t + 1] = -re[..., n4 - 1 - t]
    out[..., n2 + 2 * t] = im[..., h + t]
    out[..., n2 + 2 * t + 1] = -re[..., h - 1 - t]
    out[..., n2 + n4 + 2 * t] = -re[..., t]
    out[..., n2 + n4 + 2 * t + 1] = im[..., n4 - 1 - t]
    return out


def vorbis_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.sin(0.5 * np.pi * np.sin(np.pi / n * (i + 0.5)) ** 2)


# ---------------------------------------------------------------------------
# Top-level decoder
# ---------------------------------------------------------------------------


@dataclass
class VorbisDecoded:
    samples: np.ndarray  # interleaved f32
    sample_rate: int
    channels: int
    metadata: AudioMetadata
    comments: dict


def _parse_comments(packet: bytes) -> tuple:
    br = _Bits(packet[7:])
    vlen = br.read(32)
    vendor = bytes(br.read(8) for _ in range(vlen)).decode("utf-8", "replace")
    ncom = br.read(32)
    comments = {}
    for _ in range(ncom):
        ln = br.read(32)
        s = bytes(br.read(8) for _ in range(ln)).decode("utf-8", "replace")
        if "=" in s:
            k, v = s.split("=", 1)
            comments.setdefault(k.upper(), v)
    if br.read(1) != 1:
        raise VorbisError("comment framing bit missing")
    return vendor, comments


def _meta_from_comments(comments: dict) -> AudioMetadata:
    md = AudioMetadata(source_format="ogg")
    md.title = comments.get("TITLE")
    md.artist = comments.get("ARTIST")
    md.album = comments.get("ALBUM")
    md.album_artist = comments.get("ALBUMARTIST")
    md.genre = comments.get("GENRE")
    md.comment = comments.get("COMMENT") or comments.get("DESCRIPTION")
    if comments.get("DATE"):
        try:
            md.year = int(comments["DATE"][:4])
        except ValueError:
            pass
    if comments.get("TRACKNUMBER"):
        try:
            md.track_number = int(comments["TRACKNUMBER"].split("/")[0])
        except ValueError:
            pass
    if comments.get("BPM"):
        try:
            md.bpm = float(comments["BPM"])
        except ValueError:
            pass
    return md


class _Setup:
    def __init__(self, ident: bytes, setup: bytes):
        br = _Bits(ident[7:])
        if br.read(32) != 0:
            raise VorbisError("unsupported Vorbis version")
        self.channels = br.read(8)
        self.rate = br.read(32)
        br.read(32)  # bitrate max
        br.read(32)  # bitrate nominal
        br.read(32)  # bitrate min
        bs0 = br.read(4)
        bs1 = br.read(4)
        self.blocksize0 = 1 << bs0
        self.blocksize1 = 1 << bs1
        if not (64 <= self.blocksize0 <= 8192) or not (
            self.blocksize0 <= self.blocksize1 <= 8192
        ):
            raise VorbisError("invalid blocksizes")
        if br.read(1) != 1:
            raise VorbisError("identification framing bit missing")
        if self.channels == 0 or self.rate == 0:
            raise VorbisError("bad identification header")

        br = _Bits(setup[7:])
        self.codebooks = [Codebook(br) for _ in range(br.read(8) + 1)]
        for _ in range(br.read(6) + 1):  # time-domain transforms (placeholders)
            if br.read(16) != 0:
                raise VorbisError("nonzero time transform")
        self.floors = []
        for _ in range(br.read(6) + 1):
            ftype = br.read(16)
            if ftype == 1:
                self.floors.append(Floor1.parse(br, self.codebooks))
            elif ftype == 0:
                raise VorbisError("floor type 0 (LSP) not supported")
            else:
                raise VorbisError(f"invalid floor type {ftype}")
        self.residues = []
        for _ in range(br.read(6) + 1):
            rtype = br.read(16)
            if rtype > 2:
                raise VorbisError(f"invalid residue type {rtype}")
            self.residues.append(Residue.parse(rtype, br, self.codebooks))
        self.mappings = [
            Mapping.parse(br, self.channels, len(self.floors), len(self.residues))
            for _ in range(br.read(6) + 1)
        ]
        self.modes = []
        for _ in range(br.read(6) + 1):
            blockflag = br.read(1)
            if br.read(16) != 0 or br.read(16) != 0:
                raise VorbisError("nonzero mode window/transform type")
            mapping = br.read(8)
            if mapping >= len(self.mappings):
                raise VorbisError("mode mapping out of range")
            self.modes.append((blockflag, mapping))
        if br.read(1) != 1:
            raise VorbisError("setup framing bit missing")


def decode(data: bytes, verify_crc: bool = True) -> VorbisDecoded:
    """Decode an Ogg Vorbis byte string to interleaved float32 samples."""
    packets, last_granule = ogg_packets(data, verify_crc, with_granule=True)
    if len(packets) < 3:
        raise VorbisError("missing Vorbis headers")
    for i, sig in ((0, 1), (1, 3), (2, 5)):
        if packets[i][:7] != bytes([sig]) + b"vorbis":
            raise VorbisError("bad Vorbis header packet")
    try:
        st = _Setup(packets[0], packets[2])
        vendor, comments = _parse_comments(packets[1])
    except EOFError as e:
        raise VorbisError("truncated Vorbis header packet") from e

    ch = st.channels
    win_cache = {n: vorbis_window(n) for n in {st.blocksize0, st.blocksize1}}
    prev_tail: Optional[np.ndarray] = None  # previous frame's windowed tail
    out_parts: List[np.ndarray] = []
    mode_bits = ilog(len(st.modes) - 1)

    for pkt in packets[3:]:
        br = _Bits(pkt)
        try:
            if br.read(1) != 0:
                continue  # not an audio packet
            mode_i = br.read(mode_bits)
            if mode_i >= len(st.modes):
                continue
            blockflag, mapping_i = st.modes[mode_i]
            n = st.blocksize1 if blockflag else st.blocksize0
            long_prev = long_next = True
            if blockflag:
                long_prev = br.read(1) == 1
                long_next = br.read(1) == 1
        except EOFError:
            continue
        mapping = st.mappings[mapping_i]
        n2 = n // 2

        try:
            floor_y = []
            for c in range(ch):
                fl = st.floors[mapping.submap_floor[mapping.mux[c]]]
                floor_y.append(fl.decode(br, st.codebooks))
        except EOFError:
            floor_y = [None] * ch

        no_residue = [y is None for y in floor_y]
        for m, a in mapping.coupling:
            if not (no_residue[m] and no_residue[a]):
                no_residue[m] = no_residue[a] = False

        spectra = np.zeros((ch, n2), np.float64)
        for s in range(mapping.submaps):
            chans = [c for c in range(ch) if mapping.mux[c] == s]
            dnd = [no_residue[c] for c in chans]
            res = st.residues[mapping.submap_residue[s]]
            vecs = res.decode(br, st.codebooks, n2, dnd)
            for idx, c in enumerate(chans):
                spectra[c] = vecs[idx]

        # Inverse square-polar coupling (spec 4.3.5), reverse step order:
        #   M>0, A>0: (M', A') = (M,     M - A)
        #   M>0, A<=0:(M', A') = (M + A, M)
        #   M<=0,A>0: (M', A') = (M,     M + A)
        #   M<=0,A<=0:(M', A') = (M - A, M)
        for m, a in reversed(mapping.coupling):
            M = spectra[m].copy()
            A = spectra[a].copy()
            newM = np.where(M > 0, np.where(A > 0, M, M + A),
                            np.where(A > 0, M, M - A))
            newA = np.where(M > 0, np.where(A > 0, M - A, M),
                            np.where(A > 0, M + A, M))
            spectra[m] = newM
            spectra[a] = newA

        # Apply floor curves.
        for c in range(ch):
            if floor_y[c] is None:
                spectra[c] = 0.0
            else:
                fl = st.floors[mapping.submap_floor[mapping.mux[c]]]
                spectra[c] *= fl.synthesize(floor_y[c], n2)

        # IMDCT + window with long/short lapping (spec 4.3.8-4.3.9). A long
        # block next to a short one narrows that side's slope to blocksize0,
        # centered at n/4 (left) / 3n/4 (right); the frame emits samples
        # [left_start, right_start) with the previous frame's windowed tail
        # [right_start_prev, right_end_prev) added over the shared lap.
        time = imdct(spectra)  # [ch, n]
        ls = st.blocksize0 if (blockflag and not long_prev) else n
        rs = st.blocksize0 if (blockflag and not long_next) else n
        wl = win_cache[ls]
        wr = win_cache[rs]
        left_start = n // 4 - ls // 4
        right_start = 3 * n // 4 - rs // 4
        right_end = 3 * n // 4 + rs // 4
        w = np.zeros(n, np.float64)
        w[left_start : left_start + ls // 2] = wl[: ls // 2]
        w[left_start + ls // 2 : right_start] = 1.0
        w[right_start:right_end] = wr[rs // 2 :]
        time = time * w[None, :]

        if prev_tail is not None:
            emit = time[:, left_start:right_start].copy()
            lap = min(prev_tail.shape[1], emit.shape[1])
            emit[:, :lap] += prev_tail[:, :lap]
            out_parts.append(emit)
        prev_tail = time[:, right_start:right_end].copy()

    if not out_parts:
        pcm = np.zeros((ch, 0), np.float64)
    else:
        pcm = np.concatenate(out_parts, axis=1)
    if last_granule is not None and 0 <= last_granule < pcm.shape[1]:
        # Final-page length truncation (Vorbis-over-Ogg spec §"End of
        # stream"): the encoder pads the last block; the true stream length
        # is the last page's granule position. Without this every real
        # libvorbis file decodes up to blocksize1/2 extra padding samples.
        pcm = pcm[:, : int(last_granule)]
    inter = pcm.T.reshape(-1).astype(np.float32)
    md = _meta_from_comments(comments)
    return VorbisDecoded(
        samples=inter, sample_rate=st.rate, channels=ch,
        metadata=md, comments=comments,
    )
