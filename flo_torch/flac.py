"""Pure-Python/numpy FLAC decoder for foreign-format ingest.

The reference CLI ingests MP3/WAV/FLAC/OGG/AAC through Symphonia
(reflo/src/audio.rs:57-166); this environment has no audio-codec libraries,
so FLAC — whose primitives (LPC prediction + Rice-coded residuals) this
codebase already owns — is decoded from spec here, giving `flo encode
in.flac out.flo` the reference's headline ingest flow.

Batch-first design, mirroring the codec's own decoder: frame/subframe
headers parse sequentially (cheap), Rice partitions decode with the
binary-lifting vectorization of core/rice_host (FLAC's unary runs are
zeros-terminated-by-one, ranks over the ONE bits), and ALL predictive
subframes of the file reconstruct together in one numpy lockstep over the
block axis (<= 4096 sequential steps regardless of file length; int64
accumulators + arithmetic shift per the format's requirements).

Scope: full FLAC subset decoding — CONSTANT/VERBATIM/FIXED/LPC subframes,
all partition orders incl. escape partitions, stereo decorrelation
(left/side, right/side, mid/side), wasted bits, 8/12/16/20/24/32-bit
streams, VORBIS_COMMENT tags. Frame CRCs are not verified (tolerant
decode); the STREAMINFO MD5 can be checked by callers via
`decoded.md5_matches`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .audio_io import AudioMetadata, UnsupportedFormatError


class FlacError(UnsupportedFormatError):
    pass


# Frame-header lookup tables (FLAC format spec).
_BLOCKSIZE = {1: 192, **{n: 576 << (n - 2) for n in range(2, 6)},
              **{n: 256 << (n - 8) for n in range(8, 16)}}
_SAMPLE_RATE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
                7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_SAMPLE_SIZE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class _Bits:
    """MSB-first bit reader over an unpacked bit array."""

    __slots__ = ("bits", "pos")

    def __init__(self, bits: np.ndarray, pos: int = 0):
        self.bits = bits
        self.pos = pos

    def read(self, n: int) -> int:
        if self.pos + n > len(self.bits):
            raise FlacError("truncated FLAC stream")
        v = 0
        for b in self.bits[self.pos : self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def unary_zeros(self) -> int:
        """Count 0 bits until (and consuming) a 1 bit."""
        i = self.pos
        bits = self.bits
        nz = np.flatnonzero(bits[i : i + 4096])
        while nz.size == 0:
            i += 4096
            if i >= len(bits):
                raise FlacError("truncated unary code")
            nz = np.flatnonzero(bits[i : i + 4096])
        q = int(i - self.pos + nz[0])
        self.pos += q + 1
        return q


def _coded_number(br: _Bits) -> int:
    """UTF-8-style frame/sample number (up to 36 bits over 7 bytes)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    while (b0 << n) & 0x80:
        n += 1
    if n < 2 or n > 7:
        raise FlacError("bad coded number")
    v = b0 & (0x7F >> n)
    for _ in range(n - 1):
        c = br.read(8)
        if c & 0xC0 != 0x80:
            raise FlacError("bad coded number continuation")
        v = (v << 6) | (c & 0x3F)
    return v


def _rice_partition(bits: np.ndarray, ones_excl: np.ndarray, O: np.ndarray,
                    g_cache: dict, start: int, n: int, k: int):
    """Decode n Rice codes (q zeros, a one, k LSBs) from bit offset start.

    Returns (values int64 [n], next_bit). Vectorized: terminator ranks chase
    t_{i+1} = ones_excl[O[t_i] + 1 + k] via binary lifting, with the jump
    table cached per (frame, k)."""
    if n == 0:
        return np.zeros(0, np.int64), start
    if k not in g_cache:
        nxt = O + 1 + k
        np.clip(nxt, 0, len(bits) - 1, out=nxt)
        g_cache[k] = ones_excl[nxt]
    g = g_cache[k]

    T = np.empty(n, dtype=np.int64)
    T[0] = ones_excl[min(start, len(bits) - 1)]
    filled = 1
    gg = g
    while filled < n:
        take = min(filled, n - filled)
        T[filled : filled + take] = gg[T[:take]]
        filled += take
        if filled < n:
            gg = gg[np.minimum(gg, len(gg) - 1)]
    if int(T[-1]) >= len(O):
        raise FlacError("truncated residual partition")
    term = O[T]

    starts = np.empty(n, dtype=np.int64)
    starts[0] = start
    starts[1:] = term[:-1] + 1 + k
    q = term - starts
    if k > 0:
        pos = term[:, None] + 1 + np.arange(k, dtype=np.int64)[None, :]
        if int(pos[-1, -1]) >= len(bits):
            raise FlacError("truncated residual partition")
        w = (1 << np.arange(k - 1, -1, -1, dtype=np.int64))
        rem = (bits[pos].astype(np.int64) * w[None, :]).sum(axis=1)
    else:
        rem = np.zeros(n, np.int64)
    u = (q << k) | rem
    vals = (u >> 1) ^ -(u & 1)
    return vals, int(term[-1] + 1 + k)


def _residuals(br: _Bits, ones_excl, O, g_cache, blocksize: int, order: int):
    method = br.read(2)
    if method > 1:
        raise FlacError("reserved residual method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    nparts = 1 << po
    if blocksize % nparts or blocksize // nparts <= order and nparts == 1:
        pass
    out = np.empty(blocksize - order, np.int64)
    w = 0
    for p in range(nparts):
        n = blocksize // nparts - (order if p == 0 else 0)
        if n < 0:
            raise FlacError("bad partition order")
        k = br.read(plen)
        if k == escape:
            nbits = br.read(5)
            if nbits == 0:
                vals = np.zeros(n, np.int64)
            else:
                pos = br.pos + np.arange(n, dtype=np.int64)[:, None] * nbits + np.arange(
                    nbits, dtype=np.int64
                )[None, :]
                if n and int(pos[-1, -1]) >= len(br.bits):
                    raise FlacError("truncated escape partition")
                ww = 1 << np.arange(nbits - 1, -1, -1, dtype=np.int64)
                vals = (br.bits[pos].astype(np.int64) * ww[None, :]).sum(axis=1)
                vals -= (vals >= (1 << (nbits - 1))) * (1 << nbits)
                br.pos += n * nbits
        else:
            vals, nxt = _rice_partition(br.bits, ones_excl, O, g_cache, br.pos, n, k)
            br.pos = nxt
        out[w : w + n] = vals
        w += n
    return out


_FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


@dataclass
class _Subframe:
    kind: str            # 'const' | 'verbatim' | 'pred'
    wasted: int
    data: np.ndarray     # const: [1]; verbatim: [n]; pred: warmup+residual [n]
    coeffs: Optional[np.ndarray] = None  # pred: int64 taps (newest first)
    shift: int = 0
    order: int = 0


@dataclass
class DecodedFlac:
    samples: np.ndarray  # interleaved float32
    sample_rate: int
    channels: int
    bits_per_sample: int
    metadata: AudioMetadata
    md5_matches: Optional[bool] = None


def _parse_subframe(br, ones_excl, O, g_cache, blocksize: int, bps: int) -> _Subframe:
    if br.read(1):
        raise FlacError("bad subframe padding bit")
    t = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.unary_zeros() + 1
    eff = bps - wasted
    if t == 0:
        return _Subframe("const", wasted, np.array([br.read_signed(eff)], np.int64))
    if t == 1:
        pos = br.pos + np.arange(blocksize, dtype=np.int64)[:, None] * eff + np.arange(
            eff, dtype=np.int64
        )[None, :]
        if blocksize and int(pos[-1, -1]) >= len(br.bits):
            raise FlacError("truncated verbatim subframe")
        w = 1 << np.arange(eff - 1, -1, -1, dtype=np.int64)
        vals = (br.bits[pos].astype(np.int64) * w[None, :]).sum(axis=1)
        vals -= (vals >= (1 << (eff - 1))) * (1 << eff)
        br.pos += blocksize * eff
        return _Subframe("verbatim", wasted, vals)
    if 8 <= t <= 12:
        order = t - 8
        warm = np.array([br.read_signed(eff) for _ in range(order)], np.int64)
        res = _residuals(br, ones_excl, O, g_cache, blocksize, order)
        data = np.concatenate([warm, res])
        return _Subframe(
            "pred", wasted, data,
            np.array(_FIXED[order], np.int64), 0, order,
        )
    if t >= 32:
        order = (t & 31) + 1
        warm = np.array([br.read_signed(eff) for _ in range(order)], np.int64)
        prec = br.read(4) + 1
        if prec == 16:
            raise FlacError("invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coeffs = np.array([br.read_signed(prec) for _ in range(order)], np.int64)
        res = _residuals(br, ones_excl, O, g_cache, blocksize, order)
        data = np.concatenate([warm, res])
        return _Subframe("pred", wasted, data, coeffs, shift, order)
    raise FlacError(f"reserved subframe type {t}")


def _reconstruct_lockstep(subs: list[_Subframe], widths: list[int]) -> list[np.ndarray]:
    """Reconstruct every predictive subframe together: sequential only over
    the block axis (<= max blocksize steps), vectorized across subframes."""
    preds = [i for i, s in enumerate(subs) if s.kind == "pred" and s.order > 0]
    outs: list[np.ndarray] = [None] * len(subs)
    for i, s in enumerate(subs):
        if s.kind == "const":
            outs[i] = np.full(widths[i], s.data[0] << s.wasted, np.int64)
        elif s.kind == "verbatim":
            outs[i] = s.data << s.wasted
        elif s.order == 0:  # fixed order 0: residuals verbatim
            outs[i] = s.data << s.wasted
    if not preds:
        return outs

    L = len(preds)
    K = max(subs[i].order for i in preds)
    S = max(widths[i] for i in preds)
    rows = np.zeros((L, S), np.int64)
    coeffs = np.zeros((L, K), np.int64)
    shifts = np.zeros(L, np.int64)
    orders = np.zeros(L, np.int64)
    for j, i in enumerate(preds):
        s = subs[i]
        rows[j, : len(s.data)] = s.data
        coeffs[j, : s.order] = s.coeffs
        shifts[j] = s.shift
        orders[j] = s.order

    window = np.zeros((L, K), np.int64)  # window[:, d] = sample i-1-d
    out = rows.copy()
    idx = np.arange(S)
    for i in range(S):
        warm = i < orders
        pred = (window * coeffs).sum(axis=1) >> shifts
        s = np.where(warm, rows[:, i], rows[:, i] + pred)
        out[:, i] = s
        window[:, 1:] = window[:, :-1]
        window[:, 0] = s
    for j, i in enumerate(preds):
        outs[i] = out[j, : widths[i]] << subs[i].wasted
    return outs


def decode(data: bytes, verify_md5: bool = False) -> DecodedFlac:
    """Decode a FLAC file to interleaved float32 (normalized by 2^(bps-1))."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC file")
    pos = 4
    streaminfo = None
    tags: dict[str, str] = {}
    last = False
    while not last:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        size = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + size]
        pos += 4 + size
        if btype == 0:
            streaminfo = body
        elif btype == 4:  # VORBIS_COMMENT (little-endian lengths)
            try:
                q = 4 + int.from_bytes(body[0:4], "little")
                (ncom,) = struct.unpack_from("<I", body, q)
                q += 4
                for _ in range(ncom):
                    (ln,) = struct.unpack_from("<I", body, q)
                    q += 4
                    kv = body[q : q + ln].decode("utf-8", "replace")
                    q += ln
                    if "=" in kv:
                        k, v = kv.split("=", 1)
                        tags[k.upper()] = v
            except Exception:
                pass
    if streaminfo is None or len(streaminfo) < 34:
        raise FlacError("missing STREAMINFO")

    si = int.from_bytes(streaminfo[10:18], "big")
    sample_rate = si >> 44
    channels = ((si >> 41) & 0x7) + 1
    bps = ((si >> 36) & 0x1F) + 1
    total_samples = si & ((1 << 36) - 1)
    md5 = streaminfo[18:34]
    if sample_rate == 0:
        raise FlacError("bad STREAMINFO sample rate")

    frame_bytes = np.frombuffer(data, np.uint8, offset=pos)
    bits = np.unpackbits(frame_bytes)
    ones_incl = np.cumsum(bits, dtype=np.int64)
    ones_excl = ones_incl - bits  # rank of first 1 at/after p
    O = np.flatnonzero(bits).astype(np.int64)

    chans = [[] for _ in range(channels)]
    br = _Bits(bits, 0)
    got = 0
    while (total_samples == 0 or got < total_samples) and br.pos + 32 <= len(bits):
        br.pos = (br.pos + 7) & ~7  # frames are byte-aligned
        if br.pos + 32 > len(bits):
            break
        sync = br.read(15)
        if sync != 0b111111111111100:
            raise FlacError("lost frame sync")
        variable = br.read(1)
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        _coded_number(br)
        if bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        elif bs_code in _BLOCKSIZE:
            blocksize = _BLOCKSIZE[bs_code]
        else:
            raise FlacError("reserved blocksize code")
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = _SAMPLE_SIZE.get(ss_code, bps)
        br.read(8)  # CRC-8

        g_cache: dict = {}
        if ch_code < 8:
            nch = ch_code + 1
            if nch != channels:
                raise FlacError("channel count change mid-stream")
            bpss = [frame_bps] * nch
            mode = "indep"
        else:
            if channels != 2:
                raise FlacError("stereo decorrelation in non-stereo stream")
            mode = {8: "ls", 9: "rs", 10: "ms"}.get(ch_code)
            if mode is None:
                raise FlacError("reserved channel assignment")
            bpss = [frame_bps, frame_bps + 1] if mode in ("ls", "ms") else [
                frame_bps + 1, frame_bps]
        subs = [
            _parse_subframe(br, ones_excl, O, g_cache, blocksize, b) for b in bpss
        ]
        br.pos = (br.pos + 7) & ~7
        br.pos += 16  # CRC-16

        outs = _reconstruct_lockstep(subs, [blocksize] * len(subs))
        if mode == "indep":
            rows = outs
        elif mode == "ls":
            left, side = outs
            rows = [left, left - side]
        elif mode == "rs":
            side, right = outs
            rows = [right + side, right]
        else:  # mid/side
            mid, side = outs
            m2 = (mid << 1) | (side & 1)
            rows = [(m2 + side) >> 1, (m2 - side) >> 1]
        take = blocksize
        if total_samples:
            take = min(blocksize, int(total_samples - got))
        for c in range(channels):
            chans[c].append(rows[c][:take])
        got += take

    if total_samples and got < total_samples:
        raise FlacError("truncated FLAC stream")

    per_ch = [np.concatenate(c) if c else np.zeros(0, np.int64) for c in chans]
    n = min(len(c) for c in per_ch)
    inter = np.empty(n * channels, np.float32)
    scale = np.float32(1.0 / (1 << (bps - 1)))
    for c in range(channels):
        inter[c::channels] = per_ch[c][:n].astype(np.float32) * scale

    md5_ok = None
    if verify_md5 and any(md5):
        import hashlib

        width = (bps + 7) // 8
        pcm = np.empty((n, channels), np.int64)
        for c in range(channels):
            pcm[:, c] = per_ch[c][:n]
        le = pcm.reshape(-1).astype("<i8").view(np.uint8).reshape(-1, 8)[:, :width]
        md5_ok = hashlib.md5(le.tobytes()).digest() == md5

    meta = AudioMetadata(
        title=tags.get("TITLE"),
        artist=tags.get("ARTIST"),
        album=tags.get("ALBUM"),
        album_artist=tags.get("ALBUMARTIST"),
        genre=tags.get("GENRE"),
        comment=tags.get("COMMENT") or tags.get("DESCRIPTION"),
        source_format="FLAC",
    )
    try:
        if tags.get("DATE"):
            meta.year = int(tags["DATE"][:4])
        if tags.get("TRACKNUMBER"):
            meta.track_number = int(tags["TRACKNUMBER"].split("/")[0])
    except ValueError:
        pass
    return DecodedFlac(inter, int(sample_rate), int(channels), int(bps), meta, md5_ok)
