"""Sparse run-length coefficient coding (host finalizer).

Wire format (libflo/src/lossy/encoder.rs:284-329): repeated runs of
``[zero_count varint][non_zero_count u8][i16 LE values]`` with non-zero runs
capped at 255 per chunk; decoder zero-fills and tolerates truncation
(lossy/decoder.rs:134-188).
"""

from __future__ import annotations

import numpy as np


def encode_varint(value: int) -> bytes:
    out = bytearray()
    v = int(value)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    """Returns (value, new_pos); mirrors decode_varint (decoder.rs:170-188)."""
    value = 0
    shift = 0
    for i in range(pos, len(data)):
        byte = data[i]
        value |= (byte & 0x7F) << shift
        if not (byte & 0x80):
            return value & 0xFFFFFFFF, i + 1
        shift += 7
        if shift >= 32:
            return value & 0xFFFFFFFF, i + 1
    return value & 0xFFFFFFFF, len(data)


def serialize_sparse(coeffs: np.ndarray) -> bytes:
    """Encode one i16 coefficient row (encoder.rs:284-314)."""
    q = np.asarray(coeffs, dtype=np.int16)
    n = q.size
    out = bytearray()
    nz = q != 0
    if not nz.any():
        if n:
            out += encode_varint(n)
            out.append(0)
        return bytes(out)

    # Segment boundaries between zero/non-zero runs.
    edges = np.flatnonzero(np.diff(nz.view(np.int8))) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [n]])
    i = 0
    for s, e in zip(starts, ends):
        if not nz[s]:
            continue  # zero runs are emitted as prefixes of non-zero runs
        zero_count = s - i
        pos = s
        while pos < e:
            chunk = min(e - pos, 255)
            out += encode_varint(zero_count)
            out.append(chunk)
            out += q[pos : pos + chunk].astype("<i2").tobytes()
            pos += chunk
            zero_count = 0
        i = e
    if i < n:  # trailing zeros
        out += encode_varint(n - i)
        out.append(0)
    return bytes(out)


def deserialize_sparse(data: bytes, num_coeffs: int) -> np.ndarray:
    """Decode to a dense i16 row, zero-filled (decoder.rs:134-167)."""
    out = np.zeros(num_coeffs, dtype=np.int16)
    pos = 0
    idx = 0
    n = len(data)
    while pos < n and idx < num_coeffs:
        zero_count, pos = decode_varint(data, pos)
        idx += zero_count
        if pos >= n:
            break
        nz_count = data[pos]
        pos += 1
        take = min(nz_count, (n - pos) // 2, max(num_coeffs - idx, 0))
        if take > 0 and idx < num_coeffs:
            vals = np.frombuffer(data, dtype="<i2", count=take, offset=pos)
            out[idx : idx + take] = vals
        pos += nz_count * 2 if pos + nz_count * 2 <= n else n - pos
        idx += nz_count
    return out
