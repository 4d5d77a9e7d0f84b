"""Lossless encoder: the single-file host path.

One 1 s frame at a time: silence detection, f32 -> i32, the exact mid/side
decision, then the C++ best-of-N candidate search (raw, fixed 0-4, LPC
5..max in the reference's evaluation order) and the C++ Rice pack, and the
container writer. It does no device work, and gives the same bytes as the
reference's single-file ``encode``.

The bulk device encode (the batched candidate search and the device Rice
pack) is not ported yet: ROADMAP.md section 1, item 6.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .._flo_host import native
from .._flo_host.container import writer
from .._flo_host.core import rice_host
from .._flo_host.core.constants import (
    FIXED_PREDICTOR_MARKER,
    FRAME_FLAG_MID_SIDE,
    LPC_ORDER_BY_LEVEL,
    MIN_LEVEL_FOR_LPC,
    SILENCE_THRESHOLD,
    FrameType,
    ResidualEncoding,
)
from .._flo_host.core.convert import f32_to_i32_np
from .._flo_host.core.types import ChannelData, Frame

_BULK_ENCODE_ITEM = "ROADMAP.md section 1, item 6 (lossless bulk encode)"


def _candidate_plan(compression_level: int):
    """Candidate list in the reference's evaluation order.

    Returns (kinds, orders, max_order): kind 'raw' | 'fixed' | 'lpc'.
    """
    max_order = LPC_ORDER_BY_LEVEL[min(compression_level, 9)]
    kinds = ["raw"]
    orders = [0]
    for o in range(0, min(4, max_order) + 1):
        kinds.append("fixed")
        orders.append(o)
    if compression_level >= MIN_LEVEL_FOR_LPC and max_order > 4:
        for o in range(5, max_order + 1):
            kinds.append("lpc")
            orders.append(o)
    return kinds, orders, max_order


def encode_to_frames(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    compression_level: int = 5,
    compat: str = "fixed",
) -> List[Frame]:
    """Encode interleaved f32 samples into a list of container frames, on
    the host. compat="reference-bugs" and integer input take the bulk device
    encode in the reference, which is not ported yet: both raise."""
    arr = np.asarray(samples)
    if compat != "fixed":
        raise NotImplementedError(
            f"compat={compat!r} needs the bulk device encode: {_BULK_ENCODE_ITEM}"
        )
    if np.issubdtype(arr.dtype, np.integer):
        raise NotImplementedError(
            f"integer-domain input needs the bulk device encode: {_BULK_ENCODE_ITEM}"
        )
    return _encode_frames_host_file(arr, sample_rate, channels, compression_level)


def _encode_frames_host_file(
    samples: np.ndarray, sample_rate: int, channels: int, compression_level: int
) -> List[Frame]:
    """Whole-file host encode: one encode_frame_host call per 1 s frame."""
    arr = np.asarray(samples, dtype=np.float32).reshape(-1)
    C = int(channels)
    spf = int(sample_rate)
    total = len(arr) // C
    return [
        encode_frame_host(arr[start * C : min(start + spf, total) * C], sample_rate, C,
                          compression_level)
        for start in range(0, total, spf)
    ]


def encode_frame_host(
    samples: np.ndarray, sample_rate: int, channels: int, compression_level: int = 5
) -> Frame:
    """Encode ONE frame's interleaved f32 samples on the host: C++ candidate
    search (native/encode.cpp) + C++ Rice pack. Raises when the native
    library cannot be built."""
    arr = np.asarray(samples, dtype=np.float32).reshape(-1)
    C = int(channels)
    n = len(arr) // C
    if n == 0:
        raise ValueError("empty frame")
    if (np.abs(arr[: n * C]) < SILENCE_THRESHOLD).all():
        return Frame(
            frame_type=int(FrameType.SILENCE),
            frame_samples=n,
            channels=[ChannelData.silence() for _ in range(C)],
        )
    ints = f32_to_i32_np(arr[: n * C]).reshape(n, C)
    ch = np.ascontiguousarray(ints.T)  # [C, n]

    mid_side = False
    if C == 2:
        l, r = ch[0], ch[1]
        var_l = np.einsum("s,s->", l, l, dtype=np.float64)
        var_r = np.einsum("s,s->", r, r, dtype=np.float64)
        side = l - r
        var_side = np.einsum("s,s->", side, side, dtype=np.float64)
        mid_side = bool(var_side < np.floor_divide(var_l + var_r, 2))
        if mid_side:
            ch = np.stack([l + r, side])

    kinds, cand_orders, max_order = _candidate_plan(compression_level)
    use_lpc = any(kd == "lpc" for kd in kinds)
    out = native.lossless_search_batch(ch, np.full(C, n, np.int64), max_order, use_lpc)
    if out is None:
        raise RuntimeError("the C++ encoder (flo_tpu/native/encode.cpp) could not be built")
    sel_kind, sel_order, ks, coeffs, shifts, sizes, residuals = out

    rice_lanes = np.flatnonzero(sel_kind != 0)
    blobs = {}
    if len(rice_lanes):
        packed = rice_host.encode_batch(
            residuals[rice_lanes], ks[rice_lanes],
            np.full(len(rice_lanes), n, np.int64),
        )
        blobs = dict(zip(rice_lanes.tolist(), packed))

    chans = []
    all_raw = True
    for c in range(C):
        kd = int(sel_kind[c])
        if kd == 0:
            chans.append(ChannelData.raw(residuals[c, :n].astype("<i2").tobytes()))
            continue
        all_raw = False
        if kd == 1:
            coeff_list, shift_bits = [], FIXED_PREDICTOR_MARKER + int(sel_order[c])
        else:
            order = int(sel_order[c])
            coeff_list, shift_bits = [int(v) for v in coeffs[c, :order]], int(shifts[c])
        chans.append(
            ChannelData(
                predictor_coeffs=coeff_list,
                shift_bits=shift_bits,
                residual_encoding=ResidualEncoding.RICE,
                rice_parameter=int(ks[c]),
                residuals=blobs[c],
            )
        )
    ftype = FrameType.RAW if all_raw else FrameType.from_order(max_order)
    return Frame(
        frame_type=int(ftype),
        frame_samples=n,
        flags=FRAME_FLAG_MID_SIDE if mid_side else 0,
        channels=chans,
    )


def encode(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata: bytes = b"",
    compat: str = "fixed",
) -> bytes:
    """Encode interleaved f32 samples to flo bytes."""
    level = min(int(compression_level), 9)
    frames = encode_to_frames(samples, sample_rate, channels, level, compat)
    return writer.write(
        int(sample_rate), int(channels), int(bit_depth), level, frames, metadata
    )
