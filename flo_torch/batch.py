"""Bulk (multi-file) API: one device pass for many files.

The counterpart of the reference's ``batch.py``: lossless and lossy bulk
encode, and a bulk decode that sorts its files into lossless and lossy
batches.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from . import debug, tracing
from .container import reader, writer
from .core.analysis_batch import analyze_many
from .futures import BulkFuture
from .lossless import decoder as _lossless_decoder
from .lossless import encoder as _lossless_encoder
from .lib import is_transform
from .lossy import decoder as _lossy_decoder
from .lossy import encoder as _lossy_encoder
from .lossy.presets import QUALITY_U8_TO_F32


def _analyzed_metas_async(samples_list, sample_rate, channels, metadata_list, analyze):
    """Every encoded file gets analysis metadata (waveform, fingerprint,
    loudness, length; lib.rs:219-283). Returns a zero-argument callable that
    gives the metadata list. With analyze=True the pass runs on a worker
    thread (numpy and the C++ kernels, which release the GIL), overlapping
    the device encode; its errors are raised by the callable."""
    if not analyze:
        return lambda: metadata_list
    box: list = []

    def run():
        try:
            box.append((True, analyze_many(samples_list, sample_rate, channels, metadata_list)))
        except BaseException as e:  # noqa: BLE001 -- raised again by get()
            box.append((False, e))

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def get():
        t.join()
        ok, val = box[0]
        if not ok:
            raise val
        return val

    return get


def encode_many_async(
    samples_list: Sequence[np.ndarray],
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata_list: Optional[Sequence[bytes]] = None,
    analyze: bool = True,
    *,
    device="cuda",
) -> BulkFuture:
    """Lossless bulk encode, dispatched immediately. The device search
    (``analysis="device"``) is dispatched first; the host analysis pass runs
    meanwhile, and its metadata reaches the container writer at collect
    time."""
    level = min(int(compression_level), 9)
    n = len(samples_list)
    with tracing.span("encode.dispatch", mode="lossless", files=n) as sp:
        if sp:
            sp.add(samples=sum(map(np.size, samples_list)))
        fut = _lossless_encoder.encode_many_to_frames_async(
            samples_list, sample_rate, channels, level, "device", device=device
        )
        get_metas = _analyzed_metas_async(samples_list, sample_rate, channels, metadata_list,
                                          analyze)

        def fin(frames_per_file):
            metas = get_metas() or [b""] * n
            with tracing.span("encode.write", files=n) as sp:
                out = [
                    writer.write(int(sample_rate), int(channels), int(bit_depth), level, frames,
                                 meta)
                    for frames, meta in zip(frames_per_file, metas)
                ]
                if sp:
                    sp.add(bytes=sum(map(len, out)))
            return out

        return fut.then(fin, "encode.collect", mode="lossless", files=n)


def encode_many(
    samples_list: Sequence[np.ndarray],
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata_list: Optional[Sequence[bytes]] = None,
    analyze: bool = True,
    *,
    device="cuda",
) -> List[bytes]:
    """Lossless bulk encode with the analysis metadata embedded
    (analyze=False leaves it out). Uses the on-device coefficient analysis:
    bit-exact round trips; for the single-file ``encode``'s bytes call
    ``lossless.encoder.encode_many(..., analysis="exact")``."""
    return encode_many_async(
        samples_list, sample_rate, channels, bit_depth, compression_level, metadata_list,
        analyze, device=device,
    ).result()


def encode_lossy_many_async(
    samples_list: Sequence[np.ndarray],
    sample_rate: int,
    channels: int,
    quality: int = 2,
    metadata_list: Optional[Sequence[bytes]] = None,
    transport_dtype=np.float32,
    analyze: bool = True,
    *,
    device="cuda",
) -> BulkFuture:
    """Lossy bulk encode, dispatched immediately; quality is the u8 preset.

    The device MDCT work is dispatched before the host analysis pass runs
    (see :func:`encode_many_async`); metadata lands in the writer at collect
    time."""
    q_u8 = min(int(quality), 4)
    n = len(samples_list)
    with tracing.span("encode.dispatch", mode="lossy", files=n) as sp:
        if sp:
            sp.add(samples=sum(map(np.size, samples_list)))
        fut = _lossy_encoder.encode_many_to_frames_async(
            samples_list, sample_rate, channels, QUALITY_U8_TO_F32[q_u8], transport_dtype,
            device=device,
        )
        get_metas = _analyzed_metas_async(samples_list, sample_rate, channels, metadata_list,
                                          analyze)

        def fin(frames_per_file):
            metas = get_metas() or [b""] * n
            with tracing.span("encode.write", files=n) as sp:
                out = [
                    writer.write(
                        int(sample_rate), int(channels), 16, 5, frames, meta,
                        lossy=True, lossy_quality=q_u8,
                    )
                    for frames, meta in zip(frames_per_file, metas)
                ]
                if sp:
                    sp.add(bytes=sum(map(len, out)))
            return out

        return fut.then(fin, "encode.collect", mode="lossy", files=n)


def encode_lossy_many(
    samples_list: Sequence[np.ndarray],
    sample_rate: int,
    channels: int,
    quality: int = 2,
    metadata_list: Optional[Sequence[bytes]] = None,
    transport_dtype=np.float32,
    analyze: bool = True,
    *,
    device="cuda",
) -> List[bytes]:
    """Lossy bulk encode with the analysis metadata embedded; quality u8 0-4."""
    return encode_lossy_many_async(
        samples_list, sample_rate, channels, quality, metadata_list, transport_dtype,
        analyze, device=device,
    ).result()


def decode_many_async(datas: Sequence[bytes], *, device="cuda") -> BulkFuture:
    """Bulk auto-detecting decode: sorts the files into lossless and lossy
    batches (each one dispatched device pass; lossy files grouped by rate
    and channels); ``result()`` gives one interleaved float32 array per
    file, in input order."""
    with tracing.span("decode.dispatch", files=len(datas)):
        with tracing.span("decode.read") as sp:
            if sp:
                sp.add(bytes=sum(map(len, datas)))
            flos = [reader.read(d) for d in datas]
        outs: List[np.ndarray] = [np.zeros(0, np.float32)] * len(flos)
        lossless = [i for i, flo in enumerate(flos) if not is_transform(flo)]
        groups: dict = {}  # lossy bulk needs one rate and channel count a batch
        for i, flo in enumerate(flos):
            if is_transform(flo):
                groups.setdefault((flo.header.sample_rate, flo.header.channels), []).append(i)
        pending = []  # (indices, future)
        if lossless:
            pending.append((lossless, _lossless_decoder.decode_many_async(
                [flos[i] for i in lossless], device=device)))
        for idxs in groups.values():
            pending.append((idxs, _lossy_decoder.decode_many_async(
                [flos[i] for i in idxs], device=device)))

        def fin() -> List[np.ndarray]:
            for idxs, fut in pending:
                for i, out in zip(idxs, fut.result()):
                    if debug.debug_enabled():
                        debug.check_finite(f"decode_many, file {i}", out)
                    outs[i] = out
            return outs

        return BulkFuture(fin, "decode.collect", files=len(flos))


def decode_many(datas: Sequence[bytes], *, device="cuda") -> List[np.ndarray]:
    """Blocking form of :func:`decode_many_async`."""
    return decode_many_async(datas, device=device).result()
