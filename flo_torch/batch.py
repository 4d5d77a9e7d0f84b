"""Bulk (multi-file) API, lossless half: one device pass for many files.

The counterpart of the reference's ``batch.py`` for lossless files. Lossy
bulk encode and decode are not ported yet (ROADMAP.md section 1, items 8-9).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from ._flo_host.container import reader, writer
from ._flo_host.core.analysis_batch import analyze_many
from ._flo_host.core.constants import FrameType
from ._flo_host.futures import BulkFuture
from .lossless import decoder as _lossless_decoder
from .lossless import encoder as _lossless_encoder


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
    fut = _lossless_encoder.encode_many_to_frames_async(
        samples_list, sample_rate, channels, level, "device", device=device
    )
    get_metas = _analyzed_metas_async(samples_list, sample_rate, channels, metadata_list, analyze)

    def fin(frames_per_file):
        metas = get_metas() or [b""] * len(samples_list)
        return [
            writer.write(int(sample_rate), int(channels), int(bit_depth), level, frames, meta)
            for frames, meta in zip(frames_per_file, metas)
        ]

    return fut.then(fin)


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


def decode_many_async(datas: Sequence[bytes], *, device="cuda") -> BulkFuture:
    """Bulk decode of lossless files, dispatched immediately; ``result()``
    gives one interleaved float32 array per file, in input order."""
    flos = [reader.read(d) for d in datas]
    if any(f.frame_type == int(FrameType.TRANSFORM) for flo in flos for f in flo.frames):
        raise NotImplementedError(
            "lossy (Transform-frame) decode is not ported yet: ROADMAP.md section 1, item 9"
        )
    return _lossless_decoder.decode_many_async(flos, device=device)


def decode_many(datas: Sequence[bytes], *, device="cuda") -> List[np.ndarray]:
    """Blocking form of :func:`decode_many_async`."""
    return decode_many_async(datas, device=device).result()
