"""Push-based streaming encoder.

Behavioral mirror of libflo/src/streaming/encoder.rs: buffer interleaved
samples, emit one encoded frame per `sample_rate` sample-frames, flush a
partial final frame, and finalize() hand-assembles header + TOC + DATA + META.

Deliberate fix (SURVEY.md §2.5): the reference re-serializes ALPC channels in
a layout that does not match the container format (encoder.rs:243-257 vs
writer.rs:274-296) so its streaming-finalized files are undecodable for ALPC
frames. Frames here are serialized with the standard container writer, so
finalized files match Docs/file-format.md and decode everywhere.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..container import writer
from ..core import crc32
from ..core.constants import HEADER_SIZE, MAGIC, VERSION_MAJOR, VERSION_MINOR
from ..lossless import encoder as lossless_encoder
from .types import EncodedFrame


class StreamingEncoder:
    #: LPC candidate orders the per-frame host search fully evaluates: the
    #: 2 best PREDICTED by the Levinson prediction error (native/encode.cpp
    #: prune_topk). The o(n) residual+size passes for 8 LPC orders are ~75%
    #: of a streaming frame's host cost. Round-trips stay bit-exact
    #: regardless of K — every candidate is a valid predictor, only the
    #: CHOICE is pruned, so a miss costs bytes, never correctness.
    #: Set to 0 to restore the full reference search.
    lpc_prune_topk = 2

    def __init__(
        self, sample_rate: int, channels: int, bit_depth: int = 16, *, device="cuda"
    ) -> None:
        #: where the bulk path runs when the host has no C++ toolchain
        self.device = device
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.bit_depth = int(bit_depth)
        self.compression_level = 5
        self.samples_per_frame = self.sample_rate
        self._buffer = np.zeros(0, dtype=np.float32)
        self._pending: List[EncodedFrame] = []
        self._total_samples = 0
        self._frame_index = 0

    def with_compression(self, level: int) -> "StreamingEncoder":
        self.compression_level = min(int(level), 9)
        return self

    def pending_samples(self) -> int:
        return len(self._buffer) // self.channels

    def pending_frames(self) -> int:
        return len(self._pending)

    def push_samples(self, samples) -> None:
        """Append interleaved samples; encodes whole frames as they fill
        (encoder.rs:71-76)."""
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        self._try_encode_frames()

    def _encode_one(self, chunk: np.ndarray) -> EncodedFrame:
        # Per-frame encodes cannot amortize a device round trip; run the
        # C++ host search (native/encode.cpp). Only a host without a
        # toolchain takes the bulk path on ``self.device``: the same split
        # as StreamingDecoder.
        frame = lossless_encoder.encode_frame_host(
            chunk, self.sample_rate, self.channels, self.compression_level,
            prune_lpc=self.lpc_prune_topk,
        )
        if frame is None:
            frames = lossless_encoder.encode_to_frames(
                chunk, self.sample_rate, self.channels, self.compression_level,
                device=self.device,
            )
            assert len(frames) == 1
            frame = frames[0]
        data = writer.serialize_frame(frame)
        n = len(chunk) // self.channels
        ts = int(self._total_samples / self.sample_rate * 1000.0)
        ef = EncodedFrame(index=self._frame_index, timestamp_ms=ts, data=data, samples=n)
        self._total_samples += n
        self._frame_index += 1
        return ef

    def _try_encode_frames(self) -> None:
        need = self.samples_per_frame * self.channels
        while len(self._buffer) >= need:
            chunk, self._buffer = self._buffer[:need], self._buffer[need:]
            self._pending.append(self._encode_one(chunk))

    def next_frame(self) -> Optional[EncodedFrame]:
        """Pop the next encoded frame (encoder.rs:78-85)."""
        return self._pending.pop(0) if self._pending else None

    def flush(self) -> Optional[EncodedFrame]:
        """Encode any buffered partial frame (encoder.rs:87-109)."""
        if len(self._buffer) == 0:
            return None
        chunk, self._buffer = self._buffer, np.zeros(0, dtype=np.float32)
        return self._encode_one(chunk)

    def finalize(self, metadata: bytes = b"") -> bytes:
        """Assemble a complete file from the *pending* frames
        (encoder.rs:112-185; frames already drained via next_frame are the
        caller's responsibility, as in the reference)."""
        last = self.flush()
        if last is not None:
            self._pending.append(last)

        toc = bytearray(struct.pack("<I", len(self._pending)))
        byte_offset = 0
        for f in self._pending:
            toc += struct.pack("<IQII", f.index, byte_offset, len(f.data), f.timestamp_ms)
            byte_offset += len(f.data)

        data_chunk = b"".join(f.data for f in self._pending)
        total_samples = sum(f.samples for f in self._pending)

        header = writer._HEADER_STRUCT.pack(
            VERSION_MAJOR,
            VERSION_MINOR,
            0,
            self.sample_rate,
            self.channels,
            self.bit_depth,
            total_samples,
            self.compression_level,
            crc32.compute(data_chunk),
            HEADER_SIZE,
            len(toc),
            len(data_chunk),
            0,
            len(metadata),
        )
        return b"".join([MAGIC, header, bytes(toc), data_chunk, bytes(metadata)])
