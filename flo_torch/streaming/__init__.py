"""Streaming encode/decode (libflo/src/streaming/)."""

from .decoder import StreamingDecoder
from .encoder import StreamingEncoder
from .types import DecoderState, EncodedFrame, StreamingAudioInfo

__all__ = [
    "DecoderState",
    "EncodedFrame",
    "StreamingAudioInfo",
    "StreamingDecoder",
    "StreamingEncoder",
]
