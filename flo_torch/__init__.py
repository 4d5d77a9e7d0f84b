"""flo_torch — the flo audio codec on PyTorch and CUDA (NVIDIA Hopper).

A port of ``flo_tpu`` beside it: the same container bytes and the same public
names, with the device work in PyTorch and hand-written CUDA kernels. Ported
so far: lossless encode, single-file on the host (C++) and in bulk on the
card (``lossless.encoder.encode_many``, ``batch.encode_many``: candidate
search in ``csrc/lossless_select.cu``, Rice pack in ``csrc/rice_pack.cu``),
and lossless decode, whose LPC reconstruction runs in
``csrc/lpc_reconstruct.cu``; lossy (MDCT) encode and decode on the card
(``encode_lossy``, ``encode_transform``, ``encode_with_bitrate``,
``batch.encode_lossy_many``; ``decode`` detects the mode), whose
temporal-masking scan runs in ``csrc/temporal_mask.cu``. Functions that
allocate on a device take ``device=`` (default ``"cuda"``).
"""

from .core.constants import VERSION_STRING as __format_version__
from .lib import (
    AudioInfo,
    decode,
    encode,
    encode_lossy,
    encode_transform,
    encode_with_bitrate,
    info,
    validate,
)

__version__ = "0.1.0"

__all__ = [
    "AudioInfo",
    "decode",
    "encode",
    "encode_lossy",
    "encode_transform",
    "encode_with_bitrate",
    "info",
    "validate",
]
