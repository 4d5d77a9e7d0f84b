"""Debug / integrity mode.

The reference's switch turns on its array library's global NaN/Inf checks.
PyTorch has no such switch for forward values
(``torch.autograd.set_detect_anomaly`` watches gradients only), so the port
keeps its own flag. While it is on:

- ``decode`` verifies the DATA chunk's CRC32 before it touches a frame and
  raises ``ValueError`` on a mismatch;
- the entry points that bring float samples back from a device (``decode``,
  ``batch.decode_many``, ``seeking.decode_frame_at``, a lossy frame of
  ``StreamingDecoder``) check them with ``numpy.isfinite(...).all()`` and raise
  ``FloatingPointError`` on a NaN or an infinity.

Encodes produce bytes, not floats, and are not checked.
"""

from __future__ import annotations

import contextlib

import numpy as np

_DEBUG = False


def debug_enabled() -> bool:
    return _DEBUG


def enable_debug_mode(enable: bool = True) -> None:
    """Turn on CRC-verified decodes and the finite checks of decoded samples."""
    global _DEBUG
    _DEBUG = bool(enable)


@contextlib.contextmanager
def debug_mode():
    """Context manager form of :func:`enable_debug_mode`."""
    prev = _DEBUG
    enable_debug_mode(True)
    try:
        yield
    finally:
        enable_debug_mode(prev)


def check_crc(data: bytes) -> None:
    """Raise if the DATA CRC does not match (used by decode in debug mode)."""
    from . import lib

    if not lib.validate(data):
        raise ValueError("CRC32 mismatch: corrupted flo data")


def check_finite(what: str, samples: np.ndarray) -> None:
    """Raise ``FloatingPointError`` if ``samples`` holds a NaN or an infinity."""
    if not np.isfinite(samples).all():
        raise FloatingPointError(f"{what}: non-finite sample")
