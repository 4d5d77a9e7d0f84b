"""Quality presets (libflo/src/lossy/mod.rs:19-128)."""

from __future__ import annotations

import enum


class QualityPreset(enum.IntEnum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2
    VERY_HIGH = 3
    TRANSPARENT = 4

    def as_f32(self) -> float:
        return _PRESET_F32[self]

    @classmethod
    def from_f32(cls, quality: float) -> "QualityPreset":
        if quality < 0.2:
            return cls.LOW
        if quality < 0.45:
            return cls.MEDIUM
        if quality < 0.65:
            return cls.HIGH
        if quality < 0.85:
            return cls.VERY_HIGH
        return cls.TRANSPARENT

    def expected_ratio(self) -> float:
        return {0: 30.0, 1: 10.0, 2: 6.0, 3: 4.0, 4: 3.0}[int(self)]

    def equivalent_bitrate(self) -> int:
        return {0: 48, 1: 128, 2: 192, 3: 256, 4: 320}[int(self)]

    @classmethod
    def from_bitrate(cls, bitrate_kbps: int, sample_rate: int, channels: int) -> "QualityPreset":
        raw_kbps = (sample_rate * channels * 16) // 1000
        target_ratio = raw_kbps / float(bitrate_kbps)
        if target_ratio > 20.0:
            return cls.LOW
        if target_ratio > 10.0:
            return cls.MEDIUM
        if target_ratio > 6.0:
            return cls.HIGH
        if target_ratio > 4.0:
            return cls.VERY_HIGH
        return cls.TRANSPARENT

    @classmethod
    def from_u8(cls, v: int) -> "QualityPreset":
        return cls(min(int(v), 4))


_PRESET_F32 = {0: 0.0, 1: 0.35, 2: 0.55, 3: 0.75, 4: 1.0}

#: API u8 quality -> encoder f32 quality (lib.rs:144-151).
QUALITY_U8_TO_F32 = _PRESET_F32
