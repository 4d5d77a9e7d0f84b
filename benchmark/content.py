"""The benchmark's content: seeded stand-ins for mastered CD music.

A piece is four voices of pitched notes (bass, two middle voices, a lead),
each note a harmonic series whose partials fall with the harmonic's number
and decay faster the higher they lie, with an attack and a release; a
hi-hat on every half beat; a slow swell of the level (verse and chorus); a
pink noise floor; and the noise-shaped dither of a CD master above 15.5 kHz.
Stereo by panning each voice. The tempo, the notes, the phases and the noise
come from the seed; the length does not.

The levels are set so that the codec's own operating points hold: the lossy
``QualityPreset.HIGH`` writes about 6x (about 235 kbps of CD's 1,411), the
format's expected ratio for music, and lossless level 5 about 1.7x, a
typical CD album's ratio. Each configuration states its range
(``ratio_range``), and a run whose bytes leave it stops in set-up.

Numpy only: nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

#: (lowest and highest fundamental in Hz, level, beats a note, share to the right)
VOICES = ((41.0, 110.0, 0.35, 2.0, 0.5), (130.0, 520.0, 0.22, 1.0, 0.3),
          (196.0, 880.0, 0.16, 0.5, 0.7), (261.0, 1047.0, 0.12, 1.0, 0.55))
TILT = 1.5  # a partial's amplitude falls as harmonic ** -TILT
MAX_PARTIALS = 10
HAT_DB = -48.0  # the hi-hat's level, dB of full scale before the peak is set
FLOOR_DB = -85.0  # the pink noise floor, dB of full scale
DITHER_DB = -50.0  # the shaped dither above 15.5 kHz, dB of full scale
SWELL = 0.5  # the level swings between 1 - SWELL and 1 over 8 s
PEAK = 0.85


def make_music(seconds: float, rate: int, rng: np.random.Generator) -> np.ndarray:
    """Interleaved stereo float32 in [-1, 1], ``seconds`` long."""
    n = int(round(seconds * rate))
    out = np.zeros((2, n), np.float32)
    beat = 60.0 / rng.uniform(90.0, 140.0)
    for lo, hi, level, beats, pan in VOICES:
        dur = beats * beat
        for t0 in np.arange(0.0, seconds, dur):
            f0 = lo * (hi / lo) ** rng.uniform()
            f0 = 440.0 * 2.0 ** (np.round(12 * np.log2(f0 / 440.0)) / 12)  # equal temperament
            i0 = int(t0 * rate)
            length = min(int(1.5 * dur * rate), n - i0)
            if length <= 0:
                continue
            t = np.arange(length, dtype=np.float32) / np.float32(rate)
            h = np.arange(1, max(1, min(MAX_PARTIALS, int(8000.0 / f0))) + 1, dtype=np.float32)[:, None]
            amp = h**-TILT * rng.uniform(0.5, 1.0, h.shape).astype(np.float32)
            decay = np.exp(-t * np.float32(rng.uniform(2.0, 6.0)) * np.sqrt(h))
            phase = rng.uniform(0.0, 2 * np.pi, h.shape).astype(np.float32)
            x = (amp * decay * np.sin(np.float32(2 * np.pi * f0) * h * t + phase)).sum(0)
            ramp = np.minimum(t / np.float32(0.01), 1) * np.minimum(t[::-1] / np.float32(0.03), 1)
            x *= ramp * np.float32(level * rng.uniform(0.7, 1.0))
            out[0, i0 : i0 + length] += (2 * (1 - pan)) * x
            out[1, i0 : i0 + length] += (2 * pan) * x

    f = np.fft.rfftfreq(n, 1.0 / rate)
    hat = np.zeros(n)
    for t0 in np.arange(0.0, seconds, beat / 2):
        i0 = int(t0 * rate)
        length = min(int(0.08 * rate), n - i0)
        hat[i0 : i0 + length] += rng.standard_normal(length) * np.exp(-np.arange(length) / (0.015 * rate))
    hat = np.fft.irfft(np.fft.rfft(hat) * np.clip((f - 5000.0) / 3000.0, 0, 1) * (f < 16000.0), n)
    out += (10 ** (HAT_DB / 20) * hat * np.array([[1.2], [0.8]])).astype(np.float32)

    pink = np.fft.irfft(np.fft.rfft(rng.standard_normal((2, n)), axis=1)
                        * ((f < 16000.0) / np.sqrt(np.maximum(f, 20.0))), n, axis=1)
    out += (pink * (10 ** (FLOOR_DB / 20) / max(pink.std(), 1e-30))).astype(np.float32)
    swing = 0.5 + 0.5 * np.sin(2 * np.pi * np.arange(n) / (8.0 * rate) + rng.uniform(0, 2 * np.pi))
    out *= (1 - SWELL * swing).astype(np.float32)
    out *= np.float32(PEAK / max(float(np.abs(out).max()), 1e-30))

    dither = np.fft.irfft(np.fft.rfft(rng.standard_normal((2, n)), axis=1)
                          * ((f > 15500.0) & (f < 20000.0)), n, axis=1)
    out += (dither * (10 ** (DITHER_DB / 20) / max(dither.std(), 1e-30))).astype(np.float32)
    y = np.empty(2 * n, np.float32)
    y[0::2], y[1::2] = np.clip(out, -1, 1)
    return y
