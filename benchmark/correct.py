"""How ``correct`` is decided: the program's outputs held to the plain
reference (``reference/``), track by track, and the numbers compared, each
against the limit the configuration's file gives it.

Numbers (every one is compared as ``value <= limit``):

- ``format_errors``: checked tracks whose bytes break the container or codec
  format, or whose header or length disagrees with the track (any cell);
- ``gap_steps``: lossless, the widest gap between the track's samples and
  what came out, in steps of the 16-bit codec domain (the ingest's bytes as
  the reference decodes them, or the decode's float32 samples);
- ``q_gap_pct``: lossy, the share of coefficients (nonzero on either side)
  whose quantized value differs from the reference encoder's by more than
  one step, in %;
- ``snr_gap_db``: lossy, how far the signal-to-noise ratio of the bytes (as
  the reference decodes them) lies from that of the reference's own encode;
- ``decode_gap_steps``: lossy decode, the widest gap between the program's
  samples and the reference's decode of the same bytes, in 16-bit steps.

Numpy only: nothing here imports the program.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .reference import container, lossless, lossy

STEP = 32767.0


def sample_tracks(seed: int, lengths, pool: int):
    """The (pool batch, track) pairs a run checks, drawn from the seed: the
    longest track of one batch, and one other track."""
    rng = np.random.default_rng([seed % (1 << 64), 7])
    longest = int(np.argmax(lengths))
    first = (int(rng.integers(pool)), longest)
    rest = [(p, j) for p in range(pool) for j in range(len(lengths)) if (p, j) != first]
    return [first, rest[int(rng.integers(len(rest)))]]


def _parse(data: bytes, cfg: dict, n: int) -> container.File:
    """Parse a written file and hold its header to the configuration."""
    f = container.parse(data)
    lossy_mode = cfg["mode"] == "lossy"
    if (f.sample_rate, f.channels, f.lossy) != (cfg["sample_rate"], cfg["channels"], lossy_mode):
        raise container.FormatError("header: rate, channels or mode")
    if lossy_mode:
        hops = -(-(n + lossy.HOP) // lossy.HOP)
        if (f.flags >> 8) & 0xF != cfg["quality"] or len(f.frames) != hops:
            raise container.FormatError("header: quality or frames")
    elif (f.bit_depth, f.level, f.total_samples) != (cfg["bit_depth"], cfg["level"], n):
        raise container.FormatError("header: bit depth, level or samples")
    return f


def _snr(pcm: np.ndarray, y: np.ndarray) -> float:
    ref = np.asarray(pcm, np.float64)
    return float(10 * np.log10(np.sum(ref**2) / max(np.sum((ref - y[: ref.size]) ** 2), 1e-300)))


class Tally:
    """The numbers of one run's checked tracks, pooled."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.format_errors = 0
        self.gap = 0.0
        self.q_diff = 0
        self.q_nonzero = 0
        self.snr_gap = 0.0
        self.decode_gap = 0.0
        self.decoded = False  # the window's output is samples: decode_gap_steps is compared
        self.failed_tracks = set()
        self.lock = threading.Lock()

    def numbers(self, cfg: dict) -> dict:
        """name -> measured value, for the comparisons of this cell."""
        out = {"format_errors": float(self.format_errors)}
        if cfg["mode"] == "lossless":
            out["gap_steps"] = self.gap
        else:
            out["q_gap_pct"] = 100.0 * self.q_diff / max(self.q_nonzero, 1)
            out["snr_gap_db"] = self.snr_gap
            if self.decoded:
                out["decode_gap_steps"] = self.decode_gap
        return out

    # --- The pieces, so that the control can take the program's place. ---

    def lossless_ints(self, key, got: np.ndarray, pcm: np.ndarray, C: int) -> None:
        want = lossless.pcm_to_int(pcm).reshape(-1, C)
        if got.shape != want.shape:
            self.bad(key)
            return
        gap = float(np.abs(got - want).max(initial=0))
        self.gap = max(self.gap, gap)
        if gap > self.limits["gap_steps"]:
            self.failed_tracks.add(key)

    def lossy_coefs(self, key, q: np.ndarray, sf: np.ndarray, pcm: np.ndarray, cfg: dict):
        """Coefficients and scale factors against the reference encoder's;
        returns the reference's decode of ``(q, sf)``, or None."""
        C, rate = cfg["channels"], cfg["sample_rate"]
        qr, sr = lossy.encode(pcm, C, rate, cfg["quality_f"])
        if q.shape != qr.shape or sf.shape != sr.shape:
            self.bad(key)
            return None
        diff, nonzero = int((np.abs(q - qr) > 1).sum()), int(((q != 0) | (qr != 0)).sum())
        y = lossy.decode(q, sf, rate)
        gap = abs(_snr(pcm, y) - _snr(pcm, lossy.decode(qr, sr, rate)))
        with self.lock:
            self.q_diff += diff
            self.q_nonzero += nonzero
            self.snr_gap = max(self.snr_gap, gap)
            if (100.0 * diff / max(nonzero, 1) > self.limits["q_gap_pct"]
                    or gap > self.limits["snr_gap_db"]):
                self.failed_tracks.add(key)
        return y

    def lossy_samples(self, key, got: np.ndarray, y_ref: np.ndarray) -> None:
        """The program's decode against the reference's decode of the same
        bytes, in 16-bit steps."""
        if got.shape != y_ref.shape or not np.isfinite(got).all():
            self.bad(key)
            return
        want = np.clip(np.rint(y_ref * STEP), -32768, 32767)
        gap = float(np.abs(np.rint(got.astype(np.float64) * STEP) - want).max(initial=0))
        with self.lock:
            self.decode_gap = max(self.decode_gap, gap)
            if gap > self.limits["decode_gap_steps"]:
                self.failed_tracks.add(key)

    def bad(self, key) -> None:
        with self.lock:
            self.format_errors += 1
            self.failed_tracks.add(key)

    # --- What a run checks. ---

    def ingest(self, tracks, cfg: dict) -> None:
        """[(key, bytes as the window wrote them, the track's samples)]."""
        C = cfg["channels"]
        parsed = []
        for key, data, pcm in tracks:
            try:
                parsed.append((key, _parse(data, cfg, pcm.size // C), pcm))
            except container.FormatError:
                self.bad(key)
        if cfg["mode"] == "lossless":
            self._lossless(parsed, C)
            return

        def one(item):
            key, f, pcm = item
            try:
                self.lossy_coefs(key, *lossy.parse(f), pcm, cfg)
            except container.FormatError:
                self.bad(key)

        each(one, parsed)

    def _lossless(self, parsed, C: int) -> None:
        try:
            decoded = lossless.decode([f for _, f, _ in parsed])
        except container.FormatError:  # one stream is bad: find which
            decoded = []
            for key, f, _ in parsed:
                try:
                    decoded += lossless.decode([f])
                except container.FormatError:
                    self.bad(key)
                    decoded.append(None)
        for (key, _, pcm), ints in zip(parsed, decoded):
            if ints is not None:
                self.lossless_ints(key, ints, pcm, C)

    def decode(self, tracks, cfg: dict) -> None:
        """[(key, samples as the window decoded them, the bytes set-up encoded,
        the track's samples)]; for lossy, those bytes are checked too."""
        C = cfg["channels"]
        self.decoded = True
        if cfg["mode"] == "lossless":
            for key, got, _, pcm in tracks:
                if got.size % C or not np.isfinite(got).all():
                    self.bad(key)
                    continue
                ints = np.rint(got.astype(np.float64) * STEP).astype(np.int64).reshape(-1, C)
                self.lossless_ints(key, ints, pcm, C)
            return

        def one(item):
            key, got, data, pcm = item
            try:
                q, sf = lossy.parse(_parse(data, cfg, pcm.size // C))
            except container.FormatError:
                self.bad(key)
                return
            y = self.lossy_coefs(key, q, sf, pcm, cfg)
            if y is not None:
                self.lossy_samples(key, got, y)

        each(one, tracks)


def each(fn, items) -> None:
    """fn on every item, on a thread each (numpy releases the GIL in its
    transforms and array operations); raises what any call raised."""
    with ThreadPoolExecutor(max(len(items), 1)) as pool:
        for f in [pool.submit(fn, it) for it in items]:
            f.result()


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit."""
    return all(numbers[k] <= limits[k] for k in numbers)
