#!/usr/bin/env python3
"""Throughput benchmark of flo_torch on one NVIDIA GPU: bench.py's twin.

    python3 bench_torch.py                       # the full run, on the card
    python3 bench_torch.py --quick --device cpu  # a tiny run on the CPU

The same workloads as bench.py, driven through flo_torch: the headline pass
(8 files x 60 s of stereo 44.1 kHz corpus content, lossless level 5 and
lossy medium, each encoded and decoded, best of ITERS laps), then 21 configs
by bench.py's names and in its order. Content is the corpus of
``tests/vectors/examples``, decoded with the port and tiled as bench.py
tiles it.

Output, one JSON object a line, printed as it is known: the build, the
headline, the corpus round trip, one line a config (``{"config": name,
...}``, or ``{"config": name, "skipped": "budget"}`` once ``--budget-s`` of
wall time is spent, checked between configs), then the full result line,
with bench.py's keys (``platform`` is ``device``: the card's name, power
limit and count; ``tunnel_mbs`` is ``copy_mbs``: 8 MiB of pageable memory up
and down), and last a compact summary.

The ``device_*`` configs time device-resident work with CUDA events around
back-to-back launches and one synchronise, name the hand kernels they run
(their launch counters must move) and give a roofline: the bytes and
operations these inputs need (``chip_smoke``'s bound functions) against the
H100's 3.35 TB/s and its int32 or float32 rate.

Gates (a failure raises and the exit code is not 0): the headline's lossless
round trip on every clip, the lossy headline above the medium SNR floor,
every lossless config's round trip, the corpus round trip at 100%, the mesh
config's bytes and decodes equal to the unsharded ones, and every device
config's kernels launched. With ``--device cpu`` the kernels' plain versions
run, the device is named "cpu" and no device time is written.

Imports nothing of JAX, of flo_tpu or of bench.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke
import flo_torch
from flo_torch import batch as fbatch
from flo_torch import lib, native
from flo_torch.container import reader
from flo_torch.core import convert
from flo_torch.lossless import decoder as lld
from flo_torch.lossless import encoder as lle
from flo_torch.lossy import decoder as lod
from flo_torch.lossy import encoder as loe
from flo_torch.lossy.presets import QUALITY_U8_TO_F32, QualityPreset
from flo_torch.ops import _build, blockspread, compact, lpc, select
from flo_torch.parallel import pipeline
from flo_torch.streaming import StreamingDecoder, StreamingEncoder

ROOT = pathlib.Path(__file__).resolve().parent
EXAMPLES = ROOT / "tests" / "vectors" / "examples"

WORKLOAD_SECONDS = 60
BATCH_FILES = 8
RATE = 44100
CHANNELS = 2
ITERS = 4
NORTH_STAR = 1000.0
BREADTH_SECONDS = 15
BREADTH_FILES = 8

#: Wall-clock budget of a run, checked between configs: a full run on the
#: card takes a few minutes, so this only cuts a run that went wrong.
BUDGET_S = 540.0


@dataclasses.dataclass(frozen=True)
class Geometry:
    files: int
    seconds: int
    iters: int
    breadth_files: int
    breadth_seconds: int
    cfg_reps: int  # timed runs of a breadth config after its warm-up
    device_reps: int  # back-to-back launches a device config times
    corpus: tuple[str, ...] | None  # the corpus round trip's files (None: every one)


FULL = Geometry(BATCH_FILES, WORKLOAD_SECONDS, ITERS, BREADTH_FILES, BREADTH_SECONDS, 2, 6, None)
#: For the tests and chip_smoke.py: every path once, no number worth keeping;
#: the corpus round trip on three short files.
QUICK = Geometry(2, 2, 1, 2, 2, 1, 2, ("click_track_120bpm", "dtmf_tones", "telephone_8khz"))

CONFIGS = (
    "lossless_l0", "lossless_l5", "lossless_l9",
    "lossy_q0", "lossy_q1", "lossy_q2", "lossy_q3", "lossy_q4",
    "synthetic_noise_l5", "lossless_with_analysis",
    "lossy_transparent_sweep_20_20k", "lossy_bitrate128_sweep_20_20k",
    "lossy_transparent_hires_96khz", "lossy_bitrate128_hires_96khz",
    "mesh_lossless_l5",
    "device_kernels", "device_reconstruct", "device_decode", "device_mdct",
    "streaming_encode", "streaming_decode",
)

#: bench.py:345-347: the device search's candidates (level 5's plan).
KINDS = ("raw", "fixed", "fixed", "fixed", "fixed", "fixed", "lpc", "lpc", "lpc", "lpc")
ORDERS = (0, 0, 1, 2, 3, 4, 5, 6, 7, 8)

LOSSLESS_TOL = 1 / 32768 + 1e-6  # bench.py:179
MEDIUM_SNR_FLOOR = 30.0  # the medium preset's floor (tests/test_lossy.py)


class BenchFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise BenchFailure(msg)


def make_audio(seconds: int, rate: int, seed: int = 42) -> np.ndarray:
    """Noise-laden synthetic stereo signal (tones + noise + envelope), the
    near-incompressible stress content: bench.py's, bit for bit."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * rate, dtype=np.float64) / rate
    l = (
        0.4 * np.sin(2 * np.pi * 220 * t)
        + 0.2 * np.sin(2 * np.pi * 331 * t)
        + 0.1 * np.sin(2 * np.pi * 553 * t)
        + 0.03 * rng.standard_normal(t.size)
    ) * (0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t))
    r = (
        0.4 * np.sin(2 * np.pi * 277 * t)
        + 0.2 * np.sin(2 * np.pi * 415 * t)
        + 0.03 * rng.standard_normal(t.size)
    ) * (0.6 + 0.4 * np.cos(2 * np.pi * 0.21 * t))
    out = np.empty(2 * t.size, dtype=np.float32)
    out[0::2] = np.clip(l, -1, 1)
    out[1::2] = np.clip(r, -1, 1)
    return out


def tile_content(base: np.ndarray, rate: int, channels: int, n_files: int, seconds: int):
    """``base`` (interleaved) tiled to ``seconds`` and rolled one second a
    file, to de-correlate the batch (bench.py:124-130)."""
    need = seconds * rate * channels
    tiled = np.tile(base, -(-need // len(base)))[:need]
    return [np.roll(tiled, i * channels * rate) for i in range(n_files)]


def corpus_content(name: str, n_files: int, seconds: int, *, device="cuda"):
    """A corpus file decoded with the port and tiled to the geometry at its
    own rate and channel count: (clips, rate, channels)."""
    raw = (EXAMPLES / f"{name}.flo").read_bytes()
    hdr = reader.read(raw).header
    base = lld.decode(raw, device=device)
    rate, ch = hdr.sample_rate, hdr.channels
    return tile_content(base, rate, ch, n_files, seconds), rate, ch


def corpus_bit_exact(device, names=None) -> tuple[int, int]:
    """Round-trip every lossless corpus file (or those of ``names``)
    bit-exactly in the i32 domain (bench.py:70-99): decode, re-encode the
    float32 samples, decode again. The first decodes run as one bulk call."""
    paths = sorted(EXAMPLES.glob("*.flo")) if names is None else [
        EXAMPLES / f"{n}.flo" for n in names]
    flos = []
    for p in paths:
        flo = reader.read(p.read_bytes())
        if not (flo.header.is_lossy or any(f.frame_type == 253 for f in flo.frames)):
            flos.append(flo)
    total = ok = 0
    for flo, f32 in zip(flos, lld.decode_many(flos, device=device)):
        if f32.size == 0:
            continue
        total += 1
        h = flo.header
        enc = flo_torch.encode(f32, h.sample_rate, h.channels, analyze=False, device=device)
        got = lld.decode_file_i32(reader.read(enc), device=device)
        want = convert.f32_to_i32_np(f32).reshape(-1, h.channels)
        ok += int(got.shape == want.shape and np.array_equal(got, want))
    return ok, total


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    m = min(len(ref), len(out))
    noise = (out[:m] - ref[:m]).astype(np.float64)
    return float(10 * np.log10(np.sum(ref[:m].astype(np.float64) ** 2)
                               / max(np.sum(noise**2), 1e-30)))


def check_lossless(clips, outs, what: str) -> None:
    check(len(outs) == len(clips), f"{what}: {len(outs)} decodes of {len(clips)} files")
    for i, (clip, out) in enumerate(zip(clips, outs)):
        check(out.shape == clip.shape, f"{what}: clip {i} decodes to {out.shape}, not {clip.shape}")
        err = float(np.abs(out - clip).max(initial=0.0))
        check(err <= LOSSLESS_TOL, f"{what}: clip {i} lossless round trip broken: {err}")


def device_info(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": 0}
    _, _, limit = chip_smoke.gpu_line().partition(", ")
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit,
            "count": torch.cuda.device_count()}


def build_everything(dev: torch.device) -> float:
    """Every CUDA kernel (one nvcc a source, in parallel) beside the host
    natives (g++, one at a time); returns the wall seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        kernels = pool.submit(_build.build_all) if dev.type == "cuda" else None
        for name in native._SIGNATURES:
            native._load(name)
        if kernels is not None:
            kernels.result()
    return time.perf_counter() - t0


def copy_probe(dev: torch.device, mb: int = 8):
    """MB/s of one copy of ``mb`` MiB of pageable host memory to the card and
    back (bench.py's wire probe); None on the CPU."""
    if dev.type != "cuda":
        return None
    host = torch.from_numpy(np.random.default_rng(7).integers(0, 256, mb << 20, np.uint8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = host.to(dev)
    torch.cuda.synchronize()
    up = mb / max(time.perf_counter() - t0, 1e-9)
    t0 = time.perf_counter()
    on_card.cpu()
    down = mb / max(time.perf_counter() - t0, 1e-9)
    return {"up": round(up, 1), "down": round(down, 1)}


def roofline(work, ms: float | None, source: str, float32: bool = False) -> dict:
    """The bound of ``work`` = (bytes, operations) against the card's rates,
    and the share of it that ``ms`` reaches; on the CPU (``ms`` None) only
    the counts."""
    nbytes, ops = work
    out = {"bound": source, "bytes": int(nbytes), "operations": int(ops),
           "ops_type": "float32" if float32 else "int32"}
    if ms is None:
        return out
    rate = chip_smoke.F32_OPS_PER_S if float32 else chip_smoke.INT_OPS_PER_S
    bound_ms, by = chip_smoke.bound(nbytes, ops, rate)
    out.update(bound_ms=bound_ms, bound_by=by, pct_of_bound=round(100 * bound_ms / ms, 2),
               achieved_gbps=round(nbytes / 1e6 / ms, 1))
    return out


def mdct_work(padded, entries, row_nnz, sf) -> tuple[int, int]:
    """The lossy encode step's bytes and float32 operations: the padded
    signal in, the nonzeros, their row counts and the scale factors out. A
    block of n = 2048 samples: the window and the fold (2n), two complex
    twiddles (12 n/4), an n/4-point complex FFT (5 (n/4) log2(n/4)); each of
    its n/2 coefficients about 20 more for the SMR (square, band sum, dB,
    threshold, compare) and the quantization (scale, round, clamp, gate),
    and the 25 bands' spreading (25 x 25 adds and maxima)."""
    n = loe.BLOCK
    blocks = sf.shape[0] * sf.shape[1]
    per_block = 2 * n + 12 * (n // 4) + 5 * (n // 4) * int(math.log2(n // 4)) + 20 * (n // 2) \
        + 2 * 25 * 25
    nbytes = chip_smoke.tensor_bytes(padded, entries, row_nnz, sf)
    return nbytes, blocks * per_block


class Bench:
    """One run: the device, the geometry, the configs to run and the budget."""

    def __init__(self, device, geometry: Geometry, configs, budget_s: float, emit):
        self.dev = lib.require_device(device)
        self.on_card = self.dev.type == "cuda"
        self.geo = geometry
        self.selected = set(configs)
        self.budget_s = budget_s
        self.emit = emit
        self.t_start = time.perf_counter()
        self.configs: dict = {}
        self.kernels = chip_smoke.kernel_modules()

    # ---- headline ------------------------------------------------------

    def pass_once(self, material, q_med, stages=None):
        """bench.py's pass: both encodes dispatched before either is
        collected, each decode dispatched as soon as its encode's bytes
        exist. ``stages`` gets each step's seconds."""
        dev, stamps = self.dev, [time.perf_counter()]

        def step():
            stamps.append(time.perf_counter())

        h_ll = lle.encode_many_async(material, RATE, CHANNELS, 16, 5, device=dev)
        step()
        h_lo = loe.encode_many_async(material, RATE, CHANNELS, q_med, transport_dtype="packed",
                                     device=dev)
        step()
        d_ll = h_ll.result()
        step()
        h_lld = lld.decode_many_async([reader.read(d) for d in d_ll], device=dev)
        step()
        d_lo = h_lo.result()
        step()
        h_lod = lod.decode_many_async([reader.read(d) for d in d_lo], device=dev)
        step()
        out_ll = h_lld.result()
        step()
        out_lo = h_lod.result()
        step()
        if stages is not None:
            names = ("dispatch lossless encode", "dispatch lossy encode", "collect lossless encode",
                     "dispatch lossless decode", "collect lossy encode", "dispatch lossy decode",
                     "collect lossless decode", "collect lossy decode")
            stages.update((n, b - a) for n, a, b in zip(names, stamps, stamps[1:]))
        return d_ll, out_ll, d_lo, out_lo

    def headline(self, build_s: float) -> dict:
        g = self.geo
        clips, _, _ = corpus_content("chord_cmajor_stereo", g.files, g.seconds, device=self.dev)
        q_med = QUALITY_U8_TO_F32[1]
        t0 = time.perf_counter()
        data_ll, out_ll, data_lo, out_lo = self.pass_once(clips, q_med)
        first_s = time.perf_counter() - t0
        check_lossless(clips, out_ll, "headline")
        hops = -(-(g.seconds * RATE + loe.HOP) // loe.HOP)
        for i, (clip, out) in enumerate(zip(clips, out_lo)):
            check(out.shape == ((hops - 1) * loe.HOP * CHANNELS,) and np.isfinite(out).all(),
                  f"headline lossy clip {i}: output {out.shape}")
            snr = snr_db(clip, out)
            check(snr > MEDIUM_SNR_FLOOR, f"headline lossy clip {i}: SNR {snr:.2f} dB")
        setup_s = time.perf_counter() - self.t_start

        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(self.dev)
        laps, stages = [], []
        for _ in range(g.iters):
            st: dict = {}
            t0 = time.perf_counter()
            self.pass_once(clips, q_med, st)
            laps.append(time.perf_counter() - t0)
            stages.append(st)
        peak = torch.cuda.max_memory_allocated(self.dev) / 1e6 if self.on_card else None
        audio_seconds = g.files * g.seconds * 4  # 2 encodes + 2 decodes of every clip
        best = int(np.argmin(laps))
        head = {
            "value": round(audio_seconds / laps[best], 2),
            "value_median": round(audio_seconds / float(np.median(laps)), 2),
            "pass_seconds": [round(x, 3) for x in laps],
            "pass_stages_seconds": {k: round(v, 4) for k, v in stages[best].items()},
            "setup_seconds": round(setup_s, 2),
            "build_seconds": round(build_s, 2),
            "first_pass_seconds": round(first_s, 3),
            "peak_device_mb": None if peak is None else round(peak, 1),
            "lossless_ratio": round(len(clips[0]) * 2 / len(data_ll[0]), 2),
            "lossy_ratio": round(len(clips[0]) * 2 / len(data_lo[0]), 2),
        }
        self.emit({"headline": head})
        self.clips, self.data_ll = clips, data_ll
        return head

    # ---- breadth configs ----------------------------------------------

    def run(self, name: str, fn) -> None:
        if name not in self.selected:
            return
        if time.perf_counter() - self.t_start > self.budget_s:
            rec = {"skipped": "budget"}
        else:
            rec = fn()
        self.configs[name] = rec
        self.emit({"config": name, **rec})

    def timed(self, enc, dec, material, audio_sec=None, extra=None, lossless=False):
        """bench.py's run_cfg: one warm-up, best of ``cfg_reps``, the ratio."""
        g = self.geo
        dec(enc(material))
        dt = float("inf")
        for _ in range(g.cfg_reps):
            t0 = time.perf_counter()
            datas = enc(material)
            outs = dec(datas)
            dt = min(dt, time.perf_counter() - t0)
        if lossless:
            check_lossless(material, outs, "config")
        audio = audio_sec if audio_sec else g.breadth_files * g.breadth_seconds * 2
        rec = {"value": round(audio / dt, 1), "ratio": round(len(material[0]) * 2 / len(datas[0]), 2),
               "seconds": round(dt, 4)}
        if not lossless:
            rec["snr_db"] = round(min(snr_db(m, o) for m, o in zip(material, outs)), 2)
        rec.update(extra or {})
        return rec, datas, outs

    def lossless_enc(self, level):
        return lambda m: lle.encode_many(m, RATE, CHANNELS, 16, level, device=self.dev)

    def lossless_dec(self, datas):
        return lld.decode_many([reader.read(d) for d in datas], device=self.dev)

    def lossy_dec(self, datas):
        return lod.decode_many([reader.read(d) for d in datas], device=self.dev)

    def lossy_enc(self, q, rate=RATE, ch=CHANNELS):
        return lambda m: loe.encode_many(m, rate, ch, q, transport_dtype="packed", device=self.dev)

    def breadth(self) -> None:
        g = self.geo
        bclips, _, _ = corpus_content("chord_cmajor_stereo", g.breadth_files, g.breadth_seconds,
                                      device=self.dev)
        self.bclips = bclips
        for level in (0, 5, 9):
            self.run(f"lossless_l{level}", lambda level=level: self.timed(
                self.lossless_enc(level), self.lossless_dec, bclips, lossless=True)[0])
        for preset in range(5):
            q = QUALITY_U8_TO_F32[preset]
            self.run(f"lossy_q{preset}",
                     lambda q=q: self.timed(self.lossy_enc(q), self.lossy_dec, bclips)[0])
        noise = [make_audio(g.breadth_seconds, RATE, seed=42 + i) for i in range(g.breadth_files)]
        self.run("synthetic_noise_l5", lambda: self.timed(
            self.lossless_enc(5), self.lossless_dec, noise, lossless=True)[0])
        self.run("lossless_with_analysis", lambda: self.timed(
            lambda m: fbatch.encode_many(m, RATE, CHANNELS, analyze=True, device=self.dev),
            self.lossless_dec, bclips, lossless=True)[0])

        content = functools.cache(lambda name: corpus_content(
            name, g.breadth_files, g.breadth_seconds, device=self.dev))

        def corpus_lossy(name: str, bitrate: bool) -> dict:
            """A mono corpus file at its own rate, transparent or at the
            preset a 128 kbps target gives (bench.py:267-305)."""
            cclips, crate, cch = content(name)
            extra = {"rate": crate, "channels": cch}
            preset = int(QualityPreset.TRANSPARENT)
            if bitrate:
                preset = int(QualityPreset.from_bitrate(128, crate, cch))
                extra.update(preset=preset, note="encode_with_bitrate facade: 128 kbps -> preset "
                             "via QualityPreset.from_bitrate (lib.rs:180-206)")
            csec = g.breadth_files * (len(cclips[0]) / (crate * cch)) * 2
            return self.timed(self.lossy_enc(QUALITY_U8_TO_F32[preset], crate, cch),
                              self.lossy_dec, cclips, audio_sec=csec, extra=extra)[0]

        for name in ("sweep_20_20k", "hires_96khz"):
            self.run(f"lossy_transparent_{name}", lambda n=name: corpus_lossy(n, False))
            self.run(f"lossy_bitrate128_{name}", lambda n=name: corpus_lossy(n, True))
        self.run("mesh_lossless_l5", self.mesh_config)

    def mesh_config(self) -> dict:
        """The lossless level-5 pair under an explicit mesh of every card
        (``use_mesh``), its bytes and decodes asserted equal to the unsharded
        pair's (bench.py:307-337). The unsharded pair is timed here too, just
        before, so that the two values share their place in the run."""
        mesh = pipeline.device_mesh() if self.on_card else pipeline.device_mesh([self.dev])

        def under_mesh(fn):
            def call(x):
                with pipeline.use_mesh(mesh):
                    return fn(x)
            return call

        base, datas0, outs0 = self.timed(self.lossless_enc(5), self.lossless_dec, self.bclips,
                                         lossless=True)
        rec, datas, outs = self.timed(under_mesh(self.lossless_enc(5)),
                                      under_mesh(self.lossless_dec), self.bclips, lossless=True)
        equal = datas == datas0 and all(np.array_equal(a, b) for a, b in zip(outs, outs0))
        check(equal, "mesh path output != unsharded output")
        return {**rec, "unsharded_value": base["value"], "mesh_devices": mesh.size,
                "equal_to_unsharded": equal,
                "note": "bulk encode+decode under an explicit device Mesh; bytes and decodes "
                        "asserted == unsharded lossless_l5's, timed just before it "
                        "(unsharded_value)"}

    # ---- device-resident configs ----------------------------------------

    def device_inputs(self):
        """bench.py:348-355: the breadth clips as [F, C, S] int16 frames of 1 s."""
        g = self.geo
        pcm = np.stack(
            [np.round(c.reshape(-1, 2).T * 32767).astype(np.int16)[:, : RATE * g.breadth_seconds]
             for c in self.bclips]
        ).reshape(g.breadth_files, 2, -1)
        return np.ascontiguousarray(
            pcm.reshape(g.breadth_files, 2, g.breadth_seconds, RATE).transpose(0, 2, 1, 3)
        ).reshape(-1, 2, RATE)

    def time_device(self, name: str, fn, kernels, work, source: str, note: str,
                    float32: bool = False, extra=None) -> dict:
        """fn() twice (a warm-up, then once synchronised on the host clock:
        the latency), then ``device_reps`` calls back to back between two
        CUDA events and one synchronise; the named kernels' counters must
        move. On the CPU fn() runs once and no time is written."""
        g = self.geo
        before = {k: self.kernels[k].LAUNCHES for k in kernels}
        rec = {"kernels": list(kernels)}
        if self.on_card:
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat_ms = 1e3 * (time.perf_counter() - t0)
            ms = chip_smoke.time_ms(fn, g.device_reps)
            launches = {k: self.kernels[k].LAUNCHES - before[k] for k in kernels}
            for k, n in launches.items():
                check(n > 0, f"{name}: the {k} kernel never launched")
            rec.update(value=round(g.breadth_files * g.breadth_seconds / (ms / 1e3), 1),
                       ms=round(ms, 4), latency_ms=round(lat_ms, 3), launches=launches)
        else:
            fn()
            ms = None
            rec.update(value=None, ms=None, latency_ms=None,
                       note_cpu="the kernels' plain versions ran on the CPU; no device time")
        rec["roofline"] = roofline(work, ms, source, float32)
        rec.update(extra or {})
        rec["note"] = note
        return rec

    def device_kernels(self, pcm_f) -> dict:
        """bench.py:342-440: the candidate search (device analysis, then the
        search kernel) and the Rice pack of the winners, on [F, C, S] int16
        frames on the card; the pack as lossless/encoder._dispatch_chunk
        calls it (max_words and the search's sizes given)."""
        dev = self.dev
        pcm = torch.from_numpy(pcm_f).to(dev)
        F = pcm.shape[0]
        nv = torch.full((F,), RATE, dtype=torch.int32, device=dev)
        nv_lanes = nv.repeat_interleave(CHANNELS)
        max_words = lle._max_words([RATE] * F, CHANNELS)

        def dispatch():
            *search, _ = select._select_device_core(pcm, nv, KINDS, ORDERS)
            sel, k, size, res, _, _ = search
            packed = blockspread.pack_best(res, k, nv_lanes, sel == 0, max_words=max_words,
                                           size_hint=size)
            return search, packed

        search, (_, lane_bytes, lane_off) = dispatch()
        sel, k, size, res = search[:4]
        check(torch.equal(lane_bytes, size.to(torch.int64)), "device_kernels: pack size != search")
        total = int(lane_off[-1]) + ((int(lane_bytes[-1]) + 3) // 4) * 4
        lanes, nvalid, tables, _ = select.device_analysis(pcm, nv, KINDS, ORDERS)
        is_lpc = tuple(kd == "lpc" for kd in KINDS)
        works = (chip_smoke.select_work((lanes, nvalid, *tables), search, is_lpc),
                 chip_smoke.pack_work((res, k, nvalid, sel == 0), total))
        work = tuple(map(sum, zip(*works)))
        extra = {"payload_mb": round(total / 1e6, 3), "lanes": int(lanes.shape[0])}
        return self.time_device(
            "device_kernels", dispatch, ("lossless_select", "rice_pack"), work,
            "chip_smoke.select_work + chip_smoke.pack_work (the two kernels' work; the device "
            "analysis before them is not counted)",
            "lossless device analysis + candidate search (lossless_select) + Rice pack "
            "(rice_pack) at level 5's 10 candidates on device-resident [F, 2, 44100] int16 "
            "frames; CUDA events around back-to-back dispatches", extra=extra)

    def device_reconstruct(self, pcm_f) -> dict:
        """bench.py:444-463: the LPC reconstruction kernel on order-2 fixed
        lanes of the breadth clips' left channel."""
        dev, F = self.dev, pcm_f.shape[0]
        res = np.clip(np.diff(pcm_f[:, 0], prepend=0), -30000, 30000).astype(np.int32)
        args = (
            torch.from_numpy(res.reshape(-1, RATE)).to(dev),
            torch.from_numpy(np.tile(np.array([[2, -1] + [0] * 10], np.int32), (F, 1))).to(dev),
            torch.zeros(F, dtype=torch.int32, device=dev),
            torch.full((F,), 2, dtype=torch.int32, device=dev),
            torch.ones(F, dtype=torch.bool, device=dev),
        )
        out = lpc.reconstruct_best(*args)
        check(out.shape == (F, RATE) and out.dtype == torch.int32, f"reconstruct {out.shape}")
        return self.time_device(
            "device_reconstruct", lambda: lpc.reconstruct_best(*args), ("lpc_reconstruct",),
            chip_smoke.lpc_work(args), "chip_smoke.lpc_work",
            "the LPC reconstruction kernel (lpc_reconstruct) on device-resident [F, 44100] "
            "order-2 fixed lanes")

    def device_decode(self, pcm_f) -> dict:
        """bench.py:465-518 without its blockpack unpack and bit-plane PCM
        pack (they stay behind in the port): reconstruction, mid/side and the
        float32 conversion of int32 rows on the card."""
        dev, F = self.dev, pcm_f.shape[0]
        rows = np.asarray(
            np.clip(np.diff(pcm_f.reshape(-1, RATE), axis=1, prepend=0), -30000, 30000), np.int32)
        L = rows.shape[0]
        args = lld.lanes_to_device(
            rows, np.tile(np.array([[2, -1] + [0] * 10], np.int32), (L, 1)),
            np.zeros(L, np.int32), np.full(L, 2, np.int32), np.ones(L, bool), np.zeros(F, bool),
            device=dev)
        out = lld._device_decode(*args, channels=CHANNELS)
        check(out.shape == (F, RATE, CHANNELS) and out.dtype == torch.float32,
              f"device decode {out.shape}")
        # The reconstruction's work, and the float32 samples written in
        # place of its int32 ones: a sum, a halving, a select and a scale a
        # sample (mid/side is off here, but each sample is still selected).
        nbytes, ops = chip_smoke.lpc_work(args[:5])
        work = (nbytes - chip_smoke.tensor_bytes(args[0]) + chip_smoke.tensor_bytes(args[5], out),
                ops + 4 * out.numel())
        return self.time_device(
            "device_decode", lambda: lld._device_decode(*args, channels=CHANNELS),
            ("lpc_reconstruct",), work,
            "chip_smoke.lpc_work with float32 samples out, + 4 operations a sample",
            "the port's device decode step (lossless/decoder._device_decode: lpc_reconstruct, "
            "mid/side, float32) on device-resident int32 rows; bench.py's blockpack unpack and "
            "bit-plane PCM pack stay behind in the port (ROADMAP 'What stays behind'), so "
            "up_kmax is dropped")

    def device_mdct(self) -> dict:
        """bench.py:520-570: MDCT, SMR (with the temporal_mask kernel) and
        quantization of the breadth clips on the card, then the compaction of
        the nonzeros; compact_nonzeros waits for the device once (its count),
        inside the timed window. The two-phase assembly stays behind."""
        g, dev = self.geo, self.dev
        pf = [loe._file_padded(c, CHANNELS) for c in self.bclips]
        t_max = max(nh for _, nh in pf)
        stack = np.zeros((g.breadth_files * CHANNELS, (t_max + 1) * loe.HOP), np.float32)
        for i, (padded, _) in enumerate(pf):
            stack[i * CHANNELS : (i + 1) * CHANNELS, : padded.shape[1]] = padded
        stack_d = torch.from_numpy(stack).to(dev)
        thr = float(np.float32(loe.smr_threshold(QUALITY_U8_TO_F32[1])))

        def dispatch():
            q, sf = loe._encode_padded(stack_d, RATE, thr)
            entries, row_nnz = compact.compact_nonzeros(q.reshape(-1, q.shape[-1]))
            return entries, row_nnz, sf

        entries, row_nnz, sf = dispatch()
        check(int(row_nnz.sum()) == entries.numel(), "device_mdct: row counts != nonzeros")
        return self.time_device(
            "device_mdct", dispatch, ("temporal_mask",),
            mdct_work(stack_d, entries, row_nnz, sf), "bench_torch.mdct_work",
            "lossy MDCT + SMR (temporal_mask) + quantize + compact_nonzeros at quality 1 on a "
            "device-resident float32 [files*2, (T+1)*1024] signal; the two-phase assembly "
            "stays behind in the port", float32=True,
            extra={"nonzeros": entries.numel(), "coefficients": sf.shape[0] * sf.shape[1]
                   * loe.HOP})

    def device_configs(self) -> None:
        pcm_f = self.device_inputs()
        self.run("device_kernels", lambda: self.device_kernels(pcm_f))
        self.run("device_reconstruct", lambda: self.device_reconstruct(pcm_f))
        self.run("device_decode", lambda: self.device_decode(pcm_f))
        self.run("device_mdct", self.device_mdct)

    # ---- streaming -----------------------------------------------------

    def streaming(self) -> None:
        g, audio = self.geo, self.clips[0]

        def encode_all():
            se = StreamingEncoder(RATE, CHANNELS, device=self.dev)
            step = RATE // 4 * CHANNELS
            for i in range(0, len(audio), step):
                se.push_samples(audio[i : i + step])
                while se.next_frame() is not None:
                    pass
            return se.flush()

        def encode_cfg():
            encode_all()  # warm-up
            t0 = time.perf_counter()
            encode_all()
            dt = time.perf_counter() - t0
            return {"value": round(g.seconds / dt, 1), "seconds": round(dt, 4),
                    "note": f"StreamingEncoder.lpc_prune_topk={StreamingEncoder.lpc_prune_topk}; "
                            "host C++ search a frame"}

        def decode_all():
            sd = StreamingDecoder(device=self.dev)
            sd.feed(self.data_ll[0])
            ns = 0
            while (fr := sd.next_frame()) is not None:
                ns += len(fr) // CHANNELS
            return ns

        def decode_cfg():
            decode_all()  # warm-up
            t0 = time.perf_counter()
            ns = decode_all()
            dt = time.perf_counter() - t0
            check(ns == len(audio) // CHANNELS, f"streaming decode: {ns} samples")
            return {"value": round((ns / RATE) / dt, 1), "seconds": round(dt, 4)}

        self.run("streaming_encode", encode_cfg)
        self.run("streaming_decode", decode_cfg)


def run(device="cuda", geometry: Geometry = FULL, configs=CONFIGS, budget_s: float = BUDGET_S,
        emit=None) -> dict:
    """The whole benchmark; returns the result (the last two lines printed)
    with the headline's lossless files under ``"headline_lossless"`` (not
    printed). ``configs`` names the configs that run (the CPU test's
    subset); the others print nothing."""
    emit = emit or (lambda obj: print(json.dumps(obj), flush=True))
    unknown = set(configs) - set(CONFIGS)
    if unknown:
        raise ValueError(f"unknown configs {sorted(unknown)}")
    b = Bench(device, geometry, configs, budget_s, emit)
    build_s = build_everything(b.dev)
    emit({"build": {"seconds": round(build_s, 2), "cuda_kernels": b.on_card,
                    "natives": [n for n in native._SIGNATURES if native._load(n) is not None]}})
    head = b.headline(build_s)
    ok, total = corpus_bit_exact(b.dev, geometry.corpus)
    emit({"corpus_bit_exact": f"{ok}/{total}"})
    check(total > 0 and ok == total, f"corpus round trip {ok}/{total}")
    b.breadth()
    b.device_configs()
    b.streaming()
    copy_mbs = copy_probe(b.dev)
    g = geometry
    unit = "audio-sec/sec/chip" if b.on_card else "audio-sec/sec on the CPU"
    result = {
        "metric": "audio-seconds encoded+decoded/sec/chip (lossless+lossy)",
        "value": head["value"],
        "unit": unit,
        "vs_baseline": round(head["value"] / NORTH_STAR, 4),
        "headline_policy": f"best of {g.iters} passes (median alongside)",
        "value_median": head["value_median"],
        "device": device_info(b.dev),
        "copy_mbs": copy_mbs,
        "workload": (
            f"{g.files}x{g.seconds}s 44.1kHz stereo x{g.iters} iters, bulk lossless+lossy "
            "encode+decode, corpus content"
        ),
        "lossless_ratio": head["lossless_ratio"],
        "lossy_ratio": head["lossy_ratio"],
        "corpus_bit_exact": f"{ok}/{total}",
        "corpus_bit_exact_rate": ok / total,
        "setup_seconds": head["setup_seconds"],
        "build_seconds": head["build_seconds"],
        "first_pass_seconds": head["first_pass_seconds"],
        "pass_seconds": head["pass_seconds"],
        "pass_stages_seconds": head["pass_stages_seconds"],
        "peak_device_mb": head["peak_device_mb"],
        "wall_seconds": round(time.perf_counter() - b.t_start, 2),
        "configs": b.configs,
        "note": (
            "headline = real corpus content (chord_cmajor tiled, decoded by the port); "
            "synthetic_noise_l5 = near-incompressible stress config; setup_seconds = "
            "build_seconds (nvcc + g++) + first_pass_seconds + the corpus decode (imports not "
            "counted); wall_seconds = the whole run after imports; device_* configs time the "
            "hand kernels with CUDA events on device-resident inputs; copy_mbs = one 8 MiB "
            "pageable copy each way"
        ),
    }
    emit(result)
    emit({
        "summary": True,
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "value_median": result["value_median"],
        "headline_policy": result["headline_policy"],
        "device": result["device"],
        "copy_mbs": result["copy_mbs"],
        "pass_seconds": result["pass_seconds"],
        "corpus_bit_exact": result["corpus_bit_exact"],
        "wall_seconds": result["wall_seconds"],
        "skipped": [n for n, rec in b.configs.items() if "skipped" in rec],
    })
    return {**result, "headline_lossless": b.data_ll}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    ap.add_argument("--quick", action="store_true",
                    help="2 files x 2 s, one lap: every path once (tests, chip_smoke.py)")
    ap.add_argument("--budget-s", type=float, default=BUDGET_S,
                    help="wall seconds after which the remaining configs are skipped")
    args = ap.parse_args(argv)
    run(args.device, QUICK if args.quick else FULL, budget_s=args.budget_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
