#!/usr/bin/env python3
"""Smoke run of flo_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; any failure exits non-zero:
1. environment: torch/CUDA versions, the card's name and power limit, and
   whether the host CPU has AVX-512 (the C++ host natives are built with
   -march=native);
2. build: every CUDA kernel of flo_torch, from flo_torch/csrc/;
3. kernel against plain: the LPC reconstruction kernel must equal the plain
   PyTorch recurrence exactly, on the card, at [960, 44100] (the headline
   geometry) and a ragged [37, 1537]; both are timed with CUDA events;
4. corpus: every lossless file of tests/vectors/examples decodes on the card
   exactly as on the CPU, and validates;
5. main path: the corpus's stereo chord tiled to 8 clips of 60 s stereo
   44.1 kHz, each encoded with flo_torch.encode (host), then all decoded by
   one bulk decode on the card (960 lanes x 44100 samples); the round trip
   must be bit-exact and must have launched the kernel.

The line before the last prints the card's name and power limit; before it,
a JSON object with each kernel's launches, error and times; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of flo_tpu.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
EXAMPLES = ROOT / "tests" / "vectors" / "examples"
FILES, SECONDS, RATE, CHANNELS = 8, 60, 44100, 2  # bench.py's headline geometry
KERNEL_SHAPES = [(960, 44100), (37, 1537)]
DEVICE = "cuda"
INT32_MAX = (1 << 31) - 1


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def mixed_lanes(seed: int, L: int, S: int):
    """Seeded lane mix of tests/test_pallas_lpc.py (_mixed_lanes: LPC of
    random order and shift, fixed 0-4, identity, max-order LPC, with +-2**20
    spikes), plus three edge lanes at the end: coefficients all +-(2**31 - 1)
    over full-range residuals (sums that overflow int64), an LPC warm-up
    longer than the 12 taps, and a fixed ramp held past FIXED[4]."""
    from flo_torch.ops.lpc import MAX_ORDER, _FIXED_COEFFS

    rng = np.random.default_rng(seed)
    residuals = rng.integers(-3000, 3000, (L, S)).astype(np.int32)
    residuals[:, :: max(S // 5, 1)] = rng.integers(
        -(1 << 20), 1 << 20, residuals[:, :: max(S // 5, 1)].shape
    )
    coeffs = np.zeros((L, MAX_ORDER), np.int32)
    shifts = np.zeros(L, np.int32)
    orders = np.zeros(L, np.int32)
    is_fixed = np.zeros(L, bool)
    for l in range(L):
        kind = l % 4
        if kind == 0:
            o = int(rng.integers(1, 13))
            coeffs[l, :o] = rng.integers(-(1 << 14), 1 << 14, o)
            shifts[l] = rng.integers(0, 16)
            orders[l] = o
        elif kind == 1:
            o = int(rng.integers(0, 5))
            coeffs[l] = _FIXED_COEFFS[o]
            orders[l] = o
            is_fixed[l] = True
        elif kind == 3:
            coeffs[l] = rng.integers(-(1 << 15), 1 << 15, MAX_ORDER)
            shifts[l] = 15
            orders[l] = 12
    e = L - 3
    residuals[e] = rng.integers(-(1 << 31), 1 << 31, S, dtype=np.int64).astype(np.int32)
    coeffs[e] = rng.choice([-INT32_MAX, INT32_MAX], MAX_ORDER)
    shifts[e], orders[e], is_fixed[e] = 7, 12, False
    coeffs[e + 1] = rng.integers(-(1 << 14), 1 << 14, MAX_ORDER)
    shifts[e + 1], orders[e + 1], is_fixed[e + 1] = 12, 17, False
    coeffs[e + 2] = _FIXED_COEFFS[2]
    shifts[e + 2], orders[e + 2], is_fixed[e + 2] = 0, 9, True
    return residuals, coeffs, shifts, orders, is_fixed


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: torch.cuda.is_available() is False")
    gpu = gpu_line()
    cpuinfo = pathlib.Path("/proc/cpuinfo")
    avx512 = cpuinfo.is_file() and "avx512f" in cpuinfo.read_text().split()
    log(f"[1 env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    log(f"[1 env] gpu: {gpu}")
    log(f"[1 env] host cpu avx512f: {avx512}")
    return gpu


def phase_build(gpu: str) -> None:
    from flo_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[2 build] {len(libs)} CUDA librar{'y' if len(libs) == 1 else 'ies'} from "
        f"flo_torch/csrc in {time.perf_counter() - t0:.2f} s (nvcc {_build.nvcc()}) [{gpu}]")
    for p in libs:
        log(f"[2 build]   {p.relative_to(ROOT)}")


def phase_kernel(gpu: str) -> dict:
    from flo_torch.ops import cuda_lpc, lpc

    dev = torch.device(DEVICE)
    result = {}
    for L, S in KERNEL_SHAPES:
        args = [torch.from_numpy(a).to(dev) for a in mixed_lanes(L + S, L, S)]
        got = cuda_lpc.reconstruct_cuda(*args)
        want = lpc.reconstruct(*args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(got.dtype == torch.int32 and got.shape == (L, S), f"kernel output {got.shape}")
        check(torch.equal(got, want), f"kernel != plain at [{L}, {S}]: max abs err {err}")
        log(f"[3 kernel] lpc_reconstruct == plain at [{L}, {S}] (exact, max abs err {err})")
        if (L, S) != KERNEL_SHAPES[0]:
            continue
        # Times at the main path's shape, each after a warm-up.
        cuda_lpc.reconstruct_cuda(*args)
        ms = time_ms(lambda: cuda_lpc.reconstruct_cuda(*args), 20)
        res_t = args[0].t().contiguous()
        out_t = torch.empty_like(res_t)
        launch = cuda_lpc._kernel()
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (res_t, args[1], args[2], args[3], args[4], out_t)]
        kernel_ms = time_ms(lambda: launch(*ptrs, L, S, stream), 20)
        torch.cuda.synchronize()
        check(torch.equal(out_t.t(), want), "bare kernel launch disagrees with plain")
        lpc.reconstruct(*[a[:, :64] if a.dim() == 2 else a for a in args])  # warm-up
        plain_ms = time_ms(lambda: lpc.reconstruct(*args), 1)
        log(f"[3 kernel] [{L}, {S}] reconstruct_cuda {ms:.4f} ms (kernel alone "
            f"{kernel_ms:.4f} ms, the rest is the time-major copies), plain PyTorch "
            f"{plain_ms:.1f} ms [{gpu}]")
        result = {"max_abs_err": err, "ms": ms, "kernel_only_ms": kernel_ms, "plain_ms": plain_ms}
    return result


def phase_corpus(gpu: str) -> None:
    import flo_torch
    from flo_torch._flo_host.container import reader

    names = []
    for p in sorted(EXAMPLES.glob("*.flo")):
        data = p.read_bytes()
        if any(f.frame_type == 253 for f in reader.read(data).frames):
            continue  # lossy (Transform frames): not ported yet
        on_card = flo_torch.decode(data, device=DEVICE)
        on_cpu = flo_torch.decode(data, device="cpu")
        check(np.array_equal(on_card, on_cpu), f"{p.name}: card decode != CPU decode")
        check(flo_torch.validate(data), f"{p.name}: validate is False")
        names.append(p.name)
    check(len(names) == 11, f"expected 11 lossless corpus files, found {len(names)}")
    log(f"[4 corpus] {len(names)} lossless files decoded on the card == CPU decode, "
        f"all validate [{gpu}]")


def headline_clips():
    """bench.py's headline workload, rebuilt with the port: the stereo chord
    decoded, tiled to SECONDS and rolled by one second per clip."""
    import flo_torch

    base = flo_torch.decode((EXAMPLES / "chord_cmajor_stereo.flo").read_bytes(), device=DEVICE)
    need = SECONDS * RATE * CHANNELS
    tiled = np.tile(base, -(-need // len(base)))[:need]
    return [np.roll(tiled, i * CHANNELS * RATE) for i in range(FILES)]


def phase_main_path(gpu: str) -> int:
    import flo_torch
    from flo_torch._flo_host.container import reader
    from flo_torch.core import convert
    from flo_torch.lossless import decoder
    from flo_torch.ops import cuda_lpc

    clips = headline_clips()
    t0 = time.perf_counter()
    encoded = [flo_torch.encode(c, RATE, CHANNELS) for c in clips]
    enc_s = time.perf_counter() - t0
    audio_s = FILES * SECONDS

    torch.cuda.synchronize()
    cuda_lpc.LAUNCHES = 0
    t0 = time.perf_counter()
    outs = decoder.decode_many([reader.read(b) for b in encoded], device=DEVICE)
    dec_s = time.perf_counter() - t0
    launches = cuda_lpc.LAUNCHES

    check(launches > 0, "the main path never launched the LPC kernel")
    for i, (clip, out) in enumerate(zip(clips, outs)):
        want = convert.i32_to_f32(convert.f32_to_i32(torch.from_numpy(clip))).numpy()
        check(out.shape == want.shape and np.isfinite(out).all(), f"clip {i}: shape/finite")
        check(np.array_equal(out, want), f"clip {i}: round trip not bit-exact")
    flos = [reader.read(b) for b in encoded]
    marshaled = [(i, decoder._marshal_lanes(f)) for i, f in enumerate(flos)]
    lanes = decoder.lanes_to_device(*decoder._concat_group(marshaled), device=DEVICE)
    L, S = lanes[0].shape
    check((L, S) == (FILES * SECONDS * CHANNELS, RATE), f"main path lanes [{L}, {S}]")
    kernel_ms = time_ms(lambda: cuda_lpc.reconstruct_cuda(*lanes[:5]), 10)

    mb = sum(len(b) for b in encoded) / 1e6
    log(f"[5 main] {FILES} x {SECONDS} s stereo {RATE} Hz: {L} lanes x {S} samples, "
        f"encoded {mb:.1f} MB; round trip bit-exact; kernel launches {launches}")
    log(f"[5 main] encode (host) {enc_s:.3f} s = {audio_s / enc_s:.1f}x realtime [{gpu}]")
    log(f"[5 main] decode (parse + device + host) {dec_s:.3f} s = "
        f"{audio_s / dec_s:.1f}x realtime; reconstruct_cuda {kernel_ms:.4f} ms = "
        f"{100 * kernel_ms / 1e3 / dec_s:.3f}% of the decode [{gpu}]")
    log(f"[5 main] decode breakdown: {decode_breakdown(encoded, gpu)}")
    return launches


def decode_breakdown(encoded, gpu: str) -> str:
    """The bulk decode's stages, each timed to its end on the host clock."""
    from flo_torch._flo_host.container import reader
    from flo_torch.lossless import decoder

    stamps = [time.perf_counter()]
    flos = [reader.read(b) for b in encoded]
    stamps.append(time.perf_counter())
    marshaled = [(i, decoder._marshal_lanes(f)) for i, f in enumerate(flos)]
    group = decoder._concat_group(marshaled)
    stamps.append(time.perf_counter())
    lanes = decoder.lanes_to_device(*group, device=DEVICE)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    fsc = decoder._device_decode(*lanes, channels=CHANNELS)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    host = fsc.cpu().numpy()
    stamps.append(time.perf_counter())
    f0 = 0
    for _, m in marshaled:
        np.concatenate([host[f0 + k, :n].reshape(-1) for k, n in enumerate(m[7])])
        f0 += len(m[7])
    stamps.append(time.perf_counter())
    names = ["parse", "marshal+rice", "upload", "device", "download", "trim"]
    parts = [f"{n} {1e3 * (b - a):.1f} ms" for n, a, b in zip(names, stamps, stamps[1:])]
    return ", ".join(parts) + f" [{gpu}]"


def main() -> int:
    gpu = phase_environment()
    sys.path.insert(0, str(ROOT))
    import flo_torch  # noqa: F401  (fails where the repository is absent)

    phase_build(gpu)
    kernel = phase_kernel(gpu)
    phase_corpus(gpu)
    launches = phase_main_path(gpu)
    log(json.dumps({"kernels": [{
        "name": "lpc_reconstruct",
        "route": "cuda",
        "source": "flo_torch/csrc/lpc_reconstruct.cu",
        "replaces": "flo_tpu/ops/pallas_lpc.py:52",
        "launches": launches,
        **kernel,
    }]}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
