#!/usr/bin/env python3
"""Smoke run of flo_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; any failure exits non-zero:
1. environment: torch/CUDA versions, the card's name and power limit, and
   whether the host CPU has AVX-512 (the C++ host natives are built with
   -march=native);
2. build: every CUDA kernel of flo_torch, from flo_torch/csrc/ (one nvcc per
   source, all started together);
3. kernels against plain, on the card, each timed with CUDA events beside
   its plain PyTorch version; every output must be equal (exact):
   - LPC reconstruction at [960, 44100] (the headline geometry) and a
     ragged [37, 1537];
   - candidate search at [960, 44100] with tables from the headline clips
     (level 5, analysis="exact"), and at a ragged [37, 1537] at level 8 (14
     candidates) with ragged nvalid;
   - Rice pack at [960, 44100] from that search's output, and on a ragged
     case with 256-271-bit codes, raw lanes and empty lanes;
4. corpus: every lossless file of tests/vectors/examples decodes on the card
   exactly as on the CPU and validates, and the 9 recoverable ones re-encode
   on the card (integer samples, compat="reference-bugs") byte-identical;
5. main path: the corpus's stereo chord tiled to 8 clips of 60 s stereo
   44.1 kHz, bulk-encoded on the card (encode_many, analysis="device": 960
   lanes x 44100 samples through the search and pack kernels), then
   bulk-decoded on the card (the LPC kernel); the round trip must be
   bit-exact and must have launched all three kernels. The same clips with
   analysis="exact" must give the host C++ encode's bytes. Realtime factors
   (of the first call and of a second, warm one) and per-stage breakdowns
   are printed.

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


def ragged_lanes(seed: int, L: int, S: int):
    """Seeded lanes of five kinds (a tone with noise, loud noise, a near-
    constant signal, a square wave at the int16 rails, a random walk past
    them, as a mid channel reaches) and ragged lengths, including 0 and 5."""
    rng = np.random.default_rng(seed)
    t = np.arange(S)
    lanes = np.zeros((L, S), np.int32)
    for l in range(L):
        kind = l % 5
        if kind == 0:
            x = 12000 * np.sin(2 * np.pi * (50 + 13 * l) * t / 8000) + rng.normal(0, 30, S)
        elif kind == 1:
            x = rng.normal(0, 8000, S)
        elif kind == 2:
            x = rng.integers(-2, 3, S)
        elif kind == 3:
            x = 30000 * np.sign(np.sin(t / 7.0))
        else:
            x = np.cumsum(rng.normal(0, 200, S)).clip(-60000, 60000)
        lanes[l] = np.asarray(x).astype(np.int32)
    nvalid = rng.integers(0, S + 1, L).astype(np.int32)
    nvalid[:3] = [S, 0, 5]
    return lanes, nvalid


def ragged_pack_case(seed: int, L: int, S: int):
    """Residual rows for the pack: small residuals at every k, k = 0 lanes
    of full-range and of +-2**20 residuals and a k = 15 lane of +-2**30 ones
    (codes of 256-271 bits), raw lanes with values past int16 (the LE16
    wrap), an empty lane and a lane ending mid-word."""
    rng = np.random.default_rng(seed)
    res = rng.integers(-3000, 3000, (L, S)).astype(np.int32)
    k = rng.integers(0, 16, L).astype(np.int32)
    nvalid = rng.integers(0, S + 1, L).astype(np.int32)
    is_raw = np.zeros(L, bool)
    res[2] = rng.integers(-(1 << 31), 1 << 31, S, dtype=np.int64).astype(np.int32)
    res[3] = -(1 << 31)
    res[4, ::3] = rng.integers(-(1 << 20), 1 << 20, len(res[4, ::3]))
    k[2:5] = 0
    res[10] = rng.choice([-(1 << 30), 1 << 30], S)
    k[10] = 15
    is_raw[[5, 9]] = True
    res[5] = rng.integers(-70000, 70000, S)
    nvalid[[2, 3, 4, 5, 6, 7, 8, 10]] = [S, S, S, S, 0, 37, S, S]
    return res, k, nvalid, is_raw


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


def phase_kernel_lpc(gpu: str) -> dict:
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


def equal_outputs(got, want, what: str) -> int:
    """Check tensors pairwise equal; returns the max abs error (0)."""
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{what} output {i}: {g.shape} {w.shape}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    check(err == 0, f"{what}: kernel != plain, max abs err {err}")
    return err


def headline_search_inputs(clips):
    """The candidate search's inputs at the headline geometry: the clips'
    lanes in the mid/side domain with the exact host analysis's tables
    (level 5), on the card."""
    from flo_torch.lossless import encoder
    from flo_torch.ops import select

    kinds, orders, _ = encoder._candidate_plan(5)
    lanes_np, nvalid_f, _, _ = encoder._marshal(clips, CHANNELS, RATE)
    mid_side, tables = encoder.host_analysis(lanes_np, nvalid_f, CHANNELS, kinds, orders)
    pcm, nv = encoder.pcm_to_device(lanes_np, nvalid_f, CHANNELS, device=DEVICE)
    lanes = select._lanes_from_pcm16(pcm, torch.from_numpy(mid_side).to(DEVICE))
    args = (lanes, nv.repeat_interleave(CHANNELS), *encoder.tables_to_device(*tables, device=DEVICE))
    return args, tuple(kd == "lpc" for kd in kinds)


def phase_kernel_select(gpu: str, clips):
    from flo_torch.lossless import encoder
    from flo_torch.ops import cuda_select, select

    args, is_lpc = headline_search_inputs(clips)
    L, S = args[0].shape
    check((L, S) == (FILES * SECONDS * CHANNELS, RATE), f"search lanes [{L}, {S}]")
    got = cuda_select.encode_select_cuda(*args, is_lpc)
    want = select.encode_select_step(*args, is_lpc)
    torch.cuda.synchronize()
    err = equal_outputs(got, want, f"lossless_select [{L}, {S}]")
    ms = time_ms(lambda: cuda_select.encode_select_cuda(*args, is_lpc), 20)
    plain_ms = time_ms(lambda: select.encode_select_step(*args, is_lpc), 2)
    wins = np.bincount(got[0].cpu().numpy(), minlength=len(is_lpc)).tolist()
    log(f"[3 kernel] lossless_select == plain at [{L}, {S}], level 5, {len(is_lpc)} candidates "
        f"(exact; winners by candidate {wins}): kernel {ms:.4f} ms, plain PyTorch "
        f"{plain_ms:.1f} ms [{gpu}]")

    kinds, orders, _ = encoder._candidate_plan(8)
    lanes_np, nvalid_np = ragged_lanes(7, 37, 1537)
    _, tables = encoder.host_analysis(lanes_np, nvalid_np.astype(np.int64), 1, kinds, orders)
    rargs = (torch.from_numpy(lanes_np).to(DEVICE), torch.from_numpy(nvalid_np).to(DEVICE),
             *encoder.tables_to_device(*tables, device=DEVICE))
    r_lpc = tuple(kd == "lpc" for kd in kinds)
    equal_outputs(cuda_select.encode_select_cuda(*rargs, r_lpc),
                  select.encode_select_step(*rargs, r_lpc), "lossless_select [37, 1537]")
    log(f"[3 kernel] lossless_select == plain at a ragged [37, 1537], level 8, "
        f"{len(kinds)} candidates (exact)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}, (got, args[1])


def phase_kernel_pack(gpu: str, search) -> dict:
    from flo_torch.ops import blockspread, cuda_ricepack

    (sel, k, size, residuals, _, _), nvalid = search
    L, S = residuals.shape
    pargs = (residuals, k, nvalid, sel == 0)
    got = cuda_ricepack.pack_lanes_cuda(*pargs)
    want = blockspread.pack_lanes_words(*pargs)
    torch.cuda.synchronize()
    err = equal_outputs(got, want, f"rice_pack [{L}, {S}]")
    check(torch.equal(got[1], size.to(torch.int64)), "rice_pack lane bytes != search sizes")
    ms = time_ms(lambda: cuda_ricepack.pack_lanes_cuda(*pargs), 20)
    plain_ms = time_ms(lambda: blockspread.pack_lanes_words(*pargs), 2)
    log(f"[3 kernel] rice_pack == plain at [{L}, {S}] ({got[0].numel() / 1e6:.2f} MB packed; "
        f"exact): kernel {ms:.4f} ms (with its word-count wait), plain PyTorch "
        f"{plain_ms:.1f} ms [{gpu}]")

    rargs = [torch.from_numpy(a).to(DEVICE) for a in ragged_pack_case(11, 37, 1537)]
    rgot = cuda_ricepack.pack_lanes_cuda(*rargs)
    equal_outputs(rgot, blockspread.pack_lanes_words(*rargs), "rice_pack ragged [37, 1537]")
    longest = int(blockspread.code_fields(*rargs)[0].max())
    check(longest == 271, f"ragged pack case's longest code is {longest} bits")
    log(f"[3 kernel] rice_pack == plain on a ragged [37, 1537] with codes up to {longest} bits, "
        "raw lanes with the int16 wrap and empty lanes (exact)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


#: Lossless corpus files whose encoder input the reference generator's own
#: Raw-frame defect destroyed (tests/test_compat.py): not re-encodable.
UNRECOVERABLE = {"silence_1sec.flo", "white_noise.flo"}


def phase_corpus(gpu: str) -> None:
    import flo_torch
    from flo_torch._flo_host.container import reader
    from flo_torch.lossless import decoder, encoder

    names, reencoded = [], []
    for p in sorted(EXAMPLES.glob("*.flo")):
        data = p.read_bytes()
        flo = reader.read(data)
        if any(f.frame_type == 253 for f in flo.frames):
            continue  # lossy (Transform frames): not ported yet
        on_card = flo_torch.decode(data, device=DEVICE)
        on_cpu = flo_torch.decode(data, device="cpu")
        check(np.array_equal(on_card, on_cpu), f"{p.name}: card decode != CPU decode")
        check(flo_torch.validate(data), f"{p.name}: validate is False")
        names.append(p.name)
        if p.name in UNRECOVERABLE:
            continue
        h = flo.header
        ints = decoder.decode_file_i32(flo, device=DEVICE)
        again = encoder.encode(
            ints.reshape(-1), h.sample_rate, h.channels, h.bit_depth, h.compression_level,
            flo.metadata, compat="reference-bugs", device=DEVICE,
        )
        check(again == data, f"{p.name}: re-encode on the card is not byte-identical")
        reencoded.append(p.name)
    check(len(names) == 11, f"expected 11 lossless corpus files, found {len(names)}")
    check(len(reencoded) == 9, f"expected 9 re-encodable files, found {len(reencoded)}")
    log(f"[4 corpus] {len(names)} lossless files decoded on the card == CPU decode, "
        f"all validate; {len(reencoded)} re-encoded on the card (compat=\"reference-bugs\") "
        f"byte-identical [{gpu}]")


def headline_clips():
    """bench.py's headline workload, rebuilt with the port: the stereo chord
    decoded, tiled to SECONDS and rolled by one second per clip."""
    import flo_torch

    base = flo_torch.decode((EXAMPLES / "chord_cmajor_stereo.flo").read_bytes(), device=DEVICE)
    need = SECONDS * RATE * CHANNELS
    tiled = np.tile(base, -(-need // len(base)))[:need]
    return [np.roll(tiled, i * CHANNELS * RATE) for i in range(FILES)]


def kernel_modules():
    from flo_torch.ops import cuda_lpc, cuda_ricepack, cuda_select

    return {"lpc_reconstruct": cuda_lpc, "lossless_select": cuda_select,
            "rice_pack": cuda_ricepack}


def phase_main_path(gpu: str, clips) -> dict:
    """bench.py's headline lossless pass (bench.py:166): bulk encode on the
    card, then bulk decode on the card. Returns each kernel's launches in
    that run."""
    from flo_torch._flo_host.container import reader
    from flo_torch.core import convert
    from flo_torch.lossless import decoder, encoder
    from flo_torch.ops import cuda_lpc

    audio_s = FILES * SECONDS
    mods = kernel_modules()
    torch.cuda.synchronize()
    for m in mods.values():
        m.LAUNCHES = 0
    t0 = time.perf_counter()
    encoded = encoder.encode_many(clips, RATE, CHANNELS, 16, 5, device=DEVICE)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = decoder.decode_many([reader.read(b) for b in encoded], device=DEVICE)
    dec_s = time.perf_counter() - t0
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
    for i, (clip, out) in enumerate(zip(clips, outs)):
        want = convert.i32_to_f32(convert.f32_to_i32(torch.from_numpy(clip))).numpy()
        check(out.shape == want.shape and np.isfinite(out).all(), f"clip {i}: shape/finite")
        check(np.array_equal(out, want), f"clip {i}: round trip not bit-exact")

    # The same two calls again: the first ones pay the process's first use
    # of the analysis ops and allocator growth at this geometry.
    t0 = time.perf_counter()
    again = encoder.encode_many(clips, RATE, CHANNELS, 16, 5, device=DEVICE)
    enc2_s = time.perf_counter() - t0
    check(again == encoded, "a second encode_many gives other bytes")
    t0 = time.perf_counter()
    decoder.decode_many([reader.read(b) for b in encoded], device=DEVICE)
    dec2_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    exact = encoder.encode_many(clips, RATE, CHANNELS, 16, 5, analysis="exact", device=DEVICE)
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [encoder.encode(c, RATE, CHANNELS, 16, 5) for c in clips]
    host_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(exact, host)):
        check(a == b, f"clip {i}: analysis=\"exact\" bulk bytes != host C++ encode")
    dev_mb, exact_mb = sum(map(len, encoded)) / 1e6, sum(map(len, exact)) / 1e6
    check(abs(dev_mb - exact_mb) <= 0.02 * exact_mb, "device analysis sizes drift past 2%")

    flos = [reader.read(b) for b in encoded]
    marshaled = [(i, decoder._marshal_lanes(f)) for i, f in enumerate(flos)]
    lanes = decoder.lanes_to_device(*decoder._concat_group(marshaled), device=DEVICE)
    L, S = lanes[0].shape
    check((L, S) == (FILES * SECONDS * CHANNELS, RATE), f"main path lanes [{L}, {S}]")
    kernel_ms = time_ms(lambda: cuda_lpc.reconstruct_cuda(*lanes[:5]), 10)

    log(f"[5 main] {FILES} x {SECONDS} s stereo {RATE} Hz: {L} lanes x {S} samples; "
        f"encode_many (analysis=device) {dev_mb:.3f} MB, analysis=exact {exact_mb:.3f} MB "
        f"(== host C++ bytes); round trip bit-exact; launches {launches}")
    log(f"[5 main] encode_many on the card (analysis=device) {enc_s:.3f} s = "
        f"{audio_s / enc_s:.1f}x realtime (second call {enc2_s:.3f} s = "
        f"{audio_s / enc2_s:.1f}x); analysis=exact {exact_s:.3f} s = "
        f"{audio_s / exact_s:.1f}x; host C++ encode {host_s:.3f} s = "
        f"{audio_s / host_s:.1f}x [{gpu}]")
    log(f"[5 main] decode_many on the card {dec_s:.3f} s = {audio_s / dec_s:.1f}x realtime "
        f"(second call {dec2_s:.3f} s = {audio_s / dec2_s:.1f}x); reconstruct_cuda "
        f"{kernel_ms:.4f} ms = {100 * kernel_ms / 1e3 / dec2_s:.3f}% of the second decode [{gpu}]")
    log(f"[5 main] encode breakdown (analysis=device): {encode_breakdown(clips, encoded, gpu)}")
    log(f"[5 main] decode breakdown: {decode_breakdown(encoded, gpu)}")
    return launches


def encode_breakdown(clips, encoded, gpu: str) -> str:
    """The bulk encode's stages, each synchronised and timed to its end on
    the host clock, summed over the chunks; the bytes must be encoded's."""
    from flo_torch._flo_host.container import writer
    from flo_torch.lossless import encoder
    from flo_torch.ops import blockspread, select

    kinds, orders, max_order = encoder._candidate_plan(5)
    is_lpc = tuple(kd == "lpc" for kd in kinds)
    names = ["marshal", "upload", "analysis", "select", "pack", "download", "assembly+writer"]
    stages = dict.fromkeys(names, 0.0)
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] += now - last[0]
        last[0] = now

    lanes, nvalid_f, all_frames, slots = encoder._marshal(clips, CHANNELS, RATE)
    lap("marshal")
    frames = []
    for lo, hi in encoder._chunk_bounds(len(nvalid_f), lanes.size):
        fs = nvalid_f[lo:hi]
        pcm, nv = encoder.pcm_to_device(lanes[lo * CHANNELS : hi * CHANNELS], fs, CHANNELS,
                                        device=DEVICE)
        lap("upload")
        lanes_d, nvalid, tables, mid_side = select.device_analysis(pcm, nv, kinds, orders)
        lap("analysis")
        sel, k, size, res, win_c, win_s = select.encode_select_best(lanes_d, nvalid, *tables,
                                                                    is_lpc)
        lap("select")
        packed = blockspread.pack_best(res, k, nvalid, sel == 0,
                                       max_words=encoder._max_words(fs, CHANNELS))
        lap("pack")
        host = encoder._download_chunk(
            {"out": (sel, k, size, *packed, win_c, win_s), "mid_side": mid_side,
             "frame_samples": fs}, CHANNELS)
        lap("download")
        frames.extend(encoder._assemble_frames(host, CHANNELS, kinds, orders, max_order))
        lap("assembly+writer")
    for (fidx, fi), frame in zip(slots, frames):
        all_frames[fidx][fi] = frame
    out = [writer.write(RATE, CHANNELS, 16, 5, f, b"") for f in all_frames]
    lap("assembly+writer")
    check(out == encoded, "the staged encode's bytes differ from encode_many's")
    parts = [f"{n} {1e3 * v:.1f} ms" for n, v in stages.items()]
    return ", ".join(parts) + f" (total {1e3 * sum(stages.values()):.1f} ms) [{gpu}]"


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


KERNELS = {
    "lpc_reconstruct": ("flo_torch/csrc/lpc_reconstruct.cu", "flo_tpu/ops/pallas_lpc.py:52"),
    "lossless_select": ("flo_torch/csrc/lossless_select.cu", "flo_tpu/ops/select.py:187"),
    "rice_pack": ("flo_torch/csrc/rice_pack.cu", "flo_tpu/ops/blockspread.py:647"),
}


def main() -> int:
    gpu = phase_environment()
    sys.path.insert(0, str(ROOT))
    import flo_torch  # noqa: F401  (fails where the repository is absent)

    phase_build(gpu)
    measured = {"lpc_reconstruct": phase_kernel_lpc(gpu)}
    clips = headline_clips()
    measured["lossless_select"], search = phase_kernel_select(gpu, clips)
    measured["rice_pack"] = phase_kernel_pack(gpu, search)
    del search
    phase_corpus(gpu)
    launches = phase_main_path(gpu, clips)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **measured[name]}
        for name, (src, rep) in KERNELS.items()
    ]}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
