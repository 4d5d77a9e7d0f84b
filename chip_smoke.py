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
   its plain PyTorch version and its bound; every output must be equal
   (exact):
   - LPC reconstruction at [960, 44100] (the headline geometry) and a
     ragged [37, 1537], and every lane class interleaved lane by lane at
     S = 1, 11, 12, 13 and past two tiles (the kernel's class prologue must
     group the lanes as the plain grouping does);
   - candidate search at [960, 44100] with tables from the headline clips
     (level 5, analysis="exact"), and at ragged [37, 1537] and [37, 13] for
     every candidate plan (levels 0, 1, 2, 4, 5, 7, 8) with lanes off the
     plan and ragged nvalid;
   - Rice pack at [960, 44100] from that search's output (timed with its
     word-count wait, with max_words, and with max_words and the search's
     sizes given, as the main path calls it), on a ragged case with
     256-271-bit codes, raw lanes and empty lanes, and on the shapes its
     tiles are sensitive to (lanes around a tile's length, a lane of 44,100
     271-bit codes, only raw lanes, only empty lanes, one sample, lanes
     ending on and one bit past a word boundary), each also with a wrong
     size and with a buffer shorter than the stream;
   - temporal-masking scan at [16, 2585, 25] (the headline's lanes and hops),
     at [8, 2585, 25] (a chunk, as the main path calls it), [960, 44, 25],
     [1, 1, 25], [3, 7, 25], with no hop and with no lane, on an input with
     NaN and +-inf, through the dispatcher on a tensor with two leading
     axes, and on every case of ``cuda_psycho.scan_cases`` (hop counts around
     a fact block and a chunk, 1 to 33 lanes, a loud hop then silence, NaN in
     the first, a middle and the last chunk, infinities, denormals, -0.0):
     the same bits as the plain loop, zero signs included; timed as called
     from Python and on the card alone (a CUDA graph of 20 calls);
4. corpus: every lossless file of tests/vectors/examples decodes on the card
   exactly as on the CPU and validates, and the 9 recoverable ones re-encode
   on the card (integer samples, compat="reference-bugs") byte-identical;
   every lossy file decodes on the card within one i16 step of the CPU
   decode, with its length, and the five chord presets keep their SNR
   floors against the lossless chord;
5. main paths: the corpus's stereo chord tiled to 8 clips of 60 s stereo
   44.1 kHz.
   - Lossless: bulk-encoded on the card (encode_many, analysis="device": 960
     lanes x 44100 samples through the search and pack kernels), then
     bulk-decoded on the card (the LPC kernel); the round trip must be
     bit-exact and must have launched all three kernels. The same clips with
     analysis="exact" must give the host C++ encode's bytes.
   - Lossy: batch.encode_lossy_many at quality 1 with the "packed"
     transport (blocks [16, 2585, 2048] through MDCT, SMR with the
     temporal-masking kernel, quantization and compaction), then
     batch.decode_many. Every file validates and is marked lossy, lengths
     are right, the SNR against the input is above the medium floor (30 dB),
     one clip's CPU encode has the same size (1%) and SNR (0.1 dB), the
     card's decode is within one i16 step of the CPU decode of the same
     bytes, the scan kernel was launched and its plain loop never ran on
     the card.
   Realtime factors (of the first call and of a second, warm one),
   per-stage breakdowns, the compression ratio and the lossy path's peak
   device memory are printed;
6. the rest of the public API on one 60 s stereo 44.1 kHz clip, lossless at
   level 5 and lossy at quality 1: (a) StreamingEncoder fed 4,096 samples at
   a time gives the CPU run's bytes, and StreamingDecoder fed 64 KB at a
   time gives decode's samples; (b) the lossy file streamed frame by frame,
   its IMDCT on the card, within one i16 step of decode, frame count and
   pre-roll as on the CPU; (c) seek_to_time at 0, 1, 29,999 and 59,999 ms
   and decode_frame_at on the first, a middle and the last frame of both
   files against the whole decode's slices; (d) reflo.encode_from_audio of
   the clip as a WAV, lossless and lossy, then reflo.decode_to_wav: the
   reconstruction and the scan kernels launched, lossless bit-exact, lossy
   above the medium SNR floor; (e) one lossless and one lossy corpus file
   streamed and sought on the card as on the CPU; (f) get_metadata,
   update_metadata and strip_metadata leave validate true and the DATA
   chunk's bytes as they were. Wall times of (a)-(d) are printed;
7. the CLI, the HTTP service and lane sharding on phase 5's clips, the
   counters set to 0 before and read after, no plain version on the card:
   (a) the CLI in-process (``flo_torch.cli.main``, ``--device cuda``):
   encode of clip 0 as a WAV, decode (bit-exact; the DATA chunk is
   ``reflo.encode_from_audio``'s), a lossy encode at ``--quality high`` and
   its decode (above the medium SNR floor), ``info -m``, ``metadata
   --json``, ``analysis -w -s --json``, ``validate``, then ``python3 -m
   flo_torch info`` in a subprocess; (b) ``service.make_server(...,
   device="cuda")`` on a thread: /v1/encode -> /v1/decode of the clip's
   21 MB of float32 bit-exact, /v1/encode_transform -> /v1/decode within one
   i16 step of ``flo_torch.decode``, /v1/decode_frame, /v1/seek and
   /v1/analysis as the library, an encoder session of 4,096-sample pushes
   (== ``StreamingEncoder``'s bytes) and a decoder session fed 64 KB a piece
   (== ``decode``), /demo and /v1/version; (c) ``encode_many`` of the 8
   clips over ``device_mesh()`` and over two shards of cuda:0 (== phase 5's
   bytes; search and pack launched once a shard and chunk), ``decode_many``
   over both (bit-exact), the lossy encode and decode over two shards
   (within 1.5 i16 steps of unsharded), ``graft_entry.entry()`` on the card,
   ``dryrun_multichip(1)`` and ``dryrun_multichip(2, [cuda:0, cuda:0])``.
   Every request's and command's wall time is printed.
8. bench_torch.py's quick geometry (2 files x 2 s) in-process on the card,
   the counters set to 0 before and read after, no plain version on the
   card: the headline pass and all 21 configs once, every printed line
   parsed, every gate held (lossless round trips, the quick corpus round
   trip on its three files, the mesh equal to unsharded, each device
   config's kernels launched), every kernel launched in the phase.

The line before the last prints the card's name and power limit; before it,
a JSON object with each kernel's launches (in its main path's run, in
phase 6, in phase 7 and in phase 8), error,
times, bound (the larger of its bytes over the HBM rate and its operations
over the ALU rate for their type, from this run's inputs) and share of the
bound; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of flo_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
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


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds of fn(): ``launches`` calls captured into one
    CUDA graph and replayed, so the host's time to launch a call is not in it
    (a kernel of a few microseconds is otherwise timed at the rate Python can
    launch it). fn must launch on PyTorch's current stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # built and warm before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return time_ms(graph.replay, replays) / launches


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


def lpc_case(seed: int, L: int, S: int, mix=mixed_lanes):
    return [torch.from_numpy(a).to(DEVICE) for a in mix(seed, L, S)]


def phase_kernel_lpc(gpu: str) -> dict:
    from flo_torch.ops import cuda_lpc, lpc

    # The mixed lanes at the headline shape and a ragged one, then every
    # class interleaved lane by lane at lengths around the 12 taps and past
    # a tile.
    cases = [(mixed_lanes, L, S) for L, S in KERNEL_SHAPES]
    cases += [(cuda_lpc.class_mix_lanes, 64, S) for S in (1, 11, 12, 13, 2 * cuda_lpc.TILE + 37)]
    result = {}
    for mix, L, S in cases:
        args = lpc_case(L + S, L, S, mix)
        got = cuda_lpc.reconstruct_cuda(*args)
        want = lpc.reconstruct(*args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(got.dtype == torch.int32 and got.shape == (L, S), f"kernel output {got.shape}")
        check(torch.equal(got, want), f"kernel != plain at {mix.__name__} [{L}, {S}]: max abs err {err}")
        log(f"[3 kernel] lpc_reconstruct == plain on {mix.__name__} [{L}, {S}] (exact, max abs err {err})")
        if mix is cuda_lpc.class_mix_lanes:
            check_classes(args)
        if (mix, L, S) != (mixed_lanes, *KERNEL_SHAPES[0]):
            continue
        # Times at the headline shape, each after a warm-up.
        cuda_lpc.reconstruct_cuda(*args)
        ms = time_ms(lambda: cuda_lpc.reconstruct_cuda(*args), 20)
        lpc.reconstruct(*[a[:, :64] if a.dim() == 2 else a for a in args])  # warm-up
        plain_ms = time_ms(lambda: lpc.reconstruct(*args), 1)
        bound_ms, bound_by = lpc_bound(args)
        log(f"[3 kernel] [{L}, {S}] reconstruct_cuda {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}), plain PyTorch {plain_ms:.1f} ms [{gpu}]")
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
    return result


def check_classes(args) -> None:
    """The kernel's prologue on the card against the plain lane grouping:
    the same class counts and the same lanes in each class."""
    from flo_torch.ops import cuda_lpc

    idx, counts = cuda_lpc.classify_cuda(*args[1:])
    want_idx, want_counts = cuda_lpc.group_lanes(cuda_lpc.lane_classes(*args[1:]))
    check(counts.tolist() == want_counts.tolist(), f"lane classes {counts.tolist()} != "
          f"plain {want_counts.tolist()}")
    bounds = np.cumsum([0] + want_counts.tolist())
    for c, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        check(sorted(idx[lo:hi].tolist()) == sorted(want_idx[lo:hi].tolist()),
              f"class {c}: the prologue's lanes differ from the plain grouping")


# Bounds: the least time the card could take for a kernel's work, the larger
# of its bytes (each input read once, each output written once) over the
# HBM rate and its integer operations over the int32 ALU rate (132 SMs x 64
# lanes x 1.98 GHz, a multiply-add counted as one operation; the data
# sheet's table has no integer rate outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, the data sheet's rate


def bound(nbytes: float, ops: float, ops_per_s: float = INT_OPS_PER_S):
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def lpc_work(args):
    """Reconstruction's (bytes, operations): residuals and tables in,
    samples out; a sample takes its lane's taps (a cascade lane one add an
    order) and a shift and an add."""
    from flo_torch.ops import cuda_lpc

    res = args[0]
    classes = cuda_lpc.lane_classes(*args[1:])
    taps = torch.where(classes < cuda_lpc.CASCADE_CLASSES, classes + 1,
                       2 * (classes - cuda_lpc.CASCADE_CLASSES))
    ops = res.shape[1] * int((taps + 2).sum())
    return tensor_bytes(*args) + tensor_bytes(res), ops


def lpc_bound(args):
    return bound(*lpc_work(args))


#: Integer operations a candidate's statistics take a sample: pass 1 |r|,
#: max and sum; pass 2 the zigzag (2), the shift by k, the min and the sum.
STAT_OPS = 8


def select_work(args, outs, is_lpc):
    """Candidate search's (bytes, operations): the lanes and tables in, the
    six outputs out; a valid sample takes every LPC candidate's taps and its
    shift and subtract, a difference per fixed order past 0, and every
    candidate's statistics (this run's valid samples, not the padded rows)."""
    orders = args[4][0].tolist()
    nfix = sum(1 for f, o in zip(is_lpc, orders) if not f) - 1
    lpc_taps = sum(o for f, o in zip(is_lpc, orders) if f)
    per_sample = lpc_taps + 2 * sum(is_lpc) + max(nfix - 1, 0) + STAT_OPS * (len(is_lpc) - 1)
    ops = int(args[1].to(torch.int64).sum()) * per_sample
    return tensor_bytes(*args) + tensor_bytes(*outs), ops


def select_bound(args, outs, is_lpc):
    return bound(*select_work(args, outs, is_lpc))


def pack_work(pargs, packed_bytes: int):
    """Rice pack's (bytes, operations): the residual rows and lane scalars
    in, the packed bytes and lane sizes out; bytes bound it (a code is a few
    operations, counted as none)."""
    return tensor_bytes(*pargs) + packed_bytes + 16 * pargs[0].shape[0], 0


def pack_bound(pargs, packed_bytes: int):
    return bound(*pack_work(pargs, packed_bytes))


def equal_outputs(got, want, what: str) -> int:
    """Check tensors pairwise equal; returns the max abs error (0)."""
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{what} output {i}: {g.shape} {w.shape}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    check(err == 0, f"{what}: kernel != plain, max abs err {err}")
    return err


def headline_search_inputs(clips, level: int = 5):
    """The candidate search's inputs at the headline geometry: the clips'
    lanes in the mid/side domain with the exact host analysis's tables, on
    the card."""
    from flo_torch.lossless import encoder
    from flo_torch.ops import select

    kinds, orders, _ = encoder._candidate_plan(level)
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
    bound_ms, bound_by = select_bound(args, got, is_lpc)
    wins = np.bincount(got[0].cpu().numpy(), minlength=len(is_lpc)).tolist()
    log(f"[3 kernel] lossless_select == plain at [{L}, {S}], level 5, {len(is_lpc)} candidates "
        f"(exact; winners by candidate {wins}): kernel {ms:.4f} ms (bound {bound_ms:.4f} ms by "
        f"{bound_by}), plain PyTorch {plain_ms:.1f} ms [{gpu}]")

    # Every candidate plan with an instantiation, at a ragged shape, with
    # lanes whose tables are not the plan's (the general path) beside them.
    for level in (0, 1, 2, 4, 5, 7, 8):
        for S in (1537, 13):
            rargs, r_lpc = ragged_search_inputs(level, 37, S)
            equal_outputs(cuda_select.encode_select_cuda(*rargs, r_lpc),
                          select.encode_select_step(*rargs, r_lpc),
                          f"lossless_select level {level} [37, {S}]")
    log("[3 kernel] lossless_select == plain at ragged [37, 1537] and [37, 13] for levels "
        "0, 1, 2, 4, 5, 7, 8 (every candidate plan; 3 lanes off the plan) (exact)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}, (got, args[1])


def ragged_search_inputs(level: int, L: int, S: int):
    """Ragged lanes with the exact analysis's tables at a level, on the
    card; lanes 3, 5 and 6 get tables off the plan (a fixed candidate with
    a shift, a tap in FIXED[0]'s row, a larger order)."""
    from flo_torch.lossless import encoder

    kinds, orders, _ = encoder._candidate_plan(level)
    lanes_np, nvalid_np = ragged_lanes(7, L, S)
    _, tables = encoder.host_analysis(lanes_np, nvalid_np.astype(np.int64), 1, kinds, orders)
    coeffs, shifts, orders_t, fixed, ok = (t.clone() for t in tables)
    shifts[3, 1] = 2
    coeffs[5, 1, 11] = 7
    orders_t[6, -1] += 1
    return ((torch.from_numpy(lanes_np).to(DEVICE), torch.from_numpy(nvalid_np).to(DEVICE),
             *encoder.tables_to_device(coeffs, shifts, orders_t, fixed, ok, device=DEVICE)),
            tuple(kd == "lpc" for kd in kinds))


def equal_packed(got, want, what: str) -> int:
    """Lane bytes and offsets equal, and the payload equal up to the packed
    end: a buffer sized by ``max_words`` is longer and unspecified there, a
    shorter one holds the stream as far as it goes."""
    err = equal_outputs(got[1:], want[1:], what)
    n = min(got[0].numel(), want[0].numel())
    check(torch.equal(got[0][:n], want[0][:n]), f"{what}: payload != plain")
    return err


def phase_kernel_pack(gpu: str, search) -> dict:
    from flo_torch.lossless import encoder
    from flo_torch.ops import blockspread, cuda_ricepack

    check(cuda_ricepack.kernel_geometry()[0] == cuda_ricepack.TILE,
          f"rice_pack's tile is {cuda_ricepack.kernel_geometry()[0]} codes, the wrapper's "
          f"{cuda_ricepack.TILE}")
    (sel, k, size, residuals, _, _), nvalid = search
    L, S = residuals.shape
    pargs = (residuals, k, nvalid, sel == 0)
    got = cuda_ricepack.pack_lanes_cuda(*pargs)
    want = blockspread.pack_lanes_words(*pargs)
    torch.cuda.synchronize()
    err = equal_outputs(got, want, f"rice_pack [{L}, {S}]")
    check(torch.equal(got[1], size.to(torch.int64)), "rice_pack lane bytes != search sizes")
    # As the main path calls it: the worst-case buffer (no wait for the word
    # count) and the search's sizes as the hint (one read of the residuals).
    max_words = encoder._max_words([S] * (L // CHANNELS), CHANNELS)
    main = cuda_ricepack.pack_lanes_cuda(*pargs, max_words=max_words, size_hint=size)
    check(main[0].numel() == 4 * max_words, "rice_pack: the buffer is not max_words long")
    equal_packed(main, want, f"rice_pack [{L}, {S}] with max_words and the sizes given")
    equal_packed(cuda_ricepack.pack_lanes_cuda(*pargs, max_words=max_words), want,
                 f"rice_pack [{L}, {S}] with max_words")
    ms = time_ms(lambda: cuda_ricepack.pack_lanes_cuda(*pargs), 20)
    nowait_ms = time_ms(lambda: cuda_ricepack.pack_lanes_cuda(*pargs, max_words=max_words), 20)
    main_ms = time_ms(
        lambda: cuda_ricepack.pack_lanes_cuda(*pargs, max_words=max_words, size_hint=size), 20)
    plain_ms = time_ms(lambda: blockspread.pack_lanes_words(*pargs), 2)
    bound_ms, bound_by = pack_bound(pargs, got[0].numel())
    log(f"[3 kernel] rice_pack == plain at [{L}, {S}] ({got[0].numel() / 1e6:.2f} MB packed; "
        f"exact): kernel {ms:.4f} ms (with its word-count wait; bound {bound_ms:.4f} ms by "
        f"{bound_by}), plain PyTorch {plain_ms:.1f} ms [{gpu}]")
    log(f"[3 kernel] rice_pack at [{L}, {S}] with max_words (no wait): {nowait_ms:.4f} ms; with "
        f"max_words and the search's sizes given, as the main path calls it (one read): "
        f"{main_ms:.4f} ms = {100 * bound_ms / main_ms:.1f}% of the bound {bound_ms:.4f} ms "
        f"[{gpu}]")

    rargs = [torch.from_numpy(a).to(DEVICE) for a in ragged_pack_case(11, 37, 1537)]
    rgot = cuda_ricepack.pack_lanes_cuda(*rargs)
    equal_outputs(rgot, blockspread.pack_lanes_words(*rargs), "rice_pack ragged [37, 1537]")
    longest = int(blockspread.code_fields(*rargs)[0].max())
    check(longest == 271, f"ragged pack case's longest code is {longest} bits")
    log(f"[3 kernel] rice_pack == plain on a ragged [37, 1537] with codes up to {longest} bits, "
        "raw lanes with the int16 wrap and empty lanes (exact)")

    # The shapes the kernel's tiles are sensitive to (the CPU tests hold the
    # plain version to the host coder on the same cases), and one lane of
    # 44,100 271-bit codes beside ordinary lanes. Each: exact buffer; the
    # worst-case buffer with the true sizes given; sizes of which one is a
    # word short (that lane is cut at its span, as in the plain version); and
    # a buffer three words short of the stream.
    cases = {**cuda_ricepack.edge_cases(),
             f"271-bit lane [8, {S}]": cuda_ricepack.dense_lane_case(5, 8, S)}
    for what, arrays in cases.items():
        cargs = [torch.from_numpy(a).to(DEVICE) for a in arrays]
        cwant = blockspread.pack_lanes_words(*cargs)
        equal_outputs(cuda_ricepack.pack_lanes_cuda(*cargs), cwant, f"rice_pack {what}")
        sizes = cwant[1].to(torch.int32)
        roomy = cwant[0].numel() // 4 + 5
        equal_packed(cuda_ricepack.pack_lanes_cuda(*cargs, max_words=roomy, size_hint=sizes),
                     cwant, f"rice_pack {what} with max_words and sizes")
        short = sizes.clone()
        short[0] = max(int(short[0]) - 4, 0)
        equal_outputs(cuda_ricepack.pack_lanes_cuda(*cargs, size_hint=short),
                      blockspread.pack_lanes_words(*cargs, size_hint=short),
                      f"rice_pack {what} with a short size")
        few = max(cwant[0].numel() // 4 - 3, 0)
        cut = cuda_ricepack.pack_lanes_cuda(*cargs, max_words=few)
        check(cut[0].numel() == 4 * few, f"rice_pack {what}: short buffer's length")
        equal_packed(cut, cwant, f"rice_pack {what} with a short buffer")
    dense_mb = int(blockspread.code_fields(*cargs)[0][1].sum()) / 8e6
    log(f"[3 kernel] rice_pack == plain on {', '.join(cases)} ({dense_mb:.2f} MB of 271-bit "
        "codes in that lane); each also with max_words and sizes given, with one size a word "
        "short, and with a buffer three words short (exact)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ms_no_wait": nowait_ms, "ms_main_path": main_ms}


def masking_case(seed: int, shape):
    """Seeded masking levels as ``smr`` makes them (``cuda_psycho.music_like``)."""
    from flo_torch.ops import cuda_psycho

    return cuda_psycho.music_like(np.random.default_rng(seed), shape)


def bit_equal(got, want, what: str) -> float:
    """Check two float32 tensors equal bit for bit, NaN where and only where
    the other has NaN; returns the max abs error over the finite values."""
    check(got.shape == want.shape and got.dtype == want.dtype == torch.float32,
          f"{what}: {got.shape} {got.dtype} against {want.shape} {want.dtype}")
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), f"{what}: NaN in other places than the plain loop")
    bits = lambda t: torch.where(nan, torch.zeros_like(t), t).view(torch.int32)  # noqa: E731
    finite = torch.isfinite(want)
    err = float((got - want)[finite].abs().max()) if bool(finite.any()) else 0.0
    check(torch.equal(bits(got), bits(want)), f"{what}: kernel != plain loop, max abs err {err}")
    return err


def phase_kernel_temporal(gpu: str) -> dict:
    from flo_torch.ops import cuda_psycho, psycho

    hops = -(-(SECONDS * RATE + 1024) // 1024)
    lanes = FILES * CHANNELS
    check(hops == 2585 and lanes == 16, f"headline blocks [{lanes}, {hops}]")
    shapes = [(lanes, hops, 25), (lanes // 2, hops, 25), (960, 44, 25), (1, 1, 25), (3, 7, 25),
              (5, 0, 25), (0, 9, 25)]
    err, cases = 0.0, {}
    for shape in shapes:
        m = cases[shape] = torch.from_numpy(masking_case(sum(shape), shape)).to(DEVICE)
        got = cuda_psycho.temporal_mask_cuda(m)
        torch.cuda.synchronize()
        err = max(err, bit_equal(got, psycho.temporal_mask_plain(m), f"temporal_mask {list(shape)}"))
    odd = masking_case(1, (4, 50, 25))
    odd[0, 7, 3], odd[1, 20, 24], odd[2, 0, 0], odd[3, 49, 5] = np.nan, np.inf, -np.inf, np.nan
    odd[1, 30, 24] = np.nan
    odd = torch.from_numpy(odd).to(DEVICE)
    got = cuda_psycho.temporal_mask_cuda(odd)
    bit_equal(got, psycho.temporal_mask_plain(odd), "temporal_mask with NaN and inf")
    check(bool(torch.isnan(got[0, 7:, 3]).all()) and not bool(torch.isnan(got[0, :7, 3]).any()),
          "temporal_mask: a NaN must last from its hop to the lane's end")
    slow = None
    named = cuda_psycho.scan_cases()
    for name, m in named:
        m = torch.from_numpy(m).to(DEVICE)
        got = cuda_psycho.temporal_mask_cuda(m)
        torch.cuda.synchronize()
        err = max(err, bit_equal(got, psycho.temporal_mask_plain(m), f"temporal_mask, {name}"))
        if name.startswith("+96 dB"):
            slow = m
    log(f"[3 kernel] temporal_mask == plain loop on {len(named)} cases of the segmented scan "
        f"({'; '.join(name for name, _ in named)}): the same bits, zero signs included")
    lead = torch.from_numpy(masking_case(2, (2, 3, 7, 25))).to(DEVICE)
    before = cuda_psycho.LAUNCHES
    bit_equal(psycho.temporal_mask(lead), psycho.temporal_mask_plain(lead),
              "temporal_mask through the dispatcher, [2, 3, 7, 25]")
    check(cuda_psycho.LAUNCHES == before + 1, "the dispatcher did not launch the kernel")
    log(f"[3 kernel] temporal_mask == plain loop at {', '.join(str(list(sh)) for sh in shapes)}, "
        "with NaN and +-inf, and through the dispatcher at [2, 3, 7, 25] (the same bits)")

    head, chunk = cases[shapes[0]], cases[shapes[1]]
    ms = time_ms(lambda: cuda_psycho.temporal_mask_cuda(head), 50)
    main_ms = time_ms(lambda: cuda_psycho.temporal_mask_cuda(chunk), 50)
    # From Python the host launches a call about as fast as the card runs it,
    # so the card's own time comes from a CUDA graph of 20 calls.
    dev_ms = graph_ms(lambda: cuda_psycho.temporal_mask_cuda(head))
    dev_main_ms = graph_ms(lambda: cuda_psycho.temporal_mask_cuda(chunk))
    slow_ms = graph_ms(lambda: cuda_psycho.temporal_mask_cuda(slow))
    psycho.temporal_mask_plain(head[:, :64])  # warm-up
    plain_ms = time_ms(lambda: psycho.temporal_mask_plain(head), 1)
    # Bytes: the input read once, the output written once. Operations: a
    # multiply and a maximum an element, in float32.
    bound_ms, bound_by = bound(2 * tensor_bytes(head), 2 * head.numel(), F32_OPS_PER_S)
    log(f"[3 kernel] temporal_mask at {list(head.shape)}: kernel {ms:.4f} ms called from "
        f"Python, {dev_ms:.4f} ms on the card alone (a CUDA graph of 20 calls; bound "
        f"{bound_ms:.4f} ms by {bound_by} = {100 * bound_ms / dev_ms:.1f}%; two launches, chains "
        f"of {cuda_psycho.NEAR + cuda_psycho.CHUNK} of {head.shape[1]} hops where the near "
        f"window meets), plain PyTorch loop {plain_ms:.1f} ms; at {list(chunk.shape)}, as the "
        f"main path calls it, {main_ms:.4f} ms from Python, {dev_main_ms:.4f} ms on the card "
        f"alone; its slow side, {list(slow.shape)} of a loud hop then silence (every carry "
        f"through the warm window), {slow_ms:.4f} ms on the card alone [{gpu}]")
    # "ms" is the card's own time, as for the other kernels (theirs are long
    # enough for the host to keep ahead of the card).
    return {"max_abs_err": err, "ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ms_main_path": dev_main_ms, "ms_slow_side": slow_ms,
            "ms_from_python": ms, "ms_main_path_from_python": main_ms}


#: Lossless corpus files whose encoder input the reference generator's own
#: Raw-frame defect destroyed (tests/test_compat.py): not re-encodable.
UNRECOVERABLE = {"silence_1sec.flo", "white_noise.flo"}


def phase_corpus(gpu: str) -> None:
    import flo_torch
    from flo_torch.container import reader
    from flo_torch.lossless import decoder, encoder

    names, reencoded, lossy = [], [], {}
    for p in sorted(EXAMPLES.glob("*.flo")):
        data = p.read_bytes()
        flo = reader.read(data)
        if any(f.frame_type == 253 for f in flo.frames):
            lossy[p.stem] = lossy_file_on_card(p.name, data, flo)
            continue
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
    check(len(lossy) == 7, f"expected 7 lossy corpus files, found {len(lossy)}")
    ref = flo_torch.decode((EXAMPLES / "chord_cmajor_stereo.flo").read_bytes(), device=DEVICE)
    snrs = [snr_db(ref, lossy[f"lossy_chord_{name}"]) for name in CHORD_FLOORS]
    for (name, floor), snr, prev in zip(CHORD_FLOORS.items(), snrs, [-1e9] + snrs):
        check(snr > floor and snr > prev, f"lossy_chord_{name}: SNR {snr:.2f} dB on the card "
              f"(floor {floor}, the preset below {prev:.2f})")
    log(f"[4 corpus] {len(lossy)} lossy files decoded on the card within one i16 step of the "
        f"CPU decode, lengths right; chord presets' SNR "
        f"{', '.join(f'{n} {v:.2f}' for n, v in zip(CHORD_FLOORS, snrs))} dB, above their "
        f"floors and rising [{gpu}]")


#: SNR floors of the reference's chord files by preset (tests/test_lossy.py).
CHORD_FLOORS = {"low": 20.0, "medium": 30.0, "high": 35.0, "veryhigh": 40.0,
                "transparent": 45.0}
I16_STEP = np.float32(1.0 / 32767.0)


def snr_db(ref, out) -> float:
    m = min(len(ref), len(out))
    noise = (out[:m] - ref[:m]).astype(np.float64)
    return float(10 * np.log10(np.sum(ref[:m].astype(np.float64) ** 2)
                               / max(np.sum(noise**2), 1e-30)))


def within_one_step(got, want, what: str) -> None:
    """Two decodes of the same bytes: equal length, every sample within one
    i16 step, compared in the i16 domain (near full scale a float32 ulp is
    0.002 of a step)."""
    check(got.dtype == np.float32 and got.shape == want.shape and np.isfinite(got).all(),
          f"{what}: {got.shape} {got.dtype} against {want.shape}")
    steps = np.abs(np.rint(got / I16_STEP) - np.rint(want / I16_STEP))
    check(steps.max(initial=0) <= 1, f"{what}: {steps.max(initial=0):.0f} i16 steps apart")


def lossy_file_on_card(name: str, data: bytes, flo):
    import flo_torch

    on_card = flo_torch.decode(data, device=DEVICE)
    within_one_step(on_card, flo_torch.decode(data, device="cpu"), f"{name}: card against CPU")
    check(len(on_card) == (len(flo.frames) - 1) * 1024 * flo.header.channels, f"{name}: length")
    check(flo_torch.validate(data) and flo.header.is_lossy, f"{name}: validate / lossy flag")
    return on_card


def headline_clips():
    """bench.py's headline workload, rebuilt with the port: the stereo chord
    decoded, tiled to SECONDS and rolled by one second per clip."""
    import flo_torch

    base = flo_torch.decode((EXAMPLES / "chord_cmajor_stereo.flo").read_bytes(), device=DEVICE)
    need = SECONDS * RATE * CHANNELS
    tiled = np.tile(base, -(-need // len(base)))[:need]
    return [np.roll(tiled, i * CHANNELS * RATE) for i in range(FILES)]


def kernel_modules():
    from flo_torch.ops import cuda_lpc, cuda_psycho, cuda_ricepack, cuda_select

    return {"lpc_reconstruct": cuda_lpc, "lossless_select": cuda_select,
            "rice_pack": cuda_ricepack, "temporal_mask": cuda_psycho}


#: The kernels each main path must launch.
LOSSLESS_KERNELS = ("lpc_reconstruct", "lossless_select", "rice_pack")
LOSSY_KERNELS = ("temporal_mask",)


def phase_main_path(gpu: str, clips) -> dict:
    """bench.py's headline lossless pass (bench.py:166): bulk encode on the
    card, then bulk decode on the card. Returns each kernel's launches in
    that run, and the encoded files."""
    from flo_torch import batch
    from flo_torch.container import reader
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
    launches = {name: mods[name].LAUNCHES for name in LOSSLESS_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"the lossless main path never launched {name}")
    for i, (clip, out) in enumerate(zip(clips, outs)):
        want = convert_round_trip(clip)
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
    what = "batch.encode_many + batch.decode_many, analyze=False"
    traced_outs, line = traced(what, lambda: batch.decode_many(batch.encode_many(
        clips, RATE, CHANNELS, 16, 5, analyze=False, device=DEVICE), device=DEVICE),
        ENCODE_LEAVES + DECODE_LEAVES, gpu)
    for i, (clip, out) in enumerate(zip(clips, traced_outs)):
        check(np.array_equal(out, convert_round_trip(clip)),
              f"clip {i}: the traced round trip is not bit-exact")
    log(f"[5 main] {line}; round trip bit-exact")
    return launches, encoded


# The leaf spans of a bulk encode and decode (flo_torch.tracing); the lossy
# encode adds encode.sparse_rle.
ENCODE_LEAVES = ("encode.marshal", "encode.upload", "encode.enqueue", "encode.download",
                 "encode.assemble", "encode.write")
DECODE_LEAVES = ("decode.read", "decode.parse", "decode.upload", "decode.enqueue",
                 "decode.download", "decode.finish")


def traced(what: str, fn, leaves, gpu: str):
    """``fn()`` once with ``flo_torch.tracing`` on; each span named in
    ``leaves`` must have been recorded. Returns ``fn``'s value and a line of
    each span's total and self time (ms) and calls, and the counters."""
    from flo_torch import tracing

    torch.cuda.synchronize()
    tracing.take()
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    summary = tracing.summary()
    tracing.take()
    missing = [name for name in leaves if name not in summary["spans"]]
    check(not missing, f"{what}: no {missing} span recorded")
    parts = [f"{name} {d['total_ms']:.1f}/{d['self_ms']:.1f} ms x{d['calls']}"
             for name, d in summary["spans"].items()]
    return out, (f"{what}: spans (total/self ms, calls) {', '.join(parts)}; counters "
                 f"{summary['counters']} [{gpu}]")


LOSSY_QUALITY = 1  # the medium preset, as bench.py's headline pass


def plain_loop_guard():
    """Replace each kernel's plain version (the scan's loop, the recurrence,
    the search, the pack) with one that counts its calls on CUDA tensors;
    returns (restore, calls)."""
    from flo_torch.ops import blockspread, lpc, psycho, select

    plains = [(psycho, "temporal_mask_plain"), (lpc, "reconstruct"),
              (select, "encode_select_step"), (blockspread, "pack_lanes_words")]
    saved, calls = [(m, name, getattr(m, name)) for m, name in plains], []

    def guard(name, plain):
        def guarded(first, *args, **kwargs):
            if first.device.type == "cuda":
                calls.append((name, tuple(first.shape)))
            return plain(first, *args, **kwargs)

        return guarded

    for m, name, plain in saved:
        setattr(m, name, guard(name, plain))

    def restore():
        for m, name, plain in saved:
            setattr(m, name, plain)

    return restore, calls


def phase_lossy_path(gpu: str, clips) -> dict:
    """bench.py's headline lossy pass (bench.py:167-168), through the bulk
    facade: lossy encode of the headline clips on the card at the medium
    preset with the "packed" transport, then bulk decode on the card.
    Returns the scan kernel's launches in that run."""
    from flo_torch import batch, lib
    from flo_torch.lossy import decoder as ldec
    from flo_torch.lossy import encoder as lenc
    from flo_torch.lossy.presets import QUALITY_U8_TO_F32

    audio_s = FILES * SECONDS
    mods = kernel_modules()
    restore, plain_calls = plain_loop_guard()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        encoded = batch.encode_lossy_many(clips, RATE, CHANNELS, quality=LOSSY_QUALITY,
                                          transport_dtype="packed", device=DEVICE)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = batch.decode_many(encoded, device=DEVICE)
        dec_s = time.perf_counter() - t0
        launches = {name: mods[name].LAUNCHES for name in LOSSY_KERNELS}
        for name, n in launches.items():
            check(n > 0, f"the lossy main path never launched {name}")
        check(not plain_calls, f"a plain version ran on the card: {plain_calls}")

        hops = -(-(SECONDS * RATE + 1024) // 1024)
        snrs = []
        for i, (clip, data, out) in enumerate(zip(clips, encoded, outs)):
            info = lib.info(data)
            check(lib.validate(data) and info.crc_valid, f"lossy clip {i}: CRC")
            check(info.is_lossy and info.lossy_quality == LOSSY_QUALITY and info.channels == CHANNELS
                  and info.sample_rate == RATE, f"lossy clip {i}: header {info}")
            check(out.dtype == np.float32 and out.shape == ((hops - 1) * 1024 * CHANNELS,)
                  and np.isfinite(out).all(), f"lossy clip {i}: output {out.shape} {out.dtype}")
            snrs.append(snr_db(clip, out))
            check(snrs[-1] > CHORD_FLOORS["medium"], f"lossy clip {i}: SNR {snrs[-1]:.2f} dB")

        # Warm calls: the bulk facade again, then the encoder and decoder
        # modules alone (no analysis metadata: what bench.py times).
        t0 = time.perf_counter()
        again = batch.encode_lossy_many(clips, RATE, CHANNELS, quality=LOSSY_QUALITY,
                                        transport_dtype="packed", device=DEVICE)
        enc2_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs2 = batch.decode_many(encoded, device=DEVICE)
        dec2_s = time.perf_counter() - t0
        q = QUALITY_U8_TO_F32[LOSSY_QUALITY]
        t0 = time.perf_counter()
        bare = lenc.encode_many(clips, RATE, CHANNELS, q, transport_dtype="packed",
                                device=DEVICE)
        bare_s = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        for i, (a, b) in enumerate(zip(outs, outs2)):
            within_one_step(b, a, f"lossy clip {i}: second decode against the first")

        # The card against the CPU: one clip's encode (size and SNR), and
        # the decode of the same bytes.
        t0 = time.perf_counter()
        cpu_data = lenc.encode_many(clips[:1], RATE, CHANNELS, q, transport_dtype="packed",
                                    device="cpu")[0]
        cpu_enc_s = time.perf_counter() - t0
        alone = lenc.encode_many(clips[:1], RATE, CHANNELS, q, transport_dtype="packed",
                                 device=DEVICE)[0]
        check(abs(len(alone) - len(cpu_data)) <= 0.01 * len(cpu_data),
              f"card encode {len(alone)} bytes, CPU encode {len(cpu_data)}: past 1%")
        cpu_snr = snr_db(clips[0], ldec.decode(cpu_data, device="cpu"))
        card_snr = snr_db(clips[0], ldec.decode(alone, device=DEVICE))
        check(abs(card_snr - cpu_snr) <= 0.1, f"card SNR {card_snr:.3f} dB, CPU {cpu_snr:.3f} dB")
        for i in (0, FILES - 1):
            within_one_step(outs[i], lib.decode(encoded[i], device="cpu"),
                            f"lossy clip {i}: card decode against CPU decode")
    finally:
        restore()

    raw_mb = sum(c.size for c in clips) * 2 / 1e6
    lossy_mb = sum(map(len, bare)) / 1e6
    same = "equal" if [len(b) for b in again] == [len(b) for b in encoded] else "other"
    log(f"[5 lossy] {FILES} x {SECONDS} s stereo {RATE} Hz, quality {LOSSY_QUALITY}, packed: "
        f"blocks [{FILES * CHANNELS}, {hops}, 2048]; {lossy_mb:.3f} MB from {raw_mb:.1f} MB of "
        f"16-bit PCM = {raw_mb / lossy_mb:.2f}x; every file validates, is lossy, has its length; "
        f"SNR {min(snrs):.2f}-{max(snrs):.2f} dB; one clip alone on the card {len(alone)} bytes, "
        f"{card_snr:.3f} dB, on the CPU {len(cpu_data)} bytes, {cpu_snr:.3f} dB "
        f"(CPU encode {cpu_enc_s:.3f} s); card decode within one i16 step of the CPU decode; "
        f"a second encode's sizes {same}; launches {launches}, plain loop on the card 0")
    log(f"[5 lossy] batch.encode_lossy_many on the card {enc_s:.3f} s = {audio_s / enc_s:.1f}x "
        f"realtime (second call {enc2_s:.3f} s = {audio_s / enc2_s:.1f}x); "
        f"lossy.encoder.encode_many, no analysis metadata, {bare_s:.3f} s = "
        f"{audio_s / bare_s:.1f}x [{gpu}]")
    log(f"[5 lossy] batch.decode_many on the card {dec_s:.3f} s = {audio_s / dec_s:.1f}x "
        f"realtime (second call {dec2_s:.3f} s = {audio_s / dec2_s:.1f}x); peak device memory "
        f"of the lossy phase {peak_mb:.1f} MB [{gpu}]")

    def traced_round_trip():
        data = batch.encode_lossy_many(clips, RATE, CHANNELS, quality=LOSSY_QUALITY,
                                       transport_dtype="packed", device=DEVICE)
        return data, batch.decode_many(data, device=DEVICE)

    (traced_data, traced_outs), line = traced(
        f"batch.encode_lossy_many (quality {LOSSY_QUALITY}, packed) + batch.decode_many",
        traced_round_trip, ENCODE_LEAVES + ("encode.sparse_rle",) + DECODE_LEAVES, gpu)
    check(traced_data == encoded, "the traced lossy encode's bytes differ from the untraced")
    for i, (a, b) in enumerate(zip(traced_outs, outs)):
        within_one_step(a, b, f"lossy clip {i}: traced decode against the untraced")
    log(f"[5 lossy] {line}; bytes equal to the untraced encode's, decode within one i16 step")
    return launches


def data_chunk(data: bytes) -> bytes:
    """The DATA chunk's bytes of a flo file."""
    from flo_torch.container import reader

    h = reader.read(data).header
    start = 4 + h.header_size + h.toc_size
    return data[start : start + h.data_size]


def stream_decode(data: bytes, piece: int, device: str):
    """``data`` fed to a StreamingDecoder in pieces; every frame as it comes."""
    from flo_torch.streaming import StreamingDecoder

    dec, frames = StreamingDecoder(device=device), []
    for i in range(0, len(data), piece):
        dec.feed(data[i : i + piece])
        while (out := dec.next_frame()) is not None:
            frames.append(out)
    check(dec.state.name == "FINISHED", f"streaming decoder ended in {dec.state.name}")
    return frames


def check_seeks(name: str, data: bytes, whole: np.ndarray, targets_ms, lossy: bool) -> None:
    """``seek_to_time`` at each target and ``decode_frame_at`` on the first,
    a middle and the last frame, on the card, against the whole decode."""
    import flo_torch
    from flo_torch.container import reader

    flo = reader.read(data)
    rate, C, n_frames = flo.header.sample_rate, flo.header.channels, len(flo.frames)
    for ms in targets_ms:
        r = flo_torch.seek_to_time(data, ms)
        entry = flo.toc[r.frame_index]
        check(r.timestamp_ms == entry.timestamp_ms <= ms and r.byte_offset == entry.byte_offset
              and (r.frame_index == n_frames - 1 or ms < r.next_timestamp_ms),
              f"{name}: seek to {ms} ms gave {r}")
        check(r.sample_offset == min((ms - r.timestamp_ms) * rate // 1000,
                                     flo.frames[r.frame_index].frame_samples),
              f"{name}: seek to {ms} ms: sample offset {r.sample_offset}")
    for i in (0, n_frames // 2, n_frames - 1):
        got = flo_torch.decode_frame_at(data, i, device=DEVICE)
        if not lossy:
            lo = sum(f.frame_samples for f in flo.frames[:i]) * C
            check(np.array_equal(got, whole[lo : lo + len(got)]) and len(got) ==
                  flo.frames[i].frame_samples * C, f"{name}: frame {i} != the whole decode's slice")
        elif i == 0:  # the pre-roll frame, against a zero overlap: no slice of the output
            within_one_step(got, flo_torch.decode_frame_at(data, 0, device="cpu"),
                            f"{name}: frame 0 on the card against the CPU")
        else:
            hop = 1024 * C
            within_one_step(got, whole[(i - 1) * hop : i * hop], f"{name}: frame {i}")
    try:
        flo_torch.decode_frame_at(data, n_frames, device=DEVICE)
    except IndexError:
        pass
    else:
        raise SmokeFailure(f"{name}: a frame index past the end did not raise")


def phase_api(gpu: str, clip: np.ndarray) -> dict:
    """The rest of the public API on the card, at full width: one 60 s stereo
    44.1 kHz clip, lossless at level 5 and lossy at quality 1, through the
    streaming encoder and decoder, seeking, the reflo facade (WAV in, WAV
    out) and the metadata functions; then one lossless and one lossy corpus
    file streamed and sought on the card against the CPU. Returns each
    kernel's launches in this phase."""
    import flo_torch
    from flo_torch import audio_io, reflo
    from flo_torch.lossy.presets import QUALITY_U8_TO_F32
    from flo_torch.streaming import StreamingEncoder

    mods = kernel_modules()
    restore, plain_calls = plain_loop_guard()
    torch.cuda.synchronize()
    for m in mods.values():
        m.LAUNCHES = 0
    laps = {}

    def lap(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        laps[name] = time.perf_counter() - t0
        return out

    def stream_encode(device):
        enc = StreamingEncoder(RATE, CHANNELS, device=device).with_compression(5)
        for i in range(0, len(clip), 4096):
            enc.push_samples(clip[i : i + 4096])
        return enc.finalize()

    try:
        # (a) lossless: streamed in, streamed out.
        streamed = lap("a: StreamingEncoder, pieces of 4,096 samples", lambda: stream_encode(DEVICE))
        check(streamed == stream_encode("cpu"), "streaming encode: the card's bytes != the CPU's")
        check(flo_torch.validate(streamed), "streaming encode: CRC")
        whole = flo_torch.decode(streamed, device=DEVICE)
        want = convert_round_trip(clip)
        check(np.array_equal(whole, want), "streaming encode: round trip not bit-exact")
        frames = lap("a: StreamingDecoder, lossless, pieces of 64 KB",
                     lambda: stream_decode(streamed, 65536, DEVICE))
        check(len(frames) == SECONDS and np.array_equal(np.concatenate(frames), whole),
              "streaming decode: lossless frames != decode of the same bytes")

        # (b) lossy: encoded on the card, streamed out frame by frame.
        lossy = lap("b: encode_lossy on the card (quality 1, no analysis)",
                    lambda: flo_torch.encode_lossy(clip, RATE, CHANNELS, LOSSY_QUALITY,
                                                   analyze=False, device=DEVICE))
        lossy_whole = flo_torch.decode(lossy, device=DEVICE)
        lframes = lap("b: StreamingDecoder, lossy, a frame at a time, IMDCT on the card",
                      lambda: stream_decode(lossy, 65536, DEVICE))
        cpu_frames = lap("b: the same on the CPU", lambda: stream_decode(lossy, 65536, "cpu"))
        hops = -(-(SECONDS * RATE + 1024) // 1024)
        check([f.size for f in lframes] == [f.size for f in cpu_frames] and len(lframes) == hops
              and lframes[0].size == 0 and all(f.size == 1024 * CHANNELS for f in lframes[1:]),
              "streaming decode: lossy frame count or pre-roll differ from the CPU's")
        within_one_step(np.concatenate(lframes), lossy_whole, "streaming decode: lossy frames")

        # (c) seeking on both files.
        targets = (0, 1, 29_999, 59_999)
        lap("c: 4 seeks + 3 frames, lossless",
            lambda: check_seeks("streamed lossless", streamed, whole, targets, False))
        lap("c: 4 seeks + 3 frames, lossy",
            lambda: check_seeks("lossy", lossy, lossy_whole, targets, True))
        for ms in targets:
            r = flo_torch.seek_to_time(streamed, ms)
            check((r.frame_index, r.sample_offset) == (ms // 1000, (ms % 1000) * RATE // 1000),
                  f"lossless seek to {ms} ms: {r}")

        # (d) the reflo facade: WAV in, flo, WAV out.
        wav = audio_io.write_wav_to_bytes(clip, RATE, CHANNELS)
        before = {name: m.LAUNCHES for name, m in mods.items()}
        ref_lossless = lap("d: reflo.encode_from_audio, lossless level 5",
                           lambda: reflo.encode_from_audio(wav, reflo.EncodeOptions.lossless(),
                                                           device=DEVICE))
        ref_lossy = lap("d: reflo.encode_from_audio, lossy quality 1",
                        lambda: reflo.encode_from_audio(
                            wav, reflo.EncodeOptions.lossy_quality(QUALITY_U8_TO_F32[LOSSY_QUALITY]),
                            device=DEVICE))
        back = lap("d: reflo.decode_to_wav, lossless",
                   lambda: reflo.decode_to_wav(ref_lossless, device=DEVICE))
        back_lossy = lap("d: reflo.decode_to_wav, lossy",
                         lambda: reflo.decode_to_wav(ref_lossy, device=DEVICE))
        for name in ("lpc_reconstruct", "temporal_mask"):
            check(mods[name].LAUNCHES > before[name], f"the reflo round trip never launched {name}")
        check(reflo.validate_flo(ref_lossless) and reflo.validate_flo(ref_lossy), "reflo: CRC")
        samples, rate, C, _ = audio_io.read_audio_from_bytes(back)
        check((rate, C) == (RATE, CHANNELS) and np.array_equal(samples, want),
              "reflo: lossless WAV -> flo -> WAV not bit-exact")
        samples, rate, C, _ = audio_io.read_audio_from_bytes(back_lossy)
        snr = snr_db(clip, samples)
        check((rate, C) == (RATE, CHANNELS) and np.isfinite(samples).all()
              and snr > CHORD_FLOORS["medium"], f"reflo: lossy round trip SNR {snr:.2f} dB")
        meta = reflo.get_metadata(ref_lossy)
        check(meta.flo_encoder_version == f"flo_torch {flo_torch.__version__}"
              and meta.length_ms == SECONDS * 1000 and meta.source_format is not None,
              f"reflo: metadata stamps {meta.flo_encoder_version!r}, {meta.length_ms}")

        # (f) metadata editing leaves the audio alone.
        for name, data in (("lossless", ref_lossless), ("lossy", ref_lossy)):
            meta = flo_torch.get_metadata(data)
            meta.title, meta.artist = "smoke", "chip"
            edited = flo_torch.update_metadata(data, meta)
            stripped = flo_torch.strip_metadata(edited)
            check(flo_torch.get_metadata(edited).title == "smoke" and flo_torch.has_metadata(edited)
                  and not flo_torch.has_metadata(stripped)
                  and flo_torch.get_metadata_bytes(stripped) == b"",
                  f"metadata round trip, {name}")
            for what, d in (("edited", edited), ("stripped", stripped)):
                check(flo_torch.validate(d) and data_chunk(d) == data_chunk(data),
                      f"metadata {what}, {name}: CRC or DATA chunk changed")
        check(flo_torch.info(ref_lossless).version == flo_torch.version(), "version()")

        # (e) the corpus: one lossless and one lossy file, card against CPU.
        for fname, is_lossy in (("multitone_stereo.flo", False), ("lossy_chord_medium.flo", True)):
            data = (EXAMPLES / fname).read_bytes()
            card = stream_decode(data, 4096, DEVICE)
            cpu = stream_decode(data, 4096, "cpu")
            check([f.size for f in card] == [f.size for f in cpu], f"{fname}: streamed frame sizes")
            full = flo_torch.decode(data, device=DEVICE)
            if is_lossy:
                within_one_step(np.concatenate(card), np.concatenate(cpu), f"{fname}: streamed")
                within_one_step(np.concatenate(card), full, f"{fname}: streamed against decode")
            else:
                check(np.array_equal(np.concatenate(card), np.concatenate(cpu))
                      and np.array_equal(np.concatenate(card), full), f"{fname}: streamed")
            dur_ms = int(len(full) // flo_torch.info(data).channels * 1000
                         // flo_torch.info(data).sample_rate)
            check_seeks(fname, data, full, (0, 1, dur_ms // 2, max(dur_ms - 1, 0)), is_lossy)
        check(not plain_calls, f"a plain version ran on the card: {plain_calls}")
    finally:
        restore()

    launches = {name: m.LAUNCHES for name, m in mods.items()}
    log(f"[6 api] one {SECONDS} s stereo {RATE} Hz clip: streaming encode == the CPU's bytes "
        f"({len(streamed)} bytes, round trip bit-exact), streaming decode == decode (lossless, "
        f"{SECONDS} frames; lossy, {hops} frames with the pre-roll, within one i16 step), seeks at "
        f"{targets} ms and frames first/middle/last == the whole decode's slices, reflo WAV -> flo "
        f"-> WAV lossless bit-exact and lossy {snr:.2f} dB, metadata edits keep the DATA chunk, "
        f"two corpus files streamed and sought as on the CPU; launches {launches}")
    for name, s in laps.items():
        log(f"[6 api] {name}: {s:.3f} s = {SECONDS / s:.1f}x realtime [{gpu}]")
    return launches


def quiet(fn, *args):
    """fn(*args) with its standard output captured: (result, the output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return fn(*args), buf.getvalue()


def phase_cli(gpu: str, clip: np.ndarray, work: pathlib.Path, want: np.ndarray) -> None:
    """(a) The CLI in-process, then once as ``python3 -m flo_torch``."""
    from flo_torch import audio_io, cli, reflo

    wav = work / "clip.wav"
    wav.write_bytes(audio_io.write_wav_to_bytes(clip, RATE, CHANNELS))
    out, back, lossy, lossy_back = (str(work / n) for n in ("clip.flo", "back.wav", "lossy.flo",
                                                            "lossy.wav"))
    mods = kernel_modules()
    before = {name: m.LAUNCHES for name, m in mods.items()}
    runs = [
        ("encode", ["encode", str(wav), out, "--device", DEVICE]),
        ("decode", ["decode", out, back, "--device", DEVICE]),
        ("encode --lossy --quality high", ["encode", str(wav), lossy, "--lossy", "--quality",
                                           "high", "--device", DEVICE]),
        ("decode of the lossy file", ["decode", lossy, lossy_back, "--device", DEVICE]),
        ("info -m", ["info", out, "-m"]),
        ("metadata --json", ["metadata", out, "--json"]),
        ("analysis -w -s --json", ["analysis", out, "-w", "-s", "--json", "--device", DEVICE]),
        ("validate", ["validate", out]),
    ]
    laps, printed = {}, {}
    for name, argv in runs:
        t0 = time.perf_counter()
        rc, printed[name] = quiet(cli.main, argv)
        torch.cuda.synchronize()
        laps[name] = time.perf_counter() - t0
        check(rc == 0, f"flo-torch {name}: exit {rc}")
    samples, rate, C, _ = audio_io.read_audio_from_bytes(pathlib.Path(back).read_bytes())
    check((rate, C) == (RATE, CHANNELS) and np.array_equal(samples, want),
          "CLI: lossless WAV -> flo -> WAV not bit-exact")
    lib_flo = reflo.encode_from_audio(wav.read_bytes(), reflo.EncodeOptions.lossless(),
                                      device=DEVICE)
    check(data_chunk(pathlib.Path(out).read_bytes()) == data_chunk(lib_flo),
          "CLI: the DATA chunk differs from reflo.encode_from_audio's")
    samples, rate, C, _ = audio_io.read_audio_from_bytes(pathlib.Path(lossy_back).read_bytes())
    snr = snr_db(clip, samples)
    check(np.isfinite(samples).all() and snr > CHORD_FLOORS["medium"], f"CLI lossy SNR {snr:.2f}")
    analysis = json.loads(printed["analysis -w -s --json"])
    check(analysis["waveform"]["total_peaks"] == SECONDS * 60
          and "Lossless" in printed["info -m"]
          and json.loads(printed["metadata --json"])["flo_encoder_version"].startswith("flo_torch"),
          "CLI: info / metadata / analysis output")
    for name in ("lpc_reconstruct", "temporal_mask"):
        check(mods[name].LAUNCHES > before[name], f"the CLI never launched {name}")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "flo_torch", "info", out], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch"], check=True, timeout=300)
    torch_s = time.perf_counter() - t0
    check(res.returncode == 0 and "CRC valid:   yes" in res.stdout,
          f"python3 -m flo_torch info: exit {res.returncode}: {res.stderr[-500:]}")
    log(f"[7 cli] one {SECONDS} s stereo {RATE} Hz WAV ({wav.stat().st_size / 1e6:.1f} MB): "
        f"encode -> decode bit-exact, DATA chunk == reflo.encode_from_audio's; lossy high "
        f"{snr:.2f} dB; info, metadata, analysis ({analysis['loudness']['integrated_lufs']:.2f} "
        f"LUFS), validate exit 0; python3 -m flo_torch info exit 0 in {sub_s:.3f} s (python3 -c "
        f"'import torch' alone {torch_s:.3f} s) [{gpu}]")
    for name, t in laps.items():
        log(f"[7 cli] flo-torch {name}: {t:.3f} s [{gpu}]")


def phase_service(gpu: str, clip: np.ndarray, want: np.ndarray) -> None:
    """(b) The HTTP service on a thread, its codec calls on the card."""
    import urllib.request

    import flo_torch
    from flo_torch import service
    from flo_torch.core import ebu_r128
    from flo_torch.streaming import StreamingEncoder

    srv = service.make_server("127.0.0.1", 0, device=DEVICE)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    laps: dict = {}

    def call(what, path, body=None, *, n=1):
        t0 = time.perf_counter()
        req = urllib.request.Request(url + path, data=body, method="POST" if body is not None
                                     else "GET")
        with urllib.request.urlopen(req, timeout=300) as r:
            status, headers, payload = r.status, dict(r.headers), r.read()
        t, k = laps.get(what, (0.0, 0))
        laps[what] = (t + time.perf_counter() - t0, k + n)
        return status, headers, payload

    try:
        pcm = clip.astype("<f4").tobytes()
        q = f"?sample_rate={RATE}&channels={CHANNELS}"
        _, _, flo = call("/v1/encode", "/v1/encode" + q, pcm)
        status, headers, raw = call("/v1/decode", "/v1/decode", flo)
        check(status == 200 and headers["X-Sample-Rate"] == str(RATE)
              and headers["X-Channels"] == str(CHANNELS)
              and np.array_equal(np.frombuffer(raw, "<f4"), want),
              "service: /v1/encode -> /v1/decode not bit-exact")
        _, _, tflo = call("/v1/encode_transform", "/v1/encode_transform" + q + "&quality=0.55", pcm)
        _, _, traw = call("/v1/decode (lossy)", "/v1/decode", tflo)
        within_one_step(np.frombuffer(traw, "<f4").copy(), flo_torch.decode(tflo, device=DEVICE),
                        "service: /v1/decode of the transform file against flo_torch.decode")
        for i in (0, SECONDS // 2, SECONDS - 1):
            _, _, fr = call("/v1/decode_frame", f"/v1/decode_frame?frame_index={i}", flo)
            check(np.array_equal(np.frombuffer(fr, "<f4"),
                                 flo_torch.decode_frame_at(flo, i, device=DEVICE)),
                  f"service: /v1/decode_frame {i} != decode_frame_at")
        _, _, sk = call("/v1/seek", "/v1/seek?time_ms=29999", flo)
        check(json.loads(sk) == vars(flo_torch.seek_to_time(flo, 29999)), "service: /v1/seek")
        _, _, an = call("/v1/analysis", "/v1/analysis?waveform=1&spectrum=1", flo)
        an = json.loads(an)
        m = ebu_r128.compute_ebu_r128_loudness(want, CHANNELS, RATE)
        check(an["loudness"]["integrated_lufs"] == m.integrated_lufs
              and an["duration_secs"] == SECONDS and len(an["spectrum"]["energy_profile"]) == 16,
              "service: /v1/analysis against the library's loudness")

        # An encoder session fed 4,096 samples a push, then finalize.
        _, _, body = call("/v1/stream/encoder", "/v1/stream/encoder" + q + "&level=5", b"")
        sid = json.loads(body)["session"]
        for i in range(0, len(clip), 4096):
            call("/v1/stream/<id>/push", f"/v1/stream/{sid}/push", pcm[4 * i : 4 * (i + 4096)])
        _, _, streamed = call("/v1/stream/<id>/finalize", f"/v1/stream/{sid}/finalize", b"")
        enc = StreamingEncoder(RATE, CHANNELS, device=DEVICE).with_compression(5)
        for i in range(0, len(clip), 4096):
            enc.push_samples(clip[i : i + 4096])
        check(streamed == enc.finalize(), "service: encoder session != StreamingEncoder's bytes")
        # A decoder session fed 64 KB a piece.
        _, _, body = call("/v1/stream/decoder", "/v1/stream/decoder", b"")
        sid = json.loads(body)["session"]
        got = []
        for i in range(0, len(streamed), 65536):
            call("/v1/stream/<id>/feed", f"/v1/stream/{sid}/feed", streamed[i : i + 65536])
            _, _, chunk = call("/v1/stream/<id>/decode_available",
                               f"/v1/stream/{sid}/decode_available", b"")
            got.append(np.frombuffer(chunk, "<f4"))
        call("/v1/stream/<id>/close", f"/v1/stream/{sid}/close", b"")
        check(np.array_equal(np.concatenate(got), flo_torch.decode(streamed, device=DEVICE)),
              "service: decoder session != decode")
        status, _, page = call("GET /demo", "/demo")
        check(status == 200 and b"<title>flo_torch demo</title>" in page, "service: /demo")
        status, _, ver = call("GET /v1/version", "/v1/version")
        check(status == 200 and json.loads(ver)["version"] == flo_torch.version(), "/v1/version")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    log(f"[7 service] {len(pcm) / 1e6:.1f} MB of float32 PCM: /v1/encode -> /v1/decode "
        f"bit-exact; /v1/encode_transform -> /v1/decode within one i16 step of flo_torch.decode; "
        f"/v1/decode_frame, /v1/seek, /v1/analysis as the library; encoder session "
        f"({laps['/v1/stream/<id>/push'][1]} pushes) == StreamingEncoder's bytes, decoder "
        f"session ({laps['/v1/stream/<id>/feed'][1]} feeds of 64 KB) == decode; /demo and "
        f"/v1/version answer [{gpu}]")
    for what, (t, n) in laps.items():
        log(f"[7 service] {what}: {t:.3f} s" + (f" for {n} requests" if n > 1 else "")
            + f" [{gpu}]")


def phase_sharding(gpu: str, clips, encoded) -> None:
    """(c) The headline clips over a mesh of every card and over two shards
    of cuda:0, against phase 5's unsharded bytes; the graft entry points."""
    from flo_torch import graft_entry
    from flo_torch.container import reader
    from flo_torch.lossless import decoder, encoder
    from flo_torch.lossy import decoder as ldec
    from flo_torch.lossy import encoder as lenc
    from flo_torch.lossy.presets import QUALITY_U8_TO_F32
    from flo_torch.parallel import pipeline

    mods = kernel_modules()
    meshes = {"every card": pipeline.device_mesh(),
              "two shards of cuda:0": pipeline.device_mesh([f"{DEVICE}:0"] * 2)}
    n_chunks = len(encoder._chunk_bounds(FILES * SECONDS, FILES * SECONDS * CHANNELS * RATE))
    flos = [reader.read(b) for b in encoded]
    wants = [convert_round_trip(c) for c in clips]
    for what, mesh in meshes.items():
        before = {name: m.LAUNCHES for name, m in mods.items()}
        t0 = time.perf_counter()
        sharded = encoder.encode_many(clips, RATE, CHANNELS, 16, 5, mesh=mesh)
        enc_s = time.perf_counter() - t0
        check(sharded == encoded, f"sharded encode_many ({what}) != phase 5's bytes")
        for name in ("lossless_select", "rice_pack"):
            n = mods[name].LAUNCHES - before[name]
            check(n == mesh.size * n_chunks, f"{name}: {n} launches over {what}, "
                  f"{mesh.size} shards x {n_chunks} chunks expected")
        t0 = time.perf_counter()
        outs = decoder.decode_many(flos, mesh=mesh)
        dec_s = time.perf_counter() - t0
        check(all(np.array_equal(o, w) for o, w in zip(outs, wants)),
              f"sharded decode_many ({what}) not bit-exact")
        log(f"[7 mesh] {what} ({mesh.size} shard{'s' if mesh.size > 1 else ''}): encode_many "
            f"(analysis=device) == phase 5's bytes in {enc_s:.3f} s, {mesh.size} x {n_chunks} "
            f"search and pack launches; decode_many bit-exact in {dec_s:.3f} s [{gpu}]")

    two = meshes["two shards of cuda:0"]
    q = QUALITY_U8_TO_F32[LOSSY_QUALITY]
    plain_bytes = lenc.encode_many(clips, RATE, CHANNELS, q, transport_dtype="packed",
                                   device=DEVICE)
    t0 = time.perf_counter()
    shard_bytes = lenc.encode_many(clips, RATE, CHANNELS, q, transport_dtype="packed", mesh=two)
    enc_s = time.perf_counter() - t0
    ref_out = ldec.decode_many([reader.read(b) for b in plain_bytes], device=DEVICE)
    t0 = time.perf_counter()
    shd_out = ldec.decode_many([reader.read(b) for b in shard_bytes], mesh=two)
    dec_s = time.perf_counter() - t0
    worst = 0.0
    for a, b in zip(shd_out, ref_out):
        check(a.shape == b.shape, "sharded lossy decode length")
        worst = max(worst, float(np.abs(a - b).max()) / float(I16_STEP))
    check(worst <= 1.5, f"sharded lossy round trip {worst:.3f} i16 steps from unsharded")
    same = "equal" if shard_bytes == plain_bytes else "NOT equal"
    log(f"[7 mesh] lossy quality {LOSSY_QUALITY}, packed, two shards of cuda:0: encode "
        f"{enc_s:.3f} s, decode {dec_s:.3f} s; bytes {same} to unsharded, decodes "
        f"{worst:.3f} i16 steps apart at most (limit 1.5) [{gpu}]")

    fn, args = graft_entry.entry()
    residuals, size, qb, sf = fn(*args)
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    cpu = cpu_fn(*cpu_args)
    check(torch.equal(residuals.cpu(), cpu[0]) and torch.equal(size.cpu(), cpu[1])
          and qb.shape == (2, 4, 1024) and bool(sf.isfinite().all()),
          "graft_entry.entry() on the card: residuals / sizes != the CPU's")
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(1)
    graft_entry.dryrun_multichip(2, devices=[f"{DEVICE}:0"] * 2)
    dry_s = time.perf_counter() - t0
    log(f"[7 mesh] graft_entry.entry() on the card: residuals and sizes == the CPU's, q "
        f"{int((qb.cpu() != cpu[2]).sum())} of {qb.numel()} apart from the CPU's; "
        f"dryrun_multichip(1) and dryrun_multichip(2, [cuda:0, cuda:0]) pass in {dry_s:.3f} s "
        f"[{gpu}]")


def convert_round_trip(clip: np.ndarray) -> np.ndarray:
    """What a lossless round trip of ``clip`` decodes to: f32 -> i32 -> f32."""
    from flo_torch.core import convert

    return convert.i32_to_f32(convert.f32_to_i32(torch.from_numpy(clip))).numpy()


def phase_surfaces(gpu: str, clips, encoded) -> dict:
    """Phase 7: the CLI, the HTTP service and lane sharding on the card, on
    phase 5's clips; returns each kernel's launches in the phase."""
    mods = kernel_modules()
    restore, plain_calls = plain_loop_guard()
    torch.cuda.synchronize()
    for m in mods.values():
        m.LAUNCHES = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            want = convert_round_trip(clips[0])
            phase_cli(gpu, clips[0], pathlib.Path(tmp), want)
            phase_service(gpu, clips[0], want)
        phase_sharding(gpu, clips, encoded)
        check(not plain_calls, f"a plain version ran on the card: {plain_calls}")
    finally:
        restore()
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    for name, n in launches.items():
        check(n > 0, f"phase 7 never launched {name}")
    log(f"[7] launches in phase 7 {launches}, plain versions on the card 0")
    return launches


def phase_bench(gpu: str) -> dict:
    """Phase 8: bench_torch.py's quick geometry on the card, in-process;
    returns each kernel's launches in the phase."""
    import bench_torch

    mods = kernel_modules()
    restore, plain_calls = plain_loop_guard()
    torch.cuda.synchronize()
    for m in mods.values():
        m.LAUNCHES = 0
    printed: list[str] = []
    t0 = time.perf_counter()
    try:
        bench_torch.run(DEVICE, bench_torch.QUICK, emit=lambda obj: printed.append(json.dumps(obj)))
        check(not plain_calls, f"a plain version ran on the card: {plain_calls}")
    finally:
        restore()
    wall = time.perf_counter() - t0
    lines = [json.loads(line) for line in printed]
    cfgs = {line["config"]: line for line in lines if "config" in line}
    check(list(cfgs) == list(bench_torch.CONFIGS), f"bench configs {list(cfgs)}")
    skipped = [name for name, rec in cfgs.items() if "skipped" in rec]
    check(not skipped, f"bench skipped {skipped}")
    summary, result = lines[-1], lines[-2]
    n_corpus = len(bench_torch.QUICK.corpus)
    check(summary.get("summary") is True
          and summary["corpus_bit_exact"] == f"{n_corpus}/{n_corpus}"
          and result["device"]["name"] == torch.cuda.get_device_name(0),
          f"bench summary {summary}")
    check(cfgs["mesh_lossless_l5"]["equal_to_unsharded"] is True, "bench mesh != unsharded")
    for name in ("device_kernels", "device_reconstruct", "device_decode", "device_mdct"):
        check(cfgs[name]["ms"] > 0 and cfgs[name]["roofline"]["bound_ms"] > 0,
              f"bench {name}: {cfgs[name]}")
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    for name, n in launches.items():
        check(n > 0, f"phase 8 never launched {name}")
    log(f"[8 bench] bench_torch --quick on the card: {len(lines)} lines parsed, the headline "
        f"and {len(cfgs)} configs, corpus {summary['corpus_bit_exact']}, mesh equal to "
        f"unsharded, device configs "
        + ", ".join(f"{n} {cfgs[n]['ms']:.4f} ms" for n in
                    ("device_kernels", "device_reconstruct", "device_decode", "device_mdct"))
        + f" (quick shapes); {wall:.1f} s; launches {launches}, plain versions on the card 0 "
        f"[{gpu}]")
    return launches


KERNELS = {
    "lpc_reconstruct": ("flo_torch/csrc/lpc_reconstruct.cu", "flo_tpu/ops/pallas_lpc.py:52"),
    "lossless_select": ("flo_torch/csrc/lossless_select.cu", "flo_tpu/ops/select.py:187"),
    "rice_pack": ("flo_torch/csrc/rice_pack.cu", "flo_tpu/ops/blockspread.py:647"),
    "temporal_mask": ("flo_torch/csrc/temporal_mask.cu", "flo_tpu/ops/psycho.py:126"),
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
    measured["temporal_mask"] = phase_kernel_temporal(gpu)
    phase_corpus(gpu)
    launches, encoded = phase_main_path(gpu, clips)
    launches.update(phase_lossy_path(gpu, clips))
    api_launches = phase_api(gpu, clips[0])
    surface_launches = phase_surfaces(gpu, clips, encoded)
    bench_launches = phase_bench(gpu)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "launches_api_phase": api_launches[name],
         "launches_phase7": surface_launches[name], "launches_phase8": bench_launches[name],
         **measured[name],
         "share_of_bound": measured[name]["bound_ms"] / measured[name]["ms"],
         "library_ms": None}
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
