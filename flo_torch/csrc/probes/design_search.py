#!/usr/bin/env python3
"""The design search of the four hand-written kernels (LPC reconstruction,
candidate search, Rice pack, temporal-masking scan), on one CUDA card.

    python3 flo_torch/csrc/probes/design_search.py [lpc] [select] [pack] [scan]

from the repository root; with no argument all four parts run. Builds
``lpc_designs.cu``, ``select_designs.cu``, ``pack_designs.cu`` and
``scan_designs.cu`` (every step
of each kernel's design search, one library each, with the port's nvcc flags,
into ``build/flo_torch/probes/``), checks every design equal to the plain
version on what it is timed on, then times the designs against each other
twice, in turns (A B .. B A after a warm-up, 10 launches each, CUDA events):

- the reconstruction on ``chip_smoke.mixed_lanes`` and on the main path's
  own lanes (the headline clips bulk-encoded at level 5) at [960, 44100],
  and on mixed lanes at four times the lanes;
- the search at [960, 44100] on the headline clips' exact tables at levels
  5 and 8;
- the pack at [960, 44100] on that search's winners (level 5) and on its
  first 480 lanes (the size of a chunk of the main path), every design with
  the worst-case buffer the main path gives it, with and without the
  search's byte counts as a hint; before that, the first packer (design 0)
  pass by pass, and the shipped wrapper with and without its word-count
  wait;
- the scan at [16, 2585, 25] (the headline's lanes and hops) and at
  [8, 2585, 25] (a chunk of the main path), each design equal to the plain
  loop there, at [3, 7, 25] on an input with NaN and on every case of
  ``cuda_psycho.scan_cases`` (one of them, a loud hop followed by silence,
  is timed too: the segmented designs' slow side); its cuts (a part left
  out) are timed only. Each time is given twice over: as called from Python
  (CUDA events around 50 calls, which for a kernel of a few microseconds is
  the rate the host can launch at) and on the card alone (a CUDA graph of 20
  launches, replayed).

Prints a line for each design and input, with the card's name and power
limit. The port ships design 4 of the reconstruction
(``csrc/lpc_reconstruct.cu``), design 2 of the search
(``csrc/lossless_select.cu``), one design of the pack
(``csrc/rice_pack.cu``, whose header names it) and one of the scan
(``csrc/temporal_mask.cu``; ``SCAN_DESIGNS`` marks it); this script is not
part of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from flo_torch.ops import _build  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
OUT_DIR = _build.BUILD_DIR / "probes"

#: lpc_designs.cu's kDesigns, in order: (what the step adds, lanes a CTA,
#: samples of all a CTA's lanes in one stage).
LPC_DESIGNS = (
    ("tile staging, first step (12 taps, oldest first, C++ multiply)", 32, 8192),
    ("+ one mad.wide.s32 a tap", 32, 8192),
    ("+ newest tap alone on the chain (12 taps)", 32, 8192),
    ("+ lane classes", 32, 8192),
    ("+ 8 lanes a CTA (one CTA an SM): shipped", 8, 8192),
    ("+ a quarter of the stage (four CTAs an SM)", 8, 2048),
    ("+ shared-memory reads two groups ahead", 8, 2048),
    ("+ rolling sums in place of the tree", 8, 2048),
    ("rolling sums without the reads ahead", 8, 2048),
    ("design 5, a lane's older taps over 4 threads", 8, 2048),
)
#: select_designs.cu's kDesigns, in order.
SELECT_DESIGNS = (
    "general kernel: strided samples from L1/L2, 12 taps every candidate",
    "lane streamed through shared memory, per-plan taps, 256 threads",
    "lane streamed through shared memory, per-plan taps, 128 threads: shipped",
)
#: scan_designs.cu's designs, in order: (what it is, whether it computes the
#: scan: a cut leaves a part out and is only timed).
SCAN_DESIGNS = (
    ("a thread a chain, 32 hops of loads in flight in registers, NaN rule on the chain", True),
    ("a block a lane, tiles of 128 hops through shared memory, NaN off the chain", True),
    ("+ a tile's 128 chain inputs taken into registers first: the first kernel shipped", True),
    ("tiles of 32 hops, one warp a block", True),
    ("cut: tiles of 128 hops without the chain", False),
    ("cut: tiles of 128 hops without the global loads and stores", False),
    ("segmented, two chains over a window: chunks of 32 hops, warm window 384", True),
    ("segmented: chunks of 64 hops, warm window 384", True),
    ("segmented: chunks of 128 hops, warm window 320: shipped", True),
    ("segmented: chunks of 64 hops, 128 threads", True),
    ("cut: the segmented scan's facts kernel alone", False),
    ("cut: the segmented scan's second kernel alone, on facts left by a run before", False),
)


def build(name: str) -> ctypes.CDLL:
    src = HERE / f"{name}.cu"
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    out = OUT_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not out.is_file():
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, str(src), "-o", str(out)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out))


def lpc_launcher(lib):
    lib.flo_lpc_reconstruct.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
    )

    def run(design, residuals, coeffs, shifts, orders, is_fixed):
        L, S = residuals.shape
        smoke.check(S % 4 == 0, "the design search takes rows of whole 16-byte chunks")
        res = residuals if residuals.data_ptr() % 16 == 0 else residuals.clone()
        out = torch.empty_like(res)
        work = torch.empty(L + 11, dtype=torch.int32, device=res.device)
        rc = lib.flo_lpc_reconstruct(
            res.data_ptr(), coeffs.data_ptr(), shifts.data_ptr(), orders.data_ptr(),
            is_fixed.data_ptr(), work.data_ptr(), out.data_ptr(), L, S, design,
            torch.cuda.current_stream().cuda_stream,
        )
        smoke.check(rc == 0, f"lpc design {design}: CUDA error {rc}")
        return out

    return run


def select_launcher(lib):
    lib.flo_lossless_select.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_uint32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int32, ctypes.c_void_p]
    )

    def run(design, lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok,
            is_lpc):
        L, S = lanes.shape
        smoke.check(S % 4 == 0 and lanes.data_ptr() % 16 == 0, "rows of whole 16-byte chunks")
        outs = [torch.empty(L, dtype=torch.int32, device=lanes.device) for _ in range(3)]
        residuals = torch.empty_like(lanes)
        win_coeffs = torch.empty((L, 12), dtype=torch.int32, device=lanes.device)
        win_shift = torch.empty(L, dtype=torch.int32, device=lanes.device)
        rc = lib.flo_lossless_select(
            lanes.data_ptr(), nvalid.data_ptr(), coeffs_all.data_ptr(), shifts_all.data_ptr(),
            orders_all.data_ptr(), fixed_all.data_ptr(), cand_ok.data_ptr(),
            sum(1 << c for c, f in enumerate(is_lpc) if f), len(is_lpc), L, S, S,
            *(o.data_ptr() for o in outs), residuals.data_ptr(), win_coeffs.data_ptr(),
            win_shift.data_ptr(), design, torch.cuda.current_stream().cuda_stream,
        )
        smoke.check(rc == 0, f"select design {design}: CUDA error {rc}")
        return (*outs, residuals, win_coeffs, win_shift)

    return run


#: pack_designs.cu's designs, in order.
PACK_DESIGNS = (
    "first packer: a bit offset a sample, global atomicOr into a zeroed buffer, byte-order pass",
    "count + tile pack, codes ORed into a shared-memory window with shared atomics",
    "count + tile pack, a thread's 8 codes concatenated in a register",
    "count + tile pack, a thread an output word (binary search of the offsets, no atomics)",
    "design 2 with aligned 16-byte loads into registers, a code made once, pairs of codes, "
    "two windows in turn; 256 threads of 8 samples",
    "the same with 128 threads of 16 samples",
    "the same with 128 threads of 8 samples",
    "design 6 with no branch in a code's step (predicated shared atomicOr, no pairs), "
    "registers capped for 8 blocks of 128 threads an SM",
    "the same with 4 blocks of 256 threads an SM",
    "the same with 256 threads and no cap on the registers",
    "design 8 with plain stores for all but a thread's first and last word (two atomics a "
    "thread and tile, issued by whole warps)",
    "the same, and no atomic and no zeroed window in a tile whose threads all have 32 bits "
    "or more",
    "the same with 128 threads of 16 samples, 5 blocks an SM",
    "design 11 with fewer instructions a code (no per-sample bounds inside the lane, long "
    "codes' fields pinned in their branch, shuffle scan, every leaving word a plain store)",
    "the same with registers capped for 5 blocks of 256 threads an SM",
    "the same with 8 blocks of 128 threads an SM",
    "the same with 128 threads of 16 samples, 4 blocks an SM",
    "the same with 256 threads of 16 samples, 2 blocks an SM",
    "the same with 512 threads of 8 samples, 2 blocks an SM",
)


def pack_launcher(lib):
    """(run, pieces): ``run(design, residuals, k, nvalid, is_raw, max_words,
    hint)`` packs as ``pack_lanes_cuda`` does, by one design; ``pieces`` are
    the library's entry points by name, for timing a pass alone."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    pieces = {
        "d0_lengths": (lib.flo_pack_d0_lengths, [ptr] * 6 + [i64, i64, ptr]),
        "d0_scatter": (lib.flo_pack_d0_scatter, [ptr] * 7 + [i64] * 3 + [ptr]),
        "d0_byteswap": (lib.flo_pack_d0_byteswap, [ptr, i64, ptr]),
        "count": (lib.flo_pack_count, [ptr] * 5 + [i64, i64, ptr]),
        "layout": (lib.flo_pack_layout, [ptr, ptr, i64, ptr, ptr, ptr, ptr]),
        "pack": (lib.flo_pack_pack, [ctypes.c_int32] + [ptr] * 8 + [i64] * 3 + [ptr]),
    }

    def bind(name):
        fn, argtypes = pieces[name]
        fn.argtypes, fn.restype = argtypes, ctypes.c_int

        def call(*args):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            smoke.check(rc == 0, f"pack_designs {name}: CUDA error {rc}")

        return call

    calls = {name: bind(name) for name in pieces}

    def run(design, residuals, k, nvalid, is_raw, max_words=None, hint=None):
        from flo_torch.ops import blockspread

        L, S = residuals.shape
        dev = residuals.device
        lanes = [t.data_ptr() for t in (residuals, k, nvalid, is_raw)]
        if design == 0:
            bitoff = torch.empty((L, S), dtype=torch.int32, device=dev)
            lane_bits = torch.zeros(L, dtype=torch.int64, device=dev)
            calls["d0_lengths"](*lanes, bitoff.data_ptr(), lane_bits.data_ptr(), L, S)
            lane_bytes, lane_woff, lane_words = blockspread.lane_layout(lane_bits)
            nw = int(lane_words.sum()) if max_words is None else int(max_words)
            words = torch.zeros(nw, dtype=torch.int32, device=dev)
            calls["d0_scatter"](*lanes, bitoff.data_ptr(), lane_woff.data_ptr(),
                                words.data_ptr(), L, S, nw)
            calls["d0_byteswap"](words.data_ptr(), nw)
            return words.view(torch.uint8), lane_bytes, lane_woff * 4
        # lane bits, byte offsets, spans in words, bytes, and the word total
        meta = torch.empty(4 * L + 1, dtype=torch.int64, device=dev)
        bits, off, span, nbytes = (meta[i * L : (i + 1) * L] for i in range(4))
        if hint is None:
            calls["count"](*lanes, bits.data_ptr(), L, S)
        calls["layout"](bits.data_ptr(), None if hint is None else hint.data_ptr(), L,
                        off.data_ptr(), span.data_ptr(), meta[4 * L :].data_ptr())
        nw = int(meta[4 * L]) if max_words is None else int(max_words)
        words = torch.empty(nw, dtype=torch.int32, device=dev)
        calls["pack"](design, *lanes, off.data_ptr(), span.data_ptr(), words.data_ptr(),
                      nbytes.data_ptr(), L, S, nw)
        return words.view(torch.uint8), nbytes, off

    return run, calls


def time_in_turns(fns: dict, iters: int = 10) -> dict:
    """Each function timed twice, in the order A B .. B A, after a warm-up:
    {name: [first, second]} in ms."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(smoke.time_ms(fns[name], iters))
    return times


def main_path_lanes(clips):
    """The decoder's lanes of the headline clips bulk-encoded at level 5."""
    from flo_torch.container import reader
    from flo_torch.lossless import decoder, encoder

    encoded = encoder.encode_many(clips, smoke.RATE, smoke.CHANNELS, 16, 5, device=smoke.DEVICE)
    marshaled = [(i, decoder._marshal_lanes(reader.read(b))) for i, b in enumerate(encoded)]
    return decoder.lanes_to_device(*decoder._concat_group(marshaled), device=smoke.DEVICE)[:5]


def search_lpc(gpu: str, clips) -> None:
    from flo_torch.ops import lpc

    lib = build("lpc_designs")
    run_lpc = lpc_launcher(lib)
    smoke.check(lib.flo_lpc_designs() == len(LPC_DESIGNS), "lpc design count")
    L, S = smoke.KERNEL_SHAPES[0]
    inputs = {"mixed": smoke.lpc_case(L + S, L, S), "main path": list(main_path_lanes(clips)),
              "mixed x4": smoke.lpc_case(7, 4 * L, S)}
    for what, args in inputs.items():
        want = lpc.reconstruct(*args)
        fns = {}
        for d in range(len(LPC_DESIGNS)):
            smoke.check(torch.equal(run_lpc(d, *args), want), f"lpc design {d} != plain on {what}")
            fns[d] = lambda d=d: run_lpc(d, *args)
        for d, ms in time_in_turns(fns).items():
            smoke.log(f"[design] lpc_reconstruct {what} [{args[0].shape[0]}, {S}] design {d} "
                      f"({LPC_DESIGNS[d][0]}): {ms[0]:.4f} / {ms[1]:.4f} ms [{gpu}]")
        del want


def search_select(gpu: str, clips) -> None:
    from flo_torch.ops import select

    lib = build("select_designs")
    run_select = select_launcher(lib)
    smoke.check(lib.flo_select_designs() == len(SELECT_DESIGNS), "select design count")
    L, S = smoke.KERNEL_SHAPES[0]
    for level in (5, 8):
        args, is_lpc = smoke.headline_search_inputs(clips, level)
        want = select.encode_select_step(*args, is_lpc)
        fns = {}
        for d in range(len(SELECT_DESIGNS)):
            smoke.equal_outputs(run_select(d, *args, is_lpc), want,
                                f"select design {d} level {level}")
            fns[d] = lambda d=d: run_select(d, *args, is_lpc)
        for d, ms in time_in_turns(fns).items():
            smoke.log(f"[design] lossless_select level {level} [{L}, {S}] design {d} "
                      f"({SELECT_DESIGNS[d]}): {ms[0]:.4f} / {ms[1]:.4f} ms [{gpu}]")


def host_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the host clock, the device idle before
    and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def split_first_packer(gpu: str, calls, pargs, max_words: int) -> None:
    """Design 0 pass by pass at the headline shape: each piece launched 20
    times in a row between two CUDA events, the word-count wait on the host
    clock."""
    from flo_torch.ops import blockspread

    residuals = pargs[0]
    L, S = residuals.shape
    dev = residuals.device
    lanes = [t.data_ptr() for t in pargs]
    bitoff = torch.empty((L, S), dtype=torch.int32, device=dev)
    lane_bits = torch.zeros(L, dtype=torch.int64, device=dev)

    def lengths():
        calls["d0_lengths"](*lanes, bitoff.data_ptr(), lane_bits.data_ptr(), L, S)

    lengths()
    lane_bytes, lane_woff, lane_words = blockspread.lane_layout(lane_bits)
    exact = int(lane_words.sum())
    parts = {
        "lengths_kernel": smoke.time_ms(lengths, 20),
        "lane_layout (5 torch ops)": smoke.time_ms(lambda: blockspread.lane_layout(lane_bits), 20),
        "int(lane_words.sum()), host clock": host_ms(lambda: int(lane_words.sum()), 20),
    }
    for what, nw in (("exact", exact), ("max_words", max_words)):
        words = torch.zeros(nw, dtype=torch.int32, device=dev)
        parts[f"torch.zeros, {what} ({4 * nw / 1e6:.1f} MB)"] = smoke.time_ms(
            lambda: torch.zeros(nw, dtype=torch.int32, device=dev), 20)
        parts[f"scatter_kernel, {what}"] = smoke.time_ms(
            lambda: calls["d0_scatter"](*lanes, bitoff.data_ptr(), lane_woff.data_ptr(),
                                        words.data_ptr(), L, S, nw), 20)
        parts[f"byteswap_kernel, {what}"] = smoke.time_ms(
            lambda: calls["d0_byteswap"](words.data_ptr(), nw), 20)
        del words
    for what, ms in parts.items():
        smoke.log(f"[split] first packer [{L}, {S}] {what}: {ms:.4f} ms [{gpu}]")


def search_pack(gpu: str, clips) -> None:
    from flo_torch.lossless import encoder
    from flo_torch.ops import blockspread, cuda_ricepack, cuda_select

    lib = build("pack_designs")
    run, calls = pack_launcher(lib)
    smoke.check(lib.flo_pack_designs() == len(PACK_DESIGNS), "pack design count")
    designs = range(len(PACK_DESIGNS))

    # Every design on the shapes a tiled packer is sensitive to: exact
    # buffer, the plain version's byte counts as a hint, and a buffer three
    # words short of the stream (the bytes that fit must still be right).
    small = {"ragged [37, 1537]": smoke.ragged_pack_case(11, 37, 1537),
             **cuda_ricepack.edge_cases(),
             "dense lane [8, 44100]": cuda_ricepack.dense_lane_case(5, 8, 44100)}
    for what, arrays in small.items():
        args = [torch.from_numpy(a).to(smoke.DEVICE) for a in arrays]
        want = blockspread.pack_lanes_words(*args)
        hint = want[1].to(torch.int32)
        short = max(want[0].numel() // 4 - 3, 0)
        for d in designs:
            smoke.equal_packed(run(d, *args), want, f"pack design {d} on {what}")
            got = run(d, *args, max_words=short)
            smoke.equal_outputs(got[1:], want[1:], f"pack design {d} on {what}, short buffer")
            smoke.check(torch.equal(got[0], want[0][: 4 * short]),
                        f"pack design {d} on {what}: short buffer's payload != plain")
            if d:
                smoke.equal_packed(run(d, *args, hint=hint), want, f"pack design {d} + hint on {what}")
    smoke.log(f"[design] rice_pack designs 0-{len(PACK_DESIGNS) - 1} == plain on "
              f"{', '.join(small)} (exact; also with a hint and with a short buffer) [{gpu}]")

    args, is_lpc = smoke.headline_search_inputs(clips)
    nvalid = args[1]
    sel, k, size, residuals, _, _ = cuda_select.encode_select_cuda(*args, is_lpc)
    del args
    is_raw = sel == 0
    L, S = residuals.shape
    for lanes in (L, L // 2):
        pargs = (residuals[:lanes], k[:lanes], nvalid[:lanes], is_raw[:lanes])
        hint = size[:lanes]
        max_words = encoder._max_words([S] * (lanes // smoke.CHANNELS), smoke.CHANNELS)
        want = blockspread.pack_lanes_words(*pargs)
        smoke.check(torch.equal(want[1], hint.to(torch.int64)), "search sizes != plain lane bytes")
        if lanes == L:
            split_first_packer(gpu, calls, pargs, max_words)
            ptrs = [t.data_ptr() for t in pargs]
            meta = torch.empty(4 * lanes + 1, dtype=torch.int64, device=residuals.device)
            bits, off, span, nbytes = (meta[i * lanes : (i + 1) * lanes] for i in range(4))
            words = torch.empty(max_words, dtype=torch.int32, device=residuals.device)
            pieces = {
                "count_kernel": lambda: calls["count"](*ptrs, bits.data_ptr(), lanes, S),
                "layout_kernel": lambda: calls["layout"](
                    bits.data_ptr(), None, lanes, off.data_ptr(), span.data_ptr(),
                    meta[4 * lanes :].data_ptr()),
            }
            for d in designs[1:]:
                pieces[f"pack_kernel of design {d}"] = lambda d=d: calls["pack"](
                    d, *ptrs, off.data_ptr(), span.data_ptr(), words.data_ptr(),
                    nbytes.data_ptr(), lanes, S, max_words)
            # Designs 2 and 8 with parts cut out (the words come out wrong):
            # what is left when the tile's assembly, its stores, and all
            # after the scan are gone.
            for d, cut in ((d, cut) for d in (2, 8) for cut in (1, 2, 3)):
                what = ("without the assembly", "without assembly and stores",
                        "loads, codes and scan only")[cut - 1]
                pieces[f"pack_kernel of design {d} {what}"] = lambda c=10 * d + cut: calls["pack"](
                    c, *ptrs, off.data_ptr(), span.data_ptr(), words.data_ptr(),
                    nbytes.data_ptr(), lanes, S, max_words)
            for what, fn in pieces.items():
                fn()
                smoke.log(f"[split] tile packers [{lanes}, {S}] {what}: "
                          f"{smoke.time_ms(fn, 20):.4f} ms [{gpu}]")
            del words, meta
        fns = {}
        for d in designs:
            smoke.equal_packed(run(d, *pargs), want, f"pack design {d} [{lanes}, {S}]")
            smoke.equal_packed(run(d, *pargs, max_words), want, f"pack design {d} [{lanes}, {S}]")
            fns[f"design {d}, worst-case buffer"] = lambda d=d: run(d, *pargs, max_words)
            if d:
                smoke.equal_packed(run(d, *pargs, max_words, hint), want,
                             f"pack design {d} + hint [{lanes}, {S}]")
                fns[f"design {d}, worst-case buffer, byte counts given"] = (
                    lambda d=d: run(d, *pargs, max_words, hint))
            fns[f"design {d}, exact buffer (waits for the word count)"] = (
                lambda d=d: run(d, *pargs))
        smoke.equal_packed(cuda_ricepack.pack_lanes_cuda(*pargs), want, "shipped pack")
        fns["shipped wrapper, worst-case buffer"] = (
            lambda: cuda_ricepack.pack_lanes_cuda(*pargs, max_words=max_words))
        fns["shipped wrapper, worst-case buffer, byte counts given"] = (
            lambda: cuda_ricepack.pack_lanes_cuda(*pargs, max_words=max_words, size_hint=hint))
        fns["shipped wrapper, exact buffer (waits)"] = lambda: cuda_ricepack.pack_lanes_cuda(*pargs)
        bound_ms, _ = smoke.pack_bound(pargs, want[0].numel())
        for what, ms in time_in_turns(fns, 20).items():
            smoke.log(f"[design] rice_pack [{lanes}, {S}] {what}: {ms[0]:.4f} / {ms[1]:.4f} ms "
                      f"(bound {bound_ms:.4f} ms) [{gpu}]")
        for d in designs:
            smoke.log(f"[design] rice_pack design {d}: {PACK_DESIGNS[d]}")
        del want


def search_scan(gpu: str, clips) -> None:
    from flo_torch.ops import cuda_psycho, psycho

    lib = build("scan_designs")
    lib.flo_scan_design.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_void_p]
    smoke.check(lib.flo_scan_designs() == len(SCAN_DESIGNS), "scan design count")

    scratch: dict = {}  # the segmented designs' facts, kept between runs for cut 11

    def run(design, masking):
        out = torch.empty_like(masking)
        R, T = masking.shape[:2]
        if (R, T) not in scratch:
            scratch[R, T] = torch.empty((R, -(-T // 32), 25), device=smoke.DEVICE)
        facts = scratch[R, T]
        rc = lib.flo_scan_design(masking.data_ptr(), out.data_ptr(), facts.data_ptr(), R, T,
                                 design, torch.cuda.current_stream().cuda_stream)
        smoke.check(rc == 0, f"scan design {design}: CUDA error {rc}")
        return out

    hops = -(-(smoke.SECONDS * smoke.RATE + 1024) // 1024)
    lanes = smoke.FILES * smoke.CHANNELS
    odd = smoke.masking_case(3, (3, 7, 25))
    odd[1, 2, 4] = float("nan")
    cases = {shape: torch.from_numpy(smoke.masking_case(sum(shape), shape)).to(smoke.DEVICE)
             for shape in ((lanes, hops, 25), (lanes // 2, hops, 25))}
    timed = set(cases) | {"+96 dB then 2,000 hops of -100 dB"}
    cases["[3, 7, 25] with NaN"] = torch.from_numpy(odd).to(smoke.DEVICE)
    for name, m in cuda_psycho.scan_cases():
        cases[name] = torch.from_numpy(m).to(smoke.DEVICE)
    for what, m in cases.items():
        want = psycho.temporal_mask_plain(m)
        fns = {}
        for d, (_, whole) in enumerate(SCAN_DESIGNS):
            if whole:
                smoke.bit_equal(run(d, m), want, f"scan design {d} at {what}")
            fns[d] = lambda d=d: run(d, m)
        if what not in timed:
            continue
        called = time_in_turns(fns, iters=50)
        for fn in fns.values():
            fn()
        alone = {d: [] for d in fns}
        for d in [*fns, *reversed(fns)]:  # the card's own time: a CUDA graph of 20 launches
            alone[d].append(smoke.graph_ms(fns[d]))
        for d, ms in called.items():
            smoke.log(f"[design] temporal_mask {list(m.shape)} design {d} ({SCAN_DESIGNS[d][0]}): "
                      f"{ms[0]:.4f} / {ms[1]:.4f} ms called from Python, "
                      f"{alone[d][0]:.4f} / {alone[d][1]:.4f} ms on the card alone [{gpu}]")


def main(argv) -> int:
    parts = {"lpc": search_lpc, "select": search_select, "pack": search_pack,
             "scan": search_scan}
    chosen = argv or list(parts)
    for name in chosen:
        if name not in parts:
            raise SystemExit(f"unknown part {name!r}: choose from {', '.join(parts)}")
    if not torch.cuda.is_available():
        raise smoke.SmokeFailure("no CUDA device: torch.cuda.is_available() is False")
    gpu = smoke.gpu_line()
    with ThreadPoolExecutor(len(chosen)) as pool:  # one nvcc a library, all started together
        list(pool.map(build, [f"{name}_designs" for name in chosen]))
    clips = smoke.headline_clips()
    for name in chosen:
        parts[name](gpu, clips)
    smoke.log(f"[design] every design equal to the plain version [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
