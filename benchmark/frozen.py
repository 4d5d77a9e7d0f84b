"""The benchmark's frozen yardstick: the H100's rates and the kernels' work
formulas.

Each piece is a copy, frozen here so that a change to the program cannot
move the yardstick it is measured with:

- ``HBM_BYTES_PER_S``, ``INT_OPS_PER_S``, ``F32_OPS_PER_S`` and ``bound``:
  copied from ``chip_smoke.py`` at commit 265a410. The integer rate is
  derived from the SM count (132 SMs x 64 int32 lanes x 1.98 GHz, a
  multiply-add counted as one operation): the data sheet gives no integer
  rate outside the tensor cores.
- ``lpc_work``, ``select_work``, ``pack_work``: ``chip_smoke.py``'s formulas
  at commit 265a410, restated over counts that the stream and the format give
  (a lane's predictor order, its samples, its packed bytes, the candidate plan
  of a level) instead of the program's tensors, so that a later kernel that
  replaces one of these is held to the same count.

Numpy only: nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, the data sheet's rate


def bound(nbytes: float, ops: float, ops_per_s: float = INT_OPS_PER_S):
    """The least time in ms the card could take for this work, and what bounds
    it: (ms, "bytes" | "operations")."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# --- Work formulas -----------------------------------------------------------

#: A lossless level's largest LPC order (the format's lossless/encoder.rs:289-302).
MAX_ORDER_BY_LEVEL = {0: 0, 1: 2, 2: 4, 3: 4, 4: 6, 5: 8, 6: 8, 7: 10, 8: 12, 9: 12}


def lane_counts(f):
    """(samples [L], predictor order [L], payload bytes [L]) of the
    non-silent lanes of a lossless file parsed by ``reference.container``:
    what the work formulas below count, read from the stream."""
    samples, orders, nbytes = [], [], []
    for fr in f.frames:
        if fr.ftype == 0:  # silence: no lane
            continue
        for ch in fr.channels:
            samples.append(fr.samples)
            orders.append(ch.order if ch.kind in ("lpc", "fixed") else 0)
            nbytes.append(len(ch.payload))
    return np.array(samples, np.int64), np.array(orders, np.int64), np.array(nbytes, np.int64)


#: Bytes of a reconstruction lane's tables: 12 int32 taps, int32 shift and
#: order, a bool for "fixed".
_LPC_TABLE_BYTES = 12 * 4 + 4 + 4 + 1


def lpc_work(lane_samples, taps):
    """Reconstruction's (bytes, operations): int32 residuals and the lane
    tables in, int32 samples out; a sample takes its lane's taps, a shift and
    an add. ``lane_samples`` [L] the samples of each lane's row, ``taps`` [L]
    the predictor order the stream gives the lane (0 for raw and silent)."""
    n = np.asarray(lane_samples, np.int64)
    taps = np.asarray(taps, np.int64)
    return 8 * int(n.sum()) + _LPC_TABLE_BYTES * len(n), int((n * (taps + 2)).sum())


#: Integer operations a candidate's statistics take a sample: pass 1 |r|,
#: max and sum; pass 2 the zigzag (2), the shift by k, the min and the sum.
STAT_OPS = 8


def candidate_plan(level: int, max_order: int):
    """The candidates of a lossless level as the format defines them, in
    evaluation order: raw, fixed orders 0..min(4, max_order), and from level
    3 on LPC orders 5..max_order. Returns (is_lpc, orders)."""
    is_lpc, orders = [False], [0]
    for o in range(0, min(4, max_order) + 1):
        is_lpc.append(False)
        orders.append(o)
    if level >= 3 and max_order > 4:
        for o in range(5, max_order + 1):
            is_lpc.append(True)
            orders.append(o)
    return tuple(is_lpc), tuple(orders)


def select_work(lanes: int, row_samples: int, valid_samples: int, is_lpc, orders):
    """Candidate search's (bytes, operations): int32 lane rows, int32 valid
    counts and the candidate tables (12 int32 taps, int32 shift and order, two
    bools a candidate) in; three int32 scalars, the int32 residual rows, 12
    int32 taps and an int32 shift a lane out. A valid sample takes every LPC
    candidate's taps and its shift and subtract, a difference per fixed order
    past 0, and every candidate's statistics."""
    nc = len(is_lpc)
    nfix = sum(1 for f in is_lpc if not f) - 1
    lpc_taps = sum(o for f, o in zip(is_lpc, orders) if f)
    per_sample = lpc_taps + 2 * sum(is_lpc) + max(nfix - 1, 0) + STAT_OPS * (nc - 1)
    nbytes = lanes * (8 * row_samples + 4 + nc * (12 * 4 + 4 + 4 + 2) + 3 * 4 + 12 * 4 + 4)
    return nbytes, int(valid_samples) * per_sample


def pack_work(lanes: int, row_samples: int, lane_bytes):
    """Rice pack's (bytes, operations): the int32 residual rows and three lane
    scalars (int32 k and count, a bool) in, each lane's packed bytes (in whole
    32-bit words) and 16 bytes of lane sizes and offsets out; bytes bound it
    (a code is a few operations, counted as none)."""
    words = (np.asarray(lane_bytes, np.int64) + 3) // 4
    return lanes * (4 * row_samples + 9) + 4 * int(words.sum()) + 16 * lanes, 0


def temporal_mask_work(rows_hops):
    """The temporal-masking scan's (bytes, operations): [rows, hops, 25]
    float32 levels in and thresholds out for each of ``rows_hops`` (a lane's
    hops); a value takes a multiply and a max."""
    values = 25 * int(np.sum(np.asarray(rows_hops, np.int64)))
    return 8 * values, 2 * values
