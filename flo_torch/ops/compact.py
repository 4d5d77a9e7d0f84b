"""Sparse coefficient transport: ship (column, value) pairs, not dense rows.

Quantized MDCT coefficients are mostly zeros (the psychoacoustic gate zeroes
them; lossy ratios are 2-30x). These helpers compact the nonzeros on the
device (encode: the host downloads 4 bytes a nonzero) and expand host-built
pairs back to dense rows on the device (decode: the host uploads 4 bytes a
nonzero).

Entry format: int32 ``(col << 16) | (value & 0xFFFF)``: col < 32768 keeps
the sign bit clear, values are i16. Entries are row-major (ascending column
within each row), so hosts split rows with one cumsum of row_nnz.

``torch.nonzero`` gives the nonzeros' indices already in that order, so the
compaction is one call; it waits for the device once, for the count.
"""

from __future__ import annotations

import numpy as np
import torch


def compact_nonzeros(q):
    """q [R, W] int16/int32 -> (entries int32 [total], row_nnz int32 [R]):
    the nonzeros in row-major order. Waits for the device (the count)."""
    R, W = q.shape
    flat = q.reshape(-1)
    pos = torch.nonzero(flat).squeeze(1)  # ascending: row-major order
    col = (pos % W).to(torch.int32)
    val = flat[pos].to(torch.int32)
    entries = (col << 16) | (val & 0xFFFF)
    row_nnz = torch.count_nonzero(q, dim=1).to(torch.int32)
    return entries, row_nnz


def split_entries(entries: np.ndarray):
    """Host-side: int32 entries -> (cols int32, vals int16)."""
    cols = (entries >> 16).astype(np.int32)
    vals = (entries & 0xFFFF).astype(np.uint16).view(np.int16)
    return cols, vals


def make_entries(cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Host-side inverse of split_entries."""
    return (cols.astype(np.int32) << 16) | (
        vals.astype(np.int16).view(np.uint16).astype(np.int32)
    )


def expand_nonzeros(entries, row_nnz, R: int, W: int):
    """Rebuild dense [R, W] int32 rows from row-major entries.

    entries: [total] int32, total = row_nnz.sum(); row_nnz: [R] integer, on
    the same device. Rows may be empty, and so may ``entries``.
    """
    total = entries.numel()
    dense = torch.zeros(R * W, dtype=torch.int32, device=entries.device)
    if total:
        rows = torch.arange(R, dtype=torch.int64, device=entries.device)
        row_id = torch.repeat_interleave(rows, row_nnz.to(torch.int64), output_size=total)
        col = entries >> 16
        val = (entries << 16) >> 16  # sign-extended low 16 bits
        dense[row_id * W + col] = val
    return dense.reshape(R, W)
