"""flo_torch's nonzero compaction against flo_tpu's, on the CPU.

Integer code: everything is exact. flo_tpu's ``compact_nonzeros`` returns a
buffer of R*W entries whose prefix holds the nonzeros; the port returns that
prefix alone (one ``torch.nonzero``). ``expand_nonzeros`` gives the same
dense rows.
"""

import numpy as np
import pytest
import torch

from flo_torch.ops import compact
from flo_tpu.ops import compact as tpu_compact


def _rows(name):
    rng = np.random.default_rng(5)
    if name == "random":
        q = rng.integers(-300, 300, (12, 1024)).astype(np.int16)
        q[rng.random(q.shape) < 0.9] = 0
    elif name == "empty rows":
        q = rng.integers(-5, 6, (9, 1024)).astype(np.int16)
        q[rng.random(q.shape) < 0.7] = 0
        q[[0, 3, 4, 8]] = 0
    elif name == "all zero":
        q = np.zeros((4, 1024), np.int16)
    elif name == "extremes":
        q = np.zeros((3, 1024), np.int16)
        q[0, 0], q[0, 1023], q[1, 1023], q[2, 512] = -32768, 32767, -32768, -1
    elif name == "dense":
        q = rng.integers(1, 100, (2, 1024)).astype(np.int16)
    else:  # "narrow": another width
        q = rng.integers(-3, 4, (7, 128)).astype(np.int16)
    return q


CASES = ["random", "empty rows", "all zero", "extremes", "dense", "narrow"]


@pytest.mark.parametrize("name", CASES)
def test_compact_nonzeros_equals_reference_prefix(name):
    q = _rows(name)
    entries, row_nnz = compact.compact_nonzeros(torch.from_numpy(q))
    ref_entries, ref_nnz = (np.asarray(a) for a in tpu_compact.compact_nonzeros(q))
    assert entries.dtype == torch.int32 and row_nnz.dtype == torch.int32
    total = int(ref_nnz.sum())
    assert entries.shape == (total,)
    assert np.array_equal(row_nnz.numpy(), ref_nnz)
    assert np.array_equal(entries.numpy(), ref_entries[:total])
    assert not ref_entries[total:].any()
    cols, vals = compact.split_entries(entries.numpy())
    rid, cid = np.nonzero(q)
    assert np.array_equal(cols, cid) and np.array_equal(vals, q[rid, cid])
    assert np.array_equal(compact.make_entries(cols, vals), entries.numpy())


@pytest.mark.parametrize("name", CASES)
def test_expand_nonzeros_equals_reference_and_round_trips(name):
    q = _rows(name)
    R, W = q.shape
    entries, row_nnz = compact.compact_nonzeros(torch.from_numpy(q))
    dense = compact.expand_nonzeros(entries, row_nnz, R, W)
    assert dense.dtype == torch.int32 and dense.shape == (R, W)
    assert np.array_equal(dense.numpy(), q.astype(np.int32))
    padded = tpu_compact.pad_entries(entries.numpy(), bucket=1 << 12)
    ref = tpu_compact.expand_nonzeros(
        padded, row_nnz.numpy(), np.int32(entries.numel()), R, W
    )
    assert np.array_equal(dense.numpy(), np.asarray(ref))


def test_int32_input_and_empty_tensor():
    q = torch.tensor([[0, 70000, 0, -5]], dtype=torch.int32)  # only the low 16 bits travel
    entries, row_nnz = compact.compact_nonzeros(q)
    assert entries.tolist() == [(1 << 16) | (70000 & 0xFFFF), (3 << 16) | 0xFFFB]
    assert row_nnz.tolist() == [2]
    none, nnz = compact.compact_nonzeros(torch.zeros((0, 1024), dtype=torch.int16))
    assert none.shape == (0,) and nnz.shape == (0,)
    assert compact.expand_nonzeros(none, nnz, 0, 1024).shape == (0, 1024)
    empty = compact.expand_nonzeros(none, torch.zeros(5, dtype=torch.int32), 5, 1024)
    assert empty.shape == (5, 1024) and not empty.any()


def test_host_helpers_equal_reference():
    e = np.random.default_rng(2).integers(-(1 << 31), 1 << 31, 500).astype(np.int32) & 0x03FFFFFF
    for a, b in zip(compact.split_entries(e), tpu_compact.split_entries(e)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    cols, vals = compact.split_entries(e)
    assert np.array_equal(compact.make_entries(cols, vals), tpu_compact.make_entries(cols, vals))
