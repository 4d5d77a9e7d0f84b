"""flo_torch's Rice / raw-LE16 pack against the host coder and flo_tpu's packer,
on the CPU. Every comparison is exact (bytes)."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from flo_tpu.ops import blockspread as tpu_blockspread
from flo_torch._flo_host.core import rice_host
from flo_torch.ops import blockspread, cuda_ricepack


def _case(seed, L=14, S=600):
    """Small residuals at every k; k = 0 lanes of full-range and +-2**20
    residuals and a k = 15 lane of +-2**30 ones (codes of 256-271 bits); raw
    lanes past int16 (the LE16 wrap); an empty lane; lanes ending mid-word."""
    rng = np.random.default_rng(seed)
    res = rng.integers(-3000, 3000, (L, S)).astype(np.int32)
    k = rng.integers(0, 16, L).astype(np.int32)
    nvalid = rng.integers(0, S + 1, L).astype(np.int32)
    is_raw = np.zeros(L, bool)
    res[2] = rng.integers(-(1 << 31), 1 << 31, S, dtype=np.int64).astype(np.int32)
    res[3] = -(1 << 31)
    res[4, ::3] = rng.integers(-(1 << 20), 1 << 20, len(res[4, ::3]))
    res[10] = rng.choice([-(1 << 30), 1 << 30], S)
    k[[2, 3, 4]], k[10] = 0, 15
    is_raw[[5, 9]] = True
    res[5] = rng.integers(-70000, 70000, S)
    nvalid[[2, 3, 4, 5, 6, 7, 10]] = [S, S, S, S, 0, 37, S]
    return res, k, nvalid, is_raw


def _want(res, k, nvalid, is_raw, lane):
    row = res[lane, : nvalid[lane]]
    return row.astype("<i2").tobytes() if is_raw[lane] else rice_host.encode(row, int(k[lane]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_matches_rice_host(seed):
    case = _case(seed)
    payload, lane_bytes, lane_off = blockspread.pack_lanes_words(
        *(torch.from_numpy(a) for a in case)
    )
    assert payload.dtype == torch.uint8 and lane_bytes.dtype == lane_off.dtype == torch.int64
    payload, lane_bytes, lane_off = payload.numpy(), lane_bytes.numpy(), lane_off.numpy()
    assert (lane_off % 4 == 0).all()
    assert len(payload) == lane_off[-1] + 4 * -(-lane_bytes[-1] // 4)
    for lane in range(len(lane_off)):
        got = payload[lane_off[lane] : lane_off[lane] + lane_bytes[lane]].tobytes()
        assert got == _want(*case, lane), f"lane {lane}"
    clen = blockspread.code_fields(*(torch.from_numpy(a) for a in case))[0]
    assert int(clen.max()) == 271
    assert cuda_ricepack.LAUNCHES == 0


def _typical_case(seed, L=12, S=4096):
    """Lanes as a search leaves them: Laplacian residuals at their own k,
    sparse +-2**20 outliers (codes past 32 bits, which flo_tpu patches),
    raw lanes past int16, ragged lengths with an empty lane and a short one.
    flo_tpu's fast path packs all of these without `bad` lanes; _case's
    dense long codes crowd its tiles instead."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 16, L).astype(np.int32)
    res = np.stack([rng.laplace(0, 2.0 ** int(k[l]), S) for l in range(L)]).astype(np.int32)
    nvalid = rng.integers(S // 2, S + 1, L).astype(np.int32)
    is_raw = np.zeros(L, bool)
    is_raw[[3, 7]] = True
    res[3] = rng.integers(-70000, 70000, S)
    res[5, ::97] = rng.integers(-(1 << 20), 1 << 20, len(res[5, ::97]))
    nvalid[[6, 8]] = [0, 37]
    return res, k, nvalid, is_raw


def test_pack_matches_reference_on_its_good_lanes():
    """flo_tpu's pack_lanes_words flags lanes past its patch capacity as
    `bad` (re-packed on its host); every other lane's bytes must agree."""
    res, k, nvalid, is_raw = _typical_case(3)
    L = res.shape[0]
    clen = blockspread.code_fields(*(torch.from_numpy(a) for a in (res, k, nvalid, is_raw)))[0]
    assert int(clen.max()) > 32
    payload, got_bytes, got_off = blockspread.pack_lanes_words(
        *(torch.from_numpy(a) for a in (res, k, nvalid, is_raw))
    )
    tile = tpu_blockspread.TILE
    NW = -(-len(payload) // (4 * tile)) * tile
    words, lane_bytes, lane_off, bad = jax.jit(
        partial(tpu_blockspread.pack_lanes_words, NW=NW)
    )(res, k, nvalid, is_raw)
    want_bytes = np.asarray(words).view(np.uint8)
    np.testing.assert_array_equal(got_bytes.numpy(), np.asarray(lane_bytes))
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(lane_off))
    good = np.flatnonzero(~np.asarray(bad))
    assert len(good) == L
    for lane in good:
        lo, n = int(got_off[lane]), int(got_bytes[lane])
        assert payload[lo : lo + n].numpy().tobytes() == want_bytes[lo : lo + n].tobytes()


def test_pack_lanes_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ricepack.pack_lanes_cuda(*(torch.from_numpy(a) for a in _case(0)))
    assert cuda_ricepack.LAUNCHES == 0
