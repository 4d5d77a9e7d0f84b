"""flo_torch's seeking against flo_tpu's, on the CPU.

The same seeded inputs go through both packages. Tolerances: the TOC and
``seek_to_time`` are host arithmetic, equal field by field; a lossless frame
decodes on the host in both, bit-equal; a lossy frame is held to one i16 step
in the i16 domain (``rint(x * 32767)``: the port decodes it through its bulk
decoder, which rounds to int16 on the device, and through ``torch.fft``).
"""

import dataclasses

import numpy as np
import pytest

import flo_torch
import flo_tpu
from flo_torch import seeking
from flo_torch.container import reader as torch_reader
from flo_tpu import seeking as tpu_seeking


def _clip(seed, rate, seconds, channels):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    chans = [
        0.4 * np.sin(2 * np.pi * (150.0 * (c + 1)) * t) + 0.01 * rng.standard_normal(n)
        for c in range(channels)
    ]
    return np.stack(chans, axis=1).astype(np.float32).reshape(-1)


def _i16(x):
    return np.rint(np.asarray(x, np.float64) * 32767.0)


@pytest.fixture(scope="module")
def lossless_file():
    rate = 4000
    return flo_tpu.encode(_clip(1, rate, 4.3, 2), rate, 2, analyze=False), rate, 2


@pytest.fixture(scope="module")
def lossy_file():
    rate = 16000
    return flo_tpu.encode_lossy(_clip(2, rate, 1.5, 2), rate, 2, 2, analyze=False), rate, 2


def test_toc_equal(lossless_file, lossy_file):
    for data, _, _ in (lossless_file, lossy_file):
        ours, theirs = seeking.get_toc(data), tpu_seeking.get_toc(data)
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert flo_torch.get_toc is seeking.get_toc


@pytest.mark.parametrize("target_ms", [0, 1, 999, 1000, 2500, 4299, 4300, 10_000_000])
def test_seek_to_time_equal_field_by_field(lossless_file, lossy_file, target_ms):
    for data, _, _ in (lossless_file, lossy_file):
        ours = seeking.seek_to_time(data, target_ms)
        theirs = tpu_seeking.seek_to_time(data, target_ms)
        assert isinstance(ours, flo_torch.SeekResult)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_seek_past_the_end_lands_on_the_last_frame(lossless_file):
    data, rate, _ = lossless_file
    res = seeking.seek_to_time(data, 10_000_000)
    flo = torch_reader.read(data)
    assert res.frame_index == len(flo.frames) - 1
    assert res.sample_offset == flo.frames[-1].frame_samples


@pytest.mark.parametrize("toc_ms,target,want", [
    ([], 5, 0), ([0], 0, 0), ([0], 99, 0), ([0, 1000, 2000], 999, 0), ([0, 1000, 2000], 1000, 1),
    ([0, 1000, 2000], 5000, 2), ([0, 10, 10, 20], 10, 2),
])
def test_binary_search_frame(toc_ms, target, want):
    from flo_torch.core.types import TocEntry

    toc = [TocEntry(i, 0, 0, ms) for i, ms in enumerate(toc_ms)]
    assert seeking.binary_search_frame(toc, target) == want
    assert tpu_seeking.binary_search_frame(toc, target) == want


def test_seek_without_a_toc_raises(lossless_file):
    data = bytearray(lossless_file[0])
    # A TOC of no entry: the count at byte 70.
    data[70:74] = (0).to_bytes(4, "little")
    with pytest.raises(Exception):
        seeking.seek_to_time(bytes(data), 0)


def test_lossless_frames_bit_equal(lossless_file):
    data, rate, channels = lossless_file
    whole = flo_torch.decode(data, device="cpu")
    n_frames = len(torch_reader.read(data).frames)
    for i in range(n_frames):
        ours = seeking.decode_frame_at(data, i, device="cpu")
        theirs = tpu_seeking.decode_frame_at(data, i)
        assert ours.dtype == np.float32 and np.array_equal(ours, theirs)
        lo = i * rate * channels
        assert np.array_equal(ours, whole[lo : lo + len(ours)])


def test_lossy_frames_within_one_i16_step(lossy_file):
    data, rate, channels = lossy_file
    whole = flo_torch.decode(data, device="cpu")
    flo = torch_reader.read(data)
    hop = len(whole) // (len(flo.frames) - 1)
    for i in (0, 1, len(flo.frames) // 2, len(flo.frames) - 1):
        ours = seeking.decode_frame_at(data, i, device="cpu")
        theirs = tpu_seeking.decode_frame_at(data, i)
        assert ours.shape == theirs.shape
        assert np.abs(_i16(ours) - _i16(theirs)).max() <= 1
        if i > 0:  # frame i's samples follow the pre-roll frame
            want = whole[(i - 1) * hop : i * hop]
            assert np.abs(_i16(ours) - _i16(want)).max() <= 1


@pytest.mark.parametrize("index", [5, 1000])
def test_frame_index_out_of_bounds(lossless_file, index):
    with pytest.raises(IndexError):
        seeking.decode_frame_at(lossless_file[0], index, device="cpu")
    with pytest.raises(IndexError):
        tpu_seeking.decode_frame_at(lossless_file[0], index)


def test_truncated_lossy_frame_zero_raises(lossy_file):
    data, _, _ = lossy_file
    flo = torch_reader.read(data)
    start = 4 + flo.header.header_size + flo.header.toc_size
    broken = bytearray(data)
    # Frame 0's blob: cut its declared block size field to garbage.
    first = flo.toc[0]
    broken[start + first.byte_offset + 8 : start + first.byte_offset + first.frame_size] = bytes(
        first.frame_size - 8
    )
    with pytest.raises(Exception):
        seeking.decode_frame_at(bytes(broken), 0, device="cpu")


@pytest.mark.parametrize("name", ["multitone_stereo.flo", "lossy_chord_medium.flo"])
def test_corpus_seek_and_frames(examples_dir, name):
    data = (examples_dir / name).read_bytes()
    flo = torch_reader.read(data)
    for ms in (0, 500, 1999):
        assert dataclasses.asdict(seeking.seek_to_time(data, ms)) == dataclasses.asdict(
            tpu_seeking.seek_to_time(data, ms))
    for i in (0, len(flo.frames) - 1):
        ours = seeking.decode_frame_at(data, i, device="cpu")
        theirs = tpu_seeking.decode_frame_at(data, i)
        if flo.header.is_lossy:
            assert np.abs(_i16(ours) - _i16(theirs)).max() <= 1
        else:
            assert np.array_equal(ours, theirs)
