"""flo_torch's lossless encode and decode against flo_tpu's, on the CPU.

Corpus files and seeded clips go through both packages; decoded samples and
encoded container bytes must be identical (lossless is bit-exact, so the
tolerance is exact everywhere).
"""

import msgpack
import numpy as np
import pytest
import torch

import flo_tpu
import flo_torch
from flo_tpu.container import reader as tpu_reader
from flo_tpu.core.convert import f32_to_i32_np, i32_to_f32_np
from flo_tpu.lossless import decoder as tpu_decoder
from flo_tpu.lossless import encoder as tpu_encoder
from flo_torch.container import reader as torch_reader
from flo_torch.core import blake3, convert
from flo_torch.lossless import decoder, encoder
from flo_torch.ops import cuda_lpc

from .conftest import EXAMPLES_DIR

_ALL = sorted(p.name for p in EXAMPLES_DIR.glob("*.flo"))
LOSSLESS = [
    n for n in _ALL
    if not any(f.frame_type == 253 for f in tpu_reader.read((EXAMPLES_DIR / n).read_bytes()).frames)
]
RATE = 16000


def _clip(channels, seed=7, seconds=3):
    """Seeded clip: a tone plus noise, a silent second, a partial last frame.
    In stereo the first second is near-mono (mid/side wins there) and the
    rest has independent channels."""
    rng = np.random.default_rng(seed)
    n = seconds * RATE - RATE // 3
    t = np.arange(n) / RATE
    base = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(n)
    if channels == 1:
        x = base[:, None]
    else:
        other = 0.3 * np.sin(2 * np.pi * 523 * t) + 0.05 * rng.standard_normal(n)
        right = np.where(t < 1.0, base + 0.001 * rng.standard_normal(n), other)
        x = np.stack([base, right], axis=1)
    x[RATE : 2 * RATE] = 0.0
    return np.clip(x, -1, 1).astype(np.float32).reshape(-1)


@pytest.fixture(scope="module")
def corpus_decodes():
    """One decode_many call per package over every lossless corpus file."""
    data = [(EXAMPLES_DIR / n).read_bytes() for n in LOSSLESS]
    want = tpu_decoder.decode_many([tpu_reader.read(b) for b in data])
    got = decoder.decode_many([torch_reader.read(b) for b in data], device="cpu")
    return dict(zip(LOSSLESS, zip(got, want)))


def test_corpus_has_eleven_lossless_files():
    assert len(LOSSLESS) == 11


@pytest.mark.parametrize("name", LOSSLESS)
def test_decode_many_matches_reference(corpus_decodes, name):
    got, want = corpus_decodes[name]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", LOSSLESS)
def test_decode_file_i32_matches_reference(name):
    data = (EXAMPLES_DIR / name).read_bytes()
    want = tpu_decoder.decode_file_i32(tpu_reader.read(data))
    got = decoder.decode_file_i32(torch_reader.read(data), device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_marshal_and_lanes_to_device():
    data = (EXAMPLES_DIR / "chord_cmajor_stereo.flo").read_bytes()
    got = decoder._marshal_lanes(torch_reader.read(data))
    want = tpu_decoder._marshal_lanes(tpu_reader.read(data))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lanes = decoder.lanes_to_device(*got[:6], device="cpu")
    dtypes = [torch.int32] * 4 + [torch.bool] * 2
    for t, a, dt in zip(lanes, got[:6], dtypes):
        assert t.device.type == "cpu" and t.dtype == dt
        np.testing.assert_array_equal(t.numpy(), a)


def _metadata_without_hash(data):
    """The embedded analysis metadata with the fingerprint's BLAKE3 hash
    left out: the reference's multi-threaded C++ BLAKE3 is not deterministic
    (ROADMAP.md section 3), so its hash may differ between any two calls.
    The port's copy is repaired: :func:`_assert_spec_hash` holds its hash to
    the pure-Python digest."""
    meta = msgpack.unpackb(tpu_reader.read(data).metadata, raw=False, strict_map_key=False)
    fp = msgpack.unpackb(meta.pop("spectrum_fingerprint"), raw=False, strict_map_key=False)
    fp.pop("hash")
    return meta, fp


def _assert_spec_hash(data, x, channels, rate=RATE):
    """The fingerprint hash embedded in the port's file is the pure-Python
    BLAKE3 digest of what the fingerprint hashes: channels u8, rate u32le,
    sample count u32le, then the float32 PCM."""
    meta = msgpack.unpackb(torch_reader.read(data).metadata, raw=False, strict_map_key=False)
    fp = msgpack.unpackb(meta["spectrum_fingerprint"], raw=False, strict_map_key=False)
    pcm = np.asarray(x, np.float32).reshape(-1)
    header = bytes([channels]) + np.array([rate, pcm.size], "<u4").tobytes()
    assert bytes(fp["hash"]) == blake3.digest(header + pcm.astype("<f4").tobytes())


@pytest.mark.parametrize("channels,level", [(1, 5), (2, 5), (2, 8), (1, 0)])
def test_encode_bytes_match_reference(channels, level):
    x = _clip(channels)
    want = flo_tpu.encode(x, RATE, channels, compression_level=level, analyze=False)
    got = flo_torch.encode(x, RATE, channels, compression_level=level, analyze=False)
    assert got == want
    want = flo_tpu.encode(x, RATE, channels, compression_level=level)
    got = flo_torch.encode(x, RATE, channels, compression_level=level)
    assert flo_tpu.strip_metadata(got) == flo_tpu.strip_metadata(want)
    assert _metadata_without_hash(got) == _metadata_without_hash(want)
    _assert_spec_hash(got, x, channels)


def test_clip_exercises_silence_and_mid_side():
    frames = torch_reader.read(flo_torch.encode(_clip(2), RATE, 2, analyze=False)).frames
    assert frames[0].flags & 0x01  # mid/side frame
    assert frames[1].frame_type == 0  # silent second
    assert frames[2].frame_samples < RATE  # partial last frame


@pytest.mark.parametrize("channels", [1, 2])
def test_round_trip_bit_exact(channels):
    x = _clip(channels, seed=11)
    data = flo_torch.encode(x, RATE, channels, analyze=False)
    ints = f32_to_i32_np(x).reshape(-1, channels)
    got = decoder.decode_file_i32(torch_reader.read(data), device="cpu")
    np.testing.assert_array_equal(got, ints)
    got = flo_torch.decode(data, device="cpu")
    np.testing.assert_array_equal(got, i32_to_f32_np(ints).reshape(-1))
    assert cuda_lpc.LAUNCHES == 0


def test_transform_frames_raise():
    """A file of Transform frames goes to the lossy decoder (within one i16
    step of the reference's, tests/test_torch_lossy.py); what raises is a
    Transform frame cut short."""
    data = (EXAMPLES_DIR / "audio_lossy.flo").read_bytes()
    got, want = flo_torch.decode(data, device="cpu"), flo_tpu.decode(data)
    assert got.shape == want.shape
    assert np.abs(np.rint(got * 32767.0) - np.rint(want * 32767.0)).max() <= 1
    flo = torch_reader.read(data)
    flo.frames[1].channels[0].residuals = flo.frames[1].channels[0].residuals[:40]
    with pytest.raises(ValueError, match="Failed to deserialize transform frame"):
        flo_torch.lossy.decoder.decode_file(flo, device="cpu")


@pytest.mark.parametrize(
    "samples,kwargs",
    [
        (np.random.default_rng(1).integers(-2, 3, 2 * RATE + 77).astype(np.float32) / 32767,
         {"compat": "reference-bugs"}),
        ((np.sin(np.arange(2 * RATE + 77) / 9) * 20000).astype(np.int32), {}),
    ],
    ids=["reference-bugs", "integer-input"],
)
def test_bulk_device_encode_inputs_match_reference(samples, kwargs):
    """The inputs that take the bulk path in both packages: the same bytes."""
    got = encoder.encode(samples, RATE, 1, device="cpu", **kwargs)
    assert got == tpu_encoder.encode(samples, RATE, 1, **kwargs)
    assert cuda_lpc.LAUNCHES == 0


@pytest.mark.parametrize("name", _ALL)
def test_info_and_validate_match_reference(name):
    data = (EXAMPLES_DIR / name).read_bytes()
    assert vars(flo_torch.info(data)) == vars(flo_tpu.info(data))
    assert flo_torch.validate(data) == flo_tpu.validate(data)
    corrupt = bytearray(data)
    corrupt[len(data) // 2] ^= 0xFF
    assert flo_torch.validate(bytes(corrupt)) == flo_tpu.validate(bytes(corrupt))


def test_convert_matches_reference():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-1.5, 1.5, 4096),
        [0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 1 / 32767, -1 / 32767, 0.99999],
    ]).astype(np.float32)
    ints = f32_to_i32_np(x)
    np.testing.assert_array_equal(convert.f32_to_i32(torch.from_numpy(x)).numpy(), ints)
    i = np.concatenate([ints, [-32768, 32767, 1 << 20, -(1 << 20)]]).astype(np.int32)
    np.testing.assert_array_equal(convert.i32_to_f32(torch.from_numpy(i)).numpy(), i32_to_f32_np(i))


# ---------------- the host decode of one file, and the hosts without g++ ----------------


@pytest.mark.parametrize("name", LOSSLESS)
def test_decode_file_host_matches_decode_file(corpus_decodes, name):
    """The single-file host decode (C++ Rice unpack, C++ reconstruction, C++
    mid/side undo and interleave) gives the bulk decode's samples, and the
    reference's host decode's."""
    data = (EXAMPLES_DIR / name).read_bytes()
    got = decoder.decode_file_host(torch_reader.read(data), device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, corpus_decodes[name][0])
    np.testing.assert_array_equal(got, tpu_decoder.decode_file_host(tpu_reader.read(data)))
    assert cuda_lpc.LAUNCHES == 0


def test_decode_file_host_without_the_native_library(monkeypatch):
    """No C++ toolchain: ``decode_file_host`` takes ``decode_file`` on the
    device it is given; with the reconstruction but no finalizer, the numpy
    mid/side undo. Same samples each way."""
    from flo_torch import native

    x = _clip(2, seed=3)
    flo = torch_reader.read(flo_torch.encode(x, RATE, 2, analyze=False))
    want = decoder.decode_file(flo, device="cpu")
    np.testing.assert_array_equal(decoder.decode_file_host(flo, device="cpu"), want)
    monkeypatch.setattr(native, "midside_interleave_f32", lambda *a: None)
    np.testing.assert_array_equal(decoder.decode_file_host(flo, device="cpu"), want)
    monkeypatch.setattr(native, "lpc_reconstruct_into", lambda *a: False)
    seen = []
    monkeypatch.setattr(decoder, "decode_file",
                        lambda f, device="cuda": seen.append(device) or want)
    np.testing.assert_array_equal(decoder.decode_file_host(flo, device="cpu"), want)
    assert seen == ["cpu"]
    assert decoder.decode_file_host(
        torch_reader.read(flo_torch.encode(np.zeros(0, np.float32), RATE, 2, analyze=False)),
        device="cpu").size == 0


def test_midside_finalizer_sums_in_int64():
    """``midside_interleave_f32`` follows the host form of the mid/side undo
    (``decode_file_i32``: int64 sums, halved toward zero), not the device
    form (int32-wrapping sums, ``div2_trunc``): they part only where a sum
    leaves int32, as with two INT32_MIN."""
    from flo_torch import native
    from flo_torch.ops.intmath import div2_trunc

    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    rows = np.array([[lo, hi, -7, 7, lo], [lo, hi, 4, -2, 0]], np.int32)
    out = native.midside_interleave_f32(rows, np.array([True]), np.array([5]), 2, 1.0)
    if out is None:
        pytest.skip("no C++ toolchain on this host")
    m, s = rows[0].astype(np.int64), rows[1].astype(np.int64)
    trunc = lambda t: np.where(t < 0, -((-t) // 2), t // 2)  # noqa: E731
    host = np.stack([trunc(m + s), trunc(m - s)], axis=1).astype(np.int32).astype(np.float32)
    np.testing.assert_array_equal(out.reshape(5, 2), host)
    np.testing.assert_array_equal(
        decoder._undo_midside_host(rows.reshape(1, 2, 5), np.array([True]), 2)[0].T
        .astype(np.float32), host)
    # The device form wraps the sum first: INT32_MIN + INT32_MIN -> 0 -> 0,
    # where the host form has -2**31 (and div2_trunc(INT32_MIN) is +2**30).
    wrapped = div2_trunc(torch.tensor([lo + lo], dtype=torch.int64).to(torch.int32))
    assert int(wrapped[0]) == 0 and out[0] == np.float32(lo)
    assert int(div2_trunc(torch.tensor([lo], dtype=torch.int32))[0]) == 1 << 30
    assert out[8] == np.float32(-(1 << 30))  # (INT32_MIN + 0) / 2, exact in int64


@pytest.mark.parametrize("channels,level", [(1, 5), (2, 5), (2, 8)])
def test_encode_without_the_native_search(monkeypatch, channels, level):
    """No C++ toolchain: ``encode_frame_host`` gives None, as the
    reference's, and single-file ``encode`` takes the bulk ``"exact"`` path
    on the device it is given: the same bytes."""
    from flo_torch import native

    x = _clip(channels, seed=5)
    want = flo_torch.encode(x, RATE, channels, compression_level=level, analyze=False)
    frame = encoder.encode_frame_host(x[: RATE * channels], RATE, channels, level, prune_lpc=2)
    assert frame is not None and frame.frame_samples == RATE
    assert encoder.encode_frame_host(np.zeros(0, np.float32), RATE, channels, level) is None
    assert tpu_encoder.encode_frame_host(np.zeros(0, np.float32), RATE, channels, level) is None
    monkeypatch.setattr(native, "lossless_search_batch", lambda *a, **k: None)
    assert encoder.encode_frame_host(x[: RATE * channels], RATE, channels, level) is None
    assert encoder._encode_frames_host_file(x, RATE, channels, level) is None
    got = flo_torch.encode(x, RATE, channels, compression_level=level, analyze=False,
                           device="cpu")
    assert got == want
    assert got == encoder.encode_many([x], RATE, channels, 16, level, analysis="exact",
                                      device="cpu")[0]


def test_pruned_frame_search_matches_reference():
    """``prune_lpc`` reaches the C++ search as in the reference: the same
    frame bytes for the streaming encoder's K = 2, and for the full search."""
    from flo_torch.container import writer
    from flo_tpu.container import writer as tpu_writer

    for channels in (1, 2):
        x = _clip(channels, seed=13)[: RATE * channels]
        for prune in (0, 2, 3):
            ours = encoder.encode_frame_host(x, RATE, channels, 5, prune_lpc=prune)
            theirs = tpu_encoder.encode_frame_host(x, RATE, channels, 5, prune_lpc=prune)
            assert writer.serialize_frame(ours) == tpu_writer.serialize_frame(theirs)
