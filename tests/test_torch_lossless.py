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
from flo_torch._flo_host.container import reader as torch_reader
from flo_torch.core import convert
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
    (ROADMAP.md section 3), so the hash may differ between any two calls."""
    meta = msgpack.unpackb(tpu_reader.read(data).metadata, raw=False, strict_map_key=False)
    fp = msgpack.unpackb(meta.pop("spectrum_fingerprint"), raw=False, strict_map_key=False)
    fp.pop("hash")
    return meta, fp


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
    data = (EXAMPLES_DIR / "audio_lossy.flo").read_bytes()
    with pytest.raises(NotImplementedError, match="lossy"):
        flo_torch.decode(data, device="cpu")


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
