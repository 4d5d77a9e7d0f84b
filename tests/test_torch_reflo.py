"""flo_torch's reflo facade against flo_tpu's, on the CPU.

The same seeded audio bytes go through both packages. A lossless file's DATA
chunk is byte-equal (the same host search); metadata is equal with the two
stamps that name the encoder and the time set aside (``flo_encoder_version``
is ``flo_torch <version>`` here, ``encoding_time`` is the clock); a lossy
file is held to the lossy envelope (size within 1%, the decode of the same
bytes within one i16 step, SNR within 0.1 dB).
"""

import dataclasses

import numpy as np
import pytest

import flo_torch
from flo_torch import audio_io, reflo
from flo_torch import native as torch_native
from flo_torch.container import reader as torch_reader
from flo_torch.core.metadata import FloMetadata
from flo_tpu import reflo as tpu_reflo
from tests.test_torch_audio_io import _flac_stream


def _clip(seed, rate=8000, seconds=2.4, channels=2):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * (c + 1) * t) for c in range(channels)], axis=1)
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32).reshape(-1)


def _i16(x):
    return np.rint(np.asarray(x, np.float64) * 32767.0)


def _snr(ref, out):
    n = min(len(ref), len(out))
    noise = (out[:n] - ref[:n]).astype(np.float64)
    return 10 * np.log10(np.sum(ref[:n].astype(np.float64) ** 2) / max(np.sum(noise**2), 1e-30))


def _data_chunk(data):
    h = torch_reader.read(data).header
    lo = 4 + h.header_size + h.toc_size
    return data[lo : lo + h.data_size]


def _metadata_without_stamps(data):
    meta = dataclasses.asdict(reflo.get_metadata(data))
    version, when = meta.pop("flo_encoder_version"), meta.pop("encoding_time")
    return meta, version, when


def test_encode_options_equal():
    for build in (
        lambda m: m.EncodeOptions(),
        lambda m: m.EncodeOptions.lossless().with_level(12),
        lambda m: m.EncodeOptions.lossy_quality(1.7),
        lambda m: m.EncodeOptions.lossy_quality(-0.2).with_level(3),
        lambda m: m.EncodeOptions.lossy_bitrate(128),
    ):
        assert dataclasses.asdict(build(reflo)) == dataclasses.asdict(build(tpu_reflo))


@pytest.mark.parametrize("level", [0, 5, 8])
def test_lossless_from_wav_data_chunk_byte_equal(level):
    x = _clip(level)
    wav = audio_io.write_wav_to_bytes(x, 8000, 2)
    ours = reflo.encode_from_audio(wav, reflo.EncodeOptions.lossless().with_level(level),
                                   device="cpu")
    theirs = tpu_reflo.encode_from_audio(wav, tpu_reflo.EncodeOptions.lossless().with_level(level))
    assert _data_chunk(ours) == _data_chunk(theirs)
    assert reflo.validate_flo(ours) and tpu_reflo.validate_flo(ours)
    m_ours, version, when = _metadata_without_stamps(ours)
    m_theirs, their_version, _ = _metadata_without_stamps(theirs)
    assert m_ours == m_theirs
    assert version == f"flo_torch {flo_torch.__version__}" and their_version.startswith("flo_tpu ")
    assert len(when) == 20 and when.endswith("Z")
    assert m_ours["encoder_settings"] == f"Lossless, level {level}"
    assert m_ours["length_ms"] == 2400
    assert dataclasses.asdict(reflo.get_flo_info(ours)) == dataclasses.asdict(
        tpu_reflo.get_flo_info(ours))

    samples, rate, channels = reflo.decode_to_samples(ours, device="cpu")
    ref_samples, ref_rate, ref_channels = tpu_reflo.decode_to_samples(ours)
    assert (rate, channels) == (ref_rate, ref_channels) == (8000, 2)
    assert np.array_equal(samples, ref_samples)
    assert np.abs(samples - x).max() <= 1 / 32768 + 1e-6
    back = reflo.decode_to_wav(ours, device="cpu")
    assert back == tpu_reflo.decode_to_wav(ours)
    assert np.array_equal(audio_io.read_audio_from_bytes(back)[0], samples)


@pytest.mark.parametrize("options", ["quality", "bitrate"])
def test_lossy_from_samples_within_the_lossy_envelope(options):
    x = _clip(9, 22050, 1.5)

    def build(m):
        return (m.EncodeOptions.lossy_quality(0.55) if options == "quality"
                else m.EncodeOptions.lossy_bitrate(128))

    ours = reflo.encode_from_samples(x, 22050, 2, None, build(reflo), device="cpu")
    theirs = tpu_reflo.encode_from_samples(x, 22050, 2, None, build(tpu_reflo))
    assert abs(len(ours) - len(theirs)) <= 0.01 * len(theirs)
    assert _metadata_without_stamps(ours)[0] == _metadata_without_stamps(theirs)[0]
    info = reflo.get_flo_info(ours)
    assert info.is_lossy and info.crc_valid
    a = reflo.decode_to_samples(ours, device="cpu")[0]
    b = tpu_reflo.decode_to_samples(ours)[0]
    assert a.shape == b.shape and np.abs(_i16(a) - _i16(b)).max() <= 1
    assert abs(_snr(x, a) - _snr(x, tpu_reflo.decode_to_samples(theirs)[0])) <= 0.1


def test_source_tags_merge_and_given_metadata_wins():
    data, left, _ = _flac_stream(False)
    ours = reflo.encode_from_audio(data, reflo.EncodeOptions.lossless(), device="cpu")
    theirs = tpu_reflo.encode_from_audio(data, tpu_reflo.EncodeOptions.lossless())
    assert _data_chunk(ours) == _data_chunk(theirs)
    meta = reflo.get_metadata(ours)
    assert (meta.title, meta.artist, meta.year, meta.track_number, meta.source_format) == (
        "Test Song", "Nobody", 1999, 3, "FLAC")
    assert _metadata_without_stamps(ours)[0] == _metadata_without_stamps(theirs)[0]

    given = FloMetadata.with_basic("Mine", "Me", None)
    ours = reflo.encode_from_audio(data, reflo.EncodeOptions.lossless().with_metadata(given),
                                   device="cpu")
    meta = reflo.get_metadata(ours)
    assert meta.title == "Mine" and meta.source_format == "FLAC"
    assert meta.flo_encoder_version.startswith("flo_torch ")


def test_metadata_passthroughs():
    x = _clip(4, 4000, 1.0, 1)
    data = reflo.encode_from_samples(x, 4000, 1, None, reflo.EncodeOptions.lossless(),
                                     device="cpu")
    new = FloMetadata.with_basic("T", "A", "B").to_msgpack()
    edited = reflo.update_metadata_bytes(data, new)
    assert edited == tpu_reflo.update_metadata_bytes(data, new)
    assert reflo.get_metadata(edited).title == "T" and _data_chunk(edited) == _data_chunk(data)
    assert reflo.get_metadata(flo_torch.strip_metadata(edited)) is None
    assert reflo.get_audio_info(audio_io.write_wav_to_bytes(x, 4000, 1)) == \
        tpu_reflo.get_audio_info(audio_io.write_wav_to_bytes(x, 4000, 1))


def test_encode_from_audio_without_the_native_search(monkeypatch):
    """No C++ toolchain: the lossless encode takes the bulk ``"exact"`` path
    on the device the caller names, and gives the same DATA chunk."""
    x = _clip(5)
    wav = audio_io.write_wav_to_bytes(x, 8000, 2)
    want = reflo.encode_from_audio(wav, reflo.EncodeOptions.lossless(), device="cpu")
    monkeypatch.setattr(torch_native, "lossless_search_batch", lambda *a, **k: None)
    got = reflo.encode_from_audio(wav, reflo.EncodeOptions.lossless(), device="cpu")
    assert _data_chunk(got) == _data_chunk(want)


def test_unsupported_audio_is_refused():
    for m in (reflo, tpu_reflo):
        with pytest.raises(ValueError):
            m.encode_from_audio(b"not audio" * 20, m.EncodeOptions.lossless())
