"""flo_torch's audio ingest against flo_tpu's, on the CPU.

The port's ``audio_io``, ``flac``, ``vorbis``, ``mp3`` and ``aac`` are copies
of host code (no device work), so the same bytes give equal samples, rates,
channel counts and tags: everything is held to equality. The inputs are built
as the reference's own tests build theirs.
"""

import dataclasses
import struct

import numpy as np
import pytest

from flo_torch import aac, audio_io, flac, mp3, vorbis
from flo_torch import native as torch_native
from flo_tpu import aac as tpu_aac
from flo_tpu import audio_io as tpu_audio_io
from flo_tpu import mp3 as tpu_mp3
from tests import flac_writer as fw
from tests import mp3_writer as mw
from tests.test_audio_io_formats import make_aiff
from tests.vorbis_writer import make_stream


def _tone(rate, seconds, channels, seed=3):
    n = int(rate * seconds)
    t = np.arange(n) / rate
    rng = np.random.default_rng(seed)
    out = np.empty(n * channels, np.float32)
    for c in range(channels):
        out[c::channels] = (0.45 * np.sin(2 * np.pi * 330.0 * (c + 1) * t)
                            + 0.02 * rng.standard_normal(n))
    return out


def _same_ingest(data):
    ours = audio_io.read_audio_from_bytes(data)
    theirs = tpu_audio_io.read_audio_from_bytes(data)
    assert ours[0].dtype == theirs[0].dtype and np.array_equal(ours[0], theirs[0])
    assert ours[1:3] == theirs[1:3]
    assert dataclasses.asdict(ours[3]) == dataclasses.asdict(theirs[3])
    assert audio_io.get_audio_info(data) == tpu_audio_io.get_audio_info(data)
    return ours


def _wav_pcm(samples, rate, channels, width):
    """A PCM WAV of ``width`` bytes a sample from float samples."""
    full = float(1 << (8 * width - 1))
    ints = np.clip(np.rint(samples * (full - 1)), -full, full - 1).astype(np.int64)
    if width == 1:
        body = (ints + 128).astype(np.uint8).tobytes()
    elif width == 3:
        body = b"".join(int(v).to_bytes(3, "little", signed=True) for v in ints)
    else:
        body = ints.astype({2: "<i2", 4: "<i4"}[width]).tobytes()
    fmt = struct.pack("<HHIIHH", 1, channels, rate, rate * channels * width, channels * width,
                      8 * width)
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVEfmt " + struct.pack("<I", 16)
            + fmt + b"data" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("rate,channels", [(44100, 2), (8000, 1), (96000, 3)])
def test_float_wav_round_trip(rate, channels):
    x = _tone(rate, 0.05, channels)
    ours = audio_io.write_wav_to_bytes(x, rate, channels)
    assert ours == tpu_audio_io.write_wav_to_bytes(x, rate, channels)
    samples, r, c, meta = _same_ingest(ours)
    assert (r, c) == (rate, channels) and np.array_equal(samples, x)


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_pcm_wav(width):
    data = _wav_pcm(_tone(22050, 0.02, 2, seed=width), 22050, 2, width)
    samples, rate, channels, _ = _same_ingest(data)
    assert (rate, channels) == (22050, 2) and len(samples) == 2 * 441


@pytest.mark.parametrize("little", [False, True])
def test_aiff(little):
    s = (np.sin(np.arange(2000) * 0.05) * 20000).astype(np.int64)
    samples, rate, channels, meta = _same_ingest(make_aiff(s, 22050, 1, little))
    assert rate == 22050 and channels == 1 and meta.source_format == "AIFF"
    np.testing.assert_allclose(samples, s / 32768.0, atol=1e-7)


def _flac_stream(stereo):
    bs = 128
    t = np.arange(2 * bs)
    left = (6000 * np.sin(t * 0.05)).astype(np.int64)
    right = (4000 * np.sin(t * 0.03 + 1)).astype(np.int64)
    bw = fw.BitWriter()
    for i in range(2):
        sl = slice(i * bs, (i + 1) * bs)
        fw.frame_header(bw, bs, i, ch_code=1 if stereo else 0)
        fw.subframe_fixed(bw, left[sl], 2, 16, k=7)
        if stereo:
            fw.subframe_verbatim(bw, right[sl], 16)
        fw.end_frame(bw)
    tags = {"TITLE": "Test Song", "ARTIST": "Nobody", "DATE": "1999-01-01", "TRACKNUMBER": "3/12"}
    return fw.flac_file(bw, 44100, 2 if stereo else 1, 16, 2 * bs, tags=tags), left, right


@pytest.mark.parametrize("stereo", [False, True])
def test_flac(stereo):
    data, left, right = _flac_stream(stereo)
    samples, rate, channels, meta = _same_ingest(data)
    assert rate == 44100 and channels == (2 if stereo else 1) and meta.source_format == "FLAC"
    assert meta.title == "Test Song" and meta.year == 1999 and meta.track_number == 3
    np.testing.assert_allclose(samples[::channels], left / 32768.0, atol=1e-7)
    if stereo:
        np.testing.assert_allclose(samples[1::2], right / 32768.0, atol=1e-7)


def test_flac_that_claims_more_than_it_holds_raises():
    bs = 64
    bw = fw.BitWriter()
    fw.frame_header(bw, bs, 0, ch_code=0)
    fw.subframe_verbatim(bw, np.arange(bs), 16)
    fw.end_frame(bw)
    with pytest.raises(flac.FlacError):
        flac.decode(fw.flac_file(bw, 44100, 1, 16, 4 * bs))


@pytest.mark.parametrize("channels,coupled", [(1, False), (2, False), (2, True)])
def test_vorbis(channels, coupled):
    data, expected = make_stream(n=512, channels=channels, frames=10, seed=7, coupled=coupled,
                                 comments={"TITLE": "vector", "ARTIST": "someone"})
    samples, rate, ch, meta = _same_ingest(data)
    assert rate == 8000 and ch == channels and meta.title == "vector"
    got = samples.reshape(-1, channels).T
    assert got.shape == expected.shape
    assert np.abs(got - expected).max() <= 1e-4 * max(np.abs(expected).max(), 1.0)
    with pytest.raises(ValueError):
        vorbis.decode(data[: len(data) // 3])


@pytest.mark.parametrize("channels", [1, 2])
def test_mp3(channels):
    if not (tpu_mp3.available() and mw.available()):
        pytest.skip("system libmpg123/libmp3lame not present")
    assert mp3.available()
    x = _tone(44100, 0.5, channels)
    data = mw.write_mp3(x, 44100, channels, 192,
                        tags={"title": "Tagged", "artist": "Lame", "year": "2001"})
    samples, rate, ch, meta = _same_ingest(data)
    assert (rate, ch) == (44100, channels) and len(samples) == len(x)
    assert meta.source_format == "mp3" and meta.title == "Tagged"
    with pytest.raises(audio_io.UnsupportedFormatError):
        mp3.decode(b"\xff\xfbjunk" + b"\x00" * 64)


def test_aac():
    if not tpu_aac.available():
        pytest.skip("system libavformat/libavcodec not present")
    assert aac.available()
    x = _tone(44100, 0.5, 2, seed=7)
    data = tpu_aac.encode_for_tests(x, 44100, 2, "adts")
    assert data == aac.encode_for_tests(x, 44100, 2, "adts")
    samples, rate, ch, _ = _same_ingest(data)
    assert (rate, ch) == (44100, 2)


def test_aac_reports_unsupported_without_the_system_libraries(monkeypatch):
    """No libavformat (its shim does not build): ``aac`` says so, as the
    reference does, and an M4A file is refused, not crashed on."""
    monkeypatch.setitem(torch_native._libs, "ingest", None)
    assert aac.available() is False
    m4a = b"\x00\x00\x00\x18ftypM4A \x00\x00\x00\x00M4A mp42" + b"\x00" * 64
    with pytest.raises(audio_io.UnsupportedFormatError):
        audio_io.read_audio_from_bytes(m4a)


@pytest.mark.parametrize("data", [b"", b"RIFF", b"not audio at all" * 8, b"fLaC" + b"\x00" * 10])
def test_garbage_is_refused_as_in_the_reference(data):
    with pytest.raises(Exception) as ours:
        audio_io.read_audio_from_bytes(data)
    with pytest.raises(Exception) as theirs:
        tpu_audio_io.read_audio_from_bytes(data)
    assert type(ours.value).__name__ == type(theirs.value).__name__
