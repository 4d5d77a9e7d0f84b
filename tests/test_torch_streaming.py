"""flo_torch's streaming encoder and decoder against flo_tpu's, on the CPU.

The same seeded inputs go through both packages. Tolerances: the streaming
encoder is host code over the same C++ search, so its bytes are equal; a
lossless frame decodes on the host in both, bit-equal; a lossy frame's IMDCT
is ``torch.fft`` here and XLA's FFT there, so lossy frames are held to one
i16 step in the i16 domain (``rint(x * 32767)``).
"""

import struct

import numpy as np
import pytest

import flo_torch
import flo_tpu
from flo_torch import native as torch_native
from flo_torch.core.constants import MAX_TOC_ENTRIES
from flo_torch.lossless import encoder as torch_lossless_encoder
from flo_torch.streaming import (
    DecoderState,
    EncodedFrame,
    StreamingAudioInfo,
    StreamingDecoder,
    StreamingEncoder,
)
from flo_tpu import streaming as tpu_streaming


def _clip(seed, rate, seconds, channels):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    chans = [
        0.4 * np.sin(2 * np.pi * (110.0 * (c + 1)) * t + c) + 0.01 * rng.standard_normal(n)
        for c in range(channels)
    ]
    return np.stack(chans, axis=1).astype(np.float32).reshape(-1)


def _i16(x):
    return np.rint(np.asarray(x, np.float64) * 32767.0)


def _drain(decoder, data, chunk):
    outs = []
    for i in range(0, len(data), chunk):
        decoder.feed(data[i : i + chunk])
        while True:
            out = decoder.next_frame()
            if out is None:
                break
            outs.append(out)
    return outs


def _stream_encode(cls, x, rate, channels, piece, level=5, **kw):
    enc = cls(rate, channels, **kw).with_compression(level)
    for i in range(0, len(x), piece):
        enc.push_samples(x[i : i + piece])
    return enc.finalize()


@pytest.mark.parametrize(
    "rate,seconds,channels,piece,level",
    [(2000, 2.5, 1, 333, 5), (8000, 3.2, 2, 4096, 5), (3000, 1.0, 2, 1, 8), (1500, 1.7, 3, 700, 0)],
)
def test_streaming_encoder_bytes_equal_reference(rate, seconds, channels, piece, level):
    x = _clip(rate, rate, seconds, channels)
    if piece == 1:
        x = x[: 2 * channels * 40]
    ours = _stream_encode(StreamingEncoder, x, rate, channels, piece, level, device="cpu")
    theirs = _stream_encode(tpu_streaming.StreamingEncoder, x, rate, channels, piece, level)
    assert ours == theirs
    assert flo_torch.validate(ours)
    out = flo_torch.decode(ours, device="cpu")
    assert len(out) == len(x) and np.abs(out - x).max() <= 1 / 32768 + 1e-6


def test_streaming_encoder_frames_and_drain():
    rate = 1000
    x = _clip(1, rate, 3.0, 1)
    ours, theirs = StreamingEncoder(rate, 1, device="cpu"), tpu_streaming.StreamingEncoder(rate, 1)
    ours.push_samples(x)
    theirs.push_samples(x)
    assert ours.pending_frames() == theirs.pending_frames() == 3
    for _ in range(2):
        a, b = ours.next_frame(), theirs.next_frame()
        assert isinstance(a, EncodedFrame)
        assert (a.index, a.timestamp_ms, a.samples, a.data) == (
            b.index, b.timestamp_ms, b.samples, b.data)
    # finalize() holds only the frames not drained, as in the reference.
    data = ours.finalize()
    assert data == theirs.finalize()
    assert flo_torch.info(data).total_samples == rate


def test_streaming_encoder_flush():
    rate = 1000
    enc = StreamingEncoder(rate, 1, device="cpu")
    assert enc.flush() is None  # nothing buffered
    enc.push_samples(_clip(2, rate, 0.4, 1))
    assert enc.pending_frames() == 0 and enc.pending_samples() == 400
    f = enc.flush()
    assert f is not None and f.samples == 400 and enc.pending_samples() == 0
    assert enc.flush() is None


def test_finalize_after_draining_gives_an_empty_valid_file():
    rate = 1000
    ours, theirs = StreamingEncoder(rate, 1, device="cpu"), tpu_streaming.StreamingEncoder(rate, 1)
    x = _clip(3, rate, 2.0, 1)
    for enc in (ours, theirs):
        enc.push_samples(x)
        while enc.next_frame() is not None:
            pass
    data = ours.finalize()
    assert data == theirs.finalize()
    assert flo_torch.info(data).total_samples == 0
    assert flo_torch.decode(data, device="cpu").size == 0


def test_lpc_prune_trades_bytes_never_samples():
    rate = 4000
    x = _clip(11, rate, 3.0, 1)

    def enc(prune):
        e = StreamingEncoder(rate, 1, device="cpu")
        e.lpc_prune_topk = prune
        e.push_samples(x)
        return e.finalize()

    full, pruned = enc(0), enc(2)
    assert np.array_equal(flo_torch.decode(pruned, device="cpu"),
                          flo_torch.decode(full, device="cpu"))
    assert full == flo_torch.encode(x, rate, 1, analyze=False)


def test_streaming_encoder_without_the_native_search(monkeypatch):
    """No C++ toolchain: every frame takes the bulk ``"exact"`` path (on the
    device the caller names), and the bytes are the full search's."""
    rate = 2000
    x = _clip(5, rate, 2.3, 2)
    want = StreamingEncoder(rate, 2, device="cpu")
    want.lpc_prune_topk = 0
    want.push_samples(x)
    want = want.finalize()
    monkeypatch.setattr(torch_native, "lossless_search_batch", lambda *a, **k: None)
    assert torch_lossless_encoder.encode_frame_host(x[: 2 * rate], rate, 2, 5, prune_lpc=2) is None
    got = _stream_encode(StreamingEncoder, x, rate, 2, 777, device="cpu")
    assert got == want


@pytest.mark.parametrize("chunk", [1, 53, 1000, 65536])
def test_lossless_streaming_decode_bit_equal(chunk):
    rate = 2000
    x = _clip(chunk, rate, 2.3, 2)
    data = flo_tpu.encode(x, rate, 2, analyze=False)
    if chunk == 1:
        data = flo_tpu.encode(x[: 2 * 300], rate, 2, analyze=False)
    ours = _drain(StreamingDecoder(device="cpu"), data, chunk)
    theirs = _drain(tpu_streaming.StreamingDecoder(), data, chunk)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(np.concatenate(ours), flo_torch.decode(data, device="cpu"))


@pytest.mark.parametrize("rate,channels,quality,chunk", [(44100, 1, 2, 499), (8000, 2, 1, 65536),
                                                         (22050, 2, 4, 4001)])
def test_lossy_streaming_decode_within_one_i16_step(rate, channels, quality, chunk):
    x = _clip(rate, rate, 1.0, channels)
    data = flo_tpu.encode_lossy(x, rate, channels, quality, analyze=False)
    ours = _drain(StreamingDecoder(device="cpu"), data, chunk)
    theirs = _drain(tpu_streaming.StreamingDecoder(), data, chunk)
    # The same frame count, and the same one-time pre-roll (an empty frame).
    assert [o.size for o in ours] == [t.size for t in theirs]
    assert ours[0].size == 0 and all(o.size for o in ours[1:])
    got, want = np.concatenate(ours), np.concatenate(theirs)
    assert np.abs(_i16(got) - _i16(want)).max() <= 1
    whole = flo_torch.decode(data, device="cpu")
    assert len(got) == len(whole) and np.abs(_i16(got) - _i16(whole)).max() <= 1


def test_state_machine_and_info():
    rate = 2000
    x = _clip(7, rate, 1.5, 1)
    data = flo_torch.encode(x, rate, 1, analyze=False)
    ours, theirs = StreamingDecoder(device="cpu"), tpu_streaming.StreamingDecoder()
    assert ours.state == DecoderState.WAITING_FOR_HEADER and ours.info() is None
    for lo, hi in ((0, 10), (10, 80), (80, len(data))):
        assert ours.feed(data[lo:hi]) == theirs.feed(data[lo:hi])
        assert ours.state.name == theirs.state.name
        assert ours.buffered_bytes() == theirs.buffered_bytes()
    assert ours.state == DecoderState.READY
    info = ours.info()
    assert isinstance(info, StreamingAudioInfo)
    assert vars(info) == vars(theirs.info())
    assert ours.frames_available() == theirs.frames_available() == 2
    assert ours.available_frames() == 2
    n = 0
    while ours.next_frame() is not None:
        n += 1
    assert n == 2 and ours.state == DecoderState.FINISHED and ours.current_frame_index() == 2
    ours.reset()
    assert ours.state == DecoderState.WAITING_FOR_HEADER
    ours.feed(data)
    assert np.array_equal(ours.decode_available(), flo_torch.decode(data, device="cpu"))


def test_bad_magic_is_a_terminal_error():
    d = StreamingDecoder(device="cpu")
    assert d.feed(b"JUNK" + b"\x00" * 100) is False
    assert d.state == DecoderState.ERROR
    assert d.next_frame() is None and d.frames_available() == 0
    with pytest.raises(ValueError):
        d.feed(b"more")


def test_toc_count_over_the_limit_raises():
    data = bytearray(flo_torch.encode(_clip(8, 1000, 1.0, 1), 1000, 1, analyze=False))
    struct.pack_into("<I", data, 70, MAX_TOC_ENTRIES + 1)
    for d in (StreamingDecoder(device="cpu"), tpu_streaming.StreamingDecoder()):
        with pytest.raises(ValueError):
            d.feed(bytes(data))
        assert d.state.name == "ERROR"


def test_truncated_lossy_frame_raises():
    rate = 8000
    data = flo_tpu.encode_lossy(_clip(9, rate, 0.5, 1), rate, 1, 2, analyze=False)
    flo = flo_torch.container.reader.read(data)
    d = StreamingDecoder(device="cpu")
    d.feed(data)
    frame = flo.frames[0]
    frame.channels[0].residuals = frame.channels[0].residuals[:5]
    with pytest.raises(ValueError):
        d._decode_frame(frame)
    assert d.state == DecoderState.ERROR


@pytest.mark.parametrize("name", ["chord_cmajor_stereo.flo", "sine_440hz_mono.flo",
                                  "lossy_chord_medium.flo", "lossy_chord_high.flo"])
def test_corpus_streaming(examples_dir, name):
    data = (examples_dir / name).read_bytes()
    ours = _drain(StreamingDecoder(device="cpu"), data, 4096)
    theirs = _drain(tpu_streaming.StreamingDecoder(), data, 4096)
    assert [o.size for o in ours] == [t.size for t in theirs]
    got = np.concatenate(ours)
    want = np.concatenate(theirs)
    if flo_torch.info(data).is_lossy:
        assert np.abs(_i16(got) - _i16(want)).max() <= 1
    else:
        assert np.array_equal(got, want)
        assert np.array_equal(got, flo_torch.decode(data, device="cpu"))
