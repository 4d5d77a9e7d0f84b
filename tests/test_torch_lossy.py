"""flo_torch's lossy encode and decode against flo_tpu's, on the CPU.

Seeded numpy inputs and the corpus go through both packages. The lossy codec
has no bit-exact contract: ``log10``, the FFT and the band-energy matmul
differ by ulps between XLA:CPU and PyTorch, so a coefficient at a rounding
tie moves by one and a bin whose SMR lies within an ulp of the gate flips.
Tolerances, each stated where it is used:

- quantization of the same coefficients: scale factors (wire form) equal but
  for +-1 on at most 0.1% of the bands, ``q`` different on at most 0.1% of
  the coefficients, each by 1 or by a gate flip (one side zero);
- decode of the same container: equal length, every sample within one i16
  step, compared in the i16 domain (``rint(x * 32767)``: near full scale a
  float32 ulp is 0.002 of a step);
- encode of the same clip: file size within 1% and decode SNR within 0.1 dB.

Every test ends with the kernels' launch counters at 0: CPU tensors take the
plain versions.
"""

import numpy as np
import pytest
import torch

import flo_torch
import flo_tpu
from flo_torch import batch
from flo_torch.container import reader
from flo_torch.container import writer
from flo_torch.core.types import ChannelData, Frame
from flo_torch.lossless import decoder as lossless_decoder
from flo_torch.lossy import decoder as ldec
from flo_torch.lossy import encoder as lenc
from flo_torch.lossy.presets import QUALITY_U8_TO_F32, QualityPreset
from flo_torch.ops import cuda_psycho
from flo_tpu import batch as tpu_batch
from flo_tpu.lossy import decoder as tpu_ldec
from flo_tpu.lossy import encoder as tpu_lenc
from flo_tpu.ops import mdct as tpu_mdct
from flo_tpu.ops import psycho as tpu_psycho

from .conftest import EXAMPLES_DIR
from .test_torch_lossless import _assert_spec_hash, _metadata_without_hash

LOSSY = sorted(p.name for p in EXAMPLES_DIR.glob("*lossy*.flo"))
PRESETS = [0.0, 0.35, 0.55, 0.75, 1.0]
STEP = np.float32(1.0 / 32767.0)


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    yield
    assert cuda_psycho.LAUNCHES == 0


def sine(freq, rate, seconds, amp=0.5):
    t = np.arange(int(rate * seconds), dtype=np.float64) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def snr_db(ref, out):
    m = min(len(ref), len(out))
    noise = out[:m] - ref[:m]
    return 10 * np.log10(np.sum(ref[:m] ** 2) / max(np.sum(noise**2), 1e-30))


def clip(channels, rate, seconds=0.4, seed=3):
    """Seeded interleaved clip: two tones a channel over noise, with a quiet
    stretch, so that every preset gates some bins and keeps others."""
    rng = np.random.default_rng(seed + channels + rate)
    n = int(rate * seconds) + 37
    t = np.arange(n) / rate
    chans = []
    for c in range(channels):
        x = 0.35 * np.sin(2 * np.pi * (rate / 50 + 60 * c) * t)
        x += 0.1 * np.sin(2 * np.pi * (rate / 9) * t) + 0.02 * rng.standard_normal(n)
        x[n // 2 : n // 2 + n // 8] *= 0.01
        chans.append(x)
    return np.clip(np.stack(chans, 1), -1, 1).astype(np.float32).reshape(-1)


def assert_within_one_step(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    steps = np.abs(np.rint(got / STEP) - np.rint(want / STEP))
    assert steps.max(initial=0) <= 1
    assert np.abs(got - want).max(initial=0) <= 1.01 * STEP


def test_corpus_has_seven_lossy_files():
    assert len(LOSSY) == 7


# ---------------- quantization of the same coefficients ----------------


@pytest.mark.parametrize("rate,quality", [(44100, 0.35), (8000, 0.55), (48000, 1.0)])
def test_quantize_coeffs_matches_reference(rate, quality):
    x = clip(2, rate).reshape(-1, 2).T
    padded = np.zeros((2, (-(-x.shape[1] // 1024) + 1) * 1024), np.float32)
    padded[:, : x.shape[1]] = x
    blocks = np.lib.stride_tricks.sliding_window_view(padded, 2048, axis=1)[:, ::1024]
    coeffs = np.array(tpu_mdct.forward(np.ascontiguousarray(blocks)))
    thr = np.float32(lenc.smr_threshold(quality))
    assert lenc.smr_threshold(quality) == tpu_lenc.smr_threshold(quality)
    _, band, onehot, _, _ = tpu_psycho.model_tables(rate, 2048)
    ref_q, ref_sf = (np.asarray(a) for a in tpu_lenc._quantize_coeffs(coeffs, band, onehot, rate, thr))
    q, sf = (a.numpy() for a in lenc._quantize_coeffs(torch.from_numpy(coeffs), rate, thr))
    assert q.dtype == np.int16 and q.shape == ref_q.shape
    assert sf.dtype == np.float32 and sf.shape == ref_sf.shape

    # The band maximum is exact and the division is one float32 operation.
    u16, ref_u16 = lenc.encode_sf_u16(sf), tpu_lenc.encode_sf_u16(ref_sf)
    off = u16.astype(np.int64) - ref_u16
    assert np.abs(off).max() <= 1 and (off != 0).mean() <= 1e-3
    # Bands with no bin (8 kHz stops at band 17) have scale factor 1.
    if rate == 8000:
        assert (sf[..., 18:] == 1.0).all()

    diff = q.astype(np.int64) - ref_q
    differs = diff != 0
    assert differs.mean() <= 1e-3
    gate_flip = differs & ((q == 0) | (ref_q == 0))
    assert (np.abs(diff)[differs & ~gate_flip] == 1).all()
    assert (q != 0).mean() > 0.02  # the comparison is not of zeros alone


def test_band_max_equals_the_one_hot_product():
    """The port's 25 slice maxima against the reference's
    max(mag[..., None] * onehot): exact, bands with no bin 0."""
    rng = np.random.default_rng(0)
    mag = np.abs(rng.standard_normal((2, 3, 1024))).astype(np.float32)
    mag[0, 1] = 0.0
    for rate in (8000, 44100):
        onehot = tpu_psycho.model_tables(rate, 2048)[2]
        want = (mag[..., None] * onehot).max(axis=-2)
        got = lenc._band_max(torch.from_numpy(mag), rate).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("quality", [0.0, 0.2, 0.35, 0.55, 0.75, 0.98, 0.99, 1.0, -1.0, 7.0])
def test_smr_threshold_and_header_quality(quality):
    assert lenc.smr_threshold(quality) == tpu_lenc.smr_threshold(quality)
    assert lenc.quality_u8(quality) == min(int(round(min(max(quality, 0.0), 1.0) * 4.0)), 4)


def test_sf_wire_form_equals_reference():
    sf = np.concatenate([
        np.random.default_rng(1).uniform(1e-12, 3e14, 2000).astype(np.float32),
        np.float32([0.0, 1e-10, 1.0, 30000.0, 3e38, 1e-38]),
    ])
    u16 = lenc.encode_sf_u16(sf)
    assert np.array_equal(u16, tpu_lenc.encode_sf_u16(sf))
    every = np.arange(65536, dtype=np.uint16)
    assert np.array_equal(ldec.decode_sf_u16(every), tpu_ldec.decode_sf_u16(every))


# ---------------- decode of the same container ----------------


@pytest.mark.parametrize("name", LOSSY)
def test_decode_corpus_file_within_one_step(name):
    data = (EXAMPLES_DIR / name).read_bytes()
    want = flo_tpu.decode(data)
    got = flo_torch.decode(data, device="cpu")
    assert_within_one_step(got, want)
    f = reader.read(data)
    assert f.header.is_lossy
    assert len(got) == (len(f.frames) - 1) * 1024 * f.header.channels
    assert flo_torch.validate(data) and flo_torch.info(data).is_lossy


@pytest.mark.parametrize("channels,rate", [(1, 8000), (2, 22050), (1, 44100), (2, 48000)])
def test_decode_reference_encoded_clip_within_one_step(channels, rate):
    x = clip(channels, rate)
    data = tpu_lenc.encode(x, rate, channels, 0.55)
    want = tpu_ldec.decode(data)
    got = ldec.decode(data, device="cpu")
    assert_within_one_step(got, want)
    assert flo_torch.decode(data, device="cpu").tobytes() == got.tobytes()


def test_decode_many_mixed_list_in_input_order():
    """Lossless and lossy files of several rates and channel counts in one
    call: every output is that file's own decode, in input order."""
    names = ["lossy_chord_low.flo", "sine_440hz_mono.flo", "audio_lossy.flo",
             "lossy_chord_high.flo", "chord_cmajor_stereo.flo", "lossy_music_pattern.flo"]
    names = [n for n in names if (EXAMPLES_DIR / n).is_file()]
    assert len(names) >= 5
    datas = [(EXAMPLES_DIR / n).read_bytes() for n in names]
    datas.append(tpu_lenc.encode(clip(1, 8000), 8000, 1, 0.55))
    outs = batch.decode_many(datas, device="cpu")
    refs = tpu_batch.decode_many(datas)
    assert len(outs) == len(datas)
    for name, data, out, ref in zip(names + ["clip"], datas, outs, refs):
        if reader.read(data).header.is_lossy:
            assert_within_one_step(out, ref)
        else:
            assert np.array_equal(out, ref), name
        assert out.tobytes() == flo_torch.decode(data, device="cpu").tobytes(), name


def test_decode_many_pads_short_files_and_splits_in_two():
    """Five files of unequal length (two sub-batches, hop counts padded to
    the longest): each decodes as it does alone."""
    rate = 8000
    clips = [clip(1, rate, seconds=s, seed=i) for i, s in enumerate((0.3, 0.05, 0.5, 0.0, 0.2))]
    datas = tpu_lenc.encode_many(clips, rate, 1, 0.75)
    outs = ldec.decode_many([reader.read(d) for d in datas], device="cpu")
    for d, out, ref in zip(datas, outs, tpu_ldec.decode_many([flo_tpu.container.reader.read(d) for d in datas])):
        assert_within_one_step(out, ref)
        assert_within_one_step(out, ldec.decode(d, device="cpu"))


def _transform_file(blobs, rate=8000, channels=1):
    frames = [Frame(frame_type=253, frame_samples=1024, channels=[ChannelData.transform(b)])
              for b in blobs]
    return writer.write(rate, channels, 16, 5, frames, b"", lossy=True, lossy_quality=2)


def _blob(block_byte, sf_u16, rows):
    from flo_torch.lossy.sparse import serialize_sparse

    out = bytearray([block_byte, len(rows)])
    out += np.asarray(sf_u16, "<u2").tobytes()
    for r in rows:
        payload = serialize_sparse(r)
        out += len(payload).to_bytes(4, "little") + payload
    return bytes(out)


def test_decode_short_blocks_and_zero_scale_factors():
    """A foreign file: block-size byte 1 (256-sample blocks), and scale
    factor 0 on some bands (a zero band whatever its coefficients)."""
    rng = np.random.default_rng(4)
    blobs = []
    for _ in range(5):
        sf = rng.integers(30000, 36000, (2, 25)).astype(np.uint16)
        sf[0, 3:6] = 0
        rows = rng.integers(-200, 200, (2, 128)).astype(np.int16)
        rows[rng.random(rows.shape) < 0.6] = 0
        blobs.append(_blob(1, sf, rows))
    data = _transform_file(blobs, rate=16000, channels=2)
    want = tpu_ldec.decode(data)
    got = ldec.decode(data, device="cpu")
    assert len(got) == 4 * 128 * 2
    assert_within_one_step(got, want)
    n, sf, q = ldec.deserialize_frame(blobs[0])
    assert n == 256 and q.shape == (2, 128) and (sf[0, 3:6] == 0).all()


def test_decode_refuses_truncated_and_mixed_files():
    good = _blob(0, np.full((1, 25), 33000), [np.arange(1024, dtype=np.int16) % 7 - 3])
    for bad in (good[:1], good[:30], good[:60], bytes([9]) + good[1:]):
        with pytest.raises(ValueError, match="Failed to deserialize transform frame"):
            ldec.decode(_transform_file([good, bad]), device="cpu")
    short = _blob(1, np.full((1, 25), 33000), [np.ones(128, np.int16)])
    with pytest.raises(ValueError, match="homogeneous"):
        ldec.decode(_transform_file([good, short]), device="cpu")
    two = _blob(0, np.full((2, 25), 33000), [np.ones(1024, np.int16)] * 2)
    with pytest.raises(ValueError, match="homogeneous"):
        ldec.decode_many([reader.read(_transform_file([good])),
                          reader.read(_transform_file([two], channels=2))], device="cpu")
    # A truncated sparse stream is tolerated and zero-filled, as in the reference.
    cut = good[: len(good) - 40]
    cut = cut[:52] + (len(cut) - 56).to_bytes(4, "little") + cut[56:]
    data = _transform_file([good, cut])
    assert_within_one_step(ldec.decode(data, device="cpu"), tpu_ldec.decode(data))


def test_decode_of_nothing():
    assert ldec.decode_many([], device="cpu") == []
    empty = reader.read(_transform_file([]))
    out = ldec.decode_many([empty, empty], device="cpu")
    assert [o.shape for o in out] == [(0,), (0,)]


# ---------------- encode of the same clip ----------------


@pytest.fixture(scope="module")
def stereo_clip():
    return clip(2, 44100, seconds=0.5)


@pytest.mark.parametrize("quality", PRESETS)
def test_encode_within_reference_envelope(stereo_clip, quality):
    """Size within 1% and decode SNR within 0.1 dB of flo_tpu's encode of the
    same clip; the port's file decodes in flo_tpu and flo_tpu's in the port
    (cross-decode, each within one i16 step of the other decoder)."""
    rate, x = 44100, stereo_clip
    ref = tpu_lenc.encode(x, rate, 2, quality)
    got = lenc.encode(x, rate, 2, quality, device="cpu")
    assert abs(len(got) - len(ref)) <= 0.01 * len(ref)
    ours, theirs = ldec.decode(got, device="cpu"), tpu_ldec.decode(ref)
    assert ours.shape == theirs.shape
    assert abs(snr_db(x, ours) - snr_db(x, theirs)) <= 0.1
    assert_within_one_step(tpu_ldec.decode(got), ours)
    assert_within_one_step(ldec.decode(ref, device="cpu"), theirs)
    h, rh = reader.read(got).header, reader.read(ref).header
    assert (h.is_lossy, h.lossy_quality, h.total_samples, h.channels, h.sample_rate) == (
        rh.is_lossy, rh.lossy_quality, rh.total_samples, rh.channels, rh.sample_rate)
    assert flo_torch.validate(got) and flo_tpu.validate(got)


@pytest.mark.parametrize("transport", [np.float32, np.float16, "packed", "rice16"])
def test_transport_dtypes(transport):
    """The three transports by their numerics: float32; the input rounded to
    float16; the PCM rounded to i16 and scaled by 1/32767 on the device."""
    rate = 22050
    clips = [clip(1, rate, seconds=s, seed=i) for i, s in enumerate((0.4, 0.15))]
    refs = tpu_lenc.encode_many(clips, rate, 1, 0.35, transport_dtype=transport)
    gots = lenc.encode_many(clips, rate, 1, 0.35, transport_dtype=transport, device="cpu")
    for x, got, ref in zip(clips, gots, refs):
        assert abs(len(got) - len(ref)) <= 0.01 * len(ref)
        assert abs(snr_db(x, ldec.decode(got, device="cpu")) - snr_db(x, tpu_ldec.decode(ref))) <= 0.1
        assert len(reader.read(got).frames) == len(reader.read(ref).frames)
    if isinstance(transport, str):
        stacked, hops = lenc._marshal(clips, 1, transport)
        assert stacked.dtype == np.int16 and stacked.shape == (2, (max(hops) + 1) * 1024)
        n = len(clips[0])
        want = np.clip(np.rint(clips[0] * np.float32(32767.0)), -32768, 32767)
        assert np.array_equal(stacked[0, 1024 : 1024 + n], want)
        assert not stacked[0, :1024].any() and not stacked[0, 1024 + n :].any()


def test_packed_marshal_without_the_native_library(monkeypatch):
    from flo_torch import native

    clips = [clip(2, 8000, seconds=0.2), clip(2, 8000, seconds=0.05, seed=9)]
    with_native = lenc._marshal(clips, 2, "packed")
    monkeypatch.setattr(native, "lossy_marshal_f32", lambda *a: False)
    without = lenc._marshal(clips, 2, "packed")
    assert np.array_equal(with_native[0], without[0]) and with_native[1] == without[1]


def test_encode_without_the_native_sparse_coder(monkeypatch):
    """No toolchain: dense rows and the Python serializer give the same file,
    and the decoder's fallback the same samples."""
    from flo_torch import native

    x = clip(2, 8000, seconds=0.2)
    want = lenc.encode(x, 8000, 2, 0.55, device="cpu")
    out = ldec.decode(want, device="cpu")
    monkeypatch.setattr(native, "sparse_encode_entries_csr", lambda *a: None)
    monkeypatch.setattr(native, "sparse_decode_entries", lambda *a: None)
    monkeypatch.setattr(native, "sparse_decode_batch", lambda *a: None)
    assert lenc.encode(x, 8000, 2, 0.55, device="cpu") == want
    assert np.array_equal(ldec.decode(want, device="cpu"), out)


def test_silent_and_empty_files():
    rate = 8000
    clips = [np.zeros(3000, np.float32), np.zeros(0, np.float32), clip(1, rate, 0.2),
             np.zeros(1, np.float32)]
    gots = lenc.encode_many(clips, rate, 1, 0.55, device="cpu")
    refs = tpu_lenc.encode_many(clips, rate, 1, 0.55)
    assert gots[0] == refs[0] and gots[1] == refs[1] and gots[3] == refs[3]  # nothing to round
    for x, got in zip(clips, gots):
        out = ldec.decode(got, device="cpu")
        assert len(out) == (-(-(len(x) + 1024) // 1024) - 1) * 1024
    assert not ldec.decode(gots[0], device="cpu").any()
    assert lenc.encode_many([], rate, 1, 0.55, device="cpu") == []
    only_silence = lenc.encode_many([np.zeros(5000, np.float32)] * 4, rate, 1, 0.0, device="cpu")
    assert all(not ldec.decode(b, device="cpu").any() for b in only_silence)


# ---------------- tests/test_lossy.py's end-to-end cases, on the port ----------------


class TestEndToEnd:
    def test_sine_snr_floor(self):
        rate = 44100
        sig = sine(440, rate, 1.0)
        out = ldec.decode(lenc.encode(sig, rate, 1, 0.0, device="cpu"), device="cpu")
        assert snr_db(sig, out) > 10.0

    def test_quality_monotone(self):
        rate = 44100
        sig = sine(440, rate, 1.0)
        snrs, sizes = [], []
        for q in (0.0, 0.55, 1.0):
            data = lenc.encode(sig, rate, 1, q, device="cpu")
            snrs.append(snr_db(sig, ldec.decode(data, device="cpu")))
            sizes.append(len(data))
        assert snrs[0] < snrs[1] < snrs[2]
        assert sizes[0] <= sizes[1] <= sizes[2]

    def test_stereo(self):
        rate = 22050
        s = np.empty(2 * int(rate * 0.7), np.float32)
        s[0::2], s[1::2] = sine(440, rate, 0.7), sine(660, rate, 0.7)
        data = lenc.encode(s, rate, 2, 0.75, device="cpu")
        f = reader.read(data)
        assert f.header.is_lossy and f.header.lossy_quality == 3 and f.header.channels == 2
        assert snr_db(s, ldec.decode(data, device="cpu")) > 15.0

    def test_header_fields(self):
        rate = 8000
        sig = sine(200, rate, 0.5)
        f = reader.read(lenc.encode(sig, rate, 1, 1.0, device="cpu"))
        assert f.header.is_lossy and f.header.lossy_quality == 4
        n_hops = -(-(len(sig) + 1024) // 1024)
        assert f.header.total_samples == n_hops * 1024
        assert all(fr.frame_samples == 1024 for fr in f.frames)

    def test_compression_ratio_envelope(self):
        rate = 44100
        l = sine(262, rate, 2.0, 0.4) + sine(330, rate, 2.0, 0.3) + sine(392, rate, 2.0, 0.3)
        s = np.empty(2 * len(l), np.float32)
        s[0::2], s[1::2] = l, l * 0.9
        raw = len(s) * 2
        assert raw / len(lenc.encode(s, rate, 2, 0.0, device="cpu")) > 8.0
        assert raw / len(lenc.encode(s, rate, 2, 1.0, device="cpu")) > 2.0


class TestCorpusConformance:
    def test_lossy_chord_files(self):
        ref = lossless_decoder.decode(
            (EXAMPLES_DIR / "chord_cmajor_stereo.flo").read_bytes(), device="cpu")
        floors = {"low": 20.0, "medium": 30.0, "high": 35.0, "veryhigh": 40.0, "transparent": 45.0}
        prev = -1e9
        for name, floor in floors.items():
            out = ldec.decode((EXAMPLES_DIR / f"lossy_chord_{name}.flo").read_bytes(), device="cpu")
            s = snr_db(ref, out)
            assert s > floor and s > prev, (name, s, prev)
            prev = s

    @pytest.mark.parametrize("name,q", zip(["low", "medium", "high", "veryhigh", "transparent"],
                                           PRESETS))
    def test_encode_size_parity(self, name, q):
        """Re-encoding the chord lands within 15% of the reference files'
        sizes at every preset, and within 1% of flo_tpu's re-encode."""
        sig = lossless_decoder.decode(
            (EXAMPLES_DIR / "chord_cmajor_stereo.flo").read_bytes(), device="cpu")
        ours = len(lenc.encode(sig, 44100, 2, q, device="cpu"))
        ref = (EXAMPLES_DIR / f"lossy_chord_{name}.flo").stat().st_size
        assert 0.85 * ref <= ours <= 1.15 * ref, (name, ours, ref)
        theirs = len(tpu_lenc.encode(sig, 44100, 2, q))
        assert abs(ours - theirs) <= 0.01 * theirs

    def test_lossy_headers(self):
        for p in EXAMPLES_DIR.glob("lossy_*.flo"):
            f = reader.read(p.read_bytes())
            assert f.header.is_lossy
            out = ldec.decode_file(f, device="cpu")
            assert len(out) == (len(f.frames) - 1) * 1024 * f.header.channels


# ---------------- the facade ----------------


def _same_envelope(got, ref, x):
    assert abs(len(flo_tpu.strip_metadata(got)) - len(flo_tpu.strip_metadata(ref))) <= 0.01 * len(ref)
    a, b = flo_tpu.decode(got), flo_tpu.decode(ref)  # the port's file through flo_tpu
    assert a.shape == b.shape and abs(snr_db(x, a) - snr_db(x, b)) <= 0.1
    h, rh = reader.read(got).header, reader.read(ref).header
    assert (h.is_lossy, h.lossy_quality, h.bit_depth, h.total_samples) == (
        rh.is_lossy, rh.lossy_quality, rh.bit_depth, rh.total_samples)


@pytest.mark.parametrize("quality", [0, 2, 4, 9])
def test_encode_lossy(quality):
    rate, x = 22050, clip(2, 22050)
    got = flo_torch.encode_lossy(x, rate, 2, quality, device="cpu")
    ref = flo_tpu.encode_lossy(x, rate, 2, quality)
    _same_envelope(got, ref, x)
    assert _metadata_without_hash(got) == _metadata_without_hash(ref)
    _assert_spec_hash(got, x, 2, rate)
    assert flo_torch.info(got).lossy_quality == min(quality, 4)
    plain = flo_torch.encode_lossy(x, rate, 2, quality, analyze=False, device="cpu")
    assert reader.read(plain).metadata == b""
    assert plain == lenc.encode(x, rate, 2, QUALITY_U8_TO_F32[min(quality, 4)], device="cpu")


def test_encode_transform_and_bitrate():
    rate, x = 22050, clip(2, 22050)
    got = flo_torch.encode_transform(x, rate, 2, 24, 0.62, b"", analyze=False, device="cpu")
    ref = flo_tpu.encode_transform(x, rate, 2, 24, 0.62, b"", analyze=False)
    _same_envelope(got, ref, x)
    assert reader.read(got).header.bit_depth == 24
    for kbps in (32, 96, 400):
        got = flo_torch.encode_with_bitrate(x, rate, 2, kbps, analyze=False, device="cpu")
        preset = QualityPreset.from_bitrate(kbps, rate, 2)
        assert got == flo_torch.encode_lossy(x, rate, 2, int(preset), analyze=False, device="cpu")
        assert reader.read(got).header.lossy_quality == int(preset)
    _same_envelope(flo_torch.encode_with_bitrate(x, rate, 2, 96, analyze=False, device="cpu"),
                   flo_tpu.encode_with_bitrate(x, rate, 2, 96, analyze=False), x)


def test_presets_equal_reference():
    from flo_tpu.lossy.presets import QUALITY_U8_TO_F32 as ref_map
    from flo_tpu.lossy.presets import QualityPreset as RefPreset

    assert QUALITY_U8_TO_F32 == ref_map
    for kbps in (16, 48, 64, 128, 192, 256, 320, 400):
        for rate, ch in ((44100, 2), (8000, 1), (96000, 2)):
            assert int(QualityPreset.from_bitrate(kbps, rate, ch)) == int(
                RefPreset.from_bitrate(kbps, rate, ch))
    for q in np.linspace(0, 1, 21):
        assert int(QualityPreset.from_f32(q)) == int(RefPreset.from_f32(q))


@pytest.mark.parametrize("transport", [np.float32, "packed"])
def test_batch_encode_lossy_many(transport):
    """Five clips (two sub-batches) of unequal length: each file has the
    envelope of flo_tpu's bulk encode, its own metadata, and equals the
    port's encode of the clip alone."""
    rate = 22050
    clips = [clip(2, rate, seconds=s, seed=i) for i, s in enumerate((0.3, 0.1, 0.45, 0.02, 0.2))]
    metas = [b"", b"", flo_tpu.create_metadata(title="three"), b"", b""]
    gots = batch.encode_lossy_many(clips, rate, 2, 1, metas, transport, device="cpu")
    refs = tpu_batch.encode_lossy_many(clips, rate, 2, 1, metas, transport)
    for x, got, ref in zip(clips, gots, refs):
        _same_envelope(got, ref, x)
        assert _metadata_without_hash(got) == _metadata_without_hash(ref)
    assert flo_tpu.get_metadata(gots[2]).title == "three"
    alone = batch.encode_lossy_many(clips[1:2], rate, 2, 1, None, transport, analyze=False,
                                    device="cpu")[0]
    assert flo_tpu.strip_metadata(gots[1]) == alone
    outs = batch.decode_many(gots, device="cpu")
    for got, out in zip(gots, outs):
        assert_within_one_step(out, flo_tpu.decode(got))


def test_sparse_module_equals_reference():
    from flo_torch.lossy import sparse
    from flo_tpu.lossy import sparse as ref_sparse

    rng = np.random.default_rng(8)
    for density in (0.0, 0.05, 0.5, 1.0):
        row = rng.integers(-400, 400, 1024).astype(np.int16)
        row[rng.random(1024) >= density] = 0
        blob = sparse.serialize_sparse(row)
        assert blob == ref_sparse.serialize_sparse(row)
        assert np.array_equal(sparse.deserialize_sparse(blob, 1024), row)
        assert np.array_equal(sparse.deserialize_sparse(blob[: len(blob) // 2], 1024),
                              ref_sparse.deserialize_sparse(blob[: len(blob) // 2], 1024))


def test_native_sparse_wrappers_equal_reference():
    from flo_torch import native
    from flo_tpu import native as ref_native

    rng = np.random.default_rng(6)
    rows = rng.integers(-300, 300, (9, 1024)).astype(np.int16)
    rows[rng.random(rows.shape) < 0.85] = 0
    rows[[2, 7]] = 0
    blobs = native.sparse_encode_batch(rows)
    if blobs is None:
        pytest.skip("no C++ toolchain: the numpy fallbacks are tested above")
    assert blobs == ref_native.sparse_encode_batch(rows)
    assert np.array_equal(native.sparse_decode_batch(blobs, 1024), rows)
    entries, nnz = native.sparse_decode_entries(blobs, 1024)
    ref_entries, ref_nnz = ref_native.sparse_decode_entries(blobs, 1024)
    assert np.array_equal(entries, ref_entries) and np.array_equal(nnz, ref_nnz)
    assert native.sparse_encode_entries_csr(entries, nnz, 1024) == blobs
    assert native.sparse_encode_entries_csr(np.zeros(0, np.int32), np.zeros(3, np.int32), 1024) == \
        ref_native.sparse_encode_entries_csr(np.zeros(0, np.int32), np.zeros(3, np.int32), 1024)


# ---------------- non-finite input: two divergences, decided and pinned ----------------


def _clip_with(bad):
    rate, n = 44100, 5000
    rng = np.random.default_rng(21)
    t = np.arange(n) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 660 * t)], axis=1)
    x = (x + 0.01 * rng.standard_normal((n, 2))).astype(np.float32).reshape(-1)
    x[2001] = bad
    return x, rate


def _near(size, stated):
    return abs(size - stated) <= 0.01 * stated


def test_nan_under_the_packed_transport_is_a_silent_sample():
    """Decided: the port keeps its behaviour. ``lossy_marshal_f32`` leaves
    INT32_MIN for a NaN in both packages. The port's int16 PCM upload wraps
    it to 0, so a NaN sample is a silent sample, as in the lossless encoder
    (NaN -> 0): 12,594 bytes, byte for byte the file of the clip with 0.0
    in its place. The reference keeps int32 rows, so -2147483648/32767
    reaches its MDCT: 10,923 bytes, and a full-scale click in the decode."""
    x, rate = _clip_with(np.nan)
    ours = lenc.encode_many([x], rate, 2, 0.55, transport_dtype="packed", device="cpu")[0]
    theirs = tpu_lenc.encode_many([x], rate, 2, 0.55, transport_dtype="packed")[0]
    assert _near(len(ours), 12_594) and _near(len(theirs), 10_923)
    assert ours == lenc.encode_many([_clip_with(0.0)[0]], rate, 2, 0.55,
                                    transport_dtype="packed", device="cpu")[0]
    a, b = ldec.decode(ours, device="cpu"), np.asarray(tpu_ldec.decode(theirs))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(a).max() < 0.5 and np.abs(b).max() >= 1.0  # the reference's click


@pytest.mark.parametrize("bad", [np.inf, -np.inf])
def test_inf_under_the_float32_transport_is_a_full_scale_click(bad):
    """Decided: the port keeps its behaviour. An infinity makes its blocks'
    coefficients inf and NaN. The port's band maxima (25 slice maxima) keep
    each band to its own bins, the inf coefficients saturate at the int16
    limits, and the decode has a full-scale click where the infinity was:
    what the ``"packed"`` transport makes of an infinity in both packages (a
    clamped, full-scale sample). 10,790 bytes. The reference's one-hot
    product spreads one NaN to all 25 bands (``inf * 0``), every coefficient
    of the two blocks quantizes to 0 and they decode to silence: 10,666
    bytes, the size it also gives for a NaN there."""
    x, rate = _clip_with(bad)
    ours = lenc.encode_many([x], rate, 2, 0.55, device="cpu")[0]
    theirs = tpu_lenc.encode_many([x], rate, 2, 0.55)[0]
    assert _near(len(ours), 10_790) and _near(len(theirs), 10_666)
    x_nan = _clip_with(np.nan)[0]
    assert len(tpu_lenc.encode_many([x_nan], rate, 2, 0.55)[0]) == len(theirs)
    # With a NaN the two packages agree (10,666 bytes, one step apart).
    ours_nan = lenc.encode_many([x_nan], rate, 2, 0.55, device="cpu")[0]
    assert _near(len(ours_nan), 10_666)
    a, b = ldec.decode(ours, device="cpu"), np.asarray(tpu_ldec.decode(theirs))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(a).max() >= 1.0 and np.abs(b).max() < 0.5  # the port's click
    # Under "packed" both clamp the infinity to a full-scale sample and agree.
    p_ours = lenc.encode_many([x], rate, 2, 0.55, transport_dtype="packed", device="cpu")[0]
    p_theirs = tpu_lenc.encode_many([x], rate, 2, 0.55, transport_dtype="packed")[0]
    assert _near(len(p_ours), len(p_theirs))
