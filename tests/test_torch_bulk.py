"""flo_torch's bulk lossless encode against flo_tpu's, on the CPU.

Seeded numpy inputs go through both packages. Tolerances: exact bytes for
``analysis="exact"``, ``compat="reference-bugs"`` and integer input;
``analysis="device"`` (float32 analysis, summed in another order than XLA's)
must round-trip bit-exactly with sizes within 2% of ``analysis="exact"``
(the reference's own bound, tests/test_bulk.py). Every test ends with the
kernels' launch counters at 0: CPU tensors take the plain versions.
"""

import numpy as np
import pytest

from flo_torch import batch
from flo_torch.container import reader
from flo_torch.lossless import decoder, encoder
from flo_torch.ops import cuda_lpc, cuda_ricepack, cuda_select
from flo_tpu import batch as tpu_batch
from flo_tpu.container import reader as tpu_reader
from flo_tpu.core.convert import f32_to_i32_np
from flo_tpu.lossless import decoder as tpu_decoder
from flo_tpu.lossless import encoder as tpu_encoder

from .conftest import EXAMPLES_DIR
from .test_torch_lossless import RATE as CLIP_RATE
from .test_torch_lossless import _assert_spec_hash, _clip, _metadata_without_hash

RATE = 4000
#: Corpus files whose encoder input the reference generator's Raw-frame
#: defect destroyed (tests/test_compat.py): they cannot be re-encoded.
UNRECOVERABLE = {"silence_1sec.flo", "white_noise.flo"}
REENCODABLE = [
    p.name for p in sorted(EXAMPLES_DIR.glob("*.flo"))
    if p.name not in UNRECOVERABLE
    and not any(f.frame_type == 253 for f in tpu_reader.read(p.read_bytes()).frames)
]


def _bulk_files(channels):
    """tests/test_bulk.py's files: three stereo tones of 1-3 s plus a few
    samples, at 4 kHz (the left channel alone in mono)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(3):
        n = RATE * (i + 1) + i * 7
        t = np.arange(n) / RATE
        l = (0.4 * np.sin(2 * np.pi * (100 + 40 * i) * t)
             + 0.005 * rng.standard_normal(n)).astype(np.float32)
        r = (0.4 * np.sin(2 * np.pi * (150 + 30 * i) * t)).astype(np.float32)
        s = np.empty(2 * n, np.float32)
        s[0::2], s[1::2] = l, r
        out.append(np.clip(s, -1, 1) if channels == 2 else np.clip(l, -1, 1))
    return out


def _inputs(name, channels):
    if name == "bulk":
        return RATE, _bulk_files(channels)
    return CLIP_RATE, [_clip(channels, seed=s, seconds=2) for s in (7, 8)]


def _no_launches():
    assert cuda_lpc.LAUNCHES == cuda_select.LAUNCHES == cuda_ricepack.LAUNCHES == 0


@pytest.mark.parametrize("level", [0, 5, 8])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", ["bulk", "clip"])
def test_encode_many_exact_matches_single_file_encodes(name, channels, level):
    """Each file's bulk bytes equal flo_tpu's single-file encode (its host
    C++ path) and the port's."""
    rate, files = _inputs(name, channels)
    got = encoder.encode_many(files, rate, channels, 16, level, analysis="exact", device="cpu")
    for g, x in zip(got, files):
        assert g == tpu_encoder.encode(x, rate, channels, 16, level)
        assert g == encoder.encode(x, rate, channels, 16, level)
    _no_launches()


@pytest.mark.parametrize("level", [0, 5, 8])
def test_encode_many_exact_matches_reference_bulk(level):
    """The same bytes as flo_tpu's own bulk encode (one XLA compile per
    level, so stereo test_bulk files only)."""
    files = _bulk_files(2)
    got = encoder.encode_many(files, RATE, 2, 16, level, analysis="exact", device="cpu")
    assert got == tpu_encoder.encode_many(files, RATE, 2, 16, level, analysis="exact")
    _no_launches()


@pytest.mark.parametrize("channels", [1, 2])
def test_encode_many_silent_and_empty_files(channels):
    files = _bulk_files(channels)
    mixed = [np.zeros(RATE * channels, np.float32), files[0], np.zeros(0, np.float32)]
    got = encoder.encode_many(mixed, RATE, channels, 16, 5, analysis="exact", device="cpu")
    assert got == [tpu_encoder.encode(x, RATE, channels, 16, 5) for x in mixed]
    assert all(f.frame_type == 0 for f in reader.read(got[0]).frames)
    assert reader.read(got[2]).header.total_samples == 0
    assert encoder.encode_many([], RATE, channels, device="cpu") == []
    _no_launches()


@pytest.mark.parametrize("channels,level", [(2, 5), (2, 8), (1, 0)])
def test_device_analysis_round_trip_and_size(channels, level):
    files = _bulk_files(channels)
    dev = encoder.encode_many(files, RATE, channels, 16, level, device="cpu")
    exact = encoder.encode_many(files, RATE, channels, 16, level, analysis="exact", device="cpu")
    for x, d, e in zip(files, dev, exact):
        got = decoder.decode_file_i32(reader.read(d), device="cpu")
        np.testing.assert_array_equal(got, f32_to_i32_np(x).reshape(-1, channels))
        assert abs(len(d) - len(e)) <= 0.02 * len(e)
    _no_launches()


def test_chunked_dispatch_gives_the_same_bytes(monkeypatch):
    """Chunks bounded by MAX_BATCH_SAMPLES (here forced to ~one frame) and
    the PIPELINE_CHUNKS split assemble the same files as one chunk."""
    files = _bulk_files(2)
    whole = encoder.encode_many(files, RATE, 2, 16, 5, analysis="exact", device="cpu")
    n_frames = sum(-(-len(x) // (2 * RATE)) for x in files)
    monkeypatch.setattr(encoder.blockspread, "MAX_BATCH_SAMPLES", 2 * RATE)
    assert len(encoder._chunk_bounds(n_frames, n_frames * 2 * RATE)) == n_frames
    assert encoder.encode_many(files, RATE, 2, 16, 5, analysis="exact", device="cpu") == whole
    _no_launches()


@pytest.fixture(scope="module")
def corpus_ints():
    """Each re-encodable corpus file's stored samples, decoded by flo_tpu
    (the port's plain recurrence is slow on the CPU at 44.1-96 kHz)."""
    out = {}
    for name in REENCODABLE:
        data = (EXAMPLES_DIR / name).read_bytes()
        out[name] = (data, tpu_decoder.decode_file_i32(tpu_reader.read(data)))
    return out


def test_nine_corpus_files_are_reencodable():
    assert len(REENCODABLE) == 9


@pytest.mark.parametrize("name", REENCODABLE)
def test_reference_bugs_corpus_reencode_is_byte_identical(corpus_ints, name):
    data, ints = corpus_ints[name]
    h = reader.read(data).header
    got = encoder.encode(
        ints.reshape(-1), h.sample_rate, h.channels, h.bit_depth, h.compression_level,
        reader.read(data).metadata, compat="reference-bugs", device="cpu",
    )
    assert got == data
    _no_launches()


def test_reference_bugs_raw_frame_defect_matches_reference():
    """tests/test_compat.py's case: fixed-0 winners make a Raw frame with
    bare Rice payloads in compat mode, and an ALPC frame by default."""
    rng = np.random.default_rng(0)
    s = rng.integers(-2, 3, 2000).astype(np.int32)
    buggy = encoder.encode(s, 2000, 1, compat="reference-bugs", device="cpu")
    assert buggy == tpu_encoder.encode(s, 2000, 1, compat="reference-bugs")
    assert reader.read(buggy).frames[0].frame_type == 254
    fixed = encoder.encode(s, 2000, 1, device="cpu")
    assert fixed == tpu_encoder.encode(s, 2000, 1)
    assert reader.read(fixed).frames[0].frame_type != 254
    _no_launches()


def test_integer_input_outside_int16_is_refused():
    """flo_tpu casts integer input to int16 before its upload, so samples
    past the int16 range decode to other values; the port raises instead."""
    x = (np.sin(np.arange(4000) / 20) * 40000).astype(np.int32)
    wrong = tpu_decoder.decode_file_i32(tpu_reader.read(tpu_encoder.encode(x, 4000, 1)))
    assert int((wrong[:, 0] != x).sum()) == 1562
    with pytest.raises(ValueError, match="lie in"):
        encoder.encode(x, 4000, 1, device="cpu")
    with pytest.raises(ValueError, match="lie in"):
        encoder.encode_many([x[:100], x], 4000, 1, device="cpu")
    edge = np.tile(np.array([-32768, 32767, 0, 5], np.int32), 1000)
    assert encoder.encode(edge, 4000, 1, device="cpu") == tpu_encoder.encode(edge, 4000, 1)
    _no_launches()


def test_batch_encode_many_matches_reference_metadata():
    """flo_tpu.batch's analysis metadata, its BLAKE3 hash left out (the port's
    is held to the pure-Python digest); the audio is the port's
    device-analysis encode, which round-trips bit-exactly."""
    files = _bulk_files(2)
    got = batch.encode_many(files, RATE, 2, device="cpu")
    want = tpu_batch.encode_many(files, RATE, 2)
    bare = encoder.encode_many(files, RATE, 2, device="cpu")
    for g, w, b, x in zip(got, want, bare, files):
        assert _metadata_without_hash(g) == _metadata_without_hash(w)
        _assert_spec_hash(g, x, 2, RATE)
        assert reader.read(g).frames == reader.read(b).frames
        np.testing.assert_array_equal(
            decoder.decode_file_i32(reader.read(g), device="cpu"), f32_to_i32_np(x).reshape(-1, 2)
        )
    assert batch.encode_many(files, RATE, 2, analyze=False, device="cpu") == bare
    _no_launches()


def test_batch_decode_many_matches_reference():
    files = _bulk_files(2)
    datas = [tpu_encoder.encode(x, RATE, 2) for x in files]
    datas.append((EXAMPLES_DIR / "chord_cmajor_stereo.flo").read_bytes())
    got = batch.decode_many(datas, device="cpu")
    for g, w in zip(got, tpu_batch.decode_many(datas)):
        np.testing.assert_array_equal(g, w)
    # A lossy file among them takes the lossy decoder and keeps its place
    # (within one i16 step of the reference's: tests/test_torch_lossy.py).
    lossy = (EXAMPLES_DIR / "audio_lossy.flo").read_bytes()
    mixed = batch.decode_many([datas[0], lossy, datas[-1]], device="cpu")
    np.testing.assert_array_equal(mixed[0], got[0])
    np.testing.assert_array_equal(mixed[2], got[-1])
    want = tpu_batch.decode_many([lossy])[0]
    assert mixed[1].shape == want.shape
    assert np.abs(np.rint(mixed[1] * 32767.0) - np.rint(want * 32767.0)).max() <= 1
    _no_launches()


@pytest.mark.parametrize("lengths", [[1, 11], [1, 13], [1, 11, 12, 13]])
@pytest.mark.parametrize("analysis", ["exact", "device"])
def test_one_sample_file_beside_short_ones(lengths, analysis):
    """A batch that mixes a 1-sample file with other short ones. The
    reference's bulk encode asserts on it (its re-pack of ``bad`` lanes); the
    port has no such lanes and encodes it: with ``analysis="exact"`` each file
    byte-equal to the reference's single-file encode of that clip alone, and
    either way a bit-exact round trip."""
    import flo_tpu

    rng = np.random.default_rng(sum(lengths))
    clips = [(0.5 * rng.standard_normal(2 * n)).clip(-1, 1).astype(np.float32) for n in lengths]
    got = encoder.encode_many(clips, RATE, 2, 16, 5, analysis=analysis, device="cpu")
    outs = decoder.decode_many([reader.read(b) for b in got], device="cpu")
    for clip, blob, out in zip(clips, got, outs):
        if analysis == "exact":
            assert blob == flo_tpu.encode(clip, RATE, 2, analyze=False)
            assert blob == encoder.encode(clip, RATE, 2, device="cpu")
        ints = f32_to_i32_np(clip)
        np.testing.assert_array_equal(out, ints.astype(np.float32) * np.float32(1 / 32767))
    assert cuda_select.LAUNCHES == cuda_ricepack.LAUNCHES == cuda_lpc.LAUNCHES == 0
