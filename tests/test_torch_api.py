"""flo_torch's public API against flo_tpu's, on the CPU: the exported names,
the metadata functions, the small helpers and the debug mode.

The same seeded inputs go through both packages. The metadata functions are
host code over equal copies of the container reader and the metadata model,
so everything here is held to equal bytes and equal values.
"""

import dataclasses
import inspect

import msgpack
import numpy as np
import pytest

import flo_torch
import flo_tpu
from flo_torch import debug
from flo_torch.core.metadata import FloMetadata


def _clip(seed, rate=2000, seconds=1.5, channels=2):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * 100.0 * (c + 1) * t) for c in range(channels)], axis=1)
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32).reshape(-1)


@pytest.fixture(scope="module")
def files():
    """A lossless file with analysis metadata, one without, and a lossy one."""
    x = _clip(1)
    meta = flo_tpu.create_metadata("Title", "Artist", "Album")
    return {
        "tagged": flo_tpu.encode(x, 2000, 2, metadata=meta, analyze=False),
        "bare": flo_tpu.encode(x, 2000, 2, analyze=False),
        "lossy": flo_tpu.encode_lossy(_clip(2, 8000, 1.0), 8000, 2, 2, metadata=meta,
                                      analyze=False),
    }


def test_all_names_exported():
    assert set(flo_torch.__all__) == set(flo_tpu.__all__)
    assert len(flo_torch.__all__) == len(set(flo_torch.__all__)) == 23
    for name in flo_torch.__all__:
        assert hasattr(flo_torch, name)
    assert flo_torch.__version__ == flo_tpu.__version__
    assert flo_torch.__format_version__ == flo_tpu.__format_version__


@pytest.mark.parametrize("name", sorted(flo_tpu.__all__))
def test_signatures_take_the_reference_arguments(name):
    """Every public function takes the reference's parameters, in its order
    and with its defaults; the port may add keyword-only ones (``device``)."""
    ours, theirs = getattr(flo_torch, name), getattr(flo_tpu, name)
    if inspect.isclass(theirs):
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(theirs)]
        return
    p_ours = inspect.signature(ours).parameters
    p_theirs = inspect.signature(theirs).parameters
    shared = [p for p in p_ours.values() if p.name in p_theirs]
    assert [(p.name, p.kind, p.default) for p in shared] == [
        (p.name, p.kind, p.default) for p in p_theirs.values()]
    extra = [p for p in p_ours.values() if p.name not in p_theirs]
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in extra)
    assert {p.name for p in extra} <= {"device"}


def test_version_and_time_formats():
    assert flo_torch.version() == flo_tpu.version()
    for s in (0, 0.9, 59.999, 60, 61.5, 3599, 3600, 86399.2, -1.0, float("nan"), float("inf")):
        assert flo_torch.format_time(s) == flo_tpu.format_time(s)
        assert flo_torch.format_time_ms(s * 1000.0) == flo_tpu.format_time_ms(s * 1000.0)
    assert flo_torch.format_time(3725) == "1:02:05" and flo_torch.format_time(-3) == "0:00"


@pytest.mark.parametrize("args", [(), ("T",), ("T", "A"), ("Ünï", "çödé", "名前"), (None, None, "x")])
def test_create_metadata_bytes_equal(args):
    assert flo_torch.create_metadata(*args) == flo_tpu.create_metadata(*args)


@pytest.mark.parametrize("which", ["tagged", "bare", "lossy"])
def test_metadata_reads_equal(files, which):
    data = files[which]
    assert flo_torch.has_metadata(data) == flo_tpu.has_metadata(data) == (which != "bare")
    assert flo_torch.get_metadata_bytes(data) == flo_tpu.get_metadata_bytes(data)
    ours, theirs = flo_torch.get_metadata(data), flo_tpu.get_metadata(data)
    assert isinstance(ours, FloMetadata)
    assert ours.to_msgpack() == theirs.to_msgpack()
    assert dataclasses.asdict(flo_torch.info(data)) == dataclasses.asdict(flo_tpu.info(data))


@pytest.mark.parametrize("which", ["tagged", "bare", "lossy"])
def test_metadata_edits_byte_equal_and_leave_the_audio_alone(files, which):
    data = files[which]
    new = flo_torch.create_metadata("New title", None, "New album")
    edited = flo_torch.update_metadata_bytes(data, new)
    assert edited == flo_tpu.update_metadata_bytes(data, new)
    meta = flo_torch.get_metadata(edited)
    meta.artist = "Someone"
    again = flo_torch.update_metadata(edited, meta)
    assert again == flo_tpu.update_metadata(edited, flo_tpu.get_metadata(edited).__class__
                                            .from_msgpack(meta.to_msgpack()))
    stripped = flo_torch.strip_metadata(again)
    assert stripped == flo_tpu.strip_metadata(again)
    assert not flo_torch.has_metadata(stripped) and flo_torch.get_metadata_bytes(stripped) == b""
    h = flo_torch.container.reader.read(data).header
    lo = 4 + h.header_size + h.toc_size
    for d in (edited, again, stripped):
        assert flo_torch.validate(d) and d[lo : lo + h.data_size] == data[lo : lo + h.data_size]
    want = flo_torch.decode(data, device="cpu")
    assert np.array_equal(flo_torch.decode(stripped, device="cpu"), want)


@pytest.mark.parametrize("bad", [b"", b"FLO!", b"JUNK" + bytes(100), bytes(66)])
def test_metadata_functions_refuse_what_the_reference_refuses(bad):
    assert flo_torch.has_metadata(bad) == flo_tpu.has_metadata(bad)
    assert flo_torch.validate(bad) == flo_tpu.validate(bad) is False
    for fn_ours, fn_theirs in ((flo_torch.update_metadata_bytes, flo_tpu.update_metadata_bytes),):
        with pytest.raises(Exception) as ours:
            fn_ours(bad, b"x")
        with pytest.raises(Exception) as theirs:
            fn_theirs(bad, b"x")
        assert type(ours.value) is type(theirs.value)


def _without_hash(blob):
    """Analysis metadata with the fingerprint's BLAKE3 hash set aside: the
    reference's C++ BLAKE3 races under OpenMP (its own tests fail on it); the
    port's is held to the pure-Python digest in ``test_torch_lossless.py``."""
    meta = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    fp = msgpack.unpackb(meta.pop("spectrum_fingerprint"), raw=False, strict_map_key=False)
    fp.pop("hash")
    return meta, fp


@pytest.mark.parametrize("start", [b"", "tagged"])
def test_add_analysis_data_if_missing(start):
    x = _clip(3, 8000, 1.2)
    start = flo_tpu.create_metadata("T", "A") if start else b""
    ours = flo_torch.add_analysis_data_if_missing(start, x, 8000, 2)
    theirs = flo_tpu.add_analysis_data_if_missing(start, x, 8000, 2)
    assert _without_hash(ours) == _without_hash(theirs)
    meta = FloMetadata.from_msgpack(ours)
    assert meta.length_ms == 1200 and meta.waveform_data is not None
    assert (meta.title == "T") == bool(start)
    # Metadata that has its analysis is left as it is.
    assert flo_torch.add_analysis_data_if_missing(ours, x, 8000, 2) == ours
    assert flo_torch.add_analysis_data_if_missing(ours, x, 8000, 2, peaks_per_second=10) == ours


def test_debug_mode_switch():
    assert not debug.debug_enabled()
    debug.enable_debug_mode(True)
    try:
        assert debug.debug_enabled()
    finally:
        debug.enable_debug_mode(False)
    with debug.debug_mode():
        assert debug.debug_enabled()
        with debug.debug_mode():
            assert debug.debug_enabled()
        assert debug.debug_enabled()
    assert not debug.debug_enabled()


def test_debug_mode_checks_the_crc_before_decoding(files):
    data = files["bare"]
    debug.check_crc(data)
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        debug.check_crc(bytes(bad))
    with debug.debug_mode():
        out = flo_torch.decode(data, device="cpu")
        with pytest.raises(ValueError, match="CRC32"):
            flo_torch.decode(bytes(bad), device="cpu")
    assert np.array_equal(out, flo_tpu.decode(data))


def test_debug_mode_raises_on_non_finite_samples(files, monkeypatch):
    from flo_torch.lossy import decoder as lossy_decoder

    whole = flo_torch.decode(files["lossy"], device="cpu")
    poisoned = whole.copy()
    poisoned[7] = np.nan
    monkeypatch.setattr(lossy_decoder, "decode_file", lambda flo, device="cuda": poisoned)
    assert np.isnan(flo_torch.decode(files["lossy"], device="cpu")[7])  # off: passed through
    with debug.debug_mode():
        with pytest.raises(FloatingPointError):
            flo_torch.decode(files["lossy"], device="cpu")
        with pytest.raises(FloatingPointError):
            debug.check_finite("poisoned", poisoned)
        with pytest.raises(FloatingPointError):
            flo_torch.decode_frame_at(files["lossy"], 3, device="cpu")
    debug.check_finite("finite", whole)


def test_codec_works_in_debug_mode():
    x = _clip(4, 1500, 2.0, 1)
    with debug.debug_mode():
        data = flo_torch.encode(x, 1500, 1, analyze=False)
        out = flo_torch.decode(data, device="cpu")
        lossy = flo_torch.encode_lossy(x, 1500, 1, 2, analyze=False, device="cpu")
        assert np.isfinite(flo_torch.decode(lossy, device="cpu")).all()
    assert np.abs(out - x).max() <= 1 / 32768 + 1e-6
