"""The plain reference held to the format: the lossless corpus decoded bit
for bit as the port decodes it on the CPU, the transforms against their
defining sums, and the lossy codec against the port's at a small size."""

import pathlib

import numpy as np
import pytest
import torch

from benchmark import content
from benchmark.reference import container, lossless, lossy
from flo_torch import batch
from flo_torch.container import reader
from flo_torch.lossless import decoder as port_decoder

REPO = pathlib.Path(__file__).resolve().parents[2]
EXAMPLES = REPO / "tests" / "vectors" / "examples"
#: Raw frames with a truncated payload (an old generator's files): the
#: reference refuses them, as a check should.
QUIRKS = {"silence_1sec.flo", "white_noise.flo"}
LOSSLESS = sorted(p.name for p in EXAMPLES.glob("*.flo")
                  if not p.name.startswith(("lossy_", "audio_lossy")) and p.name not in QUIRKS)


@pytest.mark.parametrize("name", LOSSLESS)
def test_lossless_corpus_bit_for_bit(name):
    data = (EXAMPLES / name).read_bytes()
    got = lossless.decode([container.parse(data)])[0]
    want = port_decoder.decode_file_i32(reader.read(data), device="cpu")
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(QUIRKS))
def test_truncated_raw_frames_are_refused(name):
    with pytest.raises(container.FormatError):
        container.parse((EXAMPLES / name).read_bytes())


def test_corrupt_bytes_are_refused():
    data = bytearray((EXAMPLES / "dtmf_tones.flo").read_bytes())
    data[len(data) // 2] ^= 0x10
    with pytest.raises(container.FormatError, match="CRC"):
        container.parse(bytes(data))


def test_transforms_are_their_sums():
    rng = np.random.default_rng(3)
    i = np.arange(lossy.N)[:, None]
    k = np.arange(lossy.HOP)[None, :]
    basis = np.cos(np.pi / lossy.HOP * (i + 0.5 + lossy.HOP / 2) * (k + 0.5))
    win = lossy._tables()[0]
    x = rng.standard_normal((3, lossy.N))
    np.testing.assert_allclose(lossy.mdct(x), (x * win) @ basis, atol=1e-9)
    c = rng.standard_normal((3, lossy.HOP))
    np.testing.assert_allclose(lossy.imdct(c), (c @ basis.T) * win * (2 / lossy.HOP), atol=1e-12)


def _clip(seconds: int, seed: int) -> np.ndarray:
    x = content.make_music(seconds, 44100, np.random.default_rng(seed))
    return (np.clip(np.rint(x * 32768), -32768, 32767) / 32768).astype(np.float32)


def test_lossless_round_trip_of_the_port():
    x = _clip(3, 5)
    data = batch.encode_many([x], 44100, 2, 16, 5, analyze=False, device="cpu")[0]
    got = lossless.decode([container.parse(data)])[0]
    assert np.array_equal(got, lossless.pcm_to_int(x).reshape(-1, 2))


def test_lossy_against_the_port():
    torch.manual_seed(0)
    x = _clip(3, 6)
    data = batch.encode_lossy_many([x], 44100, 2, 2, analyze=False, device="cpu")[0]
    q, sf = lossy.parse(container.parse(data))
    qr, sr = lossy.encode(x, 2, 44100, 0.55)
    assert q.shape == qr.shape and sf.shape == sr.shape
    assert (np.abs(q - qr) > 1).mean() < 1e-4
    assert np.abs(sf - sr).max() <= 1
    y = lossy.decode(q, sf, 44100)
    port = batch.decode_many([data], device="cpu")[0]
    assert port.shape == y.shape
    assert np.abs(np.rint(port.astype(np.float64) * 32767) - np.rint(y * 32767)).max() <= 1


def test_rice_streams_must_hold_exactly_their_codes():
    data = (EXAMPLES / "dtmf_tones.flo").read_bytes()
    fr, ch = next((fr, c) for fr in container.parse(data).frames for c in fr.channels
                  if c.kind in ("lpc", "fixed"))
    assert len(lossless.rice_decode_lanes([ch.payload], [ch.k], [fr.samples])[0]) == fr.samples
    for stream, n in ((ch.payload, fr.samples - 50), (ch.payload + b"\x00", fr.samples),
                      (ch.payload[:-1], fr.samples)):
        with pytest.raises(container.FormatError):
            lossless.rice_decode_lanes([stream], [ch.k], [n])
