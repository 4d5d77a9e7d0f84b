"""The ``decode`` entry: ``flo_torch.batch.decode_many_async`` on a batch of
files, float32 samples a file. Its inputs are the pool's tracks encoded in
set-up by the configuration's own entry (``encode``), so a change to the
encoder's choices changes them. Its check holds the samples to the
reference's decode of the same bytes, worked out from the track (lossless:
the track itself; lossy: the bytes' coefficients held to the reference
encoder's, and the reference's decode of them)."""

from __future__ import annotations

import numpy as np

from benchmark.entries import encode
from benchmark.reference import lossless, lossy

STEP = 32767.0


def prepare(cfg: dict, traffic: dict, pool_pcm: list, device) -> list:
    """The window's inputs, one a pool batch: its tracks' files."""
    enc = encode.call(cfg, traffic, device)
    return [enc(tracks).result() for tracks in pool_pcm]


def call(cfg: dict, traffic: dict, device):
    """f(batch of files) -> future of their interleaved float32 samples."""
    import flo_torch.batch as fb

    return lambda datas: fb.decode_many_async(datas, device=device)


def files(batch_in, batch_out) -> list:
    """A batch's files' bytes: what the window read."""
    return batch_in


def check(tally, cfg: dict, items) -> None:
    """[(key, the samples the window gave, the file it read, the track)]."""
    tally.decode(items, cfg)


def control(tally, cfg: dict, tracks) -> None:
    """The reference in the program's place, a precision below the
    configuration's float32 (bfloat16): lossless, the decoded samples given
    in bfloat16; lossy, the reference encoder and decoder in bfloat16.
    [(key, track)]."""
    from benchmark import correct

    C, rate = cfg["channels"], cfg["sample_rate"]
    tally.decoded = True
    if cfg["mode"] == "lossless":
        for key, pcm in tracks:
            out = lossy.bf16(lossless.pcm_to_int(pcm) / STEP)
            tally.lossless_ints(key, np.rint(out * STEP).astype(np.int64).reshape(-1, C), pcm, C)
        return

    def one(item):
        key, pcm = item
        q, sf = lossy.encode(pcm, C, rate, cfg["quality_f"], low=True)
        y = tally.lossy_coefs(key, q, sf, pcm, cfg)
        if y is not None:
            tally.lossy_samples(key, lossy.decode(q, sf, rate, low=True), y)

    correct.each(one, tracks)
