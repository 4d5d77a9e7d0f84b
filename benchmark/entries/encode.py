"""The ``encode`` entry: the configuration's bulk encoder in
``flo_torch.batch`` on a batch of tracks (``encode_many_async`` lossless,
``encode_lossy_many_async`` lossy, with the configuration's transport), one
file's bytes a track. Its check parses and decodes the bytes the window
wrote with the reference and holds them to the track's samples."""

from __future__ import annotations

from benchmark.reference import lossless, lossy


def prepare(cfg: dict, traffic: dict, pool_pcm: list, device) -> list:
    """The window's inputs, one a pool batch: the tracks themselves."""
    return pool_pcm


def call(cfg: dict, traffic: dict, device):
    """f(batch of tracks) -> future of their files' bytes."""
    import flo_torch.batch as fb

    rate, C, analyze = cfg["sample_rate"], cfg["channels"], traffic.get("analyze", False)
    if cfg["mode"] == "lossless":
        return lambda tracks: fb.encode_many_async(
            tracks, rate, C, cfg["bit_depth"], cfg["level"], analyze=analyze, device=device)
    # ``transport`` as the API takes it: a dtype's name ("float32", "float16") or "packed".
    return lambda tracks: fb.encode_lossy_many_async(
        tracks, rate, C, quality=cfg["quality"], transport_dtype=cfg["transport"],
        analyze=analyze, device=device)


def files(batch_in, batch_out) -> list:
    """A batch's files' bytes: what the window wrote."""
    return batch_out


def check(tally, cfg: dict, items) -> None:
    """[(key, the file the window wrote, the track, the track)]."""
    tally.ingest([(key, out, pcm) for key, out, _, pcm in items], cfg)


def control(tally, cfg: dict, tracks) -> None:
    """The reference in the program's place, a precision below the
    configuration's float32 (bfloat16): lossless, the samples carried in
    bfloat16; lossy, the reference encoder in bfloat16. [(key, track)]."""
    from benchmark import correct

    C = cfg["channels"]
    if cfg["mode"] == "lossless":
        for key, pcm in tracks:
            tally.lossless_ints(key, lossless.pcm_to_int(lossy.bf16(pcm)).reshape(-1, C), pcm, C)
        return
    correct.each(lambda item: tally.lossy_coefs(
        item[0], *lossy.encode(item[1], C, cfg["sample_rate"], cfg["quality_f"], low=True),
        item[1], cfg), tracks)
