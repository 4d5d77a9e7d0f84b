"""enqueue_ms.encode: the host's time enqueueing a bulk encode's device work
(lossless: the device analysis, search and pack; lossy: MDCT, SMR and
quantiser), from the program's ``encode.enqueue`` spans in the traced slice
(``benchmark/spans.py``), in ms a batch."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_batch(ctx, "encode.enqueue", "encode_rate")
