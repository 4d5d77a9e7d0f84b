"""download_ms.encode: the downloads of a bulk encode's chunks (the ``.cpu()``
calls with their waits for the device; lossy, ``compact_nonzeros``' count
too), from the program's ``encode.download`` spans in the traced slice
(``benchmark/spans.py``), in ms a batch."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_batch(ctx, "encode.download", "encode_rate")
