"""upload_ms.encode: the host's time uploading a bulk encode's chunks (lossless:
the int16 narrowing and the copy; lossy: the stacked lanes' copy), from the
program's ``encode.upload`` spans in the traced slice
(``benchmark/spans.py``), in ms a batch."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_batch(ctx, "encode.upload", "encode_rate")
