"""write_ms.encode: the container writer over a bulk encode's files, from the
program's ``encode.write`` spans in the traced slice (``benchmark/spans.py``),
in ms a batch."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_batch(ctx, "encode.write", "encode_rate")
