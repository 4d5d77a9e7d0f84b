"""sparse_rle_ms.encode: the native sparse RLE of a lossy bulk encode's nonzeros,
from the program's ``encode.sparse_rle`` spans in the traced slice
(``benchmark/spans.py``), in ms a batch."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_batch(ctx, "encode.sparse_rle", "encode_rate")
