"""marshal_ms.encode: the host's marshal of a bulk encode (lossless: the C++
marshal to int32 lanes with silence detection; lossy: the hop-padded stacked
lanes), from the program's ``encode.marshal`` spans in the traced slice
(``benchmark/spans.py``), in ms a batch."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_batch(ctx, "encode.marshal", "encode_rate")
