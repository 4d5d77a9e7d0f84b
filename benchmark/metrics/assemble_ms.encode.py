"""assemble_ms.encode: the frame assembly of a bulk encode (lossless
``_assemble_frames`` a chunk, lossy ``_assemble_files``), from the program's
``encode.assemble`` spans in the traced slice (``benchmark/spans.py``), in ms
a batch."""

from benchmark import spans


def read(ctx):
    return spans.ms_a_batch(ctx, "encode.assemble", "encode_rate")
