"""idle_unattributed_pct.encode: the share of the traced slice's device idle
time that no leaf ``encode.*`` span of the program (on any thread) covers,
with the program's clock laid on the trace's by the harness's ``collect``
spans (``benchmark/spans.py``), in %."""

from benchmark import spans


def read(ctx):
    return spans.idle_unattributed_pct(ctx, "encode.", "encode_rate")
