"""collect_ms.encode: the median over the window's batches of the time the
future's ``result()`` takes (the harness's span around it: the downloads
and the host's finishing work), in ms."""

from benchmark import devtrace


def read(ctx):
    return devtrace.collect_ms(ctx, "encode_rate")
