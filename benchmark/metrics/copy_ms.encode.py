"""copy_ms.encode: the device's copy time (host to device and back, from the
profiler's trace of the traced slice) a batch, in ms."""

from benchmark import devtrace


def read(ctx):
    return devtrace.copy_ms(ctx, "encode_rate")
