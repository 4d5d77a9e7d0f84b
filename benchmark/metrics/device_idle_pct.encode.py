"""device_idle_pct.encode: the share of the traced slice in which no kernel,
copy or set ran on the device, in %."""

from benchmark import devtrace


def read(ctx):
    return devtrace.idle_pct(ctx, "encode_rate")
