"""dispatch_ms.encode: the median over the window's batches of the time the
encode entry takes to return (the harness's span around the call: the host's
marshalling, the uploads and the device work enqueued), in ms."""

from benchmark import devtrace


def read(ctx):
    return devtrace.dispatch_ms(ctx, "encode_rate")
