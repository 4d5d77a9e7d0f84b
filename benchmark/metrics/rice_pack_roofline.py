"""rice_pack_roofline: the Rice pack kernels (``csrc/rice_pack.cu``: count,
layout, pack) against their bound, in %: the least time the card could take
to pack the traced batches' lanes (``frozen.pack_work``: the residual rows in,
the packed bytes the window wrote out) over the kernels' time in the
profiler's trace."""

import re

KERNELS = re.compile(r"(?:^|::|\s)(count_kernel|layout_kernel|pack_kernel)[<(]")


def read(ctx):
    if ctx.entry != "encode" or ctx.mode != "lossless" or ctx.trace is None:
        return None
    t = ctx.trace.seconds(lambda n, c: c == "kernel" and "at::" not in n and KERNELS.search(n))
    if t <= 0:
        return None
    fz = ctx.frozen
    bound_ms = 0.0
    for p in ctx.trace.pool:
        for f in ctx.files(p):
            samples, _, nbytes = fz.lane_counts(f)
            bound_ms += fz.bound(*fz.pack_work(len(samples), f.sample_rate, nbytes))[0]
    return 100.0 * bound_ms / (1e3 * t)
