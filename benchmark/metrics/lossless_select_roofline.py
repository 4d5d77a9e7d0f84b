"""lossless_select_roofline: the candidate search kernel
(``csrc/lossless_select.cu``, its planned and general kernels) against its
bound, in %: the least time the card could take for the traced batches'
search (``frozen.select_work``: the level's candidate plan over the valid
samples of every non-silent lane the bytes hold) over the kernels' time in
the profiler's trace."""

import re

KERNELS = re.compile(r"(?:^|::|\s)(planned_kernel|general_kernel)[<(]")


def read(ctx):
    if ctx.entry != "encode" or ctx.mode != "lossless" or ctx.trace is None:
        return None
    t = ctx.trace.seconds(lambda n, c: c == "kernel" and "at::" not in n and KERNELS.search(n))
    if t <= 0:
        return None
    fz = ctx.frozen
    level = ctx.cfg["level"]
    is_lpc, orders = fz.candidate_plan(level, fz.MAX_ORDER_BY_LEVEL[level])
    bound_ms = 0.0
    for p in ctx.trace.pool:
        for f in ctx.files(p):
            samples = fz.lane_counts(f)[0]
            bound_ms += fz.bound(*fz.select_work(len(samples), f.sample_rate, int(samples.sum()),
                                                 is_lpc, orders))[0]
    return 100.0 * bound_ms / (1e3 * t)
