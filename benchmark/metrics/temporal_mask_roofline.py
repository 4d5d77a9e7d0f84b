"""temporal_mask_roofline: the temporal-masking scan (``csrc/temporal_mask.cu``:
its facts and scan launches) against its bound, in %: the least time the card
could take for the traced batches' scans (``frozen.temporal_mask_work``:
[channels, hops, 25] float32 in and out for each track, its own hops) over
the kernels' time in the profiler's trace."""

import re

KERNELS = re.compile(r"(?:^|::|\s)(facts_kernel|temporal_mask_kernel)[<(]")


def read(ctx):
    if ctx.entry != "encode" or ctx.mode != "lossy" or ctx.trace is None:
        return None
    t = ctx.trace.seconds(lambda n, c: c == "kernel" and "at::" not in n and KERNELS.search(n))
    if t <= 0:
        return None
    fz = ctx.frozen
    bound_ms = 0.0
    for p in ctx.trace.pool:
        rows = [len(f.frames) for f in ctx.files(p) for _ in range(f.channels)]
        bound_ms += fz.bound(*fz.temporal_mask_work(rows), fz.F32_OPS_PER_S)[0]
    return 100.0 * bound_ms / (1e3 * t)
