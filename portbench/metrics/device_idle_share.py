"""Layer: device. 100 × (1 − the union of the kernel, copy and memset
intervals over the profiled stretch's length), in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
