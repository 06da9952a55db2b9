"""95th percentile of every call's time in the window, in ms: one
``conic_ip`` or ``solve_batch`` call from its start to its result on the
host, on the host's clock (``harness.closed_loop``); linear
interpolation between order statistics."""

import statistics


def read(ctx):
    walls = [r.wall * 1e3 for r in ctx.records]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=100, method="inclusive")[94]
