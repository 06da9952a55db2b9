"""Layer: entry (``conic_ip`` / ``solve_batch``, the graph cache's
copy-in and final read). Each call's wall time minus the device time of
its graph replays (CUDA events around ``solver/graph.py:_play``), in ms,
averaged over every call of the traced run's window. Nothing to read
where no graph was replayed (the CPU)."""


def read(ctx):
    if not ctx.traced or not any(r.device_ms for r in ctx.records):
        return None
    return sum(r.wall * 1e3 - r.device_ms for r in ctx.records) / len(
        ctx.records)
