"""Layer: IPM loop. The device time of the window's graph replays (CUDA
events around ``solver/graph.py:_play``, prologue and loop), in ms, over
the units the device loop ran (``Run.units`` in ``solver.runs`` /
``parallel.batch.runs``)."""


def read(ctx):
    if not ctx.traced:
        return None
    units = sum(run.units for r in ctx.records for run in r.answer.runs)
    device_ms = sum(r.device_ms for r in ctx.records)
    return device_ms / units if units and device_ms else None
