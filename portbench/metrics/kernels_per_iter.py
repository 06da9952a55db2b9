"""Layer: KKT and cone algebra. Kernel launches the profiler records in
the profiled stretch of hits (graphs captured inside its session), over
the units those calls ran (``Run.units``)."""


def read(ctx):
    if ctx.trace is None:
        return None
    units = sum(run.units for a in ctx.prof.answers for run in a.runs)
    return len(ctx.trace.kernels) / units if units else None
