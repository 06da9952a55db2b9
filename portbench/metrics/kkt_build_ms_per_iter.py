"""Layer: KKT and cone algebra. The device time of the KKT builds
(``solve3x3gen``: the KKT assembly and factor), read from the phase clock
that the program's graphs carry while telemetry is on (``Run.phases``:
device ns per phase, prologue and units; the profiled stretch's graphs
are captured inside the profiler's session, so they carry it), summed
over the profiled stretch's runs, in ms, over the units those runs ran
(``Run.units``), as ``loop_ms_per_iter`` divides. Nothing to read where a
run of the stretch has no phase clock (an eager run, the CPU, a program
without one)."""

PHASE = "kkt_build"


def per_unit(ctx, phase):
    """The stretch's device ms of ``phase`` per unit, or None."""
    if ctx.prof is None:
        return None
    runs = [run for a in ctx.prof.answers for run in a.runs]
    if not runs or any(getattr(run, "phases", None) is None for run in runs):
        return None
    units = sum(run.units for run in runs)
    if not units:
        return None
    return sum(run.phases[phase] for run in runs) * 1e-6 / units


def read(ctx):
    return per_unit(ctx, PHASE)
