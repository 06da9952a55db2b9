"""Layer: KKT and cone algebra. The device time of the evaluations (the
new iterate's scaling, products, residuals and status, and the loop's
carry copy and predicate), read from the phase clock, per unit of the
profiled stretch, in ms (``kkt_build_ms_per_iter`` says how)."""

from .kkt_build_ms_per_iter import per_unit

PHASE = "evaluate"


def read(ctx):
    return per_unit(ctx, PHASE)
