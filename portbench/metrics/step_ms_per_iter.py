"""Layer: KKT and cone algebra. The device time of the steps
(``take_step``: the back-solves, refinement trips and step lengths), read
from the phase clock, per unit of the profiled stretch, in ms
(``kkt_build_ms_per_iter`` says how)."""

from .kkt_build_ms_per_iter import per_unit

PHASE = "step"


def read(ctx):
    return per_unit(ctx, PHASE)
