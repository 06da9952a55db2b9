"""Layer: kernel (``ops/cholesky_kernel.py``, ``csrc/cholesky.cu``). The
least time the profiled stretch's factors could take
(``roofline/cholesky.py``) over the device time of the Cholesky kernels
there, in %. The work is one factor of order n (the configuration's
``n``, the order of the Schur complement) per instance per KKT build the
solve needed: the cold start's and one per unit of the device loop (the
profiled stretch holds hits only).
Predicated retry launches that returned at once are not work; their time
is in the kernels' time."""

import torch

from ..roofline import cholesky

# the Cholesky kernel's parts, by kernel name (csrc/cholesky.cu)
PARTS = ("copy_lower<", "factor_diag<", "panel_product<", "trailing_update<")


def read(ctx):
    if ctx.trace is None:
        return None
    time_s = sum(e["dur"] for e in ctx.trace.kernels
                 if any(p in e["name"] for p in PARTS)) * 1e-6
    if time_s <= 0:
        return None
    dtype = getattr(torch, ctx.cell.config["dtype"])
    factors = sum((run.cold_start + run.units) * getattr(run, "batch", 1)
                  for a in ctx.prof.answers for run in a.runs)
    return 100.0 * factors * cholesky.bound_s(int(ctx.cell.config["n"]),
                                              dtype) / time_s
