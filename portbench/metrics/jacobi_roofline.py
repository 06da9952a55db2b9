"""Layer: small linear algebra (``ops/jacobi_kernel.py``,
``csrc/jacobi.cu``). The least time of the decompositions the profiled
stretch ran (``roofline/jacobi.py``: each d×d eigh, eigvalsh or svd by
the textbook operation count, counted from the program's launch counter
``jacobi_launches`` by kind, dtype, order and stack) over the device time
of the Jacobi kernels there, in %."""

from ..roofline import jacobi

# the Jacobi kernels, by kernel name (csrc/jacobi.cu)
PARTS = ("eigh_jacobi_warp<", "svd_jacobi_warp<", "eigh_jacobi<",
         "svd_jacobi<")


def read(ctx):
    if ctx.trace is None:
        return None
    time_s = sum(e["dur"] for e in ctx.trace.kernels
                 if any(p in e["name"] for p in PARTS)) * 1e-6
    if time_s <= 0:
        return None
    bound = sum(count * stack * jacobi.bound_s(kind, d, dtype)
                for (kind, dtype, d, stack), count
                in ctx.prof.counters["jacobi"].items())
    return 100.0 * bound / time_s
