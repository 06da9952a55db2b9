"""Dense box QPs: minimize ½yᵀQy − cᵀy subject to −1 ≤ y ≤ 1.

The counterpart, made on the device from a ``torch.Generator``, of the
program's numpy generator ``models/generators.py:box_qp_dense``: Q = MᵀM/n
with M an n×n standard normal matrix, c standard normal, A = [I; −I],
b = −1, one R cone of order 2n. Every instance of a pool has its own Q
and c; A and b are one tensor each, shared.

Each family module gives ``instances`` (the pool's operands, under the
entry's keyword names: ``each`` with a leading instance axis, ``shared``
without, and ``cone_dims``), ``reference`` (the plain reference on a
block of instances) and ``TEST_SIZE`` (the configuration's sizes at which
a test run on the CPU holds the family).
"""

from __future__ import annotations

import torch

from ..reference import qp_ipm

TEST_SIZE = dict(n=24)

# instances made by one batched draw; bounds the draw's scratch memory
_CHUNK = 64


def instances(config, count, gen, device) -> dict:
    n = int(config["n"])
    dtype = getattr(torch, config["dtype"])
    Q = torch.empty((count, n, n), dtype=dtype, device=device)
    for lo in range(0, count, _CHUNK):
        hi = min(lo + _CHUNK, count)
        M = torch.randn((hi - lo, n, n), generator=gen, dtype=dtype,
                        device=device)
        torch.matmul(M.transpose(-1, -2), M, out=Q[lo:hi])
    Q /= n
    c = torch.randn((count, n), generator=gen, dtype=dtype, device=device)
    eye = torch.eye(n, dtype=dtype, device=device)
    A = torch.cat([eye, -eye])
    b = -torch.ones(2 * n, dtype=dtype, device=device)
    return dict(each=dict(Q=Q, c=c), shared=dict(A=A, b=b),
                cone_dims=[("R", 2 * n)])


def reference(ops, dtype):
    """(y, w, v, solved) of the plain reference solver (:mod:`..reference.
    qp_ipm`) in ``dtype``, for a block ``ops`` of instances (every operand
    with a leading instance axis); no equalities, so w is empty."""
    Q, c, A, b = (ops[k].to(dtype) for k in ("Q", "c", "A", "b"))
    sol = qp_ipm.solve(Q, c, A, b,
                       tol=1e-10 if dtype == torch.float64 else 1e-6)
    return sol.y, sol.y.new_zeros(sol.y.shape[0], 0), sol.z, sol.converged
