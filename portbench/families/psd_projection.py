"""Projections onto the PSD cone: minimize ½yᵀy − cᵀy subject to y ∈ S
(packed).

One S cone of order k (n = k(k+1)/2), Q = A = I, b = 0, the shape of
ConicIP.jl's SDP benchmarks (``benchmark/profile.jl``: "Small SDP" and
"Larger SDP"); c = vecm((G + Gᵀ)/√(2k)) with G a k×k
standard normal matrix, the device-side counterpart of the program's
numpy generator ``models/generators.py:batched_small_sdp``. Every
instance has its own c; Q, A and b are one tensor each, shared.
"""

from __future__ import annotations

import math

import torch

from ..reference import psd_projection

TEST_SIZE = dict(k=6)


def instances(config, count, gen, device) -> dict:
    k = int(config["k"])
    dtype = getattr(torch, config["dtype"])
    n = k * (k + 1) // 2
    G = torch.randn((count, k, k), generator=gen, dtype=dtype, device=device)
    C = (G + G.transpose(-1, -2)) / math.sqrt(2 * k)
    eye = torch.eye(n, dtype=dtype, device=device)
    return dict(each=dict(c=psd_projection.vecm(C)),
                shared=dict(Q=eye, A=eye,
                            b=torch.zeros(n, dtype=dtype, device=device)),
                cone_dims=[("S", n)])


def reference(ops, dtype):
    """(y, w, v, solved) of the closed-form reference (:mod:`..reference.
    psd_projection`) in ``dtype`` for a block ``ops`` of instances; it
    holds for Q = A = I, b = 0 and no equalities (w empty)."""
    c = ops["c"].to(dtype)
    y, v = psd_projection.solve(c)
    return (y, y.new_zeros(y.shape[0], 0), v,
            torch.ones(c.shape[0], dtype=torch.bool, device=c.device))
