"""What a returned solution says, worked out again from the problem's data.

For ``minimize ½yᵀQy − cᵀy  subject to  Ay − b ∈ K,  Gy = d`` with K a
product of cones (``cone_dims``, a list of (kind, size) blocks in the
order of Ay − b's entries; each kind's measures in ``cones/<kind>.py``),
a primal point y, the equalities' multiplier w and the cones' multiplier
v, all in float64 and per instance:

- ``dual_res``: ‖Qy − c − Aᵀv + Gᵀw‖₂ / (1 + ‖c‖₂), the stationarity
  residual (the program's sign of w);
- ``primal_viol``: the distance of s = Ay − b to K over (1 + ‖b‖₂), or
  ‖Gy − d‖₂ over (1 + ‖d‖₂) where that is larger;
- ``dual_viol``: the distance of v to K (self-dual) over (1 + ‖c‖₂);
- ``compl``: ‖λ ∘ λ‖₂ / (1 + |cᵀy|), λ the scaled point of s and v
  and ∘ the cones' Jordan product, block by block;
- ``obj``: ½yᵀQy − cᵀy.

These are the measures a primal-dual interior-point method's stopping
rule holds under its tolerance (``optTol``): primal and dual
feasibility and complementarity. Imports nothing of the program.
"""

from __future__ import annotations

import importlib

import torch

__all__ = ["numbers"]


def _mv(M, x):
    return torch.einsum("...ij,...j->...i", M, x)


def _blocks(cone_dims, measure, *xs):
    """√Σ over the cone blocks of ``measure`` (a function of
    ``cones/<kind>.py``) squared, on each row of ``xs``."""
    total, lo = 0.0, 0
    for kind, size in cone_dims:
        fn = getattr(importlib.import_module(
            f"{__package__}.cones.{kind.lower()}"), measure)
        total = total + fn(*(x[..., lo:lo + size] for x in xs)) ** 2
        lo += size
    return torch.sqrt(total)


def numbers(ops, y, w, v) -> dict:
    """Per-instance measures (module docstring) of solutions ``y``, ``w``,
    ``v`` of the problems ``ops`` (the entry's operands ``Q``, ``c``,
    ``A``, ``b``, and ``G``, ``d`` where there are equalities, each with a
    leading instance axis, and ``cone_dims``); every operand is cast to
    float64 first."""
    f64 = {k: x.to(torch.float64) for k, x in ops.items()
           if isinstance(x, torch.Tensor)}
    Q, c, A, b = (f64[k] for k in ("Q", "c", "A", "b"))
    y, w, v = (x.to(torch.float64) for x in (y, w, v))
    Qy = _mv(Q, y)
    rd = Qy - c - _mv(A.transpose(-1, -2), v)
    s = _mv(A, y) - b
    normc = 1.0 + torch.linalg.norm(c, dim=-1)
    primal = _blocks(ops["cone_dims"], "distance", s) / (
        1.0 + torch.linalg.norm(b, dim=-1))
    if "G" in f64:
        G, d = f64["G"], f64["d"]
        rd = rd + _mv(G.transpose(-1, -2), w)
        primal = torch.maximum(primal, torch.linalg.norm(
            _mv(G, y) - d, dim=-1) / (1.0 + torch.linalg.norm(d, dim=-1)))
    cty = (c * y).sum(-1)
    return dict(
        dual_res=torch.linalg.norm(rd, dim=-1) / normc,
        primal_viol=primal,
        dual_viol=_blocks(ops["cone_dims"], "distance", v) / normc,
        compl=_blocks(ops["cone_dims"], "jordan_norm", s, v) / (
            1.0 + cty.abs()),
        obj=0.5 * (y * Qy).sum(-1) - cty,
    )
