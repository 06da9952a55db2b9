"""Solver state records and the user-facing Solution type.

Counterpart of ``conicip_tpu/solver/state.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Vec4", "Status", "SolState", "Solution", "STATUS_NAMES",
           "to_host"]


def to_host(X) -> np.ndarray:
    """A tensor (on any device), scipy.sparse matrix or array-like as a host
    numpy array."""
    if isinstance(X, torch.Tensor):
        return X.detach().cpu().numpy()
    return np.asarray(X.toarray() if hasattr(X, "toarray") else X)


@dataclass(frozen=True)
class Vec4:
    """4-block iterate: primal y, equality dual w, cone dual v, slack s;
    each (..., dim), with any leading dims a stack of instances."""

    y: torch.Tensor
    w: torch.Tensor
    v: torch.Tensor
    s: torch.Tensor

    def __add__(self, o: "Vec4") -> "Vec4":
        return Vec4(self.y + o.y, self.w + o.w, self.v + o.v, self.s + o.s)

    def __sub__(self, o: "Vec4") -> "Vec4":
        return Vec4(self.y - o.y, self.w - o.w, self.v - o.v, self.s - o.s)

    def scale(self, a) -> "Vec4":
        """``a`` times every block; a tensor ``a`` is one factor per
        instance."""
        if isinstance(a, torch.Tensor) and a.dim():
            a = a.unsqueeze(-1)
        return Vec4(a * self.y, a * self.w, a * self.v, a * self.s)

    def map(self, fn) -> "Vec4":
        return Vec4(fn(self.y), fn(self.w), fn(self.v), fn(self.s))

    def norm(self) -> torch.Tensor:
        # sum of block norms per instance, empty blocks contributing 0
        out = torch.linalg.norm(self.y, dim=-1)
        for blk in (self.w, self.v, self.s):
            if blk.shape[-1]:
                out = out + torch.linalg.norm(blk, dim=-1)
        return out


class Status:
    """Integer status codes computed on the device."""

    RUNNING = 0
    OPTIMAL = 1
    INFEASIBLE = 2
    UNBOUNDED = 3
    ABANDONED = 4
    ERROR = 5


STATUS_NAMES = {
    Status.RUNNING: "Running",
    Status.OPTIMAL: "Optimal",
    Status.INFEASIBLE: "Infeasible",
    Status.UNBOUNDED: "Unbounded",
    Status.ABANDONED: "Abandoned",
    Status.ERROR: "Error",
}


@dataclass(frozen=True)
class SolState:
    """Best-iterate record plus final diagnostics, all device tensors."""

    y: torch.Tensor
    w: torch.Tensor
    v: torch.Tensor
    status: torch.Tensor  # int32 Status code
    Iter: torch.Tensor  # int32
    Mu: torch.Tensor
    prFeas: torch.Tensor
    duFeas: torch.Tensor
    muFeas: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor


@dataclass
class Solution:
    """User-facing solution. ``y``, ``w`` and ``v`` stay tensors on the
    solve's device (``interop.solution_to_numpy`` brings them to the host);
    ``status`` is one of "Optimal", "Infeasible", "Unbounded", "Abandoned",
    "Error"."""

    y: torch.Tensor
    w: torch.Tensor
    v: torch.Tensor
    status: str
    Iter: int
    Mu: float
    prFeas: float
    duFeas: float
    muFeas: float
    pobj: float
    dobj: float

    @classmethod
    def from_state(cls, st: SolState) -> "Solution":
        return cls(
            y=st.y,
            w=st.w,
            v=st.v,
            status=STATUS_NAMES[int(st.status)],
            Iter=int(st.Iter),
            Mu=float(st.Mu),
            prFeas=float(st.prFeas),
            duFeas=float(st.duFeas),
            muFeas=float(st.muFeas),
            pobj=float(st.pobj),
            dobj=float(st.dobj),
        )
