"""Plain reference solver for QPs over the nonnegative orthant.

    minimize  ½ yᵀQy − cᵀy   subject to  Ay − s = b,  s ≥ 0

for a stack of instances (leading batch axis on every operand), by a
textbook Mehrotra predictor-corrector interior-point method on the normal
equations (Nocedal and Wright, Numerical Optimization, 2nd ed., §16.6):
dense ``Q + AᵀDA`` formed with ``einsum`` and factored by
``torch.linalg.cholesky``. Written from the method's equations alone; it
shares no code with the program under test. It runs in the dtype it is
given: float64 as the reference, float32 as the check's control.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["QPSolution", "solve"]


@dataclass
class QPSolution:
    y: torch.Tensor  # (B, n) primal point
    z: torch.Tensor  # (B, m) multipliers of Ay − b ≥ 0
    converged: torch.Tensor  # (B,) bool: every residual under tol
    iters: int


def _step_to_boundary(x, dx):
    """Largest α ≤ 1 with x + α·dx ≥ 0, per instance."""
    ratio = torch.where(dx < 0, -x / dx, torch.full_like(x, float("inf")))
    return torch.clamp(ratio.amin(dim=-1), max=1.0)


def solve(Q, c, A, b, *, tol=1e-10, max_iters=80) -> QPSolution:
    """Solve every instance of the stack to relative residuals under
    ``tol`` (dual ‖Qy − c − Aᵀz‖/(1+‖c‖), primal ‖Ay − s − b‖/(1+‖b‖),
    gap sᵀz/(1+|½yᵀQy − cᵀy|)), or stop after ``max_iters``."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _solve(Q, c, A, b, tol, max_iters)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _solve(Q, c, A, b, tol, max_iters):
    B, m, n = A.shape
    y = torch.zeros_like(c)
    s = torch.clamp(-b, min=1.0)
    z = torch.ones_like(b)
    normc = 1.0 + torch.linalg.norm(c, dim=-1)
    normb = 1.0 + torch.linalg.norm(b, dim=-1)
    At = A.transpose(-1, -2)
    broken = torch.zeros(B, dtype=torch.bool, device=c.device)
    for it in range(max_iters + 1):
        Qy = torch.einsum("bij,bj->bi", Q, y)
        rd = Qy - c - torch.einsum("bij,bj->bi", At, z)
        rp = torch.einsum("bij,bj->bi", A, y) - s - b
        gap = (s * z).sum(-1)
        obj = 0.5 * (y * Qy).sum(-1) - (c * y).sum(-1)
        converged = (~broken & (torch.linalg.norm(rd, dim=-1) / normc < tol)
                     & (torch.linalg.norm(rp, dim=-1) / normb < tol)
                     & (gap / (1.0 + obj.abs()) < tol))
        if it == max_iters or bool((converged | broken).all()):
            break
        mu = gap / m
        d = z / s
        K = Q + torch.einsum("bki,bk,bkj->bij", A, d, A)
        L, info = torch.linalg.cholesky_ex(K)
        # an instance whose matrix lost definiteness to rounding stops
        # where it is, unconverged
        broken = broken | (info != 0)
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        L = torch.where(broken[:, None, None], eye, L)

        def direction(rc):
            # Δz = −S⁻¹rc − D(AΔy + rp);  Δs = AΔy + rp
            rhs = -rd - torch.einsum("bij,bj->bi", At, rc / s + d * rp)
            dy = torch.cholesky_solve(rhs.unsqueeze(-1), L).squeeze(-1)
            ds = torch.einsum("bij,bj->bi", A, dy) + rp
            dz = -rc / s - d * ds
            return dy, ds, dz

        # predictor (affine scaling), then Mehrotra's centering corrector
        dy, ds, dz = direction(s * z)
        a_p = _step_to_boundary(s, ds)
        a_d = _step_to_boundary(z, dz)
        a = torch.minimum(a_p, a_d).unsqueeze(-1)
        mu_aff = ((s + a * ds) * (z + a * dz)).sum(-1) / m
        sigma = (mu_aff / mu) ** 3
        rc = s * z + ds * dz - (sigma * mu).unsqueeze(-1)
        dy, ds, dz = direction(rc)
        a = 0.99 * torch.minimum(_step_to_boundary(s, ds),
                                 _step_to_boundary(z, dz))
        # instances already converged stay where they are
        a = torch.where(converged | broken, torch.zeros_like(a),
                        a).unsqueeze(-1)
        y = y + a * dy
        s = s + a * ds
        z = z + a * dz
    return QPSolution(y=y, z=z, converged=converged, iters=it)
