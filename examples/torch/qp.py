"""Quadratic programs: box-constrained projection + warm starts.

Projection of a point c onto the unit box under the metric H:

    minimize   ½yᵀHy − (Hc)ᵀy      (≡ ½‖y − c‖²_H up to a constant)
    subject to  −1 ≤ yᵢ ≤ 1

expressed conically as A y ≥ b with A = [I; −I], b = −1.

Also demonstrates ``warm_start``: re-solves of a drifting problem seed from
the previous solution and typically converge in 2-4× fewer iterations (the
production pattern for rolling re-optimization).

Run: python examples/torch/qp.py      (on the GPU; CONICIP_TORCH_DEVICE=cpu
     runs it on the CPU)
"""

import os

import numpy as np

import conicip_tpu_torch as ct

device = os.environ.get("CONICIP_TORCH_DEVICE", "cuda")

n = 200
rng = np.random.default_rng(0)
H = np.diag(1.0 + rng.random(n))
c = 2.0 * rng.standard_normal(n)  # many coordinates project onto the bounds
# keep the example well-posed: a coefficient sitting exactly ON a bound
# makes that coordinate of the projection degenerate (only √tolerance-
# determined, true for any IPM)
c = np.where(np.abs(np.abs(c) - 1.0) < 0.05, 1.2 * c, c)

A = np.vstack([np.eye(n), -np.eye(n)])
b = -np.ones(2 * n)

sol = ct.conic_ip(H, H @ c, A, b, [("R", 2 * n)], device=device)
print("status:", sol.status, " iterations:", sol.Iter)

# With a diagonal metric the projection is the coordinate-wise clip.
expected = np.clip(c, -1.0, 1.0)
assert sol.status == "Optimal"
# coordinates near (but off) a bound converge at ~tolerance/distance:
# 1e-3 here reflects the 1e-6 solver tolerance, not a solver limitation
assert np.max(np.abs(sol.y.cpu().numpy() - expected)) < 2e-3

# ── Warm start: perturb the point, re-solve from the previous solution
# (its tensors stay on the device).
c2 = c + 0.01 * rng.standard_normal(n)
cold = ct.conic_ip(H, H @ c2, A, b, [("R", 2 * n)], device=device)
warm = ct.conic_ip(H, H @ c2, A, b, [("R", 2 * n)], warm_start=sol,
                   device=device)
print(f"re-solve: cold {cold.Iter} iters vs warm {warm.Iter} iters")
assert warm.status == "Optimal"
assert warm.Iter <= cold.Iter
assert np.max(np.abs(warm.y.cpu().numpy() - np.clip(c2, -1, 1))) < 2e-3
print("ok")
