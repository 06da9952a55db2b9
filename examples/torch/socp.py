"""Second-order cone programs: projection onto the unit ball.

    minimize   ½‖y − a‖²
    subject to ‖y‖ ≤ 1

The norm bound becomes a Q (second-order / Lorentz) cone constraint:
introduce the cone row A y ≥_Q b directly with A = [0; I],
b = (−1, 0, …) so that (1, y) ∈ Q ⇔ ‖y‖ ≤ 1.

Analytic answer: y* = a / max(1, ‖a‖).

Run: python examples/torch/socp.py    (on the GPU; CONICIP_TORCH_DEVICE=cpu
     runs it on the CPU)
"""

import os

import numpy as np

import conicip_tpu_torch as ct

device = os.environ.get("CONICIP_TORCH_DEVICE", "cuda")

n = 50
rng = np.random.default_rng(1)
a = rng.standard_normal(n) * 2.0
assert np.linalg.norm(a) > 1  # make the constraint active

Q = np.eye(n)
c = a  # minimize ½yᵀy − aᵀy

# (1, y) in the second-order cone of dimension n+1:
# rows: first row 0ᵀy − (−1) = 1 (the "t" entry), remaining rows y − 0
A = np.vstack([np.zeros((1, n)), np.eye(n)])
b = np.concatenate([[-1.0], np.zeros(n)])
cone_dims = [("Q", n + 1)]

sol = ct.conic_ip(Q, c, A, b, cone_dims, verbose=False, device=device)
y = sol.y.cpu().numpy()
expected = a / np.linalg.norm(a)

print("status:", sol.status, " iterations:", sol.Iter)
print("‖y‖ =", float(np.linalg.norm(y)))
assert sol.status == "Optimal"
assert np.max(np.abs(y - expected)) < 1e-5

# Mix cones freely: nonnegativity on the first 10 coordinates AND the
# ball constraint; cone_dims concatenates blocks row-wise.
A2 = np.vstack([np.hstack([np.eye(10), np.zeros((10, n - 10))]), A])
b2 = np.concatenate([np.zeros(10), b])
sol2 = ct.conic_ip(Q, c, A2, b2, [("R", 10), ("Q", n + 1)], device=device)
print("mixed R×Q status:", sol2.status)
assert sol2.status == "Optimal"
assert float(sol2.y[:10].min()) > -1e-7

# The ball projection in standard conic form (b − Ax ∈ K, the convention of
# CVXPY and SCS), with the quadratic passed as P:
from conicip_tpu_torch.frontend import ConeDims, solve_conic_form

res = solve_conic_form(-a, -A, -b, ConeDims(soc=(n + 1,)), P=Q,
                       device=device)
assert res.status == "Optimal"
assert np.max(np.abs(res.x - expected)) < 1e-5
print("ok")
