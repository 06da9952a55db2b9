"""Linear programs with conicip_tpu_torch.

An LP is the conic problem with Q = 0:

    minimize    −cᵀy
    subject to  Ay ≥ b        (here: y ≥ 0)
                Gy = d        (here: Σ y = 4)

Note the sign convention: the solver MINIMIZES ½yᵀQy − cᵀy, so the cost
vector enters with a plus sign when you want to minimize −cᵀy.

Run: python examples/torch/lp.py      (on the GPU; CONICIP_TORCH_DEVICE=cpu
     runs it on the CPU)
"""

import os

import numpy as np

import conicip_tpu_torch as ct

device = os.environ.get("CONICIP_TORCH_DEVICE", "cuda")

n = 5
Q = np.zeros((n, n))
c = np.array([2.0, 3.0, 1.0, 1.0, 1.0])  # maximize 2y1+3y2+y3+y4+y5

# nonnegativity y >= 0 as one R cone
A = np.eye(n)
b = np.zeros(n)
cone_dims = [("R", n)]

# budget: sum(y) = 4
G = np.ones((1, n))
d = np.array([4.0])

sol = ct.conic_ip(Q, c, A, b, cone_dims, G, d, verbose=True, device=device)
# the solution's y, w, v are tensors on the device; one copy to the host
host = ct.solution_to_numpy(sol)

print("status :", sol.status)
print("y      :", np.round(host.y, 6))
print("objective (cᵀy):", float(c @ host.y))

# The optimum puts the whole budget on the largest coefficient (y2 = 4).
assert sol.status == "Optimal"
assert abs(host.y[1] - 4.0) < 1e-5
assert abs(float(c @ host.y) - 12.0) < 1e-5

# Duals: w (equalities) and v (cone) certify optimality. For an LP the
# equality dual equals the marginal value of budget: 3 (the best c_i).
print("equality dual w:", np.round(host.w, 6))
assert abs(abs(host.w[0]) - 3.0) < 1e-4

# The same LP through the modeling frontend, as a maximization:
from conicip_tpu_torch.frontend import EqualTo, Nonnegatives, Optimizer

model = Optimizer(device=device)
x = model.add_variables(n)
model.set_objective("max", c)
model.variables_in(x, Nonnegatives(n))
model.add_constraint(np.ones((1, n)), np.zeros(1), EqualTo(4.0))
model.optimize()
assert model.termination_status() == "OPTIMAL"
assert abs(model.objective_value() - 12.0) < 1e-5
print("ok")
