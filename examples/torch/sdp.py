"""Semidefinite programs: projection onto the PSD cone.

    minimize   ½‖Y − C‖²_F
    subject to Y ⪰ 0

Symmetric matrices are passed in packed √2-scaled upper-triangle form
(``vecm``/``mat``, so that dot(vecm X, vecm Y) = tr(XY)). A d×d symmetric
matrix packs into t = d(d+1)/2 entries and a cone spec ("S", t).

Analytic answer: eigenvalue clipping, Y* = U max(Λ, 0) Uᵀ.

Run: python examples/torch/sdp.py     (on the GPU; CONICIP_TORCH_DEVICE=cpu
     runs it on the CPU)
"""

import os

import numpy as np
import torch

import conicip_tpu_torch as ct

device = os.environ.get("CONICIP_TORCH_DEVICE", "cuda")

d = 8
t = d * (d + 1) // 2
rng = np.random.default_rng(2)
C = rng.standard_normal((d, d))
C = (C + C.T) / 2  # symmetric, indefinite

c = ct.vecm(torch.as_tensor(C))  # packed objective data

Q = np.eye(t)
A = np.eye(t)
b = np.zeros(t)
cone_dims = [("S", t)]

sol = ct.conic_ip(Q, c, A, b, cone_dims, device=device)
Y = ct.mat(sol.y).cpu().numpy()

w, U = np.linalg.eigh(C)
expected = U @ np.diag(np.maximum(w, 0.0)) @ U.T

print("status:", sol.status, " iterations:", sol.Iter)
print("min eigenvalue of Y:", float(np.linalg.eigvalsh(Y).min()))
assert sol.status == "Optimal"
assert np.max(np.abs(Y - expected)) < 1e-5
assert np.linalg.eigvalsh(Y).min() > -1e-7

# Batched variant, the production pattern for many small SDPs (covariance
# repair): stack the instances, and every per-iteration decomposition and
# factor is one batched call for the whole stack.
from conicip_tpu_torch.models import batched_small_sdp
from conicip_tpu_torch.parallel import solve_batch

Qb, cb, Ab, bb, cones = batched_small_sdp(batch=4, k=6)
bs = solve_batch(Qb, cb, Ab, bb, cones, factor_dtype=None, device=device)
print("batched statuses:", bs.statuses)
assert bs.statuses == ["Optimal"] * 4
print("ok")
