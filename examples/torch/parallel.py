"""Data-parallel batched solving: stacked solves, warm re-solves, and
checkpoint/resume.

The first free parallelism axis is the PROBLEM BATCH: the IPM core is
mask-based and takes a leading batch axis on every operand, so a stack of
B independent conic QPs is one loop whose per-iteration work is batched
products, factors and decompositions. This example walks the workflow:

1. ``solve_batch`` on a stack of scenario QPs (B solves, one loop),
2. warm-started re-solves of a drifted batch (rolling re-optimization),
3. ``solve_batch_resumable``: chunked solving with atomic checkpoints.

(Sharding a batch over several cards, ``solve_batch(mesh=...)``, is not in
this package yet.)

Run: python examples/torch/parallel.py    (on the GPU;
     CONICIP_TORCH_DEVICE=cpu runs it on the CPU)
"""

import os
import tempfile

import numpy as np
import torch

from conicip_tpu_torch.parallel import solve_batch, solve_batch_resumable

device = os.environ.get("CONICIP_TORCH_DEVICE", "cuda")

# ── 1. a batch of scenario QPs: same structure, different data ──────
B, n = 8, 40
rng = np.random.default_rng(0)
Q = np.stack([np.diag(1.0 + rng.random(n)) for _ in range(B)])
c = rng.standard_normal((B, n))
A = np.stack([np.vstack([np.eye(n), -np.eye(n)])] * B)
b = np.stack([-np.ones(2 * n)] * B)
cones = [("R", 2 * n)]

bs = solve_batch(Q, c, A, b, cones, device=device)
assert bs.statuses == ["Optimal"] * B
resid = torch.maximum(bs.prFeas, torch.maximum(bs.duFeas, bs.muFeas))
print(f"batch of {B}: all Optimal, max resid {float(resid.max()):.2e}, "
      f"iters {bs.Iter.tolist()}")

# ── 2. warm-started re-solve of a drifted batch ──────────────────────
# rolling re-optimization: the new batch seeds from the old solutions,
# which stay on the device
c_drift = c + 0.01 * rng.standard_normal((B, n))
bs3 = solve_batch(Q, c_drift, A, b, cones, warm_start=bs, device=device)
assert bs3.statuses == ["Optimal"] * B
print(f"warm re-solve after drift: iters {bs3.Iter.tolist()} "
      f"(cold was {bs.Iter.tolist()})")
assert int(bs3.Iter.max()) <= int(bs.Iter.max())

# ── 3. checkpoint/resume for long batched runs ───────────────────────
# chunked solving with atomic .npz snapshots: a preempted job re-runs the
# same call and continues from the last finished chunk (finished
# instances stay frozen; the data fingerprint guards against resuming
# onto different problems)
with tempfile.TemporaryDirectory() as tmp:
    ckpt = os.path.join(tmp, "conicip_example_ckpt.npz")
    bs4 = solve_batch_resumable(Q, c, A, b, cones, store=ckpt,
                                chunk_iters=4, device=device)
    assert bs4.statuses == ["Optimal"] * B
    bs5 = solve_batch_resumable(  # resumes: everything already finished
        Q, c, A, b, cones, store=ckpt, chunk_iters=4, device=device
    )
    assert bs5.statuses == ["Optimal"] * B
print("checkpoint/resume: chunked solve + instant resume ok")
