"""Data-parallel batched solving: stacked solves, a stack sharded over a
mesh of ranks, warm re-solves, and checkpoint/resume.

The first free parallelism axis is the PROBLEM BATCH: the IPM core is
mask-based and takes a leading batch axis on every operand, so a stack of
B independent conic QPs is one loop whose per-iteration work is batched
products, factors and decompositions. This example walks the workflow:

1. ``solve_batch`` on a stack of scenario QPs (B solves, one loop),
2. the same kind of stack sharded over a ``torch.distributed`` mesh: one
   process per rank, every rank making the same call, solving its slice
   and getting the whole answer back (no collective between instances
   until the final gather),
3. warm-started re-solves of a drifted batch (rolling re-optimization),
4. ``solve_batch_resumable``: chunked solving with atomic checkpoints.

Run: python examples/torch/parallel.py    (on the GPU; the mesh is a
     world of one rank there)
     python examples/torch/parallel.py --cpu    (on the CPU; the mesh is
     two gloo ranks that the script starts; CONICIP_TORCH_DEVICE=cpu does
     the same)
"""

import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from conicip_tpu_torch import make_mesh
from conicip_tpu_torch.parallel import solve_batch, solve_batch_resumable
from conicip_tpu_torch.parallel.mesh import spawn_world, start_rank

device = ("cpu" if "--cpu" in sys.argv[1:]
          else os.environ.get("CONICIP_TORCH_DEVICE", "cuda"))

B, n = 8, 40
rng = np.random.default_rng(0)
Q = np.stack([np.diag(1.0 + rng.random(n)) for _ in range(B)])
c = rng.standard_normal((B, n))
A = np.stack([np.vstack([np.eye(n), -np.eye(n)])] * B)
b = np.stack([-np.ones(2 * n)] * B)
cones = [("R", 2 * n)]


def sharded_leg(rank, world, init):
    """Leg 2 on one rank: a stack of 2 instances per rank over a mesh of
    ``world`` ranks."""
    dev = start_rank(rank, world, init, torch.device(device).type)
    try:
        mesh = make_mesh((world,), ("batch",), device_type=dev.type)
        Bs = 2 * world
        bs2 = solve_batch(
            np.broadcast_to(Q[0], (Bs, n, n)),
            np.random.default_rng(1).standard_normal((Bs, n)),
            np.broadcast_to(A[0], (Bs, 2 * n, n)),
            np.broadcast_to(b[0], (Bs, 2 * n)),
            cones, mesh=mesh, batch_axis="batch", device=dev,
        )
    finally:
        torch.distributed.destroy_process_group()
    assert bs2.statuses == ["Optimal"] * Bs
    print(f"rank {rank} of {world}: mesh-sharded batch of {Bs}: all Optimal",
          flush=True)


if __name__ == "__main__" and "--mesh-rank" in sys.argv:
    # one rank of the CPU world that leg 2 starts
    k = sys.argv.index("--mesh-rank")
    sharded_leg(int(sys.argv[k + 1]), 2, sys.argv[k + 2])
    sys.exit(0)

# ── 1. a batch of scenario QPs: same structure, different data ──────
bs = solve_batch(Q, c, A, b, cones, device=device)
assert bs.statuses == ["Optimal"] * B
resid = torch.maximum(bs.prFeas, torch.maximum(bs.duFeas, bs.muFeas))
print(f"batch of {B}: all Optimal, max resid {float(resid.max()):.2e}, "
      f"iters {bs.Iter.tolist()}")

# ── 2. the same kind of stack sharded over a mesh of ranks ──────────
# On the card: a world of one rank, started here. On the CPU: two gloo
# ranks, each this script run with --mesh-rank (every rank must make the
# same solve_batch call, so each is a process of its own).
if torch.device(device).type == "cuda":
    with tempfile.TemporaryDirectory() as tmp:
        sharded_leg(0, 1, "file://" + os.path.join(tmp, "rendezvous"))
else:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[2])]
        + [p for p in [env.get("PYTHONPATH")] if p])
    world = spawn_world(
        lambda k, init: [sys.executable, __file__, "--cpu", "--mesh-rank",
                         str(k), init], 2, timeout=300, env=env)
    assert world.ok, f"ranks exited {world.codes}:\n" + "\n".join(world.err)
    print("".join(world.out), end="")

# ── 3. warm-started re-solve of a drifted batch ──────────────────────
# rolling re-optimization: the new batch seeds from the old solutions,
# which stay on the device
c_drift = c + 0.01 * rng.standard_normal((B, n))
bs3 = solve_batch(Q, c_drift, A, b, cones, warm_start=bs, device=device)
assert bs3.statuses == ["Optimal"] * B
print(f"warm re-solve after drift: iters {bs3.Iter.tolist()} "
      f"(cold was {bs.Iter.tolist()})")
assert int(bs3.Iter.max()) <= int(bs.Iter.max())

# ── 4. checkpoint/resume for long batched runs ───────────────────────
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
