"""Four-rank dry run of the distributed paths on one host.

Counterpart of ``tools/dryrun_multiprocess.py``. It starts four ranks as
four processes, forms a (2, 2) ``("dp", "tp")`` mesh over them and runs:

- the dp leg: ``solve_batch`` of ``batched_box_qp(16, n=16)`` sharded over
  both mesh axes (``batch_axis=("dp", "tp")``, four instances per rank);
- the tp leg: one n = 24 box QP through ``kktsolver_schur_tp`` on the
  ``"tp"`` sub-groups (two ranks each factor it together).

    python -m conicip_tpu_torch.parallel.dryrun [--cpu]

runs on the card by default (NCCL when every rank has a card of its own,
gloo when ranks share one) and with ``--cpu`` on gloo and the CPU. It exits
0 only when every rank reports everything Optimal.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .mesh import make_mesh, spawn_world, start_rank

WORLD = 4
DP_BATCH = 16
TIMEOUT = 600.0  # seconds the four ranks may take in all


def dp_leg(mesh, device):
    """The batch sharded over every rank of the mesh."""
    from ..models import batched_box_qp
    from .batch import solve_batch

    Q, c, A, b, cones = batched_box_qp(batch=DP_BATCH, n=16)
    return solve_batch(Q, c, A, b, cones, mesh=mesh, batch_axis=("dp", "tp"),
                       optTol=1e-6, maxIters=30, device=device)


def tp_problem(n: int = 24):
    """The dry run's tp problem: a dense box QP, min ½yᵀQy − cᵀy over
    −1 ≤ y ≤ 1, as ``conic_ip``'s positional arguments."""
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, n))
    Q = B.T @ B / n + np.eye(n)
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    return Q, c, A, -np.ones(2 * n), [("R", 2 * n)]


def tp_leg(mesh, device):
    """One problem whose Schur solve is split over the mesh's "tp" axis."""
    from ..solver import conic_ip
    from .distributed import kktsolver_schur_tp

    return conic_ip(*tp_problem(), kktsolver=kktsolver_schur_tp(mesh, "tp"),
                    optTol=1e-6, device=device)


def _rank(rank: int, init: str, device_type: str) -> int:
    torch.set_num_threads(1)
    device = start_rank(rank, WORLD, init, device_type)
    try:
        mesh = make_mesh((2, 2), ("dp", "tp"), device_type=device.type)
        bs = dp_leg(mesh, device)
        sol = tp_leg(mesh, device)
    finally:
        torch.distributed.destroy_process_group()
    ok = bs.statuses == ["Optimal"] * DP_BATCH and sol.status == "Optimal"
    print(f"rank {rank}: dp batch={DP_BATCH} {dict(Counter(bs.statuses))} "
          f"+ tp n=24 {sol.status}/{sol.Iter}", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the ranks on the CPU (gloo)")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--init", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    device_type = "cpu" if args.cpu else "cuda"
    if args.rank is not None:
        return _rank(args.rank, args.init, device_type)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            print("dryrun: no CUDA device (--cpu runs on the CPU)",
                  file=sys.stderr)
            return 2
        # build the kernel once here, so that the ranks only load it
        from ..ops.build import load_library

        load_library("cholesky")
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    world = spawn_world(
        lambda k, init: [sys.executable, "-m", __spec__.name, "--rank",
                         str(k), "--init", init] + ["--cpu"] * args.cpu,
        WORLD, TIMEOUT, env=env)
    for k in range(WORLD):
        print(world.out[k], end="")
        if world.codes[k] != 0:
            print(f"rank {k} exited {world.codes[k]}:\n{world.err[k]}",
                  file=sys.stderr)
    if not world.ok:
        print(f"dryrun failed: exit codes {world.codes}"
              + (" (timed out)" if world.timed_out else ""), file=sys.stderr)
        return 1
    print(f"dryrun OK: {WORLD} ranks on a (2, 2) ('dp', 'tp') mesh "
          f"({device_type}), dp + tp legs all Optimal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
