"""Batched solving and its checkpointing (``conicip_tpu/parallel``'s
``batch`` and ``checkpoint``). Sharding a batch over a device mesh and the
distributed Schur solver are not part of this package yet."""

from .batch import (
    BatchSolution,
    make_batched_solver,
    make_batched_warm_solver,
    solve_batch,
)
from .checkpoint import SnapshotInfo, load_snapshot, solve_batch_resumable

__all__ = [
    "solve_batch",
    "solve_batch_resumable",
    "load_snapshot",
    "SnapshotInfo",
    "BatchSolution",
    "make_batched_solver",
    "make_batched_warm_solver",
]
