"""Batched solving, its checkpointing, and distribution over
``torch.distributed`` (``conicip_tpu/parallel``): a stack sharded over a
mesh with ``solve_batch(mesh=...)``, one problem's Schur solve sharded with
:func:`kktsolver_schur_tp`."""

from .batch import (
    BatchSolution,
    make_batched_solver,
    make_batched_warm_solver,
    solve_batch,
)
from .checkpoint import SnapshotInfo, load_snapshot, solve_batch_resumable
from .distributed import distributed_normal_matrix, kktsolver_schur_tp
from .mesh import make_mesh

__all__ = [
    "solve_batch",
    "solve_batch_resumable",
    "load_snapshot",
    "SnapshotInfo",
    "BatchSolution",
    "make_batched_solver",
    "make_batched_warm_solver",
    "kktsolver_schur_tp",
    "distributed_normal_matrix",
    "make_mesh",
]
