"""Checkpoint / resume for long batched solves.

Counterpart of ``conicip_tpu/parallel/checkpoint.py``:

- the batch is solved in *chunks* of ``chunk_iters`` interior-point
  iterations (one stacked solve per chunk, warm-started from the previous
  chunk's iterates: the same warm path ``solve_batch`` exposes);
- after each chunk the full iterate state (y, w, v and per-instance
  bookkeeping) is written atomically to an ``.npz`` snapshot of numpy
  arrays, with the reference's field names, so that a snapshot written by
  either package loads in the other;
- ``solve_batch_resumable`` with the same ``store`` path picks up from the
  snapshot: already-finished instances are frozen, unfinished ones continue
  from their saved iterates.

The snapshot also records a digest of the problem data, so resuming
against different data fails loudly instead of silently mixing batches.

Every chunk after the first is a warm stacked solve of one configuration
(the stack's shapes, ``maxIters=chunk_iters``), so on the device loop
(``solver/graph.py``) the first warm chunk builds its cache entry and every
later one, of this call or of a resumed one, hits it.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..solver.state import Status, to_host
from .batch import BatchSolution, solve_batch
from .mesh import MeshAxis

__all__ = ["solve_batch_resumable", "load_snapshot", "SnapshotInfo"]

_FIELDS = ("y", "w", "v", "status", "Iter", "Mu", "prFeas", "duFeas",
           "muFeas", "pobj", "dobj")


@dataclass
class SnapshotInfo:
    """Metadata of an on-disk snapshot."""

    iters_done: int
    n_finished: int
    batch: int

    @property
    def done(self) -> bool:
        return self.n_finished == self.batch


def _digest(*arrays, cone_dims=None) -> str:
    h = hashlib.sha256()
    h.update(repr(list(cone_dims or [])).encode())
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _save(path: str, state: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **state)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic on POSIX: a crash never corrupts


def load_snapshot(store: str) -> Optional[SnapshotInfo]:
    """Peek at a snapshot without solving."""
    if not os.path.exists(store):
        return None
    z = np.load(store)
    running = int((z["status"] == Status.RUNNING).sum())
    return SnapshotInfo(
        iters_done=int(z["iters_done"]),
        n_finished=int(z["status"].shape[0] - running),
        batch=int(z["status"].shape[0]),
    )


def solve_batch_resumable(
    Q,
    c,
    A,
    b,
    cone_dims: Sequence[Tuple[str, int]],
    G=None,
    d=None,
    *,
    store: str,
    chunk_iters: int = 10,
    maxIters: int = 100,
    **options,
) -> BatchSolution:
    """Batched solve with durable progress: state is snapshotted to
    ``store`` (an ``.npz`` path, written atomically) every ``chunk_iters``
    interior-point iterations, and an interrupted run re-invoked with the
    same arguments resumes from the snapshot instead of restarting.

    Accepts everything :func:`solve_batch` does (``mesh`` sharding,
    ``factor_dtype``, ``device``, ...). Semantics note: a chunk boundary
    warm-restarts the Mehrotra iteration (fresh initial scaling), so iterate
    trajectories differ slightly from an uninterrupted ``solve_batch``;
    statuses and residual tolerances do not.

    With a ``mesh`` every rank makes the call and holds the same gathered
    state; the lowest rank of the mesh writes the snapshot, and the call
    returns on no rank before the last write is done, so a later call
    reads a whole snapshot on every rank.
    """
    mesh = options.get("mesh")
    writer = mesh is None or dist.get_rank() == int(mesh.mesh.min())
    cn = to_host(c)
    batch = cn.shape[0]
    extra = [to_host(x) for x in (G, d) if x is not None]
    fingerprint = _digest(to_host(Q), cn, to_host(A), to_host(b), *extra,
                          cone_dims=cone_dims)

    # ── resume state ─────────────────────────────────────────────
    iters_done = 0
    frozen: dict = {}  # fields of finished instances, numpy
    warm = None
    active = np.ones(batch, dtype=bool)
    if os.path.exists(store):
        z = np.load(store)
        if str(z["fingerprint"]) != fingerprint:
            raise ValueError(
                f"snapshot {store!r} was written for different problem data"
            )
        iters_done = int(z["iters_done"])
        frozen = {k: np.array(z[k]) for k in _FIELDS}
        active = np.array(z["status"]) == Status.RUNNING
        warm = (np.array(z["warm_y"]), np.array(z["warm_w"]),
                np.array(z["warm_v"]))

    out: Optional[BatchSolution] = None
    while iters_done < maxIters and active.any():
        # constant chunk size; the global budget is enforced by the freeze
        # logic below, overshooting by at most chunk_iters - 1
        step = chunk_iters
        final = iters_done + step >= maxIters
        bs = solve_batch(
            Q, c, A, b, cone_dims, G, d,
            maxIters=step, warm_start=warm, backstop=final, **options,
        )
        iters_done += step

        # Freeze instances that reached a definitive status; Abandoned
        # within a chunk just means "not converged yet" unless the
        # iteration budget is exhausted.
        bs_status = to_host(bs.status)
        definitive = ~np.isin(bs_status, (Status.ABANDONED, Status.RUNNING))
        newly_done = active & (definitive | (iters_done >= maxIters))
        for k in _FIELDS:
            arr = np.array(to_host(getattr(bs, k)))
            if k == "Iter":  # cumulative across chunks
                arr = (iters_done - step + arr).astype(np.int32)
            if k not in frozen:
                frozen[k] = arr.copy()
            frozen[k][newly_done] = arr[newly_done]
        active = active & ~newly_done
        # mark still-active rows RUNNING in the snapshot so resume sees them
        snap_status = np.array(frozen["status"])
        snap_status[active] = Status.RUNNING
        frozen["status"] = snap_status

        warm = tuple(np.array(to_host(x)) for x in (bs.y, bs.w, bs.v))
        if writer:
            _save(store, dict(
                fingerprint=fingerprint, iters_done=iters_done,
                warm_y=warm[0], warm_w=warm[1], warm_v=warm[2],
                **frozen,
            ))
        out = bs

    # assemble the final BatchSolution from frozen fields
    fin = {k: np.array(v) for k, v in frozen.items()}
    # anything still RUNNING after maxIters is Abandoned
    fin["status"] = np.where(
        fin["status"] == Status.RUNNING, Status.ABANDONED, fin["status"]
    ).astype(np.int32)
    last = {k: np.array(to_host(getattr(out, k))) if out is not None else fin[k]
            for k in ("y", "w", "v")}
    if writer:
        _save(store, dict(
            fingerprint=fingerprint, iters_done=iters_done,
            warm_y=last["y"], warm_w=last["w"], warm_v=last["v"],
            **fin,
        ))
    if mesh is not None:
        # a barrier over the whole mesh: one all_reduce along each axis
        # (every rank waits for every other), then a host read
        flag = torch.zeros(1, device=mesh.device_type)
        for name in mesh.mesh_dim_names:
            MeshAxis(mesh, name).all_reduce(flag)
        flag.item()
    device = out.y.device if out is not None else torch.device(
        options.get("device", "cuda"))
    return BatchSolution(**{k: torch.as_tensor(v, device=device)
                            for k, v in fin.items()})
