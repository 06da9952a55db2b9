"""Meshes of ranks, collectives along one mesh dimension, and worlds of
processes on one host.

Counterpart of ``conicip_tpu/parallel/mesh.py``. A JAX mesh is an array of
devices driven by one controller; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group, one process per rank, each running the same program (SPMD).
:func:`make_mesh` builds it over the default process group, which the
caller starts (``torch.distributed.init_process_group``, or
:func:`start_rank` in a world that :func:`spawn_world` launched).

:class:`MeshAxis` holds one mesh dimension as this rank sees it and maps
the reference's collectives onto ``torch.distributed``:

==============================  =================================
reference (``shard_map``)       port
==============================  =================================
``psum``                        ``all_reduce`` (SUM)
``psum_scatter(tiled=True)``    ``reduce_scatter``
``all_gather(tiled=True)``      ``all_gather``
psum of a one-rank block        ``broadcast`` from that rank
==============================  =================================

The list forms ``all_gather`` and ``reduce_scatter`` are used because the
tensor forms (``all_gather_into_tensor``, ``reduce_scatter_tensor``) warn as
deprecated on newer torch, and their replacements are missing from older
ones. NCCL and gloo both run all four on CUDA tensors (gloo copies them
through host memory itself); NCCL takes one rank per card, so ranks that
share a card use gloo (:func:`start_rank`).

Under a CUDA graph's capture (solver/graph.py) the NCCL collectives are
captured as they are issued; the list forms' staging buffers are then
allocated in the capture's memory pool. Gloo's are not: it copies CUDA
tensors through host memory, which a graph cannot hold, so a solve whose
collectives run over gloo on the card keeps the eager loop.
"""

from __future__ import annotations

import datetime
import math
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "MeshAxis", "start_rank", "spawn_world", "World"]


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("dp", "tp"),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the default process group.

    The default layout puts all ranks on the first (data-parallel) axis
    and gives every other axis size 1; ``axis_sizes`` splits them. The
    default process group must already be started: this never starts one.
    ``device_type="cpu"`` builds a mesh for CPU tensors (gloo)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group first")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if math.prod(axis_sizes) != world:
        raise ValueError(f"mesh {axis_sizes} does not match {world} ranks")
    return init_device_mesh(device_type, axis_sizes,
                            mesh_dim_names=tuple(axis_names[:len(axis_sizes)]))


class MeshAxis:
    """One dimension of a mesh as this rank sees it: its process group and
    that group's backend (``"nccl"`` or ``"gloo"``), its size and this
    rank's place along it, with the collectives of the module docstring.
    Every rank of the group must make the same calls in the same order."""

    def __init__(self, mesh, axis: str):
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"expected a DeviceMesh (conicip_tpu_torch.make_mesh), got "
                f"{type(mesh).__name__}")
        if axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {axis!r}: its axes are "
                             f"{mesh.mesh_dim_names}")
        self.group = mesh.get_group(axis)
        self.backend = str(dist.get_backend(self.group))
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the axis (``psum``), in place: pass a
        temporary."""
        dist.all_reduce(x, group=self.group)
        return x

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of rows of the sum of ``x`` over the axis
        (``psum_scatter(tiled=True)`` on dim 0, which the axis size
        divides)."""
        parts = list(x.contiguous().chunk(self.size))
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along dim 0 in axis order
        (``all_gather(tiled=True)``)."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather(list(out.chunk(self.size)), x, group=self.group)
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """``x`` of the rank at place ``src`` along the axis, on every rank
        (overwrites ``x`` elsewhere)."""
        dist.broadcast(x, src=dist.get_global_rank(self.group, src),
                       group=self.group)
        return x


def start_rank(rank: int, world: int, init_method: str,
               device_type: str = "cuda",
               timeout: float = 120.0) -> torch.device:
    """Start the default process group of one rank of a world on this host
    and return the device its tensors live on. CPU ranks use gloo. CUDA
    ranks take a card each (``rank % cards``) and use NCCL when every rank
    has a card of its own, gloo when ranks share one (NCCL refuses two
    ranks on one card). A collective that waits ``timeout`` seconds
    raises."""
    if device_type == "cpu":
        backend, device = "gloo", torch.device("cpu")
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("start_rank: no CUDA device")
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if world <= cards else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return device


class World(NamedTuple):
    """How the ranks of a :func:`spawn_world` call ended."""

    codes: List[int]  # exit codes; negative where a rank was killed
    out: List[str]  # standard output of each rank
    err: List[str]  # standard error of each rank
    timed_out: bool

    @property
    def ok(self) -> bool:
        return not self.timed_out and all(c == 0 for c in self.codes)


def spawn_world(argv: Callable[[int, str], Sequence[str]], world: int,
                timeout: float, env: Optional[dict] = None) -> World:
    """Run ``world`` processes on this host, rank k running the command
    ``argv(k, init_method)``, where ``init_method`` is a ``file://``
    rendezvous in a fresh temporary directory (no port to collide on).

    Waits at most ``timeout`` seconds in all. When a rank fails or the time
    runs out, every rank still running is killed: a rank that raised would
    otherwise leave the others waiting in a collective. Returns what each
    rank printed and how it ended."""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        logs = [(os.path.join(tmp, f"rank{k}.out"),
                 os.path.join(tmp, f"rank{k}.err")) for k in range(world)]
        procs = []
        timed_out = False
        try:
            for k, (out, err) in enumerate(logs):
                with open(out, "w") as fo, open(err, "w") as fe:
                    procs.append(subprocess.Popen(
                        list(argv(k, init)), stdout=fo, stderr=fe,
                        stdin=subprocess.DEVNULL, env=env))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        texts = [(Path(out).read_text(), Path(err).read_text())
                 for out, err in logs]
    return World([p.returncode for p in procs], [o for o, _ in texts],
                 [e for _, e in texts], timed_out)
