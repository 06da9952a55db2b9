"""The hand-written CUDA Jacobi eigendecomposition and SVD (``csrc/jacobi.cu``).

Stacks (..., d, d) of the S cones' small matrices: :func:`eigh` (values
ascending and vectors), :func:`eigvalsh` (values only) and :func:`svd` (U
and σ descending, no V), in f64 or f32 (computed in double, read and
written in f32). Each is one launch for the whole stack: one warp per
matrix for d <= 32, one thread block per matrix above (d <= 2048), by the
plan of :func:`launch_plan`, a plain function of (kind, d, dtype): its
threads, its shared memory and whether the matrices fit there or take a
scratch buffer in device memory. An entry whose input is not finite, or
that does not converge within ``MAX_SWEEPS`` sweeps, comes back NaN in
every output and the others are untouched: nothing is read back to the
host and nothing raises for it. :func:`rotation_check` holds the eigh kernels'
branch-free rotation, under Rutishauser's negligible-element rule, to the
library's rounding under the same rule (a check the tests and
``chip_smoke.py`` run; the solver never calls it).

These take CUDA tensors only. ``ops/batched.py`` (``safe_eigh``,
``safe_eigvalsh``, ``safe_svd``) is the wrapper the cone code calls: for a
tensor on the CPU it runs the plain ``torch.linalg`` versions beside it,
for a CUDA tensor these kernels. Nothing here runs at import, so the module
imports on a CPU-only torch.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple

import torch

from .build import load_library

__all__ = ["eigh", "eigvalsh", "svd", "jacobi_launches", "launch_count",
           "reset_launch_count", "rotation_check", "MAX_SWEEPS", "KINDS",
           "Plan", "launch_plan", "smem_bytes"]

# Launches of the kernels, keyed by (kind, dtype, d, stack size), kind one
# of KINDS. Counted by the wrapper where it launches and nowhere else.
jacobi_launches: Counter = Counter()

KINDS = ("eigvalsh", "eigh", "svd")  # the C side's kind numbers, in order
# Sweeps before an entry is given up on (NaN). A random matrix takes 5-10
# up to d = 200. A spectrum of a few values, each repeated exactly (the
# central path's mat(λ) can have such), took 27 to more than 40 at
# d = 33-200 before the eigh kernels took Rutishauser's negligible-element
# rule: the blocks of rounding noise of its repeated values were turned by
# large angles, sweep after sweep. With the rule, a reflected three-value
# spectrum or a projector takes 1-11 sweeps at d = 5-200, the same values
# in a random orthogonal basis 4-24 (tests/jacobi_sweeps.py, --rule none
# for the counts without it). Hence 40, with room above the most.
MAX_SWEEPS = 40

# ── the launch plans of csrc/jacobi.cu ──

# the largest order of the one-warp kernels; the block kernels' largest
# (a row of pairs is at most one block of threads)
WARP_MAX_D = 32
BLOCK_MAX_D = 2048
# threads a block and shared memory a block may use on an H100 (sm_90)
MAX_THREADS = 1024
MAX_SMEM = 232448
_DOUBLE = 8


class Plan(NamedTuple):
    """How one launch runs: ``route`` "warp" (one warp a matrix) or "block"
    (one block a matrix) of ``threads``; ``lanes`` the block eigh kernel's
    threads a row of pairs (the pairs rounded up to 16) or the block SVD's
    lanes a pair; ``smem_bytes`` its dynamic shared memory; ``on_chip``
    whether the matrices are in it, else ``work_elems`` doubles of scratch
    in device memory per matrix."""
    route: str
    threads: int
    lanes: int
    smem_bytes: int
    on_chip: bool
    work_elems: int


def smem_bytes(kind: str, d: int, on_chip: bool = True) -> int:
    """Dynamic shared memory of a launch of ``kind`` at order d, with the
    matrices in it or not: the layout of csrc/jacobi.cu (warp_elems,
    block_head, block_mats), whose launch refuses a plan that counts it
    otherwise."""
    n = d + (d & 1)
    mats = (2 if kind == "eigh" else 1)
    if d <= WARP_MAX_D:  # the warp's matrices (odd row stride) and slots
        return _DOUBLE * (mats * n * (n | 1) + (n if kind == "svd" else 3 * n))
    # svd: sigma, ranks, warp slots; eigh: rotations, pairs, the diagonal,
    # warp slots (5 m + 32); then the d x d matrices where they fit
    head = 2 * n + 32 if kind == "svd" else 5 * (n // 2) + 32
    return _DOUBLE * (head + (mats * d * d if on_chip else 0))


def launch_plan(kind: str, d: int, dtype) -> Plan:
    """The launch of ``kind`` (one of :data:`KINDS`) on order-d matrices of
    ``dtype`` (both dtypes compute in double: the same plan). d <= 32: one
    warp. Above, one block: eigh and eigvalsh give each thread one column
    pair and every G-th row pair, a row of pairs being the m = ⌈d/2⌉ pairs
    rounded up to 16 threads (whole half-warps, for the banks) and G as many
    rows as fit in 1024 threads, whole warps; the SVD gives a pair 32 lanes
    up to m = 32 and 16 above, as many pairs at once as fit. The matrices
    sit in shared memory where they fit (eigh to d = 119, eigvalsh and svd
    to 169), else in device memory."""
    if kind not in KINDS:
        raise ValueError(f"jacobi kernels: no kind {kind!r}")
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"jacobi kernels: unsupported dtype {dtype}")
    if not 1 <= d <= BLOCK_MAX_D:
        raise ValueError(f"jacobi kernels: order {d} outside 1..{BLOCK_MAX_D}")
    if d <= WARP_MAX_D:
        return Plan("warp", 32, 32, smem_bytes(kind, d), True, 0)
    m = (d + 1) // 2
    if kind == "svd":
        lanes = 32 if m <= 32 else 16
        threads = min(m, MAX_THREADS // lanes) * lanes
        threads = -(-threads // 32) * 32
    else:
        lanes = -(-m // 16) * 16
        rows = min(m, MAX_THREADS // lanes)
        if rows * lanes % 32:
            if rows > 1:
                rows -= 1
            else:
                lanes += 16
        threads = rows * lanes
    on_chip = smem_bytes(kind, d, True) <= MAX_SMEM
    work = 0 if on_chip else (2 if kind == "eigh" else 1) * d * d
    return Plan("block", threads, lanes, smem_bytes(kind, d, on_chip),
                on_chip, work)


_ENTRY = {("eigh", torch.float64): "conicip_jacobi_eigh_f64",
          ("eigh", torch.float32): "conicip_jacobi_eigh_f32",
          ("svd", torch.float64): "conicip_jacobi_svd_f64",
          ("svd", torch.float32): "conicip_jacobi_svd_f32"}


def launch_count(kind=None, dtype=None, d=None) -> int:
    """Kernel launches so far, optionally of one kind (``"eigh"``,
    ``"eigvalsh"``, ``"svd"``), one dtype's entry and one order ``d``."""
    return sum(c for (k, dt, n, _), c in jacobi_launches.items()
               if kind in (None, k) and dtype in (None, dt) and d in (None, n))


def reset_launch_count() -> None:
    jacobi_launches.clear()


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("jacobi")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.conicip_jacobi_rotation_check.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.conicip_jacobi_rotation_check.restype = ctypes.c_int
    return lib


def _check(A: torch.Tensor, what: str) -> None:
    if A.device.type != "cuda":
        raise ValueError(f"jacobi {what}: unsupported device {A.device} (the "
                         "CPU takes ops.batched's plain version)")
    if A.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"jacobi {what}: unsupported dtype {A.dtype}")
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"jacobi {what}: expected square matrices, got "
                         f"shape {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError(f"jacobi {what}: the stack must be contiguous")


def _launch(kind: str, A: torch.Tensor, max_sweeps: int = MAX_SWEEPS):
    """One launch of ``kind`` on the stack A: (w, U) for eigh, (w, None) for
    eigvalsh, (U, σ) for svd. ``max_sweeps`` is the kernel's sweep limit."""
    _check(A, kind)
    d = A.shape[-1]
    lead = A.shape[:-2]
    vec = A.new_empty(lead + (d,))
    mats = None if kind == "eigvalsh" else torch.empty_like(A)
    B = A.numel() // (d * d) if d else 0
    if B == 0:
        return (mats, vec) if kind == "svd" else (vec, mats)
    plan = launch_plan(kind, d, A.dtype)
    lib = _library()
    # scratch in device memory where the matrices do not fit on chip
    work = (torch.empty(B * plan.work_elems, dtype=torch.float64,
                        device=A.device) if plan.work_elems else None)
    fn = getattr(lib, _ENTRY[("svd" if kind == "svd" else "eigh", A.dtype)])
    ptr = (None if mats is None else mats.data_ptr())
    first, second = ((ptr, vec.data_ptr()) if kind == "svd"
                     else (vec.data_ptr(), ptr))
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), first, second,
                 None if work is None else work.data_ptr(), B, d, max_sweeps,
                 plan.threads, plan.lanes, int(plan.on_chip),
                 plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"jacobi {kind} kernel launch failed: CUDA error "
                           f"{err}")
    jacobi_launches[(kind, A.dtype, d, B)] += 1
    return (mats, vec) if kind == "svd" else (vec, mats)


def rotation_check(app: torch.Tensor, apq: torch.Tensor,
                   aqq: torch.Tensor) -> tuple[int, int, int]:
    """Holds the eigh kernels' branch-free rotation (the fast paths of the
    correctly rounded division, reciprocal and square root, then
    Rutishauser's negligible-element rule) against the library's rounding
    under the same rule, on CUDA f64 vectors of (a_pp, a_pq, a_qq): returns
    (triples whose (c, s, t) differ in a bit where the fast paths hold or
    the rule takes a_pq, which must be 0; triples that leave a fast path
    and that the rule does not take, where the kernels take the library's
    values; triples whose a_pq the rule takes, set to 0 and not rotated).
    Reads the three counts back; not used by the solver."""
    for v in (app, apq, aqq):
        if v.device.type != "cuda" or v.dtype != torch.float64:
            raise ValueError("rotation_check takes CUDA float64 vectors")
    app, apq, aqq = (v.contiguous() for v in (app, apq, aqq))
    counts = torch.zeros(3, dtype=torch.int64, device=app.device)
    with torch.cuda.device(app.device):
        stream = torch.cuda.current_stream(app.device).cuda_stream
        err = _library().conicip_jacobi_rotation_check(
            app.data_ptr(), apq.data_ptr(), aqq.data_ptr(), app.numel(),
            counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"jacobi rotation check failed: CUDA error {err}")
    mismatched, slow, zeroed = counts.tolist()
    return mismatched, slow, zeroed


def eigh(A: torch.Tensor):
    """``(w, U)`` of the symmetric matrices (..., d, d) whose lower
    triangles A holds: w ascending, U's columns in the same order."""
    return _launch("eigh", A)


def eigvalsh(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of the symmetric (..., d, d), ascending."""
    return _launch("eigvalsh", A)[0]


def svd(M: torch.Tensor):
    """``(U, σ)`` of square (..., d, d): σ descending, U's columns the
    matching left singular vectors."""
    return _launch("svd", M)
