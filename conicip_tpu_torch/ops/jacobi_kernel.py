"""The hand-written CUDA Jacobi eigendecomposition and SVD (``csrc/jacobi.cu``).

Stacks (..., d, d) of the S cones' small matrices: :func:`eigh` (values
ascending and vectors), :func:`eigvalsh` (values only) and :func:`svd` (U
and σ descending, no V), in f64 or f32 (computed in double, read and
written in f32). Each is one launch for the whole stack: one warp per
matrix for d <= 32 (every order the S cones give), one thread block per
matrix above. An entry whose input is not finite, or that does not
converge within ``MAX_SWEEPS`` sweeps, comes back NaN in every output and
the others are untouched: nothing is read back to the host and nothing
raises for it. :func:`rotation_check` holds the d <= 32 kernels'
branch-free rotation to the library's rounding (a check the tests and
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

import torch

from .build import load_library

__all__ = ["eigh", "eigvalsh", "svd", "jacobi_launches", "launch_count",
           "reset_launch_count", "rotation_check", "MAX_SWEEPS", "KINDS"]

# Launches of the kernels, keyed by (kind, dtype, d, stack size), kind one
# of KINDS. Counted by the wrapper where it launches and nowhere else.
jacobi_launches: Counter = Counter()

KINDS = ("eigvalsh", "eigh", "svd")  # the C side's kind numbers, in order
# Sweeps before an entry is given up on (NaN). Cyclic Jacobi converges
# quadratically: the paths' matrices take well under ten.
MAX_SWEEPS = 40

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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.conicip_jacobi_work_elems.argtypes = [ctypes.c_int] * 2
    lib.conicip_jacobi_work_elems.restype = ctypes.c_longlong
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
    lib = _library()
    # scratch in device memory where the matrices do not fit on chip
    per = lib.conicip_jacobi_work_elems(KINDS.index(kind), d)
    work = (torch.empty(B * per, dtype=torch.float64, device=A.device) if per
            else None)
    fn = getattr(lib, _ENTRY[("svd" if kind == "svd" else "eigh", A.dtype)])
    ptr = (None if mats is None else mats.data_ptr())
    first, second = ((ptr, vec.data_ptr()) if kind == "svd"
                     else (vec.data_ptr(), ptr))
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), first, second,
                 None if work is None else work.data_ptr(), B, d, max_sweeps,
                 stream)
    if err != 0:
        raise RuntimeError(f"jacobi {kind} kernel launch failed: CUDA error "
                           f"{err}")
    jacobi_launches[(kind, A.dtype, d, B)] += 1
    return (mats, vec) if kind == "svd" else (vec, mats)


def rotation_check(app: torch.Tensor, apq: torch.Tensor,
                   aqq: torch.Tensor) -> tuple[int, int]:
    """Holds the d <= 32 kernels' branch-free rotation (the fast paths of the
    correctly rounded division, reciprocal and square root) against the
    library's rounding on CUDA f64 vectors of (a_pp, a_pq, a_qq): returns
    (triples whose (c, s, t) differ in a bit while the fast paths hold, which
    must be 0; triples that leave a fast path, where the kernels take the
    library's values). Reads the two counts back; not used by the solver."""
    for v in (app, apq, aqq):
        if v.device.type != "cuda" or v.dtype != torch.float64:
            raise ValueError("rotation_check takes CUDA float64 vectors")
    app, apq, aqq = (v.contiguous() for v in (app, apq, aqq))
    counts = torch.zeros(2, dtype=torch.int64, device=app.device)
    with torch.cuda.device(app.device):
        stream = torch.cuda.current_stream(app.device).cuda_stream
        err = _library().conicip_jacobi_rotation_check(
            app.data_ptr(), apq.data_ptr(), aqq.data_ptr(), app.numel(),
            counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"jacobi rotation check failed: CUDA error {err}")
    mismatched, slow = counts.tolist()
    return mismatched, slow


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
