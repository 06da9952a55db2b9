"""The hand-written CUDA Cholesky (``csrc/cholesky.cu``) and its plain twin.

Counterpart of ``conicip_tpu/ops/pallas_cholesky.py``. :func:`cholesky_factor`
is the wrapper: for a tensor on the CPU it runs :func:`cholesky_plain`; for
a CUDA tensor it launches the kernel or raises, and never falls back. An
(n, n) matrix goes to the kernel's single entry, a stack (..., n, n) to its
batched entry, where the batch is a grid dimension: the launches of one
matrix whatever the stack's size, and per matrix the single entry's factor.

Both return the lower factor with the strict upper triangle zeroed, and
both leave non-finite values where the matrix is not positive definite
(the kernel NaN from the failing pivot on, the plain version everywhere in
the lower triangle, as JAX's CPU factor does). The Schur solver's ridge
retry depends on that.

Both also take a predicated form, ``(M, skip=flags, out=L)``: where a
matrix's flag (a bool tensor on M's device, one per matrix) is set, its
factor is not computed and ``out`` keeps what it held; elsewhere the factor
is written into ``out``. The kernel reads the flags on the device (its
launches return at once for a flagged matrix), so the caller reads nothing
back; the plain version selects with ``torch.where``.

The same family holds the explicit inverse of a lower factor,
:func:`tri_inverse`: on a CUDA tensor the kernel's inverse entries (f64 or
f32, single or batched; one launch up to n = 128, else ``ceil(n / 128) +
1``, the block algorithm of ``csrc/cholesky.cu``, with a scratch of L's
size), on the CPU :func:`tri_inverse_plain`, a triangular solve against the
identity. Both read the lower triangle only, write the strict upper
triangle as zeros, and give a non-finite inverse for a non-finite factor,
each matrix of a stack on its own.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .build import load_library

__all__ = ["cholesky_factor", "cholesky_plain", "tri_inverse",
           "tri_inverse_plain", "cholesky_launches", "predicated_launches",
           "inverse_launches", "launch_count", "reset_launch_count",
           "graph_edges"]

# Launches of the CUDA kernel, keyed by (dtype, order) for the single
# entries and (dtype, order, B) for the batched ones: the dtype names the
# entry point that ran. Counted by the wrapper where it launches and
# nowhere else: unconditional factors in ``cholesky_launches``, predicated
# ones (``skip`` given; whether a matrix was factored is known only on the
# device) apart in ``predicated_launches``. A CUDA graph's replays add what
# its capture counted (solver/graph.py). The inverses, one a call of
# :func:`tri_inverse` whatever its launches, apart in ``inverse_launches``,
# keyed alike.
cholesky_launches: Counter = Counter()
predicated_launches: Counter = Counter()
inverse_launches: Counter = Counter()


def launch_count(dtype=None, n=None, batch=None, counter="factor") -> int:
    """Kernel launches so far, optionally of one dtype's entry points
    (``dtype``) and of one matrix order (``n``). ``batch`` picks the entry:
    ``None`` counts both, ``False`` the single entry only, ``True`` the
    batched entry (``cholesky_launches[(dtype, n, B)]`` is the count at one
    stack size). ``counter`` picks the counter: ``"factor"`` the
    unconditional factors, ``"predicated"`` the predicated ones,
    ``"inverse"`` the inverses."""
    counts = {"factor": cholesky_launches, "predicated": predicated_launches,
              "inverse": inverse_launches}[counter]
    total = 0
    for key, c in counts.items():
        dt, k = key[:2]
        if dtype not in (None, dt) or n not in (None, k):
            continue
        if batch is None or batch == (len(key) == 3):
            total += c
    return total


def reset_launch_count() -> None:
    cholesky_launches.clear()
    predicated_launches.clear()
    inverse_launches.clear()


_ENTRY = {torch.float64: "conicip_cholesky_f64",
          torch.float32: "conicip_cholesky_f32"}
_BATCHED_ENTRY = {torch.float64: "conicip_cholesky_batched_f64",
                  torch.float32: "conicip_cholesky_batched_f32"}
_INVERSE_ENTRY = {torch.float64: "conicip_tri_inv_f64",
                  torch.float32: "conicip_tri_inv_f32"}
_INVERSE_BATCHED_ENTRY = {torch.float64: "conicip_tri_inv_batched_f64",
                          torch.float32: "conicip_tri_inv_batched_f32"}

# Panel width of the kernel: above it, the kernel needs a scratch buffer for
# the inverse of each diagonal block (PANEL x PANEL) and one counter; a
# batch has one such scratch per matrix, WORK_PAD elements apart beyond the
# block so that each stays 16-byte aligned.
PANEL = 128
WORK_PAD = 4
# the batch is a grid dimension, which CUDA caps
MAX_GRID_BATCH = 65535


def _check_predicate(M, skip, out):
    if skip is None:
        return
    if out is None:
        raise ValueError("a predicated factor needs `out`, whose matrices "
                         "the flagged ones keep")
    if skip.dtype != torch.bool or tuple(skip.shape) != tuple(M.shape[:-2]):
        raise ValueError(f"skip must be a bool tensor of shape "
                         f"{tuple(M.shape[:-2])}, got {skip.dtype} "
                         f"{tuple(skip.shape)}")
    if skip.device != M.device:
        raise ValueError("skip must lie on M's device")
    if out.shape != M.shape or out.dtype != M.dtype or out.device != M.device:
        raise ValueError("out must match M's shape, dtype and device")


def cholesky_plain(M: torch.Tensor, skip=None, out=None) -> torch.Tensor:
    """Plain PyTorch version, batched over leading dims: each factor is
    NaN-filled (lower triangle) where its factorization fails. It never
    reads ``info`` back to the host. With ``skip``, the flagged matrices
    are ``out``'s (module docstring)."""
    _check_predicate(M, skip, out)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where(info[..., None, None] == 0, L, torch.nan).tril()
    return L if skip is None else torch.where(skip[..., None, None], out, L)


def _entry(dtype, batched=False):
    fn = getattr(load_library("cholesky"),
                 (_BATCHED_ENTRY if batched else _ENTRY)[dtype])
    ints = [ctypes.c_int] * (2 if batched else 1)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   *ints, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _inverse_entry(dtype, batched=False):
    names = _INVERSE_BATCHED_ENTRY if batched else _INVERSE_ENTRY
    fn = getattr(load_library("cholesky"), names[dtype])
    ints = [ctypes.c_int] * (2 if batched else 1)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   *ints, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def graph_edges(graph) -> tuple[int, int]:
    """(edges, programmatic edges) of a captured ``torch.cuda.CUDAGraph``
    made with ``keep_graph=True``: whether the capture kept the factor's
    programmatic dependent launches as such."""
    fn = load_library("cholesky").conicip_graph_edges
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    total, prog = ctypes.c_longlong(), ctypes.c_longlong()
    err = fn(graph.raw_cuda_graph(), ctypes.byref(total), ctypes.byref(prog))
    if err != 0:
        raise RuntimeError(f"graph edge query failed: CUDA error {err}")
    return total.value, prog.value


def cholesky_factor(M: torch.Tensor, skip=None, out=None) -> torch.Tensor:
    """Lower Cholesky factor of the SPD matrix ``M`` (n, n), or of every
    matrix of a stack (..., n, n); with ``skip``, the predicated factor
    into ``out`` (module docstring)."""
    if M.device.type == "cpu":
        return cholesky_plain(M, skip, out)
    if M.device.type != "cuda":
        raise ValueError(f"cholesky_factor: unsupported device {M.device}")
    if M.dtype not in _ENTRY:
        raise TypeError(f"cholesky_factor: unsupported dtype {M.dtype}")
    if M.dim() < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"cholesky_factor: expected square matrices, got "
                         f"shape {tuple(M.shape)}")
    if not M.is_contiguous():
        raise ValueError("cholesky_factor: M must be contiguous")
    _check_predicate(M, skip, out)
    if skip is None:
        out = torch.empty_like(M)
    elif not (out.is_contiguous() and skip.is_contiguous()):
        raise ValueError("cholesky_factor: out and skip must be contiguous")
    n = M.shape[-1]
    if M.numel() == 0:
        return out
    batched = M.dim() > 2
    B = M.numel() // (n * n)
    if B > MAX_GRID_BATCH:
        raise ValueError(f"cholesky_factor: a stack of {B} matrices exceeds "
                         f"the kernel's {MAX_GRID_BATCH}")
    work = None
    if n > PANEL:
        per = PANEL * PANEL + (WORK_PAD if batched else 1)
        work = torch.empty(B * per, dtype=M.dtype, device=M.device)
    fn = _entry(M.dtype, batched)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        sizes = (B, n) if batched else (n,)
        err = fn(M.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), *sizes,
                 None if skip is None else skip.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cholesky kernel launch failed: CUDA error {err}")
    counter = cholesky_launches if skip is None else predicated_launches
    counter[(M.dtype, n, B) if batched else (M.dtype, n)] += 1
    return out


def tri_inverse_plain(L: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, batched over leading dims: the triangular
    solve of L X = I, the lower triangle of L read."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def tri_inverse(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of the lower factor ``L`` (n, n), or of every
    matrix of a stack (..., n, n), strict upper triangle zero (module
    docstring)."""
    if L.device.type == "cpu":
        return tri_inverse_plain(L)
    if L.device.type != "cuda":
        raise ValueError(f"tri_inverse: unsupported device {L.device}")
    if L.dtype not in _INVERSE_ENTRY:
        raise TypeError(f"tri_inverse: unsupported dtype {L.dtype}")
    if L.dim() < 2 or L.shape[-1] != L.shape[-2]:
        raise ValueError(f"tri_inverse: expected square matrices, got "
                         f"shape {tuple(L.shape)}")
    if not L.is_contiguous():
        raise ValueError("tri_inverse: L must be contiguous")
    X = torch.empty_like(L)
    n = L.shape[-1]
    if L.numel() == 0:
        return X
    batched = L.dim() > 2
    B = L.numel() // (n * n)
    if B > MAX_GRID_BATCH:
        raise ValueError(f"tri_inverse: a stack of {B} matrices exceeds "
                         f"the kernel's {MAX_GRID_BATCH}")
    # the scratch of the block rows' products, above one panel
    W = torch.empty_like(L) if n > PANEL else None
    fn = _inverse_entry(L.dtype, batched)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        sizes = (B, n) if batched else (n,)
        err = fn(L.data_ptr(), X.data_ptr(),
                 None if W is None else W.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"triangular inverse launch failed: CUDA error "
                           f"{err}")
    inverse_launches[(L.dtype, n, B) if batched else (L.dtype, n)] += 1
    return X
