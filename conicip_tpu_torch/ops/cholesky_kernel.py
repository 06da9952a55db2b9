"""The hand-written CUDA Cholesky (``csrc/cholesky.cu``) and its plain twin.

Counterpart of ``conicip_tpu/ops/pallas_cholesky.py``. :func:`cholesky_factor`
is the wrapper: for a tensor on the CPU it runs :func:`cholesky_plain`; for
a CUDA tensor it launches the kernel or raises, and never falls back.

Both return the lower factor with the strict upper triangle zeroed, and
both leave non-finite values where the matrix is not positive definite
(the kernel NaN from the failing pivot on, the plain version everywhere in
the lower triangle, as JAX's CPU factor does). The Schur solver's ridge
retry depends on that.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .build import load_library

__all__ = ["cholesky_factor", "cholesky_plain", "cholesky_launches",
           "launch_count", "reset_launch_count"]

# Launches of the CUDA kernel, keyed by (dtype, order): the dtype names the
# entry point that ran. Counted by the wrapper where it launches and
# nowhere else.
cholesky_launches: Counter = Counter()


def launch_count(dtype=None, n=None) -> int:
    """Kernel launches so far, optionally of one entry point (``dtype``)
    and of one matrix order (``n``)."""
    return sum(c for (dt, k), c in cholesky_launches.items()
               if dtype in (None, dt) and n in (None, k))


def reset_launch_count() -> None:
    cholesky_launches.clear()


_ENTRY = {torch.float64: "conicip_cholesky_f64",
          torch.float32: "conicip_cholesky_f32"}

# Panel width of the kernel: above it, the kernel needs a scratch buffer for
# the inverse of each diagonal block (PANEL x PANEL) and one counter.
PANEL = 128


def cholesky_plain(M: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, batched over leading dims: each factor is
    NaN-filled (lower triangle) where its factorization fails. It never
    reads ``info`` back to the host."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info[..., None, None] == 0, L, torch.nan).tril()


def _entry(dtype):
    fn = getattr(load_library("cholesky"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cholesky_factor(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the (n, n) SPD matrix ``M``."""
    if M.device.type == "cpu":
        return cholesky_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"cholesky_factor: unsupported device {M.device}")
    if M.dtype not in _ENTRY:
        raise TypeError(f"cholesky_factor: unsupported dtype {M.dtype}")
    if M.dim() != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"cholesky_factor: expected a square matrix, got "
                         f"shape {tuple(M.shape)}")
    if not M.is_contiguous():
        raise ValueError("cholesky_factor: M must be contiguous")
    n = M.shape[0]
    out = torch.empty_like(M)
    if n == 0:
        return out
    work = (torch.empty(PANEL * PANEL + 1, dtype=M.dtype, device=M.device)
            if n > PANEL else None)
    fn = _entry(M.dtype)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        err = fn(M.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"cholesky kernel launch failed: CUDA error {err}")
    cholesky_launches[(M.dtype, n)] += 1
    return out
