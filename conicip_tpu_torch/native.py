"""ctypes binding of the host C++ column-pivoted QR.

Counterpart of ``conicip_tpu/native/__init__.py`` with its own loader: the
source is ``native/pivoted_qr.cpp`` at the repository root, built on demand
with the host compiler into this package's ``_build/`` directory. When the
source or a compiler is missing :func:`pivoted_qr_rank` returns ``None`` and
the caller uses ``scipy.linalg.qr(..., pivoting=True)``; :func:`backend`
says which of the two a process ends up with. Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["pivoted_qr_rank", "available", "backend"]

_PKG = Path(__file__).resolve().parent
_SOURCE = _PKG.parent / "native" / "pivoted_qr.cpp"
_BUILD = _PKG / "_build"
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_library() -> Optional[Path]:
    if not _SOURCE.exists():
        return None
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return None
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
    lib = _BUILD / f"pivoted_qr-{digest}.so"
    if lib.exists():
        return lib
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, str(_SOURCE)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except Exception:
        return None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _build_library()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.cip_pivoted_qr.restype = ctypes.c_int
        lib.cip_pivoted_qr.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def pivoted_qr_rank(A: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Column-pivoted QR rank data of ``A``: ``(rdiag, piv)`` with |R_kk| for
    k < min(m, n) and the column permutation, or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    A = np.ascontiguousarray(A, dtype=np.float64).copy()
    m, n = A.shape
    rdiag = np.zeros(min(m, n), dtype=np.float64)
    piv = np.zeros(n, dtype=np.int64)
    rc = lib.cip_pivoted_qr(
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(m),
        ctypes.c_long(n),
        rdiag.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        piv.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if rc != 0:
        return None
    return rdiag, piv


def available() -> bool:
    return _load() is not None


def backend() -> str:
    """``"native"`` when the C++ pivoted QR is loaded, else ``"scipy"``."""
    return "native" if available() else "scipy"
