"""The hand-written CUDA kernels of the R cones (``csrc/rcone.cu``).

One pass each over the (B, m) vectors of a stack of B instances (a single
solve is B = 1), in f64 or f32: :func:`scaling`, :func:`reduce4_pre`,
:func:`reduce4_post`, :func:`comp` (the corrector's, the refinement
residual's and the Gondzio trial's s-rows) and :func:`step`. Each takes
CUDA tensors only, contiguous, of one dtype and one device, and launches
its kernel on the current stream or raises: there is no other route.
``ops/rcone.py`` is the wrapper the solver calls: for tensors on the CPU it
runs the plain PyTorch twins beside it, for CUDA tensors these. Nothing
here runs at import, so the module imports on a CPU-only torch.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from .build import load_library

__all__ = ["scaling", "reduce4_pre", "reduce4_post", "comp", "step",
           "rcone_launches", "launch_count", "reset_launch_count", "ENTRIES"]

# Launches of the kernels, keyed by (entry, dtype, m, B), entry one of
# ENTRIES. Counted by the wrapper where it launches and nowhere else.
rcone_launches: Counter = Counter()

ENTRIES = ("scaling", "reduce4_pre", "reduce4_post", "corrector", "k4",
           "gondzio", "predictor", "step")
# the r_comp kernel's entries, in the C side's mode numbers
_COMP = ("corrector", "k4", "gondzio")

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def launch_count(entry=None, dtype=None) -> int:
    """Launches so far, optionally of one entry and of one dtype."""
    return sum(c for (e, dt, _, _), c in rcone_launches.items()
               if entry in (None, e) and dtype in (None, dt))


def reset_launch_count() -> None:
    rcone_launches.clear()


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("rcone")
    for dt in _SUFFIX.values():
        sigs = {"r_scaling": [_P] * 7 + [_I, _I, _P],
                "r_reduce4": [_I] + [_P] * 6 + [_I, _I, _P],
                "r_comp": [_I] + [_P] * 9 + [_I, _I, _P],
                "r_step": [_I] + [_P] * 4 + [_D] + [_P] * 4 + [_I, _I, _P]}
        for name, argtypes in sigs.items():
            fn = getattr(lib, f"conicip_{name}_{dt}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.conicip_rcone_preload.argtypes = []
    lib.conicip_rcone_preload.restype = ctypes.c_int
    err = lib.conicip_rcone_preload()
    if err != 0:
        raise RuntimeError(f"rcone kernels failed to load: CUDA error {err}")
    return lib


def _rows(*xs):
    """(B, m) and the dtype of the vectors ``xs``: CUDA tensors of one
    device, one dtype the kernels take and one (B, m) shape with B >= 1,
    each contiguous; raises on anything else."""
    x0 = xs[0]
    if x0.device.type != "cuda":
        raise ValueError(f"rcone kernels: unsupported device {x0.device}")
    if x0.dtype not in _SUFFIX:
        raise TypeError(f"rcone kernels: unsupported dtype {x0.dtype}")
    if x0.dim() != 2 or x0.shape[0] < 1:
        raise ValueError(f"rcone kernels: expected (B, m) with B >= 1, got "
                         f"shape {tuple(x0.shape)}")
    for x in xs:
        if (x.device != x0.device or x.dtype != x0.dtype
                or x.shape != x0.shape):
            raise ValueError(
                f"rcone kernels: operands differ: {x.device} {x.dtype} "
                f"{tuple(x.shape)} against {x0.device} {x0.dtype} "
                f"{tuple(x0.shape)}")
        if not x.is_contiguous():
            raise ValueError("rcone kernels: operands must be contiguous")
    return x0.shape[0], x0.shape[1], x0.dtype


def _per_instance(x0, *ss):
    """Check per-instance values ``ss``: (B,) contiguous, of ``x0``'s
    device and dtype."""
    for s in ss:
        if (s.device != x0.device or s.dtype != x0.dtype
                or tuple(s.shape) != (x0.shape[0],)
                or not s.is_contiguous()):
            raise ValueError(
                f"rcone kernels: a per-instance value must be a contiguous "
                f"({x0.shape[0]},) {x0.dtype} on {x0.device}, got "
                f"{s.dtype} {tuple(s.shape)} on {s.device}")


def _launch(entry, name, x0, *args):
    B, m = x0.shape
    fn = getattr(_library(), f"conicip_{name}_{_SUFFIX[x0.dtype]}")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = fn(*ptrs, B, m, stream)
    if err != 0:
        raise RuntimeError(f"rcone kernel {entry} launch failed: CUDA error "
                           f"{err}")
    rcone_launches[(entry, x0.dtype, m, B)] += 1


def scaling(v, s):
    """``(r_d, 1/r_d, λ, λ∘λ, μ̄)`` of the iterate (v, s): r_d = √(s/v),
    λ = r_d v, μ̄ = vᵀs per instance (B,)."""
    _rows(v, s)
    outs = [torch.empty_like(v) for _ in range(4)]
    mubar = v.new_empty(v.shape[0])
    _launch("scaling", "r_scaling", v, v, s, *outs, mubar)
    return (*outs, mubar)


def reduce4_pre(rs, lam, r_d, rv):
    """``(t1, r.v + t1)`` with t1 = r_d (r.s / λ)."""
    _rows(rs, lam, r_d, rv)
    t1, vt = torch.empty_like(rs), torch.empty_like(rs)
    _launch("reduce4_pre", "r_reduce4", rs, 0, rs, lam, r_d, rv, t1, vt)
    return t1, vt


def reduce4_post(t1, r_d, dv):
    """ds = t1 − r_d (r_d dv)."""
    _rows(t1, r_d, dv)
    ds = torch.empty_like(t1)
    _launch("reduce4_post", "r_reduce4", t1, 1, t1, None, r_d, dv, ds, None)
    return ds


def comp(entry, lam, r_d, rinv, dv, ds, x=None, smu=None, atil=None):
    """One of the complementarity vectors (``entry`` in ``_COMP``):
    ``"corrector"`` x − (−(rinv ds)(r_d dv) + smu) with x = rleft.s,
    ``"k4"`` λ(r_d dv) + λ(rinv ds), ``"gondzio"`` −q of the trial
    w = (λ − atil r_d dv)(λ − atil rinv ds) (``smu``, ``atil``: (B,))."""
    given = (x is not None, smu is not None, atil is not None)
    if given != {"corrector": (True, True, False), "k4": (False,) * 3,
                 "gondzio": (False, True, True)}[entry]:
        raise ValueError(f"rcone kernels: wrong operands for {entry}")
    _rows(lam, r_d, rinv, dv, ds, *([x] if given[0] else []))
    _per_instance(lam, *(s for s in (smu, atil) if s is not None))
    out = torch.empty_like(lam)
    _launch(entry, "r_comp", lam, _COMP.index(entry), lam, r_d, rinv, dv, ds,
            x, smu, atil, out)
    return out


def step(v, s, dv, ds, scale=1.0, fts=False):
    """``(α, ok)``, and with ``fts`` also the four dots (B, 4) and fts (B,):
    the fraction-to-boundary step of (v, s) along (dv, ds)·scale, whether
    dv and ds are finite (bool)."""
    _rows(v, s, dv, ds)
    B = v.shape[0]
    alpha = v.new_empty(B)
    ok = torch.empty(B, dtype=torch.bool, device=v.device)
    dots = v.new_empty(B, 4) if fts else None
    fval = v.new_empty(B) if fts else None
    _launch("predictor" if fts else "step", "r_step", v, int(fts), v, s, dv,
            ds, float(scale), alpha, ok, dots, fval)
    return (alpha, ok, dots, fval) if fts else (alpha, ok)
