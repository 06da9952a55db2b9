"""The hand-written CUDA kernels of the R cones (``csrc/rcone.cu``).

One pass each over the (B, m) vectors of a stack of B instances (a single
solve is B = 1), in f64 or f32: :func:`scaling`, :func:`reduce4_pre`,
:func:`reduce4_post`, :func:`comp` (the corrector's, the refinement
residual's and the Gondzio trial's s-rows) and :func:`step`. Each takes
CUDA tensors only, of one dtype and one device, and launches its kernel on
the current stream or raises: there is no other route. Each takes rows of
unit stride along m at any row stride (0: one row shared by the stack),
launched by the plan of :func:`launch_plan`, a plain function of (B, m,
dtype, alignment).
``ops/rcone.py`` is the wrapper the solver calls: for tensors on the CPU it
runs the plain PyTorch twins beside it, for CUDA tensors these. Nothing
here runs at import, so the module imports on a CPU-only torch.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple, Optional

import torch

from .build import load_library

__all__ = ["scaling", "reduce4_pre", "reduce4_post", "comp", "step",
           "rcone_launches", "launch_count", "reset_launch_count", "ENTRIES",
           "Plan", "launch_plan", "cluster_size", "aligned", "plan_of",
           "empty", "SIGNATURES"]

# Launches of the kernels, keyed by (entry, dtype, m, B), entry one of
# ENTRIES. Counted by the wrapper where it launches and nowhere else.
rcone_launches: Counter = Counter()

ENTRIES = ("scaling", "reduce4_pre", "reduce4_post", "corrector", "k4",
           "gondzio", "predictor", "step")
# the r_comp kernel's entries, in the C side's mode numbers
_COMP = ("corrector", "k4", "gondzio")

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_P, _I, _D, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
    ctypes.c_longlong

# ── the launch plans of csrc/rcone.cu ──

# lanes of one 16-byte vector, by dtype
LANES = {torch.float64: 2, torch.float32: 4}
# elements of one instance per block of r_reduce4 and r_comp (128 threads
# in f64, 64 in f32, one vector each)
GRID_TILE = 256
# threads of a block of r_step and r_scaling, and their cluster sizes: the
# portable largest, 8, and no more
CLUSTER_THREADS = 128
MAX_CLUSTER = 8
# the card's SMs (an H100): a cluster plan gives a stack at most two
# blocks an SM
SMS = 132
# CUDA's limit on gridDim.y; a larger stack loops over its instances
MAX_GRID_Y = 65535
# the kernels by plan: a grid over m, or a cluster per instance
GRID_KERNELS = ("r_reduce4", "r_comp")
CLUSTER_KERNELS = ("r_step", "r_scaling")
# the kernel whose plan each entry launches by
PLANNED = {"scaling": "r_scaling", "reduce4_pre": "r_reduce4",
           "reduce4_post": "r_reduce4", "corrector": "r_comp",
           "k4": "r_comp", "gondzio": "r_comp", "predictor": "r_step",
           "step": "r_step"}


class Plan(NamedTuple):
    """How one call launches: ``grid`` (x, y) blocks of ``threads``,
    ``cluster`` blocks a cluster along x (None: an ordinary launch),
    ``vec`` the 16-byte vector path, ``lanes`` elements a vector."""
    grid: tuple
    threads: int
    cluster: Optional[int]
    vec: bool
    lanes: int


def cluster_size(B: int, m: int, dtype) -> int:
    """r_step's and r_scaling's blocks per instance: enough that each
    thread holds about one vector of the row, at most
    :data:`MAX_CLUSTER`, and for a stack no more than two blocks an SM; a
    power of two. A function of (B, m, dtype) alone, so every launch of
    one shape sums in one order."""
    vectors = -(-m // LANES[dtype])
    blocks = -(-vectors // CLUSTER_THREADS)
    want = 1 << (blocks - 1).bit_length()  # blocks, rounded up to 2^k
    room = 1 << max(0, (2 * SMS // B).bit_length() - 1)  # rounded down
    return max(1, min(MAX_CLUSTER, want, room))


def launch_plan(kernel: str, B: int, m: int, dtype, aligned: bool) -> Plan:
    """The launch of ``kernel`` (one of :data:`GRID_KERNELS` or
    :data:`CLUSTER_KERNELS`) on (B, m) rows of ``dtype``; ``aligned``:
    every pointer and row start is 16 bytes aligned (:func:`aligned`), so
    the vector path is taken."""
    if B < 1 or m < 1:
        raise ValueError(f"rcone kernels: no launch for (B, m) = ({B}, {m})")
    lanes, gy = LANES[dtype], min(B, MAX_GRID_Y)
    if kernel in GRID_KERNELS:
        return Plan((-(-m // GRID_TILE), gy), GRID_TILE // lanes, None,
                    bool(aligned), lanes)
    if kernel in CLUSTER_KERNELS:
        c = cluster_size(B, m, dtype)
        return Plan((c, gy), CLUSTER_THREADS, c, bool(aligned), lanes)
    raise ValueError(f"rcone kernels: no launch plan for {kernel}")


def aligned(ptrs, row_strides, itemsize: int, B: int) -> bool:
    """Whether 16-byte vectors may be used: every pointer 16-byte aligned
    and, in a stack, every row stride (elements) a multiple of 16 bytes."""
    return (all(p % 16 == 0 for p in ptrs)
            and (B == 1 or all(s * itemsize % 16 == 0 for s in row_strides)))


def plan_of(kernel: str, *rows) -> Plan:
    """The plan of ``kernel`` on (B, m) rows (inputs and outputs), as the
    wrapper launches it."""
    B, m = rows[0].shape
    return launch_plan(kernel, B, m, rows[0].dtype, aligned(
        [x.data_ptr() for x in rows], [x.stride(0) for x in rows],
        rows[0].element_size(), B))


def launch_count(entry=None, dtype=None) -> int:
    """Launches so far, optionally of one entry and of one dtype."""
    return sum(c for (e, dt, _, _), c in rcone_launches.items()
               if entry in (None, e) and dtype in (None, dt))


def reset_launch_count() -> None:
    rcone_launches.clear()


# the C functions' arguments (csrc/rcone.cu, conicip_<kernel>_f64/_f32):
# the mode or flag, the pointers, (B, m), the inputs' row strides, the
# plan (vector path, grid or cluster along x, grid along y, threads) and
# the stream
SIGNATURES = {
    "r_scaling": [_P] * 7 + [_I, _I] + [_L] * 2 + [_I] * 4 + [_P],
    "r_reduce4": [_I] + [_P] * 6 + [_I, _I] + [_L] * 4 + [_I] * 4 + [_P],
    "r_comp": [_I] + [_P] * 8 + [_I, _I] + [_L] * 5 + [_I] * 4 + [_P],
    "r_step": [_I] + [_P] * 4 + [_D] + [_P] * 4 + [_I, _I] + [_L] * 4
    + [_I] * 4 + [_P]}


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("rcone")
    for dt in _SUFFIX.values():
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, f"conicip_{name}_{dt}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.conicip_rcone_preload.argtypes = []
    lib.conicip_rcone_preload.restype = ctypes.c_int
    lib.conicip_rcone_empty.argtypes = [_I] * 4 + [_P]
    lib.conicip_rcone_empty.restype = ctypes.c_int
    err = lib.conicip_rcone_preload()
    if err != 0:
        raise RuntimeError(f"rcone kernels failed to load: CUDA error {err}")
    return lib


def _rows(*xs):
    """(B, m) and the dtype of the vectors ``xs``: CUDA tensors of one
    device, one dtype the kernels take and one (B, m) shape with B >= 1,
    each of unit stride along m at any row stride; raises on anything
    else."""
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
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError("rcone kernels: operands must have unit stride "
                             "along m")
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


def _launch(entry, name, x0, *args, tail=()):
    B, m = x0.shape
    fn = getattr(_library(), f"conicip_{name}_{_SUFFIX[x0.dtype]}")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = fn(*ptrs, B, m, *tail, stream)
    if err != 0:
        raise RuntimeError(f"rcone kernel {entry} launch failed: CUDA error "
                           f"{err}")
    rcone_launches[(entry, x0.dtype, m, B)] += 1


def _planned(kernel, ins, outs):
    """The launch arguments after (B, m): the inputs' row strides, then
    the plan's vector path, grid along x (a cluster plan's cluster size),
    grid along y and threads."""
    plan = plan_of(kernel, *ins, *outs)
    return (*(x.stride(0) for x in ins), int(plan.vec), plan.grid[0],
            plan.grid[1], plan.threads)


def _outputs(x0, k):
    """``k`` contiguous (B, m) rows of ``x0``'s dtype on its device."""
    return [torch.empty(x0.shape, dtype=x0.dtype, device=x0.device)
            for _ in range(k)]


def scaling(v, s):
    """``(r_d, 1/r_d, λ, λ∘λ, μ̄)`` of the iterate (v, s): r_d = √(s/v),
    λ = r_d v, μ̄ = vᵀs per instance (B,)."""
    _rows(v, s)
    outs = _outputs(v, 4)
    mubar = v.new_empty(v.shape[0])
    _launch("scaling", "r_scaling", v, v, s, *outs, mubar,
            tail=_planned("r_scaling", (v, s), outs))
    return (*outs, mubar)


def reduce4_pre(rs, lam, r_d, rv):
    """``(t1, r.v + t1)`` with t1 = r_d (r.s / λ)."""
    _rows(rs, lam, r_d, rv)
    t1, vt = _outputs(rs, 2)
    _launch("reduce4_pre", "r_reduce4", rs, 0, rs, lam, r_d, rv, t1, vt,
            tail=_planned("r_reduce4", (rs, lam, r_d, rv), (t1, vt)))
    return t1, vt


def reduce4_post(t1, r_d, dv):
    """ds = t1 − r_d (r_d dv)."""
    _rows(t1, r_d, dv)
    ds, = _outputs(t1, 1)
    # the kernel's x, lam, r_d, y: lam unused (t1 stands in for it)
    _launch("reduce4_post", "r_reduce4", t1, 1, t1, None, r_d, dv, ds, None,
            tail=_planned("r_reduce4", (t1, t1, r_d, dv), (ds,)))
    return ds


def comp(entry, a, r_d, rinv, dv, ds, smu=None, atil=None):
    """One of the complementarity vectors (``entry`` in ``_COMP``), ``a``
    being x = rleft.s for the corrector and λ for the others:
    ``"corrector"`` x − (−(rinv ds)(r_d dv) + smu), ``"k4"`` λ(r_d dv) +
    λ(rinv ds), ``"gondzio"`` −q of the trial w = (λ − atil r_d dv)(λ −
    atil rinv ds) (``smu``, ``atil``: (B,))."""
    given = (smu is not None, atil is not None)
    if given != {"corrector": (True, False), "k4": (False, False),
                 "gondzio": (True, True)}[entry]:
        raise ValueError(f"rcone kernels: wrong operands for {entry}")
    ins = (a, r_d, rinv, dv, ds)
    _rows(*ins)
    _per_instance(a, *(s for s in (smu, atil) if s is not None))
    out, = _outputs(a, 1)
    _launch(entry, "r_comp", a, _COMP.index(entry), *ins, smu, atil, out,
            tail=_planned("r_comp", ins, (out,)))
    return out


def step(v, s, dv, ds, scale=1.0, fts=False):
    """``(α, ok)``, and with ``fts`` also the four dots (B, 4) and fts (B,):
    the fraction-to-boundary step of (v, s) along (dv, ds)·scale, whether
    dv and ds are finite (bool)."""
    B, _, _ = _rows(v, s, dv, ds)
    alpha = v.new_empty(B)
    ok = torch.empty(B, dtype=torch.bool, device=v.device)
    dots = v.new_empty(B, 4) if fts else None
    fval = v.new_empty(B) if fts else None
    _launch("predictor" if fts else "step", "r_step", v, int(fts), v, s, dv,
            ds, float(scale), alpha, ok, dots, fval,
            tail=_planned("r_step", (v, s, dv, ds), ()))
    return (alpha, ok, dots, fval) if fts else (alpha, ok)


def empty(plan: Plan, device=None) -> None:
    """One launch of a kernel that does nothing, by ``plan`` (an entry's:
    its grid, threads and cluster) on the current stream: the fixed cost of
    such a node. Not counted; no entry of the solver calls it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().conicip_rcone_empty(
            plan.grid[0], plan.grid[1], plan.threads, plan.cluster or 0,
            stream)
    if err != 0:
        raise RuntimeError(f"rcone empty kernel launch failed: CUDA error "
                           f"{err}")
