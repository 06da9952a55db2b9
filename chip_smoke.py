"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from this checkout, holds it against its
plain PyTorch version, then drives ``conicip_tpu_torch.conic_ip`` through
every default KKT backend (dense Schur, diagonal, spectral) on R, Q and S
cone problems at the sizes the repository benchmarks, and checks the
answers. Three further phases drive the options around the default path:
``[f32]`` the f32-factor solves (the kernel's f32 entry, the last-mile
switch to f64 factors), ``[eq]`` null-space elimination of equalities and
the rank-repairing preprocessor, ``[backends]`` the qr, lu and low-rank KKT
solvers. ``[batch]`` drives ``solve_batch`` on stacks of 64 instances of the
four batched families (every dense factor one launch of the kernel's
batched entry, sampled instances held against their single solves) and
``[checkpoint]`` an interrupted and resumed ``solve_batch_resumable``.
``[frontend]`` builds three generator families through the modeling
frontends (``Optimizer``, ``solve_conic_form``) and holds each against the
direct ``conic_ip`` solve and against the CPU solve through the same
frontend; ``[ladder]`` drives the rescue paths behind f32 factors: a single
solve that climbs every tier of ``conic_ip``'s ladder and a stack whose
stalled instances are finished by ``solve_batch``'s backstop, each held to
the CPU run of the same call. ``[distributed]`` drives the distributed
paths: a world of one rank (NCCL, started by the phase) runs
``distributed_normal_matrix``, ``kktsolver_schur_tp`` and a sharded
``solve_batch``, and two ranks sharing the card (gloo), each this script run
with ``--distributed-rank``, solve three of those problems together and a
stack split between them. Every phase prints one line per case; any failed
check raises, so the script exits non-zero. It imports nothing of JAX.

The second-to-last line is a JSON object describing each kernel entry of
the path; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# orders held against the plain version besides those the main path factors
# (factor_sizes): one panel, its edges, partial last panels, the timed sizes
SIZES = (1, 31, 127, 128, 129, 257, 500, 1000, 1024, 1280, 2048, 4096)
SCHUR_N = (1024, 4096)  # box_qp_dense orders of the [schur] phase
TIMED = (128, 1024, 2048, 4096)
# stacks (B, n) the batched entry is held against the plain version at
# besides those the main path factors (batch_factor_shapes): more matrices
# than SMs, a ragged second panel, and order 1
BATCH_EDGE_SHAPES = ((256, 55), (7, 129), (3, 1))
BATCH_TIMED = ((64, 500), (64, 200))
BATCH = 64  # instances per stack in the [batch] and [checkpoint] phases
PLANTED_N = 100  # order of the planted and the checkpointed box QP stacks
LADDER_N = 200  # variables of the [ladder] phase's single solve
BACKSTOP_K = 20  # S-cone order of its stack: n = 210 variables
SAMPLED = (0, 1, 31, 63)  # instances held against their single solves
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# ill-conditioned SPD per dtype: condition number, and the bound on
# |LL' - M| / |M| (rounding of a backward-stable factor at n = 500)
ILL = {torch.float64: (1e12, 1e-13), torch.float32: (1e5, 1e-5)}
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# 3.35 TB/s; 67 TFLOP/s in f64 on the tensor cores, which the kernel's f64
# products use, and 67 TFLOP/s in f32 outside them (the f32 entry keeps
# full f32, no TF32).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
# the f32 solves must land this close to the f64 solution, relative to
# max(1, |y|_inf): both end at optTol = 1e-6, on differently rounded paths
F32_Y_TOL = 1e-5
# every shape an entry of the kernel was held against the plain version at:
# (dtype, n) for the single entries, (dtype, n, B) for the batched ones,
# the keys of the wrapper's launch counter, with max |L - L_plain| there
HELD = {}


def cholesky_bound_ms(n, dtype, batch=1):
    """Least time the card could take for ``batch`` order-n factors: n^3/3
    operations each at the peak rate of the dtype against every matrix read
    once and every factor written once at the memory rate. Returns (ms,
    which)."""
    ops = batch * (n ** 3 / 3.0) / PEAK_FLOPS[dtype]
    moved = batch * 2.0 * n * n * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(ops, moved) * 1e3, "operations" if ops >= moved else "bytes"


def tri(k):
    """Packed length of a symmetric k x k matrix."""
    return k * (k + 1) // 2


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def line(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_environment():
    from conicip_tpu_torch.ops.build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    line("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=repr(torch.cuda.get_device_name(0)),
         nvcc=repr(next((s for s in nvcc if "release" in s), nvcc[-1])))
    print(smi.splitlines()[0], flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmul must be off (the reference ran products at HIGHEST)")


def phase_build():
    from conicip_tpu_torch.ops.build import load_library

    t = time.perf_counter()
    load_library("cholesky")
    line("build", kernel="csrc/cholesky.cu",
         seconds=f"{time.perf_counter() - t:.2f}")


def spd(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = torch.randn(n, n, generator=g, device="cuda", dtype=torch.float64)
    return B @ B.T / n + torch.eye(n, device="cuda", dtype=torch.float64)


def ill_conditioned(n, kappa, seed):
    """SPD with condition number ~kappa and unit diagonal (equilibrated)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(n, n, generator=g, device="cuda",
                                       dtype=torch.float64))
    lam = torch.logspace(0, -np.log10(kappa), n, device="cuda",
                         dtype=torch.float64)
    M = (Q * lam) @ Q.T
    d = torch.rsqrt(torch.diagonal(M))
    M = M * d[:, None] * d[None, :]
    return (M + M.T) / 2


def cuda_launches(fn, expect):
    """Kernels run on the card by one call of fn, from a profiler trace.
    The tracer can lose events (now and then the first kernel after it
    starts, or a whole trace) and never invents one, so a fill goes first,
    fn runs twice and the count is halved (the fill's event, seen or not,
    falls out), and the largest of up to four traces is taken, stopping at
    the count ``expect`` that the kernel's schedule gives."""
    from torch.profiler import ProfilerActivity, profile

    most = 0
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(4, device="cuda")
            torch.cuda.synchronize()
            fn()
            fn()
            torch.cuda.synchronize()
        most = max(most, sum(
            1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA) // 2)
        if most >= expect:
            break
    return most


def launches_of_order(n):
    """CUDA launches of one factor of order n, whatever the stack: one for
    a single panel; else the copy of the lower triangle, three per panel
    and none for the last panel's product and update."""
    from conicip_tpu_torch.ops.cholesky_kernel import PANEL

    return 1 if n <= PANEL else 3 * -(-n // PANEL) - 1


def hold_single(n, dt, main_path):
    """The single entry against the plain version at order n."""
    from conicip_tpu_torch.ops.cholesky_kernel import (cholesky_factor,
                                                       cholesky_plain)

    M = spd(n, seed=n).to(dt)
    L = cholesky_factor(M)
    Lp = cholesky_plain(M)
    torch.cuda.synchronize()
    err = (L - Lp).abs().max().item()
    rel = err / Lp.abs().max().item()
    rec = ((L @ L.T - M).abs().max() / M.abs().max()).item()
    check(rel <= TOL[dt], f"n={n} {dt}: |L-L_plain| rel {rel:.3e}")
    check(rec <= TOL[dt], f"n={n} {dt}: |LL'-M| rel {rec:.3e}")
    check(bool(torch.equal(L.triu(1), torch.zeros_like(L))),
          f"n={n} {dt}: strict upper triangle not zero")
    for pos in {n // 2, n - 1}:  # a middle and the last panel
        bad = M.clone()
        bad[pos, pos] = -1.0
        check(not bool(torch.isfinite(cholesky_factor(bad)).all()),
              f"n={n} {dt}: indefinite at {pos} gave a finite factor")
    HELD[(dt, n)] = err
    line("kernel", n=n, dtype=str(dt).split(".")[-1],
         max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
         recon_rel=f"{rec:.3e}", indefinite="non-finite",
         main_path=main_path)


def phase_kernel():
    """The kernel against its plain version; returns its JSON records."""
    from conicip_tpu_torch.ops.cholesky_kernel import (PANEL, cholesky_factor,
                                                       cholesky_plain)

    on_path = factor_sizes()
    for n in sorted(set(SIZES) | on_path):
        for dt in (torch.float64, torch.float32):
            hold_single(n, dt, n in on_path)
    for dt, (kappa, bound) in ILL.items():
        M = ill_conditioned(500, kappa, seed=5).to(dt)
        L = cholesky_factor(M)
        rec = ((L @ L.T - M).abs().max() / M.abs().max()).item()
        check(rec <= bound, f"ill-conditioned {dt}: |LL'-M| rel {rec:.3e}")
        line("kernel_ill", n=500, dtype=str(dt).split(".")[-1],
             kappa=f"{kappa:.0e}", recon_rel=f"{rec:.3e}")
    times = {}
    for n in TIMED:
        M64 = spd(n, seed=n)
        reps = max(3, 40960 // n)
        # the launch budget: 3 per panel and one more, one when n <= PANEL
        budget = 1 if n <= PANEL else 3 * -(-n // PANEL) + 1
        for dt in (torch.float64, torch.float32):
            M = M64.to(dt).contiguous()
            ms = cuda_ms(lambda: cholesky_factor(M), reps)
            plain = cuda_ms(lambda: cholesky_plain(M), reps)
            # the one library call for the same function (cuSOLVER's
            # potrf); a yardstick only, the port never calls it on the card
            library = cuda_ms(lambda: torch.linalg.cholesky_ex(M), reps)
            bound, bound_by = cholesky_bound_ms(n, dt)
            per_factor = cuda_launches(lambda: cholesky_factor(M),
                                       launches_of_order(n))
            check(per_factor <= budget,
                  f"n={n} {dt}: {per_factor} CUDA launches per factor, "
                  f"budget {budget}")
            times[(n, dt)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                  bound_by=bound_by, library_ms=library)
            line("kernel_time", n=n, dtype=str(dt).split(".")[-1],
                 kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                 library_ms=f"{library:.4f}", bound_ms=f"{bound:.5f}",
                 bound_by=bound_by, bound_share=f"{bound / ms:.4f}",
                 ratio=f"{ms / plain:.3f}", launches_per_factor=per_factor,
                 launch_budget=budget, reps=reps)
    record = {"name": "cholesky", "route": "cuda",
              "source": "conicip_tpu_torch/csrc/cholesky.cu",
              "replaces": "conicip_tpu/ops/pallas_cholesky.py:41",
              "shape": "(1024, 1024) float64", **times[(1024, torch.float64)]}
    return [record] + phase_kernel_batched()


def spd_stack(B, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, n, n, generator=g, device="cuda", dtype=torch.float64)
    return X @ X.mT / n + torch.eye(n, device="cuda", dtype=torch.float64)


def hold_batched(B, n, dt, main_path, traced=True):
    """The batched entry against the plain version on a stack (B, n, n);
    with ``traced`` its CUDA launches against those of one matrix."""
    from conicip_tpu_torch.ops.cholesky_kernel import (cholesky_factor,
                                                       cholesky_plain)

    M = spd_stack(B, n, seed=B + n).to(dt)
    L = cholesky_factor(M)
    Lp = cholesky_plain(M)
    torch.cuda.synchronize()
    err = (L - Lp).abs().max().item()
    rel = err / Lp.abs().max().item()
    rec = ((L @ L.mT - M).abs().max() / M.abs().max()).item()
    what = f"batched ({B}, {n}) {dt}"
    check(rel <= TOL[dt], f"{what}: |L-L_plain| rel {rel:.3e}")
    check(rec <= TOL[dt], f"{what}: |LL'-M| rel {rec:.3e}")
    check(bool(torch.equal(L.triu(1), torch.zeros_like(L))),
          f"{what}: strict upper triangle not zero")
    one = cholesky_factor(M[B // 2].contiguous())
    check(bool(torch.equal(L[B // 2], one)),
          f"{what}: instance {B // 2} differs from the single entry")
    # the batch is a grid dimension: the launches of one matrix
    per_stack = "untraced"
    if traced:
        per_one = launches_of_order(n)
        per_stack = cuda_launches(lambda: cholesky_factor(M), per_one)
        check(per_stack == per_one,
              f"{what}: {per_stack} CUDA launches for the stack, "
              f"{per_one} for one matrix of that order")
    HELD[(dt, n, B)] = err
    line("kernel_batched", B=B, n=n, dtype=str(dt).split(".")[-1],
         max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
         recon_rel=f"{rec:.3e}", launches_per_factor=per_stack,
         equals_single="bitwise", main_path=main_path)


def phase_kernel_batched():
    """The kernel's batched entries against the plain version on stacks
    (B, n, n); returns their JSON records (one per dtype)."""
    from conicip_tpu_torch.ops.cholesky_kernel import (cholesky_factor,
                                                       cholesky_plain)

    on_path = batch_factor_shapes()
    for B, n in sorted(set(BATCH_EDGE_SHAPES) | on_path):
        for dt in (torch.float64, torch.float32):
            hold_batched(B, n, dt, (B, n) in on_path)
    # one indefinite matrix in the middle of a stack: NaN from its failing
    # pivot on, every other factor untouched
    B, n = 64, 200
    for dt in (torch.float64, torch.float32):
        M = spd_stack(B, n, seed=9).to(dt)
        good = cholesky_factor(M)
        bad = M.clone()
        bad[31, n // 2, n // 2] = -1.0
        L = cholesky_factor(bad)
        keep = [i for i in range(B) if i != 31]
        Lp = cholesky_plain(M)
        rel = ((L[keep] - Lp[keep]).abs().max() / Lp.abs().max()).item()
        check(not bool(torch.isfinite(L[31]).all()),
              f"batched {dt}: the indefinite instance gave a finite factor")
        check(bool(torch.isfinite(L[31, :n // 2]).all()),
              f"batched {dt}: NaN before the failing pivot")
        check(bool(torch.equal(L[keep], good[keep])) and rel <= TOL[dt],
              f"batched {dt}: an indefinite instance touched its neighbours")
        line("kernel_batched_nan", B=B, n=n, dtype=str(dt).split(".")[-1],
             bad_instance="non-finite", others_rel_err=f"{rel:.3e}",
             others="bitwise unchanged")
    records = {}
    for B, n in BATCH_TIMED:
        M64 = spd_stack(B, n, seed=n)
        for dt in (torch.float64, torch.float32):
            M = M64.to(dt).contiguous()
            reps = 20
            ms = cuda_ms(lambda: cholesky_factor(M), reps)
            plain = cuda_ms(lambda: cholesky_plain(M), reps)
            library = cuda_ms(lambda: torch.linalg.cholesky_ex(M), reps)
            bound, bound_by = cholesky_bound_ms(n, dt, B)
            name = str(dt).split(".")[-1]
            line("kernel_time", B=B, n=n, dtype=name, kernel_ms=f"{ms:.4f}",
                 plain_ms=f"{plain:.4f}", library_ms=f"{library:.4f}",
                 bound_ms=f"{bound:.5f}", bound_by=bound_by,
                 bound_share=f"{bound / ms:.4f}", ratio=f"{ms / plain:.3f}",
                 reps=reps)
            if (B, n) == BATCH_TIMED[0]:
                records[dt] = {
                    "name": f"cholesky_batched_{'f64' if dt == torch.float64 else 'f32'}",
                    "route": "cuda",
                    "source": "conicip_tpu_torch/csrc/cholesky.cu",
                    "replaces": "conicip_tpu/ops/pallas_cholesky.py:41",
                    "shape": f"({B}, {n}, {n}) {name}",
                    "ms": ms, "plain_ms": plain, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": library}
    return [records[torch.float64], records[torch.float32]]


def solve_timed(args, **kw):
    from conicip_tpu_torch import conic_ip

    torch.cuda.synchronize()
    t = time.perf_counter()
    sol = conic_ip(*args, **kw)
    torch.cuda.synchronize()
    return sol, (time.perf_counter() - t) * 1e3


def launches(dtype=None, n=None):
    from conicip_tpu_torch.ops import cholesky_kernel

    return cholesky_kernel.launch_count(dtype, n)


def phase_schur():
    from conicip_tpu_torch import conic_ip
    from conicip_tpu_torch.models import box_qp_dense

    for n in SCHUR_N:
        args = box_qp_dense(n=n, seed=42).args()
        before = launches()
        sol, ms = solve_timed(args, device="cuda")
        used = launches() - before
        resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
        check(sol.status == "Optimal", f"n={n}: status {sol.status}")
        check(resid < 1e-6, f"n={n}: residual {resid:.3e}")
        check(all(t.device.type == "cuda" for t in (sol.y, sol.w, sol.v)),
              f"n={n}: result tensors are not on cuda")
        # one factor for the cold-start solve and one per step taken: the
        # loop stops at the iteration that reaches Optimal, so an Optimal
        # solve that ends on its best iterate takes Iter - 1 steps
        check(used >= sol.Iter,
              f"n={n}: {used} kernel launches for Iter {sol.Iter}")
        _, ms2 = solve_timed(args, device="cuda")
        extra = {}
        if n == 1024:
            ref = conic_ip(*args, device="cpu")
            dp = abs(sol.pobj - ref.pobj)
            dy = (sol.y.cpu() - ref.y).abs().max().item()
            check(ref.status == sol.status and ref.Iter == sol.Iter,
                  f"n={n}: cpu {ref.status}/{ref.Iter} vs gpu "
                  f"{sol.status}/{sol.Iter}")
            check(dp <= 1e-8 * (1 + abs(ref.pobj)), f"n={n}: pobj diff {dp:.3e}")
            check(dy <= 1e-6, f"n={n}: y diff {dy:.3e}")
            extra = dict(cpu_iter=ref.Iter, pobj_diff=f"{dp:.3e}",
                         y_diff=f"{dy:.3e}")
        line("schur", n=n, status=sol.status, Iter=sol.Iter,
             resid=f"{resid:.3e}", launches=used,
             ms_per_solve=f"{ms2:.2f}", ms_per_iter=f"{ms2 / sol.Iter:.3f}",
             first_solve_ms=f"{ms:.2f}", **extra)


def diag_args(eq, n=1000):
    """The README box QP (diag backend), with one equality if ``eq``."""
    H = 0.5 * np.eye(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    G, d = (np.ones((1, n)), np.array([1.0])) if eq else (None, None)
    return (H, H @ np.arange(1.0, n + 1), A, -np.ones(2 * n), [("R", 2 * n)],
            G, d)


def phase_diag():
    n = 1000
    for eq in (False, True):
        args = diag_args(eq, n)
        before = launches()
        sol, ms = solve_timed(args, device="cuda")
        used = launches() - before
        _, ms2 = solve_timed(args, device="cuda")
        check(sol.status == "Optimal", f"diag eq={eq}: status {sol.status}")
        if eq:
            check(used > 0, "diag woodbury: the kernel was never launched")
        line("diag", n=n, equality=eq, status=sol.status, Iter=sol.Iter,
             resid=f"{max(sol.prFeas, sol.duFeas, sol.muFeas):.3e}",
             launches=used, ms_per_solve=f"{ms2:.2f}",
             ms_per_iter=f"{ms2 / sol.Iter:.3f}", first_solve_ms=f"{ms:.2f}")


@functools.lru_cache(maxsize=None)
def conic_cases():
    """(label, problem, backend, launch rule) of the [conic] phase. The
    rule: "iter" launches >= Iter (one factor per KKT build), "2iter"
    >= 2 Iter (the n and the p factor of an equality solve), "none" no
    launch at all (the spectral backend factors nothing); ``cpu`` says
    whether Iter is held against the port's own CPU solve."""
    from conicip_tpu_torch import models
    from conicip_tpu_torch.kkt import kktsolver_schur

    return (
        ("single_soc(n=500)", models.single_soc(n=500), None, "iter", True),
        ("single_soc(n=4096)", models.single_soc(n=4096), None, "iter", False),
        ("many_small_socs(k=250,n=500)", models.many_small_socs(), None,
         "iter", True),
        ("mixed_rq_eq(n=200,p=10)", models.mixed_rq_eq(), None, "2iter", True),
        ("larger_sdp(k=30)", models.larger_sdp(), None, "none", True),
        ("larger_sdp(k=30)", models.larger_sdp(), kktsolver_schur, "iter",
         True),
        ("mixed_rqs(n=86)", models.mixed_rqs(), None, "none", True),
        ("mixed_rqs(n=86)", models.mixed_rqs(), kktsolver_schur, "iter", True),
    )


def factor_sizes():
    """Orders of the matrices the main path hands the kernel: n of every
    Schur solve and p of every equality block (the Schur path's second
    factor, the diag path's Woodbury factor)."""
    sizes = set(SCHUR_N)
    for eq in (False, True):
        G = diag_args(eq)[5]
        if G is not None:
            sizes.add(G.shape[0])
    for _, P, _, rule, _ in conic_cases():
        if rule != "none":
            sizes.add(P.Q.shape[0])
            if P.G is not None and P.G.shape[0]:
                sizes.add(P.G.shape[0])
    for _, P, _ in f32_cases():
        sizes.add(P.Q.shape[0])
    for P in eq_cases():  # the reduced problem: order n - p, no equalities
        sizes.add(P.Q.shape[0] - P.G.shape[0])
    P = redundant_eq_case()  # direct saddle after the rank repair
    sizes |= {P.Q.shape[0], EQ_RANK}
    P = lowrank_case()  # r = SOC rows + equality rows, and p
    sizes |= {P.A.shape[0] - P.Q.shape[0] + P.G.shape[0], P.G.shape[0]}
    # the single solves the [batch] phase holds its instances against
    sizes |= {n for _, n in batch_factor_shapes()}
    for _, P, _, _, rule in frontend_cases():
        if rule != "none":
            sizes.add(P.Q.shape[0])
    P = ladder_case()  # eliminated: the reduced problem, order n - p
    sizes.add(P.Q.shape[0] - P.G.shape[0])
    for ranks in (1, DIST_RANKS):  # [distributed], a world of one and two
        sizes |= distributed_factor_shapes(ranks)[0]
    return sizes


def phase_conic():
    from conicip_tpu_torch import conic_ip

    for label, P, kkt, rule, cpu in conic_cases():
        backend = "auto" if kkt is None else "schur"
        kw = {} if kkt is None else dict(kktsolver=kkt)
        solve_timed(P.args(), device="cuda", **kw)  # warm-up
        before = launches()
        sol, ms = solve_timed(P.args(), device="cuda", **kw)
        used = launches() - before
        resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
        what = f"{label} {backend}"
        check(sol.status == "Optimal", f"{what}: status {sol.status}")
        check(resid < 1e-6, f"{what}: residual {resid:.3e}")
        check(all(t.device.type == "cuda" for t in (sol.y, sol.w, sol.v)),
              f"{what}: result tensors are not on cuda")
        need = {"iter": sol.Iter, "2iter": 2 * sol.Iter, "none": 0}[rule]
        check(used == 0 if rule == "none" else used >= need,
              f"{what}: {used} kernel launches for Iter {sol.Iter} "
              f"(rule {rule})")
        extra = {}
        if cpu:
            ref = conic_ip(*P.args(), device="cpu", **kw)
            dy = (sol.y.cpu() - ref.y).abs().max().item()
            check(ref.status == sol.status and ref.Iter == sol.Iter,
                  f"{what}: cpu {ref.status}/{ref.Iter} vs gpu "
                  f"{sol.status}/{sol.Iter}")
            check(dy <= 1e-6, f"{what}: y diff {dy:.3e}")
            extra = dict(cpu_iter=ref.Iter, y_diff=f"{dy:.3e}")
        line("conic", instance=label, backend=backend, status=sol.status,
             Iter=sol.Iter, resid=f"{resid:.3e}", launches=used,
             ms_per_solve=f"{ms:.2f}", ms_per_iter=f"{ms / sol.Iter:.3f}",
             **extra)


@functools.lru_cache(maxsize=None)
def f32_cases():
    """(label, problem, kktsolver or None) of the [f32] phase. mixed_rqs
    takes the spectral backend by default, which factors nothing, so it is
    given the dense Schur backend in its f32 last-mile configuration, as
    the default path builds it."""
    from conicip_tpu_torch import models
    from conicip_tpu_torch.kkt import kktsolver_schur

    schur_f32 = functools.partial(kktsolver_schur, factor_dtype=torch.float32,
                                  lastmile=True)
    return (
        ("box_qp_dense(n=1024)", models.box_qp_dense(n=1024), None),
        ("box_qp_dense(n=4096)", models.box_qp_dense(n=4096), None),
        ("single_soc(n=4096)", models.single_soc(n=4096), None),
        ("many_small_socs(k=250,n=500)", models.many_small_socs(), None),
        ("mixed_rqs(n=86) schur", models.mixed_rqs(), schur_f32),
    )


def run_stats():
    """What the latest conic_ip call's runs did: KKT builds by the
    precision they factored in (a run with f32 factors builds its cold
    start and fast steps in f32 and its last-mile steps in f64; any other
    run builds everything in the working dtype, f64 here), full-precision
    recertifications of the mixed residuals, and the number of runs (more
    than one: the escalation ladder or an elimination retry ran)."""
    from conicip_tpu_torch import solver

    out = dict(f32_builds=0, f64_builds=0, lastmile_steps=0, recertified=0,
               runs=len(solver.runs))
    for r in solver.runs:
        kw = getattr(r.kktsolver, "keywords", {})
        fast = r.fast_steps + r.cold_start
        if kw.get("factor_dtype") == torch.float32:
            out["f32_builds"] += fast
            out["f64_builds"] += r.slow_steps
            out["lastmile_steps"] += r.slow_steps
        else:
            out["f64_builds"] += fast + r.slow_steps
        out["recertified"] += r.recertified
    return out


def phase_f32():
    """f32 factors with the last-mile switch, against the f64 solve of the
    same instance from the same run. No speed is asserted."""
    from conicip_tpu_torch import conic_ip
    from conicip_tpu_torch.kkt import kktsolver_schur

    f32, f64 = torch.float32, torch.float64
    for label, P, kkt in f32_cases():
        n = P.Q.shape[0]
        kw64 = dict(device="cuda")
        kw32 = dict(device="cuda", factor_dtype=f32)
        if kkt is not None:
            # a caller's kktsolver gets no default last-mile trigger: ask
            # for the one the default path sets
            kw32.update(kktsolver=kkt, lastmileProactive=50.0)
            kw64.update(kktsolver=kktsolver_schur)
        solve_timed(P.args(), **kw64)  # warm-ups
        solve_timed(P.args(), **kw32)
        # in turns on one card: f64, f32, f32, f64
        ref, t64a = solve_timed(P.args(), **kw64)
        c32, c64, at_n = launches(f32), launches(f64), launches(n=n)
        sol, t32a = solve_timed(P.args(), **kw32)
        used32, used64 = launches(f32) - c32, launches(f64) - c64
        at_n = launches(n=n) - at_n
        stats = run_stats()
        _, t32b = solve_timed(P.args(), **kw32)
        _, t64b = solve_timed(P.args(), **kw64)
        cpu = conic_ip(*P.args(), **dict(kw32, device="cpu"))
        resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
        check(sol.status == "Optimal", f"{label}: f32 status {sol.status}")
        check(ref.status == "Optimal", f"{label}: f64 status {ref.status}")
        check(resid < 1e-6, f"{label}: f32 residual {resid:.3e}")
        dy = (sol.y - ref.y).abs().max().item()
        scale = max(1.0, ref.y.abs().max().item())
        check(dy <= F32_Y_TOL * scale,
              f"{label}: |y_f32 - y_f64| {dy:.3e} over {F32_Y_TOL:g} x "
              f"{scale:.3g}")
        # these cases have no equalities: one order-n factor per KKT
        # build, through the f32 entry on a fast build and the f64 entry on
        # a last-mile step; what a count exceeds its builds by are ridge
        # retries
        fast, slow = stats["f32_builds"], stats["f64_builds"]
        check(used32 >= fast > 0,
              f"{label}: {used32} f32 launches for {fast} f32 builds")
        check(used64 >= slow,
              f"{label}: {used64} f64 launches for {slow} f64 builds")
        check(at_n == used32 + used64,
              f"{label}: {at_n} of {used32 + used64} launches at order {n}")
        check(abs(cpu.Iter - sol.Iter) <= 2 and cpu.status == sol.status,
              f"{label}: cpu {cpu.status}/{cpu.Iter} vs gpu "
              f"{sol.status}/{sol.Iter}")
        line("f32", instance=label, status=sol.status, Iter=sol.Iter,
             f64_iter=ref.Iter, cpu_iter=cpu.Iter, resid=f"{resid:.3e}",
             y_diff_f64=f"{dy:.3e}", runs=stats["runs"], f32_builds=fast,
             f64_builds=slow, lastmile_steps=stats["lastmile_steps"],
             f32_launches=used32, f64_launches=used64,
             f32_retries=used32 - fast, f64_retries=used64 - slow,
             recertified=stats["recertified"],
             ms_per_solve=f"{(t32a + t32b) / 2:.2f}",
             f64_ms_per_solve=f"{(t64a + t64b) / 2:.2f}")


EQ_RANK = 10  # rank of every [eq] instance's equality block


@functools.lru_cache(maxsize=None)
def eq_cases():
    from conicip_tpu_torch import models

    return (models.mixed_rq_eq(), models.mixed_rq_eq(n=1000))


@functools.lru_cache(maxsize=None)
def redundant_eq_case():
    """mixed_rq_eq with two dependent equality rows appended (rank 10 of
    12 rows, consistent): the preprocessor has to drop two."""
    from conicip_tpu_torch import models

    P = models.mixed_rq_eq()
    G = np.vstack([P.G, P.G[0] + P.G[1], 2.0 * P.G[2]])
    d = np.concatenate([P.d, [P.d[0] + P.d[1], 2.0 * P.d[2]]])
    return models.Problem("mixed_rq_eq(n=200,p=10+2 redundant)", P.Q, P.c,
                          P.A, P.b, P.cone_dims, G, d)


def eq_residual(P, sol):
    G = torch.as_tensor(P.G, device=sol.y.device)
    d = torch.as_tensor(P.d, device=sol.y.device)
    return (G @ sol.y - d).abs().max().item()


def phase_eq():
    """Equality elimination and the preprocessor, against the port's own
    CPU solve."""
    from conicip_tpu_torch import conic_ip, native, preprocess_conic_ip

    for P in eq_cases():
        n, p = P.Q.shape[0], P.G.shape[0]
        kw = dict(eliminateEqualities=True)
        solve_timed(P.args(), device="cuda", **kw)  # warm-up
        before, at_order = launches(), launches(n=n - p)
        sol, ms = solve_timed(P.args(), device="cuda", **kw)
        used = launches() - before
        at_order = launches(n=n - p) - at_order
        ref = conic_ip(*P.args(), device="cpu", **kw)
        resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
        gy = eq_residual(P, sol)
        check(sol.status == "Optimal", f"{P.name}: status {sol.status}")
        check(resid < 1e-6, f"{P.name}: residual {resid:.3e}")
        check(ref.status == sol.status and ref.Iter == sol.Iter,
              f"{P.name}: cpu {ref.status}/{ref.Iter} vs gpu "
              f"{sol.status}/{sol.Iter}")
        check(gy < 1e-8, f"{P.name}: |Gy - d| {gy:.3e}")
        dy = (sol.y.cpu() - ref.y).abs().max().item()
        check(dy <= 1e-6, f"{P.name}: y diff {dy:.3e}")
        # the reduced problem has no equalities: every factor is of order
        # n - p, one per KKT build
        check(used >= sol.Iter and at_order == used,
              f"{P.name}: {used} launches, not all at order {n - p}")
        line("eq", instance=P.name, path="eliminated", status=sol.status,
             Iter=sol.Iter, cpu_iter=ref.Iter, resid=f"{resid:.3e}",
             Gy_minus_d=f"{gy:.3e}", y_diff=f"{dy:.3e}", launches=used,
             reduced_order=n - p, ms_per_solve=f"{ms:.2f}",
             pivoted_qr=native.backend())

    P = redundant_eq_case()
    before = launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    sol = preprocess_conic_ip(*P.args(), device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    used = launches() - before
    ref = preprocess_conic_ip(*P.args(), device="cpu")
    gy = eq_residual(P, sol)
    dropped = int((sol.w == 0).sum().item())
    check(sol.status == "Optimal", f"{P.name}: status {sol.status}")
    check(ref.status == sol.status and ref.Iter == sol.Iter,
          f"{P.name}: cpu {ref.status}/{ref.Iter} vs gpu "
          f"{sol.status}/{sol.Iter}")
    check(sol.w.shape[0] == P.G.shape[0] and sol.w.device.type == "cuda",
          f"{P.name}: w of shape {tuple(sol.w.shape)} on {sol.w.device}")
    check(dropped == P.G.shape[0] - EQ_RANK,
          f"{P.name}: {dropped} zero duals, "
          f"{P.G.shape[0] - EQ_RANK} redundant rows")
    check(gy < 1e-8, f"{P.name}: |Gy - d| {gy:.3e}")
    check(used >= 2 * sol.Iter, f"{P.name}: {used} launches")
    line("eq", instance=P.name, path="preprocessed", status=sol.status,
         Iter=sol.Iter, cpu_iter=ref.Iter,
         resid=f"{max(sol.prFeas, sol.duFeas, sol.muFeas):.3e}",
         Gy_minus_d=f"{gy:.3e}", rows_dropped=dropped, launches=used,
         ms_per_solve=f"{ms:.2f}", pivoted_qr=native.backend())


@functools.lru_cache(maxsize=None)
def lowrank_case():
    """Instance 0 of the low-rank backend's family at the shape of
    mixed_rq_eq: r = 51 SOC rows + 10 equality rows = 61."""
    from conicip_tpu_torch import models

    Q, c, A, b, cones, G, d = models.batched_mixed_rq_eq(
        1, n=200, n_q=51, p=10)
    return models.Problem("batched_mixed_rq_eq(1,n=200,n_q=51,p=10)[0]",
                          Q[0], c[0], A[0], b[0], cones, G, d[0])


def phase_backends():
    """The KKT backends a caller picks by hand: qr and lu (library
    factorizations, no kernel of this package) and the low-rank Woodbury
    solver, whose two small factors run the kernel."""
    from conicip_tpu_torch import conic_ip, kktsolver_lu, kktsolver_qr, models
    from conicip_tpu_torch.cones.spec import ConeSpec
    from conicip_tpu_torch.kkt.lowrank import (lowrank_applicable,
                                               lowrank_kktsolver)

    low = lowrank_case()
    check(lowrank_applicable(low.Q, low.A, low.G, ConeSpec(low.cone_dims)),
          "the low-rank backend does not apply to its own family")
    for name, P, kkt in (("qr", models.mixed_rq_eq(), kktsolver_qr),
                         ("lu", models.mixed_rq_eq(), kktsolver_lu),
                         ("lowrank", low, lowrank_kktsolver())):
        solve_timed(P.args(), device="cuda", kktsolver=kkt)  # warm-up
        before = launches()
        sol, ms = solve_timed(P.args(), device="cuda", kktsolver=kkt)
        used = launches() - before
        builds = run_stats()["f64_builds"]
        by_order = {k: launches(n=k) for k in (P.Q.shape[0], P.G.shape[0],
                    P.A.shape[0] - P.Q.shape[0] + P.G.shape[0])}
        ref = conic_ip(*P.args(), device="cpu", kktsolver=kkt)
        resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
        dy = (sol.y.cpu() - ref.y).abs().max().item()
        check(sol.status == "Optimal", f"{name}: status {sol.status}")
        check(resid < 1e-6, f"{name}: residual {resid:.3e}")
        check(ref.status == sol.status and ref.Iter == sol.Iter,
              f"{name}: cpu {ref.status}/{ref.Iter} vs gpu "
              f"{sol.status}/{sol.Iter}")
        check(dy <= 1e-6, f"{name}: y diff {dy:.3e}")
        extra = {}
        if name == "lowrank":
            n, p = P.Q.shape[0], P.G.shape[0]
            r = P.A.shape[0] - n + p
            at_r, at_p = by_order[r], by_order[p]
            # counts since the phase began: the warm-up solve doubles them
            check(at_r == at_p == 2 * builds and by_order[n] == 0,
                  f"lowrank: {at_r} launches at r={r}, {at_p} at p={p}, "
                  f"{by_order[n]} at n={n}, for {builds} KKT builds")
            check(used == 2 * builds, f"lowrank: {used} launches")
            extra = dict(r=r, p=p, kkt_builds=builds,
                         launches_at_r=at_r // 2, launches_at_p=at_p // 2,
                         launches_at_n=0)
        else:
            check(used == 0, f"{name}: {used} Cholesky launches")
        line("backends", backend=name, instance=P.name, status=sol.status,
             Iter=sol.Iter, cpu_iter=ref.Iter, resid=f"{resid:.3e}",
             y_diff=f"{dy:.3e}", launches=used, ms_per_solve=f"{ms:.2f}",
             **extra)
    for name, kkt in (("qr", kktsolver_qr), ("lu", kktsolver_lu)):
        backend_on_a_stack(name, kkt)


def backend_on_a_stack(name, kkt):
    """qr or lu under solve_batch on the mixed R+Q stack with equalities:
    library factorizations with a leading batch axis, no kernel of this
    package. Sampled instances against their single solves on the same
    backend; then a cut of the stack with one non-finite instance, which
    reaches the factorizations and must end Error alone."""
    from conicip_tpu_torch import conic_ip
    from conicip_tpu_torch.ops import cholesky_kernel

    label, args = batch_cases()[1][:2]
    timed_batch(args, kktsolver=kkt)  # warm-up
    before = Counter(cholesky_kernel.cholesky_launches)
    out, ms = timed_batch(args, kktsolver=kkt)
    got, singles = launched_since(before)
    resid = torch.maximum(out.prFeas, torch.maximum(
        out.duFeas, out.muFeas)).max().item()
    statuses, iters = out.statuses, out.Iter.tolist()
    what = f"{name} on {label}"
    check(statuses == ["Optimal"] * BATCH, f"{what}: {Counter(statuses)}")
    check(resid < 1e-6, f"{what}: max residual {resid:.3e}")
    check(out.y.device.type == "cuda", f"{what}: result not on cuda")
    check(not got and singles == 0,
          f"{what}: Cholesky launches {dict(got)}, {singles} single")
    pairs, dy = [], 0.0
    for i in SAMPLED:
        one = conic_ip(*instance(args, i), device="cuda", kktsolver=kkt)
        pairs.append(f"{iters[i]}/{one.Iter}")
        check((one.status, one.Iter) == (statuses[i], iters[i]),
              f"{what}[{i}]: batch {statuses[i]}/{iters[i]}, single "
              f"{one.status}/{one.Iter}")
        dy = max(dy, (one.y - out.y[i]).abs().max().item())
    check(dy <= 1e-6, f"{what}: |y - y_single| {dy:.3e}")
    cut, bad = 8, 5
    hurt_args = list(stack_of_many(args, cut))
    hurt_args[1] = hurt_args[1].clone()
    hurt_args[1][bad, 3] = float("nan")
    hurt = timed_batch(tuple(hurt_args), kktsolver=kkt)[0]
    keep = [i for i in range(cut) if i != bad]
    check(hurt.statuses[bad] == "Error"
          and [hurt.statuses[i] for i in keep] == ["Optimal"] * (cut - 1)
          and hurt.Iter[keep].tolist() == [iters[i] for i in keep],
          f"{what}: with a non-finite instance {hurt.statuses}, Iter "
          f"{hurt.Iter.tolist()}")
    line("backends", backend=name, stack=repr(label), B=BATCH,
         status="Optimal x64", Iter=f"{min(iters)}-{max(iters)}",
         resid=f"{resid:.3e}", sampled_iter_batch_single=",".join(pairs),
         y_diff_single=f"{dy:.3e}", launches=0,
         nan_instance=f"Error@{bad} of {cut}, others unchanged",
         ms_per_batch=f"{ms:.2f}")


def on_card(args):
    """A stacked problem's arrays as f64 tensors on the card."""
    return tuple(x if isinstance(x, list) or x is None
                 else torch.as_tensor(x, dtype=torch.float64, device="cuda")
                 for x in args)


def instance(args, i):
    """conic_ip's positional arguments for instance i of a stack (G shared
    when it is 2-D)."""
    Q, c, A, b, cones = args[:5]
    G = d = None
    if len(args) > 5 and args[5] is not None:
        G = args[5] if args[5].dim() == 2 else args[5][i]
        d = args[6][i]
    return Q[i], c[i], A[i], b[i], cones, G, d


@functools.lru_cache(maxsize=None)
def batch_cases():
    """(label, stacked arguments, solve_batch keywords, the keywords that
    give conic_ip the same solver on one instance, orders factored by
    backend). Widths of the batched families; 64 instances each."""
    from conicip_tpu_torch import models
    from conicip_tpu_torch.kkt import kktsolver_schur

    f32 = torch.float32
    schur1 = dict(kktsolver=kktsolver_schur, centralityCorrectors=1)
    schur0 = dict(kktsolver=kktsolver_schur, centralityCorrectors=0)
    rq = on_card(models.batched_mixed_rq_eq(BATCH, n=200, n_q=51, p=10))
    sdp = on_card(models.batched_small_sdp(BATCH))
    # orders by backend: the Schur solver factors n and, with equalities,
    # p; the low-rank one r = SOC rows + p, and p; the spectral one nothing
    return (
        ("batched_box_qp(64,n=500)",
         on_card(models.batched_box_qp(BATCH, n=500)), {}, schur1,
         dict(schur=(500,))),
        ("batched_mixed_rq_eq(64,n=200,n_q=51,p=10)", rq, {}, schur1,
         dict(schur=(200, 10))),
        ("batched_mixed_rq_eq(64,n=200,n_q=51,p=10) f32", rq,
         dict(factor_dtype=f32),
         dict(factor_dtype=f32, eliminateEqualities=False),
         dict(schur=(200, 10), lowrank=(61, 10))),
        ("batched_mixed_rq_eq(64,n=200,n_q=51,p=10) f32 eliminated", rq,
         dict(factor_dtype=f32, eliminate_equalities=True),
         dict(factor_dtype=f32, eliminateEqualities=True),
         dict(schur=(190,))),
        ("batched_mixed_rqs(64)", on_card(models.batched_mixed_rqs(BATCH)),
         {}, schur0, dict(schur=(86,))),
        ("batched_small_sdp(64)", sdp, {}, schur0, dict(schur=(55,))),
        ("batched_small_sdp(64) f32", sdp, dict(factor_dtype=f32),
         dict(factor_dtype=f32), dict(schur=(55,))),
    )


def batch_factor_shapes():
    """Stacks (B, n) the [batch] and [checkpoint] phases hand the batched
    entries: every order of every backend of batch_cases, the planted and
    checkpointed stacks and the [ladder] phase's S-cone stack, at 64
    instances; and the f32 cases' orders at one instance, where the phase
    solves a rescued instance alone."""
    shapes = {(BATCH, PLANTED_N), (BATCH, tri(BACKSTOP_K))}
    for _, _, kw, _, by_backend in batch_cases():
        for sizes in by_backend.values():
            shapes.update((B, n) for n in sizes
                          for B in ((BATCH, 1) if kw else (BATCH,)))
    for ranks in (1, DIST_RANKS):  # [distributed]: a slice of the stack each
        shapes |= distributed_factor_shapes(ranks)[1]
    return shapes


def stack_of_one(args, i):
    """solve_batch's positional arguments for instance i alone (G shared
    when it is 2-D)."""
    Q, c, A, b, cones = args[:5]
    rest = ()
    if len(args) > 5 and args[5] is not None:
        G = args[5] if args[5].dim() == 2 else args[5][i:i + 1]
        rest = (G, args[6][i:i + 1])
    return (Q[i:i + 1], c[i:i + 1], A[i:i + 1], b[i:i + 1], cones) + rest


def stack_of_many(args, k):
    """solve_batch's positional arguments for the first k instances."""
    Q, c, A, b, cones = args[:5]
    rest = ()
    if len(args) > 5 and args[5] is not None:
        G = args[5] if args[5].dim() == 2 else args[5][:k]
        rest = (G, args[6][:k])
    return (Q[:k], c[:k], A[:k], b[:k], cones) + rest


def finished_by(runs, i, batch):
    """The first run over the whole stack of ``batch`` that left instance i
    with a definitive status: (its index in runs, the run), or (None,
    None)."""
    from conicip_tpu_torch.solver.state import Status

    for k, r in enumerate(runs):
        if r.batch == batch and r.status[i] not in (Status.ABANDONED,
                                                    Status.ERROR):
            return k, r
    return None, None


def expected_batched_launches(runs, orders):
    """Launches of the batched entries that the stacked runs of one
    solve_batch call must have made, as a Counter over (dtype, order): one
    factor per order of its backend and per KKT build of a run (its cold
    start and every step)."""
    from conicip_tpu_torch.kkt.lowrank import lowrank_kktsolver
    from conicip_tpu_torch.kkt.spectral import spectral_kktsolver

    want = Counter()
    for r in runs:
        builds = r.fast_steps + r.slow_steps + r.cold_start
        if r.kktsolver is spectral_kktsolver(None):
            continue
        if r.kktsolver is lowrank_kktsolver():
            dt, sizes = torch.float64, orders["lowrank"]
        else:
            kw = getattr(r.kktsolver, "keywords", {})
            dt = kw.get("factor_dtype") or torch.float64
            sizes = orders["schur"]
        for k in sizes:
            want[(dt, k)] += builds
    return want


def launched_since(before):
    """What the wrapper's counter gained since the copy ``before``: the
    batched launches as a Counter over (dtype, order), and the number of
    single-entry launches."""
    from conicip_tpu_torch.ops import cholesky_kernel

    got, singles = Counter(), 0
    for key, count in (cholesky_kernel.cholesky_launches - before).items():
        if len(key) == 3:
            got[key[:2]] += count
        else:
            singles += count
    return got, singles


def timed_batch(args, **kw):
    from conicip_tpu_torch import solve_batch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = solve_batch(*args, device="cuda", **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def phase_batch():
    """solve_batch on stacks of 64 instances, every instance checked, four
    of them against their own conic_ip solve, and the kernel's batched
    launches against the KKT builds of the stacked runs."""
    from conicip_tpu_torch import conic_ip, models, solve_batch
    from conicip_tpu_torch.ops import cholesky_kernel
    from conicip_tpu_torch.parallel import batch as pbatch

    for label, args, kw, single_kw, orders in batch_cases():
        f32 = "factor_dtype" in kw
        timed_batch(args, **kw)  # warm-up
        before = Counter(cholesky_kernel.cholesky_launches)
        out, ms = timed_batch(args, **kw)
        runs = list(pbatch.runs)
        got, singles = launched_since(before)
        want = expected_batched_launches(runs, orders)
        _, ms2 = timed_batch(args, **kw)
        resid = torch.maximum(out.prFeas, torch.maximum(
            out.duFeas, out.muFeas)).max().item()
        statuses = out.statuses
        check(statuses == ["Optimal"] * BATCH,
              f"{label}: {Counter(statuses)}")
        check(resid < 1e-6, f"{label}: max residual {resid:.3e}")
        check(out.y.device.type == "cuda", f"{label}: result not on cuda")
        # one stacked factor per order and KKT build (none on the spectral
        # tier); what a count exceeds its builds by are ridge retries (f32
        # factors near convergence)
        retries = sum(got.values()) - sum(want.values())
        check(set(got) == set(want) and all(got[k] >= want[k] for k in want)
              and singles == 0,
              f"{label}: batched launches {dict(got)}, KKT builds "
              f"{dict(want)}, single-entry launches {singles}")
        check(f32 or retries == 0, f"{label}: {retries} ridge retries in f64")
        iters = out.Iter.tolist()
        t_single = 0.0
        for i in range(8):
            torch.cuda.synchronize()
            t = time.perf_counter()
            one = conic_ip(*instance(args, i), device="cuda", **single_kw)
            torch.cuda.synchronize()
            t_single += (time.perf_counter() - t) * 1e3
        whole = all(r.batch == BATCH for r in runs)
        pairs = []
        for i in SAMPLED:
            one = conic_ip(*instance(args, i), device="cuda", **single_kw)
            k, by = finished_by(runs, i, BATCH)
            check(k is not None and one.status == statuses[i],
                  f"{label}[{i}]: batch {statuses[i]}, single {one.status}, "
                  f"finished by run {k} over the stack")
            if whole:  # no sub-batch added its steps: the tier's own count
                check(iters[i] == by.Iter[i],
                      f"{label}[{i}]: Iter {iters[i]}, {by.tier} counted "
                      f"{by.Iter[i]}")
            if k == 0:
                # finished by the main tier: the single solve's count, in
                # f32 within 2 of it
                pairs.append(f"{iters[i]}/{one.Iter}")
                check(abs(one.Iter - iters[i]) <= (2 if f32 else 0),
                      f"{label}[{i}]: batch Iter {iters[i]} vs single "
                      f"{one.Iter}")
                continue
            # finished by a rescue tier: Iter is that tier's own count,
            # where the single solve's in-loop switch to f64 factors avoids
            # the stall. Held against the same instance as a stack of one,
            # same keywords: the same tier finishes it, within 2 steps.
            alone = solve_batch(*stack_of_one(args, i), device="cuda", **kw)
            _, by1 = finished_by(list(pbatch.runs), 0, 1)
            it1 = int(alone.Iter[0])
            pairs.append(f"{iters[i]}/{it1}({by.tier})")
            check(f32 and alone.statuses == [statuses[i]]
                  and by1 is not None and by1.tier == by.tier
                  and abs(it1 - iters[i]) <= 2,
                  f"{label}[{i}]: {by.tier} finished it at Iter {iters[i]} "
                  f"in the stack; alone {alone.statuses[0]} at Iter {it1} by "
                  f"{by1 and by1.tier}")
        line("batch", family=repr(label), B=BATCH, status="Optimal x64",
             Iter=f"{min(iters)}-{max(iters)}", resid=f"{resid:.3e}",
             tiers="+".join(f"{r.tier}:{r.batch}" for r in runs),
             batched_launches=",".join(
                 f"{str(dt).split('.')[-1]}@{k}:{v}"
                 for (dt, k), v in sorted(got.items(), key=str)) or "none",
             kkt_builds=sum(want.values()), ridge_retries=retries,
             sampled_iter_batch_single=",".join(pairs),
             ms_per_batch=f"{(ms + ms2) / 2:.2f}",
             ms_64_single_solves=f"{8 * t_single:.2f}",
             single_measured_on="8 instances x 8",
             speedup=f"{8 * t_single / ((ms + ms2) / 2):.1f}")

    # one infeasible and one unbounded instance in a stack of dense box QPs
    n, inf_i, unb_i = PLANTED_N, BATCH // 3, 2 * BATCH // 3
    Q, c, A, b, cones = models.batched_box_qp(BATCH, n=n)
    b[inf_i] = np.ones(2 * n)  # y >= 1 and -y >= 1
    Q[unb_i] = 0.0  # no curvature, only y >= -1: +c is a free ray
    A[unb_i, n:] = np.eye(n)
    c[unb_i] = np.abs(c[unb_i]) + 0.1
    out, ms = timed_batch(on_card((Q, c, A, b, cones)))
    statuses = out.statuses
    others = [i for i in range(BATCH) if i not in (inf_i, unb_i)]
    rest = [statuses[i] for i in others]
    check(statuses[inf_i] == "Infeasible" and statuses[unb_i] == "Unbounded"
          and rest == ["Optimal"] * (BATCH - 2),
          f"planted batch: {statuses[inf_i]}, {statuses[unb_i]}, "
          f"{Counter(rest)}")
    check(bool(torch.isfinite(out.y[others]).all()),
          "planted batch: a certificate's NaN reached another instance")
    line("batch", family=f"'batched_box_qp(64,n={PLANTED_N}) planted'", B=BATCH,
         infeasible=f"{statuses[inf_i]}@{inf_i}",
         unbounded=f"{statuses[unb_i]}@{unb_i}",
         others=f"Optimal x{len(rest)}", ms_per_batch=f"{ms:.2f}")


def phase_checkpoint():
    """solve_batch_resumable stopped after its first chunk and resumed."""
    from conicip_tpu_torch import models, solve_batch
    from conicip_tpu_torch.parallel import checkpoint as cp

    args = on_card(models.batched_box_qp(BATCH, n=PLANTED_N))
    ref = solve_batch(*args, device="cuda")
    orig, calls = cp.solve_batch, {"n": 0}

    def preempted(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt
        return orig(*a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "snapshot.npz")
        cp.solve_batch = preempted
        try:
            cp.solve_batch_resumable(*args, store=store, chunk_iters=3,
                                     maxIters=60, device="cuda")
            check(False, "checkpoint: the second chunk did not stop the run")
        except KeyboardInterrupt:
            pass
        finally:
            cp.solve_batch = orig
        info = cp.load_snapshot(store)
        check(info is not None and info.iters_done == 3 and not info.done
              and info.batch == BATCH,
              f"checkpoint: snapshot after the first chunk {info}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = cp.solve_batch_resumable(*args, store=store, chunk_iters=50,
                                       maxIters=60, device="cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        done = cp.load_snapshot(store)
    resid = torch.maximum(out.prFeas, torch.maximum(
        out.duFeas, out.muFeas)).max().item()
    dy = (out.y - ref.y).abs().max().item()
    check(out.statuses == ref.statuses == ["Optimal"] * BATCH,
          f"checkpoint: {Counter(out.statuses)} vs {Counter(ref.statuses)}")
    check(done.done and int(out.Iter.min()) > 3 and resid < 1e-6,
          f"checkpoint: done={done.done} Iter>={int(out.Iter.min())} "
          f"resid {resid:.3e}")
    check(out.y.device.type == "cuda", "checkpoint: result not on cuda")
    # a chunk boundary warm-restarts the iteration: two tolerance-accurate
    # answers of one problem
    check(dy <= 2e-3, f"checkpoint: |y - y_uninterrupted| {dy:.3e}")
    line("checkpoint", family=f"'batched_box_qp(64,n={PLANTED_N})'", chunk_iters=3,
         stopped_after="chunk 1", finished_at_stop=info.n_finished,
         resumed="Optimal x64", Iter=f"{int(out.Iter.min())}-"
         f"{int(out.Iter.max())}", resid=f"{resid:.3e}",
         y_diff_uninterrupted=f"{dy:.3e}", resume_ms=f"{ms:.2f}")


SET_OF_CONE = {"R": "Nonnegatives", "Q": "SecondOrderCone"}


def optimizer_model(P, **options):
    """The generator problem P (min ½yᵀQy − cᵀy, Ay ≥_K b, Gy = d) as an
    Optimizer model: −c as the linear terms, Q as the quadratic, one
    constraint per cone block and one Zeros constraint for the equalities.
    Returns (model, variables, cone constraint ids, equality id or None)."""
    from conicip_tpu_torch import frontend as fe
    from conicip_tpu_torch.cones.spec import tri_order

    model = fe.Optimizer(**options)
    x = model.add_variables(P.Q.shape[0])
    model.set_objective("min", -P.c, quadratic=P.Q)
    cones, row = [], 0
    for kind, dim in P.cone_dims:
        cset = (fe.PSDTriangle(tri_order(dim)) if kind == "S"
                else getattr(fe, SET_OF_CONE[kind])(dim))
        cones.append(model.add_constraint(P.A[row:row + dim],
                                          -P.b[row:row + dim], cset))
        row += dim
    eq = None
    if P.G is not None and P.G.shape[0]:
        eq = model.add_constraint(P.G, -P.d, fe.Zeros(P.G.shape[0]))
    return model, x, cones, eq


def conic_form_data(P):
    """The generator problem P in standard conic form, b − Ax ∈ K with the
    rows ordered zero, nonneg, soc, psd: rows and signs flipped, the
    objective's sign too. Returns (c, A, b, dims, P)."""
    from conicip_tpu_torch.cones.spec import tri_order
    from conicip_tpu_torch.frontend import ConeDims

    kinds = [k for k, _ in P.cone_dims]
    check(kinds == sorted(kinds, key="RQS".index),
          f"{P.name}: cone blocks are not in R, Q, S order")
    dims = ConeDims(
        zero=0 if P.G is None else P.G.shape[0],
        nonneg=sum(d for k, d in P.cone_dims if k == "R"),
        soc=[d for k, d in P.cone_dims if k == "Q"],
        psd=[tri_order(d) for k, d in P.cone_dims if k == "S"])
    if dims.zero:
        return (-P.c, np.vstack([P.G, -P.A]), np.concatenate([P.d, -P.b]),
                dims, P.Q)
    return -P.c, -P.A, -P.b, dims, P.Q


def through_frontend(route, P, options, **device):
    """Build P through a frontend and solve it (on the card unless
    ``device`` says otherwise). Returns what a user reads back, all host
    values: the solution record, primal, per-block cone duals, equality
    dual, objective; and the ms of building the model and of the solve."""
    from conicip_tpu_torch.frontend import solve_conic_form

    t0 = time.perf_counter()
    if route == "Optimizer":
        model, x, cones, eq = optimizer_model(P, **options, **device)
        t1 = time.perf_counter()
        sol = model.optimize()
        if sol.y.is_cuda:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        primal = model.variable_primal(x)
        duals = [model.constraint_dual(ci) for ci in cones]
        w = model.constraint_dual(eq) if eq is not None else np.zeros(0)
        obj = model.objective_value()
    else:
        c, A, b, dims, Pq = conic_form_data(P)
        t1 = time.perf_counter()
        res = solve_conic_form(c, A, b, dims, P=Pq, **options, **device)
        if res.solution.y.is_cuda:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        sol, primal, obj = res.solution, res.x, res.obj
        w, v = res.y[:dims.zero], res.y[dims.zero:]
        duals = list(np.split(v, np.cumsum([d for _, d in P.cone_dims])[:-1]))
    return dict(sol=sol, primal=primal, duals=duals, w=w, obj=obj,
                build_ms=(t1 - t0) * 1e3, solve_ms=(t2 - t1) * 1e3)


@functools.lru_cache(maxsize=None)
def frontend_cases():
    """(label, problem, frontend, solver options, launch rule as in
    conic_cases) of the [frontend] phase."""
    from conicip_tpu_torch import models
    from conicip_tpu_torch.kkt import kktsolver_schur

    box, soc, sdp = (models.box_qp_dense(n=1024), models.single_soc(n=500),
                     models.larger_sdp())
    return (
        ("box_qp_dense(n=1024)", box, "Optimizer", {}, "iter"),
        ("single_soc(n=500)", soc, "Optimizer", {}, "iter"),
        ("single_soc(n=500)", soc, "solve_conic_form", {}, "iter"),
        ("larger_sdp(k=30)", sdp, "solve_conic_form", {}, "none"),
        ("larger_sdp(k=30) schur", sdp, "solve_conic_form",
         dict(kktsolver=kktsolver_schur), "iter"),
    )


def max_diff(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max()) if a.size else 0.0


def phase_frontend():
    """Three families built through the frontends at full width, each held
    against the direct conic_ip solve of the same generator on the card
    and against the CPU solve through the same frontend."""
    from scipy.linalg import qr as lapack_qr

    from conicip_tpu_torch import conic_ip, native
    from conicip_tpu_torch.frontend import (Nonnegatives, Nonpositives,
                                            Optimizer)
    from conicip_tpu_torch.preprocess import imcols

    for label, P, route, options, rule in frontend_cases():
        what = f"{route} {label}"
        solve_timed(P.args(), device="cuda", **options)  # warm-up
        # one frontend call between the direct ones: its host rank
        # detection takes seconds at n = 1024, so it is not repeated
        before = launches()
        got = through_frontend(route, P, options)  # on the card by default
        used = launches() - before
        direct, d1 = solve_timed(P.args(), device="cuda", **options)
        _, d2 = solve_timed(P.args(), device="cuda", **options)
        cpu = through_frontend(route, P, options, device="cpu")
        sol = got["sol"]
        check(all(t.device.type == "cuda" for t in (sol.y, sol.w, sol.v)),
              f"{what}: the solution's tensors are not on cuda")
        check(all(isinstance(a, np.ndarray) for a in
                  [got["primal"], got["w"]] + got["duals"])
              and isinstance(got["obj"], float),
              f"{what}: a getter returned something that is no host value")
        check(sol.status == direct.status == cpu["sol"].status == "Optimal",
              f"{what}: {sol.status}, direct {direct.status}, cpu "
              f"{cpu['sol'].status}")
        check(sol.Iter == direct.Iter == cpu["sol"].Iter,
              f"{what}: Iter {sol.Iter}, direct {direct.Iter}, cpu "
              f"{cpu['sol'].Iter}")
        need = {"iter": sol.Iter, "none": 0}[rule]
        check(used == 0 if rule == "none" else used >= need,
              f"{what}: {used} kernel launches for Iter {sol.Iter} "
              f"(rule {rule})")
        want = dict(primal=direct.y.cpu().numpy(), w=direct.w.cpu().numpy(),
                    duals=list(np.split(
                        direct.v.cpu().numpy(),
                        np.cumsum([d for _, d in P.cone_dims])[:-1])),
                    obj=direct.pobj)
        diffs = {}
        for other, ref in (("direct", want), ("cpu", cpu)):
            dobj = abs(got["obj"] - ref["obj"])
            check(dobj <= 1e-8 * (1 + abs(ref["obj"])),
                  f"{what}: objective {got['obj']!r} vs {other} "
                  f"{ref['obj']!r}")
            dy = max_diff(got["primal"], ref["primal"])
            dv = max([max_diff(a, b) for a, b in zip(got["duals"],
                                                      ref["duals"])]
                     + [max_diff(got["w"], ref["w"])])
            check(len(got["duals"]) == len(ref["duals"]) and dy <= 1e-6
                  and dv <= 1e-6,
                  f"{what}: primal {dy:.3e}, duals {dv:.3e} off {other}")
            diffs[other] = (dobj, dy, dv)
        # the preprocessor's host rank detection, alone, on the same data
        t = time.perf_counter()
        imcols(np.hstack([P.Q, P.A.T]), P.c)
        rank_ms = (time.perf_counter() - t) * 1e3
        solve_ms, build_ms = got["solve_ms"], got["build_ms"]
        line("frontend", call=route, instance=repr(label), status=sol.status,
             Iter=sol.Iter, cpu_iter=cpu["sol"].Iter, launches=used,
             obj_diff_direct=f"{diffs['direct'][0]:.3e}",
             primal_diff_direct=f"{diffs['direct'][1]:.3e}",
             dual_diff_direct=f"{diffs['direct'][2]:.3e}",
             primal_diff_cpu=f"{diffs['cpu'][1]:.3e}",
             dual_diff_cpu=f"{diffs['cpu'][2]:.3e}",
             ms_per_solve=f"{build_ms + solve_ms:.2f}",
             model_build_ms=f"{build_ms:.2f}", solve_call_ms=f"{solve_ms:.2f}",
             rank_detection_ms=f"{rank_ms:.2f}")
        direct_ms = (d1 + d2) / 2
        line("frontend", call="conic_ip(direct)", instance=repr(label),
             status=direct.status, Iter=direct.Iter,
             ms_per_solve=f"{direct_ms:.2f}",
             frontend_over_direct=f"{(build_ms + solve_ms) / direct_ms:.2f}")

    # the two pivoted QRs of the rank detection at one shape it meets here
    P = frontend_cases()[1][1]
    M = np.hstack([P.Q, P.A.T]).T
    t = time.perf_counter()
    by_loop = native.pivoted_qr_rank(M)
    loop_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    lapack_qr(M, mode="r", pivoting=True)
    lapack_ms = (time.perf_counter() - t) * 1e3
    line("frontend", rank_qr_shape=f"{M.shape[0]}x{M.shape[1]}",
         cpp_loop_ms=("unavailable" if by_loop is None
                      else f"{loop_ms:.2f}"),
         lapack_ms=f"{lapack_ms:.2f}")

    # certificates through the status map. Infeasible: x − 1 ≥ 0 and
    # x ≤ 0; unbounded: min −Σx on x ≥ 0
    n = 50
    ones, zeros = np.ones(n), np.zeros(n)
    for want, cost, blocks in (
            ("INFEASIBLE", ones, ((-ones, Nonnegatives),
                                  (zeros, Nonpositives))),
            ("DUAL_INFEASIBLE", -ones, ((zeros, Nonnegatives),))):
        seen = []
        for device in ({}, dict(device="cpu")):
            model = Optimizer(**device)
            model.add_variables(n)
            model.set_objective("min", cost)
            for q, cset in blocks:
                model.add_constraint(np.eye(n), q, cset(n))
            model.optimize()
            seen.append((model.termination_status(), model.sol.Iter))
        check(seen[0] == seen[1] and seen[0][0] == want,
              f"Optimizer LP: card {seen[0]}, cpu {seen[1]}, wanted {want}")
        line("frontend", call="Optimizer",
             instance=f"'{want.lower()} LP n={n}'", status=seen[0][0],
             Iter=seen[0][1], cpu_iter=seen[1][1])


@functools.lru_cache(maxsize=None)
def ladder_case():
    """A separable QP with a wide diagonal spread and one equality, asked
    for a tolerance beyond what f32 factors reach: eliminated to a dense
    problem of order n − 1, the f32 tier and the f64-assembled f32 tier
    stall, the f64 tier finishes."""
    from conicip_tpu_torch import models

    n = LADDER_N
    rng = np.random.default_rng(1)
    Q = np.diag(np.logspace(0, -6, n))
    c = rng.standard_normal(n) * np.logspace(0, -3, n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    return models.Problem(f"wide_diag_qp(n={n},p=1)", Q, c, A, -np.ones(2 * n),
                          [("R", 2 * n)], np.ones((1, n)), np.array([0.3]))


def tier_of(kktsolver):
    """A default-backend kktsolver's precision as factor/assembly names."""
    kw = getattr(kktsolver, "keywords", {})

    def name(dt):
        return "f64" if dt is None else str(dt).replace("torch.float", "f")

    fd = kw.get("factor_dtype")
    return (f"{name(fd)}/{name(kw.get('assemble_dtype') or fd)}"
            + ("+lastmile" if kw.get("lastmile") else ""))


def iters_agree(tiers, mine, theirs):
    """Iter of the runs of one call on the card and on the CPU, instance by
    instance: equal while every run so far factored in f64, within 2 in
    the first f32 tier. A later tier starts from that tier's differently
    rounded iterates, and an instance then takes its short route (2 steps)
    on one machine and its long one (5) on the other: there each instance
    is held within 3, and the least and the most over the stack within
    2."""
    warm_from_f32 = False
    for tier, a, b in zip(tiers, mine, theirs):
        slack = 3 if warm_from_f32 else 2 if "f32" in tier else 0
        ok = (len(a) == len(b)
              and max(abs(x - y) for x, y in zip(a, b)) <= slack
              and abs(min(a) - min(b)) <= 2 and abs(max(a) - max(b)) <= 2)
        if not ok:
            return False
        warm_from_f32 = warm_from_f32 or "f32" in tier
    return True


def phase_ladder():
    """The rescue paths behind f32 factors, each against the CPU run of the
    same call: the tiers in order, the statuses, Iter, and the kernel's
    launches by dtype and order against the KKT builds of the runs."""
    from conicip_tpu_torch import conic_ip, models, solve_batch, solver
    from conicip_tpu_torch.cones.symm import mat, vecm
    from conicip_tpu_torch.kkt import kktsolver_schur
    from conicip_tpu_torch.ops import cholesky_kernel
    from conicip_tpu_torch.parallel import batch as pbatch
    from conicip_tpu_torch.solver.state import Status

    f32, f64 = torch.float32, torch.float64
    P = ladder_case()
    order = P.Q.shape[0] - P.G.shape[0]
    kw = dict(factor_dtype=f32, optTol=1e-10, maxIters=40)
    solve_timed(P.args(), device="cuda", **kw)  # warm-up
    c32, c64, at_n = launches(f32), launches(f64), launches(n=order)
    sol, ms = solve_timed(P.args(), device="cuda", **kw)
    used32, used64 = launches(f32) - c32, launches(f64) - c64
    at_n = launches(n=order) - at_n
    stats, runs = run_stats(), list(solver.runs)
    cpu = conic_ip(*P.args(), device="cpu", **kw)
    cpu_runs = list(solver.runs)
    tiers = [tier_of(r.kktsolver) for r in runs]
    cpu_tiers = [tier_of(r.kktsolver) for r in cpu_runs]
    what = f"ladder {P.name}"
    check(len(runs) > 1 and tiers == cpu_tiers,
          f"{what}: tiers {tiers}, cpu {cpu_tiers}")
    check([r.status for r in runs] == [r.status for r in cpu_runs]
          and sol.status == cpu.status == "Optimal",
          f"{what}: {[r.status for r in runs]} vs cpu "
          f"{[r.status for r in cpu_runs]}")
    check(iters_agree(tiers, [(r.Iter,) for r in runs],
                      [(r.Iter,) for r in cpu_runs]),
          f"{what}: Iter {[r.Iter for r in runs]} vs cpu "
          f"{[r.Iter for r in cpu_runs]}")
    resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
    dy = (sol.y.cpu() - cpu.y).abs().max().item()
    dp = abs(sol.pobj - cpu.pobj)
    # residuals of 1e-10 over a smallest curvature of 1e-6 pin y to 1e-4
    check(resid < 1e-10 and dy <= 1e-4 and dp <= 1e-8 * (1 + abs(cpu.pobj)),
          f"{what}: residual {resid:.3e}, |y - y_cpu| {dy:.3e}, pobj diff "
          f"{dp:.3e}")
    check(used32 >= stats["f32_builds"] > 0
          and used64 >= stats["f64_builds"] > 0
          and at_n == used32 + used64
          and cholesky_kernel.launch_count(batch=True) == 0,
          f"{what}: {used32} f32 / {used64} f64 launches ({at_n} at order "
          f"{order}) for {stats['f32_builds']} / {stats['f64_builds']} builds")
    line("ladder", instance=P.name, call="conic_ip", tiers=">".join(tiers),
         statuses=">".join(r.status for r in runs),
         Iter=">".join(str(r.Iter) for r in runs),
         cpu_iter=">".join(str(r.Iter) for r in cpu_runs),
         resid=f"{resid:.3e}", y_diff_cpu=f"{dy:.3e}",
         pobj_diff_cpu=f"{dp:.3e}", reduced_order=order,
         f32_builds=stats["f32_builds"], f64_builds=stats["f64_builds"],
         f32_launches=used32, f64_launches=used64, ms_per_solve=f"{ms:.2f}")

    # a stack of S-cone projections under a caller's f32 Schur solver: no
    # fused tier stands behind a caller's solver on S cones, the f32
    # decompositions stall the stack near the tolerance, and the backstop
    # re-solves the stalled instances as a sub-batch in f64
    host = models.batched_small_sdp(BATCH, k=BACKSTOP_K)
    args = on_card(host)
    n = tri(BACKSTOP_K)
    kw = dict(factor_dtype=f32, kktsolver=functools.partial(
        kktsolver_schur, factor_dtype=f32))
    label = f"batched_small_sdp(64,k={BACKSTOP_K}) f32 schur"
    timed_batch(args, **kw)  # warm-up
    before = Counter(cholesky_kernel.cholesky_launches)
    out, ms = timed_batch(args, **kw)
    runs = list(pbatch.runs)
    got, singles = launched_since(before)
    ref = solve_batch(*host, device="cpu", **kw)
    cpu_runs = list(pbatch.runs)
    tiers = [f"{r.tier}:{tier_of(r.kktsolver)}" for r in runs]
    check(any(r.tier.startswith("backstop-") for r in runs)
          and [(r.tier, r.batch) for r in runs]
          == [(r.tier, r.batch) for r in cpu_runs],
          f"{label}: runs {[(r.tier, r.batch) for r in runs]}, cpu "
          f"{[(r.tier, r.batch) for r in cpu_runs]}")

    def stalled(r):
        return [s in (Status.ABANDONED, Status.ERROR) for s in r.status]

    check(out.statuses == ref.statuses == ["Optimal"] * BATCH
          and [stalled(r) for r in runs] == [stalled(r) for r in cpu_runs],
          f"{label}: {Counter(out.statuses)}, cpu {Counter(ref.statuses)}; "
          f"stalled per run {[sum(stalled(r)) for r in runs]}, cpu "
          f"{[sum(stalled(r)) for r in cpu_runs]}")
    check(iters_agree(tiers, [r.Iter for r in runs],
                      [r.Iter for r in cpu_runs])
          and (runs[-1].batch != BATCH
               or out.Iter.tolist() == list(runs[-1].Iter)),
          f"{label}: Iter {[r.Iter for r in runs]} vs cpu "
          f"{[r.Iter for r in cpu_runs]}")
    resid = torch.maximum(out.prFeas, torch.maximum(
        out.duFeas, out.muFeas)).max().item()
    dy = (out.y.cpu() - ref.y).abs().max().item()
    # two answers within optTol = 1e-6, from differently rounded f32 iterates
    check(resid < 1e-6 and dy <= 1e-4,
          f"{label}: max residual {resid:.3e}, |y - y_cpu| {dy:.3e}")
    # every instance came back from the sub-batch to its own place: its y
    # is the projection of its own matrix onto the PSD cone, which an
    # eigendecomposition gives in closed form. Residuals of 1e-6 under unit
    # curvature pin y to sqrt(2e-6) = 1.4e-3 of it; the answers of two
    # different instances lie a few tenths apart.
    lam, V = torch.linalg.eigh(mat(args[1]))
    exact = vecm((V * lam.clamp_min(0).unsqueeze(-2)) @ V.mT)
    off = (out.y - exact).abs().amax(-1)
    apart = torch.cdist(exact, exact, p=float("inf")).fill_diagonal_(
        float("inf")).min().item()
    check(off.max().item() <= 1.4e-3 < apart / 10,
          f"{label}: an instance is {off.max().item():.3e} (instance "
          f"{int(off.argmax())}) off the projection of its own matrix; two "
          f"instances' answers are {apart:.3e} apart at the least")
    # and the sampled ones against their own single f64 solve
    d1 = 0.0
    for i in SAMPLED:
        one = conic_ip(*instance(args, i), device="cuda")
        d1 = max(d1, (out.y[i] - one.y).abs().max().item())
        check(one.status == "Optimal" and d1 <= 1e-4,
              f"{label}[{i}]: {one.status} alone in f64, |y - y_single| "
              f"{d1:.3e}")
    per_instance = [abs(a - b) for a, b in zip(runs[-1].Iter,
                                               cpu_runs[-1].Iter)]
    want = expected_batched_launches(runs, dict(schur=(n,)))
    check(set(got) == set(want) == {(f32, n), (f64, n)}
          and all(got[k] >= want[k] for k in want) and singles == 0,
          f"{label}: batched launches {dict(got)}, KKT builds {dict(want)}, "
          f"single-entry launches {singles}")
    line("ladder", stack=repr(label), call="solve_batch", B=BATCH,
         tiers="+".join(f"{t}:{r.batch}" for t, r in zip(tiers, runs)),
         stalled_per_run="+".join(str(r.stalled) for r in runs),
         status="Optimal x64",
         Iter="+".join(f"{min(r.Iter)}-{max(r.Iter)}" for r in runs),
         cpu_iter="+".join(f"{min(r.Iter)}-{max(r.Iter)}" for r in cpu_runs),
         rescue_iter_differs_from_cpu=f"{sum(d > 0 for d in per_instance)}/"
         f"{len(per_instance)}", by_at_most=max(per_instance),
         resid=f"{resid:.3e}", y_diff_cpu=f"{dy:.3e}",
         y_off_own_projection=f"{off.max().item():.3e}",
         least_between_instances=f"{apart:.3e}",
         y_diff_sampled_single_f64=f"{d1:.3e}",
         batched_launches=",".join(
             f"{str(dt).split('.')[-1]}@{k}:{v}"
             for (dt, k), v in sorted(got.items(), key=str)),
         kkt_builds=sum(want.values()), ms_per_batch=f"{ms:.2f}")


DIST_N = 4096  # box_qp_dense order of [distributed]'s world of one
DIST_PAIR_N = 1024  # ... and of its two ranks sharing the card
DIST_RANKS = 2
DIST_TIMEOUT = 300.0  # seconds the two ranks may take in all


@functools.lru_cache(maxsize=None)
def multichip_problem():
    """The production-sized problem the reference's multichip dry run
    solves through its kktsolver_schur_tp (``__graft_entry__.py``): n = 512,
    R(1024) x Q(32) x Q(32), m = 1088, p = 16, diagonal Q, strictly
    feasible."""
    from conicip_tpu_torch import models
    from conicip_tpu_torch.cones.spec import ConeSpec

    n, p = 512, 16
    cones = [("R", 2 * n), ("Q", 32), ("Q", 32)]
    m = sum(k for _, k in cones)
    rng = np.random.default_rng(0)
    Q = np.diag(1.0 + rng.random(n))
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n),
                   rng.standard_normal((m - 2 * n, n)) * 0.1])
    y0 = rng.standard_normal(n) * 0.1
    b = A @ y0 - ConeSpec(cones).identity
    G = rng.standard_normal((p, n))
    return models.Problem(f"rq_eq(n={n},m={m},p={p})", Q, c, A, b,
                          cones, G, G @ y0)


@functools.lru_cache(maxsize=None)
def distributed_cases():
    """(label, problem, kktsolver_schur_tp keywords, conic_ip keywords,
    whether the CPU solve is run beside it) of [distributed]'s world of
    one; the two ranks sharing the card solve the ones of pair_cases()."""
    from conicip_tpu_torch import models

    rq, rqs = models.mixed_rq_eq(), models.mixed_rqs()
    return (
        (f"box_qp_dense(n={DIST_N})", models.box_qp_dense(n=DIST_N), {}, {},
         False),
        (f"box_qp_dense(n={DIST_PAIR_N})", models.box_qp_dense(n=DIST_PAIR_N),
         {}, {}, True),
        ("mixed_rq_eq(n=200,p=10)", rq, {}, {}, True),
        ("mixed_rq_eq(n=200,p=10) shard_scaling=False", rq,
         dict(shard_scaling=False), {}, True),
        ("mixed_rq_eq(n=200,p=10) distributed_factor=False", rq,
         dict(distributed_factor=False), {}, True),
        ("mixed_rqs(n=86)", rqs, {}, {}, True),
        # f32 factors on S cones stop near 2-3e-7 (the factor is the
        # floor there): optTol stays at 1e-6; the CPU tests hold the SOC
        # problem to 1e-7
        ("mixed_rqs(n=86) f32", rqs, dict(factor_dtype=torch.float32),
         dict(mixedResiduals=True), False),
        (multichip_problem().name, multichip_problem(), {}, {}, True),
    )


@functools.lru_cache(maxsize=None)
def pair_cases():
    from conicip_tpu_torch import models

    return ((f"box_qp_dense(n={DIST_PAIR_N})",
             models.box_qp_dense(n=DIST_PAIR_N)),
            ("mixed_rq_eq(n=200,p=10)", models.mixed_rq_eq()),
            (multichip_problem().name, multichip_problem()))


def distributed_factor_shapes(ranks):
    """Orders a world of ``ranks`` ranks hands the single entries through
    kktsolver_schur_tp (r = n_pad / ranks per panel, p for the equality
    factor, n_pad with distributed_factor=False), and the stacks its
    sharded solve_batch hands the batched ones."""
    if ranks == 1:
        cases = [(P, kw) for _, P, kw, _, _ in distributed_cases()]
    else:
        cases = [(P, {}) for _, P in pair_cases()]
    sizes = set()
    for P, kw in cases:
        n_pad = -(-P.Q.shape[0] // ranks) * ranks
        sizes.add(n_pad if kw.get("distributed_factor") is False
                  else n_pad // ranks)
        if P.G is not None:
            sizes.add(P.G.shape[0])
    return sizes, {(BATCH // ranks, 500)}


def tp_solve(P, mesh, kkt_kw, **kw):
    """P through kktsolver_schur_tp over the mesh's "tp" axis, on the card:
    (solution, ms, KKT builds, kernel launches of the solve)."""
    from conicip_tpu_torch import conic_ip, kktsolver_schur_tp, solver
    from conicip_tpu_torch.ops import cholesky_kernel

    before = Counter(cholesky_kernel.cholesky_launches)
    kkt = kktsolver_schur_tp(mesh, "tp", **kkt_kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sol = conic_ip(*P.args(), kktsolver=kkt, device="cuda", **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    r = solver.runs[-1]
    return (sol, ms, r.fast_steps + r.slow_steps + r.cold_start,
            cholesky_kernel.cholesky_launches - before)


def tp_launches_ok(P, got, builds, ranks, kkt_kw):
    """A TP solve's launches on one rank: per KKT build ``ranks`` factors
    of order r = n_pad / ranks (one of order n_pad with
    distributed_factor=False), one of order p with equalities; a ridge
    retry repeats the first kind. Returns (ok, description)."""
    n = P.Q.shape[0]
    n_pad = -(-n // ranks) * ranks
    whole = kkt_kw.get("distributed_factor") is False
    r, per = (n_pad, 1) if whole else (n_pad // ranks, ranks)
    dt = kkt_kw.get("factor_dtype", torch.float64)
    p = 0 if P.G is None else P.G.shape[0]
    want = {(dt, r)} | ({(dt, p)} if p else set())
    at_r, at_p = got[(dt, r)], got[(dt, p)] if p else 0
    ok = (set(got) == want and at_r >= per * builds and at_r % per == 0
          and at_p == (builds if p else 0))
    return ok, f"{at_r}@{r}" + (f"+{at_p}@{p}" if p else "")


def phase_distributed():
    """Distribution on the card: (a) a world of one rank (NCCL, started
    here): distributed_normal_matrix, kktsolver_schur_tp on each of
    distributed_cases() against the port's single-device Schur solve with 0
    correctors (and its CPU solve where it is small), solve_batch over a
    mesh against the unsharded stack; (b) two ranks sharing the card (gloo),
    this script run with --distributed-rank. Returns the kernel launches the
    two ranks made, which main() counts as this phase's."""
    import torch.distributed as dist

    from conicip_tpu_torch import make_mesh, models, solve_batch
    from conicip_tpu_torch.parallel import distributed_normal_matrix
    from conicip_tpu_torch.parallel.mesh import start_rank

    f64 = torch.float64
    one = {}
    with tempfile.TemporaryDirectory() as tmp:
        start_rank(0, 1, "file://" + os.path.join(tmp, "rendezvous"), "cuda")
        try:
            check(dist.get_backend() == "nccl",
                  f"world of one on {dist.get_backend()}, not nccl")
            tp = make_mesh((1,), ("tp",))
            g = torch.Generator(device="cuda").manual_seed(7)
            n, m = 1024, 2048
            A = torch.randn(m, n, generator=g, device="cuda", dtype=f64)
            dinv = 0.5 + torch.rand(m, generator=g, device="cuda", dtype=f64)
            Q = torch.eye(n, device="cuda", dtype=f64)
            M = distributed_normal_matrix(Q, A, dinv, tp, "tp")
            At = A * dinv[:, None]
            ref = Q + At.T @ At
            rel = ((M - ref).abs().max() / ref.abs().max()).item()
            check(rel <= 1e-12, f"distributed_normal_matrix: rel {rel:.3e}")
            line("distributed", world=1, backend="nccl",
                 case="distributed_normal_matrix", n=n, m=m,
                 rel_err=f"{rel:.3e}")
            for label, P, kkt_kw, kw, cpu in distributed_cases():
                one[label] = tp_case(label, P, tp, kkt_kw, kw, cpu, one)
            args = on_card(models.batched_box_qp(BATCH, n=500))
            plain = solve_batch(*args, device="cuda")
            bmesh = make_mesh((1,), ("batch",))
            timed_batch(args, mesh=bmesh)  # warm-up
            out, ms = timed_batch(args, mesh=bmesh)
            _, plain_ms = timed_batch(args)
            dy = (out.y - plain.y).abs().max().item()
            check(out.statuses == plain.statuses == ["Optimal"] * BATCH
                  and torch.equal(out.Iter, plain.Iter) and dy <= 1e-12,
                  f"solve_batch over a mesh of one: {Counter(out.statuses)}, "
                  f"Iter equal {torch.equal(out.Iter, plain.Iter)}, "
                  f"|y - y_unsharded| {dy:.3e}")
            one["batch"] = dict(status=plain.status.cpu(),
                                Iter=plain.Iter.cpu(), ms=plain_ms)
            line("distributed", world=1, backend="nccl",
                 case=f"'solve_batch batched_box_qp({BATCH},n=500)'",
                 mesh="(1,) batch", status=f"Optimal x{BATCH}",
                 Iter="equal to unsharded", y_diff_unsharded=f"{dy:.3e}",
                 ms_per_batch=f"{ms:.2f}", unsharded_ms=f"{plain_ms:.2f}")
        finally:
            dist.destroy_process_group()
    return pair_of_ranks(one)


def tp_case(label, P, mesh, kkt_kw, kw, cpu, one):
    """One TP solve of the world of one, held against the single-device
    Schur solve (0 correctors) on the card and, where ``cpu``, on the
    CPU."""
    from conicip_tpu_torch import conic_ip
    from conicip_tpu_torch.kkt import kktsolver_schur

    tp_solve(P, mesh, kkt_kw, **kw)  # warm-up
    sol, ms, builds, got = tp_solve(P, mesh, kkt_kw, **kw)
    single_kw = dict(kktsolver=kktsolver_schur, centralityCorrectors=0, **kw)
    if "factor_dtype" in kkt_kw:
        single_kw["kktsolver"] = functools.partial(
            kktsolver_schur, factor_dtype=kkt_kw["factor_dtype"])
    ref, ref_ms = solve_timed(P.args(), device="cuda", **single_kw)
    resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
    dy = (sol.y - ref.y).abs().max().item()
    what = f"world of one, {label}"
    f32 = "factor_dtype" in kkt_kw
    check(sol.status == ref.status == "Optimal",
          f"{what}: {sol.status}, single {ref.status}")
    # f32 factors round differently on the two paths: Iter within 2, as in
    # the [f32] phase, and y to F32_Y_TOL of the f64 TP solve below
    check(abs(sol.Iter - ref.Iter) <= (2 if f32 else 0),
          f"{what}: Iter {sol.Iter}, single {ref.Iter}")
    check(f32 or dy <= 1e-6, f"{what}: |y - y_single| {dy:.3e}")
    check(resid < 1e-6, f"{what}: residual {resid:.3e}")
    extra = {}
    if cpu:
        cref = conic_ip(*P.args(), device="cpu", **single_kw)
        check(cref.Iter == sol.Iter and cref.status == sol.status,
              f"{what}: cpu {cref.status}/{cref.Iter}")
        extra["cpu_iter"] = cref.Iter
    base = label.split(" ")[0]
    if base != label:  # a variant of the default keywords, solved before
        dd = (sol.y - one[base]["y"].to(sol.y.device)).abs().max().item()
        tol = (1e-8 if kkt_kw.get("shard_scaling") is False
               else F32_Y_TOL if f32 else 1e-6)
        check(dd <= tol, f"{what}: |y - y_default| {dd:.3e}")
        extra["y_diff_default"] = f"{dd:.3e}"
    ok, by_order = tp_launches_ok(P, got, builds, 1, kkt_kw)
    check(ok, f"{what}: launches {dict(got)} for {builds} KKT builds")
    line("distributed", world=1, backend="nccl", case=repr(label),
         status=sol.status, Iter=sol.Iter, single_iter=ref.Iter, **extra,
         resid=f"{resid:.3e}", y_diff_single=f"{dy:.3e}", kkt_builds=builds,
         launches=by_order, ms_per_solve=f"{ms:.2f}",
         single_ms_per_solve=f"{ref_ms:.2f}")
    return dict(status=sol.status, Iter=sol.Iter, y=sol.y.cpu(), ms=ms,
                single_ms=ref_ms)


def pair_of_ranks(one):
    """(b): two ranks on the one card, each this script with
    --distributed-rank, held against the world of one's answers."""
    from conicip_tpu_torch.parallel.mesh import spawn_world

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        world = spawn_world(
            lambda k, init: [sys.executable, os.path.abspath(__file__),
                             "--distributed-rank", str(k), "--init", init,
                             "--out", out], DIST_RANKS, DIST_TIMEOUT, env=env)
        seconds = time.perf_counter() - t
        check(world.ok, f"ranks exited {world.codes} (timed out "
              f"{world.timed_out}):\n" + "\n".join(world.err))
        got = [torch.load(os.path.join(out, f"rank{k}.pt"))
               for k in range(DIST_RANKS)]
    ranks = Counter()
    for k, text in enumerate(world.out):
        rec = json.loads(next(s for s in text.splitlines()
                              if s.startswith('{"rank_launches"')))
        for dt, n, B, count in rec["rank_launches"]:
            key = (getattr(torch, dt), n) + ((B,) if B else ())
            ranks[key] += count
        line("distributed", world=DIST_RANKS, rank=k,
             launches=",".join(f"{dt}@{n}" + (f"x{B}" if B else "")
                               + f":{c}" for dt, n, B, c in
                               rec["rank_launches"]))
    for label, _ in pair_cases():
        a, b = got[0][label], got[1][label]
        ref = one[label]
        dy = (a["y"] - ref["y"]).abs().max().item()
        what = f"{DIST_RANKS} ranks, {label}"
        check(torch.equal(a["y"], b["y"]) and a["Iter"] == b["Iter"],
              f"{what}: the ranks' answers differ")
        check(a["status"] == "Optimal" and a["Iter"] == ref["Iter"],
              f"{what}: {a['status']}/{a['Iter']}, world of one "
              f"{ref['status']}/{ref['Iter']}")
        check(dy <= 1e-8, f"{what}: |y - y_world_of_one| {dy:.3e}")
        check(a["launches_ok"] and b["launches_ok"],
              f"{what}: launches {a['launches']} / {b['launches']} for "
              f"{a['builds']} KKT builds")
        line("distributed", world=DIST_RANKS, backend="gloo",
             device="cuda:0 shared", case=repr(label), status=a["status"],
             Iter=a["Iter"], world_of_one_iter=ref["Iter"],
             y_diff_world_of_one=f"{dy:.3e}", ranks_y="bitwise equal",
             kkt_builds=a["builds"], launches_per_rank=a["launches"],
             ms_per_solve=f"{a['ms']:.2f}",
             world_of_one_ms=f"{ref['ms']:.2f}",
             single_ms_per_solve=f"{ref['single_ms']:.2f}")
    a, b = got[0]["batch"], got[1]["batch"]
    ref = one["batch"]
    check(torch.equal(a["status"], ref["status"])
          and torch.equal(a["Iter"], ref["Iter"])
          and torch.equal(a["y"], b["y"]),
          f"{DIST_RANKS} ranks, solve_batch: statuses or Iter differ from "
          "the unsharded stack's, or the ranks' answers differ")
    line("distributed", world=DIST_RANKS, backend="gloo",
         case=f"'solve_batch batched_box_qp({BATCH},n=500)'",
         mesh=f"({DIST_RANKS},) batch", per_rank=BATCH // DIST_RANKS,
         status=f"Optimal x{BATCH}", Iter="equal to unsharded",
         ms_per_batch=f"{a['ms']:.2f}", unsharded_ms=f"{ref['ms']:.2f}")
    line("distributed", world=DIST_RANKS, backend="gloo",
         collectives="all_reduce,reduce_scatter,all_gather,broadcast",
         on="CUDA tensors", staged="none", world_seconds=f"{seconds:.1f}")
    return ranks


def distributed_rank(rank, init, out):
    """One of the two ranks of [distributed] (b): both on the one card,
    gloo. Saves its answers to ``out/rank<k>.pt`` and prints its kernel
    launches as a JSON line."""
    import torch.distributed as dist

    from conicip_tpu_torch import make_mesh, models
    from conicip_tpu_torch.ops import cholesky_kernel
    from conicip_tpu_torch.parallel.mesh import start_rank

    start_rank(rank, DIST_RANKS, init, "cuda")
    res = {}
    try:
        check(dist.get_backend() == "gloo", "ranks sharing a card: not gloo")
        tp = make_mesh((DIST_RANKS,), ("tp",))
        for label, P in pair_cases():
            tp_solve(P, tp, {})  # warm-up
            sol, ms, builds, got = tp_solve(P, tp, {})
            ok, by_order = tp_launches_ok(P, got, builds, DIST_RANKS, {})
            res[label] = dict(status=sol.status, Iter=sol.Iter,
                              y=sol.y.cpu(), ms=ms, builds=builds,
                              launches=by_order, launches_ok=ok)
        args = on_card(models.batched_box_qp(BATCH, n=500))
        bmesh = make_mesh((DIST_RANKS,), ("batch",))
        timed_batch(args, mesh=bmesh)  # warm-up
        bs, ms = timed_batch(args, mesh=bmesh)
        res["batch"] = dict(status=bs.status.cpu(), Iter=bs.Iter.cpu(),
                            y=bs.y.cpu(), ms=ms)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    print(json.dumps({"rank_launches": [
        [str(k[0]).split(".")[-1], k[1], k[2] if len(k) == 3 else None, c]
        for k, c in sorted(cholesky_kernel.cholesky_launches.items(),
                           key=str)]}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if "--distributed-rank" in sys.argv:
        import argparse

        parser = argparse.ArgumentParser()
        parser.add_argument("--distributed-rank", type=int, required=True)
        parser.add_argument("--init", required=True)
        parser.add_argument("--out", required=True)
        a = parser.parse_args()
        distributed_rank(a.distributed_rank, a.init, a.out)
        return 0
    phase_environment()
    phase_build()
    single, batched64, batched32 = phase_kernel()

    from conicip_tpu_torch.ops import cholesky_kernel

    # each path of the main run is driven with the count at 0 and read
    # just after; the comparison launches of phase_kernel do not count
    f32, f64 = torch.float32, torch.float64
    single.update(launches=0, launches_f64=0, launches_f32=0)
    batched64["launches"] = batched32["launches"] = 0
    launched = set()  # the counter's keys: every shape a path gave an entry
    for phase in (phase_schur, phase_diag, phase_conic, phase_f32, phase_eq,
                  phase_backends, phase_batch, phase_checkpoint,
                  phase_frontend, phase_ladder, phase_distributed):
        cholesky_kernel.reset_launch_count()
        # launches of the ranks a phase spawned, counted by their wrappers
        ranks = phase() or Counter()
        counts = cholesky_kernel.cholesky_launches + ranks
        used = sum(counts.values())
        used32 = sum(c for k, c in counts.items() if k[0] == f32)
        stacked = {dt: sum(c for k, c in counts.items()
                           if k[0] == dt and len(k) == 3)
                   for dt in (f32, f64)}
        check(used > 0, f"{phase.__name__} never launched the kernel")
        check((used32 > 0) == (phase in (phase_f32, phase_batch,
                                         phase_ladder, phase_distributed)),
              f"{phase.__name__}: {used32} launches of the f32 entries")
        # the stacked solves run the batched entries, and nothing else does
        check((sum(stacked.values()) > 0)
              == (phase in (phase_batch, phase_checkpoint, phase_ladder,
                            phase_distributed)),
              f"{phase.__name__}: {stacked} launches of the batched entries")
        line("launches", of=phase.__name__, f64=used - used32, f32=used32,
             batched_f64=stacked[f64], batched_f32=stacked[f32])
        single["launches"] += used - sum(stacked.values())
        single["launches_f64"] += used - used32 - stacked[f64]
        single["launches_f32"] += used32 - stacked[f32]
        batched64["launches"] += stacked[f64]
        batched32["launches"] += stacked[f32]
        launched |= set(counts)
    for rec in (single, batched64, batched32):
        check(rec["launches"] > 0, f"{rec['name']} was never launched on "
              "the main paths")
    # a shape the paths gave the kernel that the kernel phase did not
    # foresee (a rescue tier's sub-batch) is held against the plain version
    # now, after the counts were read (untraced: after this much work the
    # tracer returns no events)
    for dt, n, *B in sorted(launched - set(HELD), key=str):
        if B:
            hold_batched(B[0], n, dt, True, traced=False)
        else:
            hold_single(n, dt, True)
    for rec, dt, batched in ((single, f64, False), (batched64, f64, True),
                             (batched32, f32, True)):
        rec["max_abs_err"] = max(err for key, err in HELD.items() if
                                 key[0] == dt and (len(key) == 3) == batched)

    print(json.dumps({"kernels": [single, batched64, batched32]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
