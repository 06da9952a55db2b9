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
``[checkpoint]`` an interrupted and resumed ``solve_batch_resumable``. Every
phase prints one line per case; any failed check raises, so the script
exits non-zero. It imports nothing of JAX.

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
    entries: every order of every backend of batch_cases, and the planted
    and checkpointed stacks, at 64 instances; and the f32 cases' orders at
    one instance, where the phase solves a rescued instance alone."""
    shapes = {(BATCH, PLANTED_N)}
    for _, _, kw, _, by_backend in batch_cases():
        for sizes in by_backend.values():
            shapes.update((B, n) for n in sizes
                          for B in ((BATCH, 1) if kw else (BATCH,)))
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
                  phase_backends, phase_batch, phase_checkpoint):
        cholesky_kernel.reset_launch_count()
        phase()
        used = cholesky_kernel.launch_count()
        used32 = cholesky_kernel.launch_count(f32)
        stacked = {dt: cholesky_kernel.launch_count(dt, batch=True)
                   for dt in (f32, f64)}
        check(used > 0, f"{phase.__name__} never launched the kernel")
        check((used32 > 0) == (phase in (phase_f32, phase_batch)),
              f"{phase.__name__}: {used32} launches of the f32 entries")
        # the stacked solves run the batched entries, and nothing else does
        check((sum(stacked.values()) > 0)
              == (phase in (phase_batch, phase_checkpoint)),
              f"{phase.__name__}: {stacked} launches of the batched entries")
        line("launches", of=phase.__name__, f64=used - used32, f32=used32,
             batched_f64=stacked[f64], batched_f32=stacked[f32])
        single["launches"] += used - sum(stacked.values())
        single["launches_f64"] += used - used32 - stacked[f64]
        single["launches_f32"] += used32 - stacked[f32]
        batched64["launches"] += stacked[f64]
        batched32["launches"] += stacked[f32]
        launched |= set(cholesky_kernel.cholesky_launches)
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
