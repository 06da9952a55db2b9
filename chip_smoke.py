"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from this checkout, holds it against its
plain PyTorch version, then drives ``conicip_tpu_torch.conic_ip`` through
every default KKT backend (dense Schur, diagonal, spectral) on R, Q and S
cone problems at the sizes the repository benchmarks, and checks the
answers. Every phase prints one line per case; any failed check raises, so
the script exits non-zero. It imports nothing of JAX.

The second-to-last line is a JSON object describing each kernel of the
path; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# orders held against the plain version besides those the main path factors
# (factor_sizes): one panel, its edges, partial last panels, the timed sizes
SIZES = (1, 31, 127, 128, 129, 257, 500, 1000, 1024, 1280, 2048, 4096)
SCHUR_N = (1024, 4096)  # box_qp_dense orders of the [schur] phase
TIMED = (128, 1024, 2048, 4096)
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# ill-conditioned SPD per dtype: condition number, and the bound on
# |LL' - M| / |M| (rounding of a backward-stable factor at n = 500)
ILL = {torch.float64: (1e12, 1e-13), torch.float32: (1e5, 1e-5)}


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


def cuda_launches(fn):
    """Kernels run on the card by one call of fn, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_kernel():
    """The kernel against its plain version; returns its JSON record."""
    from conicip_tpu_torch.ops.cholesky_kernel import (PANEL, cholesky_factor,
                                                       cholesky_plain)

    worst = {torch.float64: 0.0, torch.float32: 0.0}
    on_path = factor_sizes()
    for n in sorted(set(SIZES) | on_path):
        M64 = spd(n, seed=n)
        for dt in (torch.float64, torch.float32):
            M = M64.to(dt)
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
            worst[dt] = max(worst[dt], err)
            line("kernel", n=n, dtype=str(dt).split(".")[-1],
                 max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
                 recon_rel=f"{rec:.3e}", indefinite="non-finite",
                 main_path=n in on_path)
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
            per_factor = cuda_launches(lambda: cholesky_factor(M))
            check(per_factor <= budget,
                  f"n={n} {dt}: {per_factor} CUDA launches per factor, "
                  f"budget {budget}")
            times[(n, dt)] = (ms, plain)
            line("kernel_time", n=n, dtype=str(dt).split(".")[-1],
                 kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                 ratio=f"{ms / plain:.3f}", launches_per_factor=per_factor,
                 launch_budget=budget, reps=reps)
    ms, plain = times[(1024, torch.float64)]
    return {"name": "cholesky", "route": "cuda",
            "source": "conicip_tpu_torch/csrc/cholesky.cu",
            "replaces": "conicip_tpu/ops/pallas_cholesky.py:41",
            "max_abs_err": worst[torch.float64], "ms": ms, "plain_ms": plain}


def solve_timed(args, **kw):
    from conicip_tpu_torch import conic_ip

    torch.cuda.synchronize()
    t = time.perf_counter()
    sol = conic_ip(*args, **kw)
    torch.cuda.synchronize()
    return sol, (time.perf_counter() - t) * 1e3


def launches():
    from conicip_tpu_torch.ops import cholesky_kernel

    return cholesky_kernel.cholesky_launches


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    phase_environment()
    phase_build()
    record = phase_kernel()

    from conicip_tpu_torch.ops import cholesky_kernel

    # each path of the main run is driven with the count at 0 and read
    # just after; the comparison launches of phase_kernel do not count
    record["launches"] = 0
    for phase in (phase_schur, phase_diag, phase_conic):
        cholesky_kernel.cholesky_launches = 0
        phase()
        used = cholesky_kernel.cholesky_launches
        check(used > 0, f"{phase.__name__} never launched the kernel")
        record["launches"] += used

    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
