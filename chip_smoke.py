"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one nvcc per source,
all at once), holds the Cholesky kernel against its plain PyTorch version,
then in ``[inverse]`` the inverse of a lower factor (``tri_inverse``, the
same source: single and batched, f64 and f32) against its plain version,
also on the factors of ill-conditioned matrices, and times it beside the library's triangular solve against the identity,
then in ``[jacobi]`` the Jacobi eigendecomposition and SVD kernels
(``csrc/jacobi.cu``: eigh, values-only eigh, SVD; f64 and f32) against
theirs at every (d, stack) the S-cone phases hand them (``jacobi_shapes()``)
and at edge shapes (d = 1-64, d = 128 and 200 on the device-memory route, a
stack of 200, the identity, a clustered spectrum, an indefinite matrix, an
ill-conditioned Lzᵀ Ls, NaN and Inf entries, the sweep limit, the block
kernels' on-chip / device-memory edges 119/120 and 169/170), and times
them beside cuSOLVER on random stacks (above d = 32 too: (1, 64) to (1,
200), with the sweeps they take and the block kernels' launch plans) and
on the first stack of each kind that one larger_sdp(k=30) solve and one
batched_small_sdp(64) solve hand them; ``[rcone]`` holds every entry of the R cones' kernels
(``csrc/rcone.cu``: the NT scaling, the 4x4 reduction, the
complementarity vectors, the step; f64 and f32) against its plain twin
(``ops/rcone.py``) at the widths the R-only solves hand them and at edge
inputs, prints each entry's launch plan (grid, cluster, vector path),
and times each inside a captured CUDA graph beside the twin, its bound and
the launch floor (an empty kernel launched by the same plan), and times
the device loop's conditional node (``csrc/graph_cond.cu``); then it
drives ``conicip_tpu_torch.conic_ip`` through
every default KKT backend (dense Schur, diagonal, spectral) on R, Q and S
cone problems at the sizes the repository benchmarks, and checks the
answers; ``[graph]`` holds each of those solves, and the f32 solves of
``[f32]``, on the device loop (CUDA graphs kept across calls,
``solver/graph.py``) against the eager loop on the same arguments and
against the CPU, bit for bit, with its KKT builds per precision, steps on
each variant, mixed-residual recomputes, refinement trips (each
``lax.cond`` of the reference a conditional graph node,
``csrc/graph_cond.cu``), kernel launches by entry and dtype, host reads,
replays and device-to-host copies, after the kernel phase has held the
Cholesky kernel's predicated entries, f64 and f32 (the ridge retries),
against their plain form; ``[graph_cache]`` solves chains of six
instances of one shape, f64 and f32, on the device loop's cache (one
capture, hits equal to solves after ``graph.clear()`` bit for bit, flat
reserved memory, an evicted entry's pools freed) and times hits, misses
and the eager loop.
``[sdp_large]`` solves S cones above order 32 on the device loop, the
block Jacobi kernels' path: conic_ip on instance 0 of
batched_small_sdp(1, k=100) (n = 5050, spectral) and solve_batch on
batched_small_sdp(32, k=64) (n = 2080), a miss and hits each, held to the
CPU's status, Iter, KKT builds and trips (the stack through a sample of
its instances, solved as a stack of their own on the CPU and on the
card), with the Jacobi launches of a solve by (kind, dtype, d, stack) and
the sweeps each launch took.
Three further phases drive the options around the default path:
``[f32]`` the f32-factor solves (the kernel's f32 entry, the last-mile
switch to f64 factors), ``[eq]`` null-space elimination of equalities and
the rank-repairing preprocessor, ``[backends]`` the qr, lu and low-rank KKT
solvers. ``[custom_kkt]`` drives a caller's own kktsolver on the device
loop (``examples/torch/custom_kkt.py``'s box solver at n=1000, a dense
Schur solver on the port's ``ops.cholesky`` at n=1024: a miss, then hits
held to the eager loop bit for bit and to the CPU), the same solver
reading the device (found before any capture, kept on the eager loop),
and ``verbose=True`` printing the eager loop's text. ``[batch]`` drives
``solve_batch`` on stacks of 64 instances of the four batched families (every dense factor one launch of the kernel's
batched entry, sampled instances held against their single solves; every
run the solver chooses, f32 included, on the device loop, a cache hit),
``[batch_graph]`` holds each stack, f64 and f32, on the device loop
against the eager loop on the same operands and against the CPU as
``[graph]`` holds the single solves, with its reads, builds, trips, times
and the memory its cache entry holds, and a stack split across the two
variants of the f32 last-mile generator, and ``[checkpoint]`` an
interrupted and resumed
``solve_batch_resumable`` whose resumed chunks hit the device loop's
cache.
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
stack split between them. Every phase that solves an S cone must launch the
Jacobi kernels and no other phase may (their counter,
``ops.jacobi_kernel.jacobi_launches``, keyed by (kind, dtype, d, stack), is
read per phase like the Cholesky's, and ``[jacobi_launches]`` prints the
main path's launches per key); ``[diag]``, ``[graph]``, ``[graph_cache]``
and ``[batch]`` check that their R-only solves launch every entry of the
R cones' kernels (the Gondzio trial where a corrector runs) and the other
solves none, and each phase's ``[launches]`` line counts them. Every
phase prints one line per case;
any failed check raises, so the script exits non-zero. It imports nothing
of JAX.

The second-to-last line is a JSON object describing each kernel entry of
the path; the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --phase NAME [--package DIR]

runs the environment, the build and the one phase ``phase_NAME`` alone,
and prints its ``[phase_time]``: no kernels line and no final line. With
``--package`` the package is the one in DIR, another checkout (for
example the parent commit's, unpacked by ``git archive``), so that two
trees' runs of one phase compare in one call on one card.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict

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
# (status, Iter) of the port's own CPU solves, by case, as the [schur] and
# [conic] phases hold them; [graph] holds its solves to them again
CPU_REF = {}
# orders (n, n) and stacks (B, n, n) the predicated entries are held at,
# by dtype: the f32 ones are the ridge retries of the f32 Schur builds,
# which run inside the device loop's conditional graph nodes
PREDICATED_SHAPES = {
    torch.float64: ((128, 128), (1024, 1024), (4096, 4096), (64, 500, 500)),
    torch.float32: ((128, 128), (1024, 1024), (64, 500, 500)),
}


def cholesky_bound_ms(n, dtype, batch=1):
    """Least time the card could take for ``batch`` order-n factors: n^3/3
    operations each at the peak rate of the dtype against every matrix read
    once and every factor written once at the memory rate. Returns (ms,
    which)."""
    ops = batch * (n ** 3 / 3.0) / PEAK_FLOPS[dtype]
    moved = batch * 2.0 * n * n * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(ops, moved) * 1e3, "operations" if ops >= moved else "bytes"


def inverse_bound_ms(n, dtype, batch=1):
    """Least time the card could take for ``batch`` inverses of order-n
    lower factors: n^3/3 operations each at the peak rate of the dtype
    against the factor's lower triangle read once and the inverse written
    once (1.5 n^2 elements) at the memory rate. Returns (ms, which)."""
    ops = batch * (n ** 3 / 3.0) / PEAK_FLOPS[dtype]
    moved = batch * 1.5 * n * n * torch.finfo(dtype).bits / 8 / PEAK_BYTES
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


# csrc/<name>.cu: the kernels, and the device loop's conditional node
KERNEL_SOURCES = ("cholesky", "jacobi", "rcone", "graph_cond")


def phase_build():
    """Every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from conicip_tpu_torch.ops.build import load_library

    def timed(name):
        t = time.perf_counter()
        load_library(name)
        return time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        took = dict(zip(KERNEL_SOURCES, pool.map(timed, KERNEL_SOURCES)))
    for name, seconds in took.items():
        line("build", kernel=f"csrc/{name}.cu", seconds=f"{seconds:.2f}")
    line("build", all_seconds=f"{time.perf_counter() - t:.2f}")


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
    hold_predicated()
    return [record] + phase_kernel_batched()


def hold_predicated():
    """The predicated entries, f64 and f32 (the Schur solver's ridge
    retries), against the plain version's predicated form: every flag set
    (``out`` kept bit for bit), none set, and on the stack every other
    one, within TOL of the dtype where a matrix is factored; then, at n = 4096,
    what a skipped factor costs (its launches return at once) beside a
    full one, issued eagerly and replayed from a CUDA graph, and whether
    the graph kept the factor's programmatic dependent launches."""
    from conicip_tpu_torch.ops.cholesky_kernel import (
        PANEL, cholesky_factor, cholesky_plain, graph_edges)

    for dt, shape in ((dt, shape) for dt, shapes in PREDICATED_SHAPES.items()
                      for shape in shapes):
        n = shape[-1]
        stack = shape[:-2]
        make = (lambda seed: spd_stack(stack[0], n, seed)) if stack else (
            lambda seed: spd(n, seed))
        M = make(1).to(dt)
        prev = cholesky_factor(make(2).to(dt))  # what a skipped matrix keeps
        flag_sets = {"set": torch.ones(stack, dtype=torch.bool),
                     "unset": torch.zeros(stack, dtype=torch.bool)}
        if stack:
            flag_sets["alternate"] = torch.arange(stack[0]) % 2 == 0
        for what, flags in flag_sets.items():
            flags = flags.cuda()
            L = cholesky_factor(M, skip=flags, out=prev.clone())
            Lp = cholesky_plain(M, skip=flags, out=prev.clone())
            torch.cuda.synchronize()
            err = (L - Lp).abs().max().item()
            rel = err / Lp.abs().max().item()
            kept = bool(torch.equal(L[flags], prev[flags])
                        and torch.equal(Lp[flags], prev[flags]))
            check(rel <= TOL[dt] and kept,
                  f"predicated {shape} {dt} flags {what}: |L-L_plain| rel "
                  f"{rel:.3e}, flagged kept bit for bit: {kept}")
            line("kernel_predicated", shape=str(shape).replace(" ", ""),
                 dtype=dtname(dt), flags=what, max_abs_err=f"{err:.3e}",
                 rel_err=f"{rel:.3e}", flagged="kept bitwise")
    n = 4096
    M = spd(n, seed=3)
    L = cholesky_factor(M)
    skip = torch.ones((), dtype=torch.bool, device="cuda")
    reps = 20
    full = cuda_ms(lambda: cholesky_factor(M), reps)
    skipped = cuda_ms(lambda: cholesky_factor(M, skip=skip, out=L), reps)
    per = launches_of_order(n)
    traced = cuda_launches(lambda: cholesky_factor(M, skip=skip, out=L), per)
    check(traced == per, f"a skipped factor ran {traced} CUDA launches, "
          f"{per} expected")
    # the same two captured in CUDA graphs, as the device loop runs them
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graphs = {}
    with torch.cuda.stream(stream):
        for name, fn in (("full", lambda: cholesky_factor(M)),
                         ("skipped", lambda: cholesky_factor(
                             M, skip=skip, out=L))):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            g.capture_begin()
            out = fn()
            g.capture_end()
            graphs[name] = (g, out)
        edges, programmatic = graph_edges(graphs["full"][0])
        for g, _ in graphs.values():
            g.instantiate()
    torch.cuda.current_stream().wait_stream(stream)
    want = -(-n // PANEL) - 1  # one per panel: the next diagonal block's
    check(programmatic == want, f"the captured factor kept {programmatic} "
          f"programmatic edges of {edges}, {want} expected")
    g_full = cuda_ms(graphs["full"][0].replay, reps)
    g_skipped = cuda_ms(graphs["skipped"][0].replay, reps)
    check(torch.equal(graphs["full"][1], cholesky_factor(M)),
          "the factor replayed from a graph differs from the eager one")
    line("kernel_predicated_time", n=n, launches_per_factor=per,
         factor_ms=f"{full:.4f}", skipped_ms=f"{skipped:.4f}",
         graph_factor_ms=f"{g_full:.4f}", graph_skipped_ms=f"{g_skipped:.4f}",
         per_kkt_build_ms=f"{2 * g_skipped:.4f}",
         programmatic_edges=f"{programmatic}/{edges}", reps=reps)


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
    # the predicated entries on the same stacks, as the device loop's ridge
    # retries run them: every flag unset (each matrix factored: a full
    # factor's work) and every flag set (a retry that no matrix needs)
    for (B, n), dt in ((shape, dt) for shape in BATCH_TIMED
                       for dt in (torch.float64, torch.float32)):
        M = spd_stack(B, n, seed=n).to(dt)
        out = torch.empty_like(M)
        unset = torch.zeros(B, dtype=torch.bool, device="cuda")
        every = torch.ones(B, dtype=torch.bool, device="cuda")
        reps = 20
        ms = cuda_ms(lambda: cholesky_factor(M, skip=unset, out=out), reps)
        skipped = cuda_ms(lambda: cholesky_factor(M, skip=every, out=out),
                          reps)
        plain = cuda_ms(lambda: cholesky_plain(M, skip=unset, out=out), reps)
        library = cuda_ms(lambda: torch.linalg.cholesky_ex(M), reps)
        bound, bound_by = cholesky_bound_ms(n, dt, B)
        line("kernel_predicated_time", B=B, n=n, dtype=dtname(dt),
             kernel_ms=f"{ms:.4f}", skipped_ms=f"{skipped:.4f}",
             plain_ms=f"{plain:.4f}", library_ms=f"{library:.4f}",
             bound_ms=f"{bound:.5f}", bound_by=bound_by,
             bound_share=f"{bound / ms:.4f}", ratio=f"{ms / plain:.3f}",
             reps=reps)
    return [records[torch.float64], records[torch.float32]]


# ── the inverse of a lower factor (csrc/cholesky.cu tri_inverse) ───────
# (stack, order) held against the plain version: one launch (n <= 128),
# its edges, ragged last block rows, the box cells' and the sdp stack's
# Schur orders, a stack of more matrices than SMs
INVERSE_HELD = ((1, 1), (1, 31), (1, 128), (1, 129), (1, 257), (1, 500),
                (1, 1000), (1, 1280), (7, 129), (64, 500), (64, 465),
                (200, 129))
# (stack, order) of the ill-conditioned factors held (ILL)
INVERSE_ILL = ((1, 500), (64, 500))
# (stack, order) timed: the box single's (1, 500), the box stack's (64,
# 500), the sdp stack's Schur order (64, 465), and single 1024 and 4096
INVERSE_TIMED = ((1, 500), (64, 500), (64, 465), (1, 1024), (1, 4096))


def inverse_launches_of_order(n):
    """CUDA launches of one inverse of order n, whatever the stack: the
    diagonal blocks'; above one panel the block rows' products, then one
    step per block row below the first."""
    from conicip_tpu_torch.ops.cholesky_kernel import PANEL

    return 1 if n <= PANEL else -(-n // PANEL) + 1


def inverse_input(B, n, dt):
    """The factors of a random SPD stack (B, n, n), or of one (n, n)."""
    from conicip_tpu_torch.ops.cholesky_kernel import cholesky_factor

    M = spd(n, seed=n) if B == 1 else spd_stack(B, n, seed=B + n)
    return cholesky_factor(M.to(dt).contiguous())


def kernel_names(fn):
    """Names of the kernels one call of ``fn`` ran on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def inverse_residual(L, X):
    """max |XL - I| relative to max |X| max |L|."""
    eye = torch.eye(L.shape[-1], device=L.device, dtype=L.dtype)
    return ((X @ L - eye).abs().max()
            / (X.abs().max() * L.abs().max())).item()


def hold_inverse(L, X, what):
    """The kernel's inverse X of L against the plain version, and by its
    residual, both to TOL; returns max |X - X_plain|, that relative to
    max |X_plain|, and the kernel's and the plain version's residuals."""
    from conicip_tpu_torch.ops.cholesky_kernel import tri_inverse_plain

    Xp = tri_inverse_plain(L)
    err = (X - Xp).abs().max().item()
    rel = err / Xp.abs().max().item()
    res = inverse_residual(L, X)
    check(rel <= TOL[L.dtype], f"{what}: |X-X_plain| rel {rel:.3e}")
    check(res <= TOL[L.dtype], f"{what}: |XL-I| rel {res:.3e}")
    return err, rel, res, inverse_residual(L, Xp)


def phase_inverse():
    """The inverse entries (single and batched, f64 and f32) against the
    plain version (the triangular solve against the identity), then their
    times beside the bound, the plain version and the library's solve, by
    CUDA events around eager calls and inside a captured graph (bound share
    and ratio of the latter); returns the JSON records of the single and
    the batched f64 entries."""
    from conicip_tpu_torch.ops.cholesky_kernel import (cholesky_factor,
                                                       inverse_launches,
                                                       tri_inverse,
                                                       tri_inverse_plain)

    for (B, n), dt in ((shape, dt) for shape in INVERSE_HELD
                       for dt in (torch.float64, torch.float32)):
        L = inverse_input(B, n, dt)
        key = (dt, n) if B == 1 else (dt, n, B)
        before = inverse_launches[key]
        X = tri_inverse(L)
        check(inverse_launches[key] == before + 1,
              f"inverse {key}: not counted once")
        what = f"inverse ({B}, {n}) {dtname(dt)}"
        err, rel, res, _ = hold_inverse(L, X, what)
        check(bool(torch.equal(X.triu(1), torch.zeros_like(X))),
              f"{what}: strict upper triangle not zero")
        bad = L.clone()
        bad.view(-1, n, n)[B // 2, n // 2:, n // 2] = float("nan")
        Xb = tri_inverse(bad).view(-1, n, n)
        check(not bool(torch.isfinite(Xb[B // 2]).all()),
              f"{what}: a NaN factor gave a finite inverse")
        if B > 1:
            keep = [i for i in range(B) if i != B // 2]
            check(bool(torch.equal(Xb[keep], X[keep])),
                  f"{what}: a NaN factor touched its neighbours")
            check(bool(torch.equal(
                X[B // 2], tri_inverse(L[B // 2].contiguous()))),
                f"{what}: instance {B // 2} differs from the single entry")
        line("inverse", B=B, n=n, dtype=dtname(dt), max_abs_err=f"{err:.3e}",
             rel_err=f"{rel:.3e}", residual_rel=f"{res:.3e}",
             nan_factor="non-finite", upper="zero")
    # the factors of ill-conditioned matrices (ILL's condition numbers, the
    # regime of the f32 Schur last mile), one and a stack
    for (B, n), (dt, (kappa, _)) in ((shape, ill) for shape in INVERSE_ILL
                                     for ill in ILL.items()):
        M = (ill_conditioned(n, kappa, seed=5) if B == 1 else torch.stack(
            [ill_conditioned(n, kappa, seed=5 + i) for i in range(B)]))
        L = cholesky_factor(M.to(dt).contiguous())
        what = f"inverse ({B}, {n}) {dtname(dt)} kappa {kappa:.0e}"
        X = tri_inverse(L)
        check(bool(torch.isfinite(X).all()), f"{what}: not finite")
        err, rel, res, res_plain = hold_inverse(L, X, what)
        line("inverse_ill", B=B, n=n, dtype=dtname(dt), kappa=f"{kappa:.0e}",
             max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
             residual_rel=f"{res:.3e}", plain_residual_rel=f"{res_plain:.3e}")
    records = {}
    for (B, n), dt in ((shape, dt) for shape in INVERSE_TIMED
                       for dt in (torch.float64, torch.float32)):
        L = inverse_input(B, n, dt)
        eye = torch.eye(n, device="cuda", dtype=dt)
        ms, reps = budget_ms(lambda: tri_inverse(L))
        plain = cuda_ms(lambda: tri_inverse_plain(L), reps)
        # the library's solve against the identity, what tri_inv ran
        # before the kernel: a yardstick only, the port never calls it on
        # the card
        library = cuda_ms(
            lambda: torch.linalg.solve_triangular(L, eye, upper=False), reps)
        # as the main path runs both: inside a captured CUDA graph, no host
        # launch between them
        in_graph = graph_ms(lambda: tri_inverse(L))
        library_graph = graph_ms(
            lambda: torch.linalg.solve_triangular(L, eye, upper=False))
        bound, bound_by = inverse_bound_ms(n, dt, B)
        per_call = cuda_launches(lambda: tri_inverse(L),
                                 inverse_launches_of_order(n))
        check(per_call == inverse_launches_of_order(n),
              f"inverse ({B}, {n}) {dtname(dt)}: {per_call} CUDA launches, "
              f"{inverse_launches_of_order(n)} expected")
        names = kernel_names(lambda: tri_inverse(L))
        check(not any("trsm" in k.lower() for k in names),
              f"inverse ({B}, {n}): a library trsm ran: {names}")
        line("kernel_time", kernel="tri_inverse", B=B, n=n, dtype=dtname(dt),
             kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
             library_ms=f"{library:.4f}", graph_ms=f"{in_graph:.4f}",
             library_graph_ms=f"{library_graph:.4f}",
             bound_ms=f"{bound:.5f}", bound_by=bound_by,
             bound_share=f"{bound / in_graph:.4f}",
             ratio_library=f"{in_graph / library_graph:.3f}",
             launches=per_call, reps=reps)
        if dt == torch.float64 and (B, n) in ((1, 500), (64, 500)):
            records[B > 1] = {
                "name": "tri_inverse_batched" if B > 1 else "tri_inverse",
                "route": "cuda",
                "source": "conicip_tpu_torch/csrc/cholesky.cu",
                "replaces": "conicip_tpu/ops/cholesky.py:tri_inv (XLA's "
                            "triangular solve; no Pallas kernel)",
                "shape": f"({B}, {n}, {n}) float64" if B > 1
                         else f"({n}, {n}) float64",
                "ms": ms, "graph_ms": in_graph, "plain_ms": plain,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": library, "library_graph_ms": library_graph}
    return records[False], records[True]


# ── the Jacobi kernels (csrc/jacobi.cu) ─────────────────────────────────
JACOBI_KINDS = ("eigh", "eigvalsh", "svd")
# orders held besides those the paths hand the kernels (jacobi_shapes):
# the smallest, a warp's edges, two warps; and orders whose matrices exceed
# a block's shared memory (128: eigh; 200: every kind)
JACOBI_EDGE_D = (1, 2, 3, 31, 32, 33, 64)
JACOBI_GLOBAL_D = (128, 200)
# the block kernels' on-chip / device-memory edges (ops/jacobi_kernel.py
# launch_plan): eigh 119 / 120, values only and the SVD 169 / 170
JACOBI_PLAN_EDGE_D = (119, 120, 169, 170)
# the largest order the one-warp kernels take (csrc/jacobi.cu WARP_MAX_D):
# above it the block kernels, which the kernels line lists apart
JACOBI_WARP_MAX_D = 32
JACOBI_BIG_STACK = 200  # more matrices than SMs
# (stack, d) timed: the stacks of 64 at d = 10 and 5, larger_sdp's one
# matrix at 30, the step eigenvalues of two stacked directions at 10, the
# [ladder] stack at 20
JACOBI_TIMED = ((64, 10), (64, 5), (1, 30), (128, 10), (64, 20))
# the shape of each kind's JSON record: the [batch] stacks' (the values-only
# kind: their stacked step eigenvalues)
JACOBI_RECORD = {"eigh": (64, 10), "eigvalsh": (128, 10), "svd": (64, 10)}
# (stack, d) timed above a warp's orders, each kind in f64 and f32: a single
# d = 64, the [sdp_large] single's matrix (d = 100) and its step's two
# stacked directions, the [sdp_large] stack's scaling (32 at d = 64) and
# its step's stacked pair (64), and the device-memory route at 128 and 200
JACOBI_TIMED_LARGE = ((1, 64), (1, 100), (2, 100), (32, 64), (64, 64),
                      (1, 128), (1, 200))
# the block kernels' JSON records: the shape, and the kinds and dtypes the
# paths launch above d = 32 (the step's stacked eigenvalues in f32)
JACOBI_BLOCK_RECORD = (1, 100)
JACOBI_BLOCK_KINDS = (("eigh", torch.float64), ("eigvalsh", torch.float64),
                      ("eigvalsh", torch.float32), ("svd", torch.float64))
# exactly repeated spectra above a warp's orders: the orders, and (case of
# tests/jacobi_cases.py, seed) of each matrix; every kind must converge
# within JACOBI_REPEATED_SWEEPS sweeps (MAX_SWEEPS is 40)
JACOBI_REPEATED_D = (64, 128, 200)
JACOBI_REPEATED = (("reflected", 1000), ("reflected", 1003),
                   ("projector", 1000))
JACOBI_REPEATED_SWEEPS = 30
# relative to max(1, |A|_F) (|M|_F^2 for the SVD's Gram identity, which is
# quadratic in M)
JACOBI_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# Golub and Van Loan's flop counts (Matrix Computations, 4th ed.: the
# symmetric QR algorithm 9 d^3 with vectors and 4 d^3 / 3 without; the SVD
# of a square matrix 12 d^3 for sigma and U)
JACOBI_FLOPS = {"eigh": 9.0, "eigvalsh": 4.0 / 3.0, "svd": 12.0}
# the reference's decomposition each kind replaces (no Pallas kernel: XLA
# ran these on the TPU inside the loop)
JACOBI_REPLACES = {"eigh": "conicip_tpu/cones/algebra.py:111",
                   "eigvalsh": "conicip_tpu/cones/algebra.py:334",
                   "svd": "conicip_tpu/cones/scaling.py:160"}
# every (kind, dtype, d, stack) a kernel was held against its plain version
# at, the keys of its launch counter, with max |values - plain values|
JACOBI_HELD = {}
# the solves whose first stack of each kind [jacobi_time] times beside the
# random stacks: larger_sdp's one 30 x 30 matrix and the [batch] stack of 64
JACOBI_PATH_SOLVES = ("larger_sdp(k=30)", "batched_small_sdp(64)")


def dtname(dt):
    return str(dt).split(".")[-1]


def jacobi_bound_ms(kind, B, d, dtype):
    """Least time the card could take for the decompositions of B order-d
    matrices: Golub and Van Loan's count at the dtype's peak rate against the
    stack read once and the outputs written once. Returns (ms, which)."""
    ops = B * JACOBI_FLOPS[kind] * d ** 3 / PEAK_FLOPS[dtype]
    out = d + (0 if kind == "eigvalsh" else d * d)
    moved = B * (d * d + out) * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(ops, moved) * 1e3, "operations" if ops >= moved else "bytes"


@functools.lru_cache(maxsize=None)
def jacobi_shapes():
    """(d, stack) of every S group the S-cone phases solve: k matrices of a
    group of k cones per instance for the scaling, the KKT build, the
    corrector and the initial shift, 2 k for the step eigenvalues of two
    stacked directions; a stack of 64 instances and its sampled instances
    alone."""
    from conicip_tpu_torch import models
    from conicip_tpu_torch.cones.spec import ConeSpec

    problems = [(P.cone_dims, 1) for _, P, _, _, _ in conic_cases()]
    problems += [(P.cone_dims, 1) for _, P, _ in f32_cases()]
    problems += [(args[4], BATCH) for _, args, _, _, _ in batch_cases()]
    problems += [(P.cone_dims, 1) for _, P, _, _, _ in frontend_cases()]
    problems += [(models.batched_small_sdp(1, k=BACKSTOP_K)[4], BATCH)]
    problems += [(P.cone_dims, 1) for _, P, _, _, _ in distributed_cases()]
    shapes = set()
    for dims, B in problems:
        for g in ConeSpec(dims).sdp_groups:
            for b in {1, B}:
                shapes |= {(g.order, b * g.count), (g.order, 2 * b * g.count)}
    # [sdp_large]: its single and its stack (no instance of it alone)
    for dims, B in sdp_large_dims():
        for g in ConeSpec(dims).sdp_groups:
            shapes |= {(g.order, B * g.count), (g.order, 2 * B * g.count)}
    return shapes


def jacobi_input(kind, B, d, dt, seed):
    """A stack of B random order-d matrices: symmetric (and indefinite) for
    the eigendecompositions, general for the SVD."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, d, d, generator=g, device="cuda", dtype=torch.float64)
    return (X if kind == "svd" else (X + X.mT) / 2).to(dt).contiguous()


def jacobi_run(kind, A, plain=False):
    """(values, vectors or None) of one kind on the stack A, by the kernel
    or by its plain version (ops/batched.py: torch.linalg behind the
    non-finite and per-entry guards)."""
    from conicip_tpu_torch.ops import batched, jacobi_kernel

    if kind == "eigh":
        return (batched.eigh_plain if plain else jacobi_kernel.eigh)(A)
    if kind == "eigvalsh":
        return (batched.eigvalsh_plain if plain
                else jacobi_kernel.eigvalsh)(A), None
    U, sig = (batched.svd_plain if plain else jacobi_kernel.svd)(A)
    return sig, U


def jacobi_library(kind, A):
    """The one torch.linalg call for the same function (cuSOLVER), a
    yardstick only: the port never calls it on the card."""
    if kind == "eigh":
        return torch.linalg.eigh(A)
    if kind == "eigvalsh":
        return torch.linalg.eigvalsh(A)
    return torch.linalg.svd(A)


def jacobi_rotation_inputs(count, seed=0):
    """(a_pp, a_pq, a_qq) on the card over the range the kernels' scaled
    matrices give: |a| < 1, a_pq down to the subnormals, every 97th a_pq 0
    and every 89th a_qq = a_pp (the last two leave a fast path)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def spread(lowest):
        mant = torch.rand(count, generator=g, device="cuda",
                          dtype=torch.float64) * 2 - 1
        ex = torch.randint(lowest, 1, (count,), generator=g, device="cuda")
        return mant * torch.pow(2.0, ex.double())

    app, apq, aqq = spread(-60), spread(-1074), spread(-60)
    apq[::97] = 0
    aqq[::89] = app[::89]
    return app, apq, aqq


def jacobi_cases():
    """tests/jacobi_cases.py (its inputs) and tests/jacobi_model.py (the
    kernels' arithmetic, whose ``negligible`` is the rule), numpy only."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jacobi_cases
    import jacobi_model

    return jacobi_cases, jacobi_model


def hold_jacobi(kind, dt, d, B, A=None, what="random"):
    """The kernel against its plain version on the stack A (B, d, d),
    random when None: its values against the plain values, and the
    identities that do not depend on signs or bases, each relative to
    max(1, |A|_F): |U diag(w) U^T - A|_F and |U^T U - I|_F, for the SVD
    |U^T M M^T U - diag(σ^2)|_F over max(1, |M|_F)^2. Returns the worst
    error over its tolerance."""
    if A is None:
        A = jacobi_input(kind, B, d, dt, seed=1000 * d + B)
    vals, vecs = jacobi_run(kind, A)
    plain, _ = jacobi_run(kind, A, plain=True)
    torch.cuda.synchronize()
    A64, v = A.double(), vals.double()
    scale = torch.linalg.matrix_norm(A64).clamp_min(1.0)
    err = {"values": (v - plain.double()).abs().amax(-1) / scale}
    if vecs is not None:
        U = vecs.double()
        eye = torch.eye(d, dtype=torch.float64, device="cuda")
        err["orth"] = torch.linalg.matrix_norm(U.mT @ U - eye) / scale
        if kind == "eigh":
            err["recon"] = torch.linalg.matrix_norm(
                U @ torch.diag_embed(v) @ U.mT - A64) / scale
        else:
            err["gram"] = torch.linalg.matrix_norm(
                U.mT @ A64 @ A64.mT @ U - torch.diag_embed(v * v)) / scale ** 2
    err = {k: e.max().item() for k, e in err.items()}
    tol = JACOBI_TOL[dt]
    what = f"jacobi {kind} {dtname(dt)} ({B}, {d}, {d}) {what}"
    check(all(e <= tol for e in err.values()), f"{what}: {err} over {tol:g}")
    steps = v.diff(dim=-1)
    check(bool((steps >= 0).all() if kind != "svd" else (steps <= 0).all()),
          f"{what}: values out of order")
    if kind == "eigvalsh":
        # the values-only mode runs eigh's arithmetic on A: the same values
        check(torch.equal(vals, jacobi_run("eigh", A)[0]),
              f"{what}: values differ from the eigh mode's")
    key = (kind, dt, d, B)
    max_abs = (v - plain.double()).abs().max().item()
    JACOBI_HELD[key] = max(JACOBI_HELD.get(key, 0.0), max_abs)
    return max(err.values()) / tol


def jacobi_path_inputs():
    """{(solve, kind): the first stack the Jacobi kernels were handed for
    that kind} in one ``conic_ip`` solve of larger_sdp(k=30) and one
    ``solve_batch`` of batched_small_sdp(64) on the card."""
    from conicip_tpu_torch import conic_ip, models
    from conicip_tpu_torch.ops import jacobi_kernel

    solves = dict(zip(JACOBI_PATH_SOLVES, (
        lambda: conic_ip(*models.larger_sdp(k=30).args(), device="cuda"),
        lambda: timed_batch(on_card(models.batched_small_sdp(BATCH))))))
    first = {}
    launch = jacobi_kernel._launch
    try:
        for label, solve in solves.items():
            def record(kind, A, *args, **kw):
                first.setdefault((label, kind), A.clone())
                return launch(kind, A, *args, **kw)

            jacobi_kernel._launch = record
            solve()
    finally:
        jacobi_kernel._launch = launch
    return first


def jacobi_sweeps(kind, A):
    """Sweeps the kernel takes on the stack A (its slowest matrix), found by
    running it under a rising sweep limit; the SVD's count includes the
    sweep that finds nothing left to rotate."""
    from conicip_tpu_torch.ops import jacobi_kernel

    for sweeps in range(jacobi_kernel.MAX_SWEEPS + 1):
        out = jacobi_kernel._launch(kind, A, max_sweeps=sweeps)
        if all(o is None or bool(torch.isfinite(o).all()) for o in out):
            return sweeps
    return None


def jacobi_special(dt):
    """Inputs the solver meets besides random ones, at d = 10 and 30: the
    identity, a clustered spectrum (three values, repeated: the central
    path's mat(λ) has such), an indefinite matrix, and for the SVD the
    ill-conditioned Lz^T Ls of the NT scaling."""
    f64 = torch.float64
    g = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for d in (10, 30):
        Q, P = torch.linalg.qr(torch.randn(2, 4, d, d, generator=g,
                                           device="cuda", dtype=f64))[0]
        eye = torch.eye(d, device="cuda", dtype=f64).expand(4, d, d)
        w = torch.tensor([2.0, -0.5, 1.0], device="cuda",
                         dtype=f64).repeat_interleave(-(-d // 3))[:d]
        clustered = (Q * w) @ Q.mT
        X = torch.randn(4, d, d, generator=g, device="cuda", dtype=f64)
        indefinite = (X + X.mT) / 2 - 2.0 * eye

        def spd(V, kappa):
            lam = torch.logspace(0, -np.log10(kappa), d, device="cuda",
                                 dtype=f64)
            return (V * lam) @ V.mT

        Lz = torch.linalg.cholesky(spd(Q, 1e8))
        Ls = torch.linalg.cholesky(spd(P, 1e5))
        for label, A, kinds in (
                ("identity", eye, JACOBI_KINDS),
                ("clustered", clustered, JACOBI_KINDS),
                ("indefinite", indefinite, ("eigh", "eigvalsh")),
                ("LzT_Ls", Lz.mT @ Ls, ("svd",))):
            out.append((d, label, A.to(dt).contiguous(), kinds))
    return out


def phase_jacobi():
    """The Jacobi kernels against their plain versions at every shape the
    S-cone paths hand them and at edge shapes, their failure semantics, and
    their times; returns their JSON records by (kind, dtype)."""
    from conicip_tpu_torch.ops import jacobi_kernel

    f32, f64 = torch.float32, torch.float64
    on_path = jacobi_shapes()
    edges = {(d, 3) for d in JACOBI_EDGE_D} | {(d, 2) for d in
                                              JACOBI_GLOBAL_D}
    edges |= {(d, 1) for d in JACOBI_PLAN_EDGE_D}
    edges.add((10, JACOBI_BIG_STACK))
    for d, B in sorted(on_path | edges):
        worst = {}
        for dt in (f64, f32):
            for kind in JACOBI_KINDS:
                worst[f"{kind}_{dtname(dt)}"] = (
                    f"{hold_jacobi(kind, dt, d, B):.3g}")
        line("jacobi", d=d, B=B, main_path=(d, B) in on_path,
             worst_over_tol=",".join(f"{k}:{v}" for k, v in worst.items()))
    for dt in (f64, f32):
        for d, label, A, kinds in jacobi_special(dt):
            worst = {k: hold_jacobi(k, dt, d, A.shape[0], A=A, what=label)
                     for k in kinds}
            line("jacobi", case=label, d=d, B=A.shape[0], dtype=dtname(dt),
                 worst_over_tol=",".join(f"{k}:{v:.3g}"
                                         for k, v in worst.items()))
    # a non-finite entry (NaN in one, +inf in another) and an entry at the
    # sweep limit come back NaN alone; the others as in a clean stack
    for dt in (f64, f32):
        for kind in JACOBI_KINDS:
            A = jacobi_input(kind, 8, 10, dt, seed=13)
            bad = A.clone()
            bad[2, 4, 1] = float("nan")
            bad[5, 0, 7] = float("inf")
            clean = jacobi_run(kind, A)
            hurt = jacobi_run(kind, bad)
            keep = [i for i in range(8) if i not in (2, 5)]
            for c, h in zip(clean, hurt):
                if c is None:
                    continue
                check(bool(torch.isnan(h[[2, 5]]).all())
                      and torch.equal(h[keep], c[keep]),
                      f"jacobi {kind} {dtname(dt)}: a non-finite entry is "
                      "not NaN alone")
            D = A[:2].clone()
            D[0] = torch.diag(torch.arange(10, device="cuda", dtype=dt))
            limited = jacobi_kernel._launch(kind, D.contiguous(), max_sweeps=1)
            for out in limited:
                if out is None:
                    continue
                check(bool(torch.isfinite(out[0]).all()
                           and torch.isnan(out[1]).all()),
                      f"jacobi {kind} {dtname(dt)}: at the sweep limit")
            line("jacobi_nan", kind=kind, dtype=dtname(dt), B=8, d=10,
                 nan_at="2,5", inf_at="5", others="bitwise as a clean stack",
                 sweep_limit_1="NaN alone (a diagonal entry converges)")
    # the d <= 32 kernels' branch-free rotation against the library's
    # correctly rounded operations, bit for bit where its fast paths hold
    cases, model = jacobi_cases()
    app, apq, aqq = jacobi_rotation_inputs(1 << 20)
    mismatched, slow, zeroed = jacobi_kernel.rotation_check(app, apq, aqq)
    host = int(model.negligible(*(v.cpu().numpy()
                                  for v in (app, apq, aqq))).sum())
    check(mismatched == 0, f"jacobi rotation: {mismatched} triples differ "
          "from the library's rounding")
    check(slow > 0, "jacobi rotation: no triple left a fast path")
    check(zeroed == host, f"jacobi rotation: the rule took {zeroed} a_pq, "
          f"the host's sums {host}")
    line("jacobi_rotation", triples=app.numel(), mismatched=mismatched,
         slow_path=slow, rule_took=zeroed, host_rule=host)
    # at the rule's edge and one ulp past it: the rule takes the first half
    # (as numpy's sums do), the library's bits under the rule everywhere
    edge = cases.rule_edge_triples(1 << 16)
    host = int(model.negligible(*edge).sum())
    app, apq, aqq = (torch.from_numpy(v).cuda() for v in edge)
    mismatched, slow, zeroed = jacobi_kernel.rotation_check(app, apq, aqq)
    check(mismatched == 0 and zeroed == host == app.numel() // 2,
          f"jacobi rotation at the rule's edge: {mismatched} differ, the "
          f"rule took {zeroed}, the host's sums {host} of {app.numel()}")
    line("jacobi_rotation", case="rule_edge", triples=app.numel(),
         mismatched=mismatched, slow_path=slow, rule_took=zeroed,
         host_rule=host)
    # exactly repeated spectra above a warp's orders: every kind finite,
    # held against its plain version, within JACOBI_REPEATED_SWEEPS sweeps
    for d in JACOBI_REPEATED_D:
        for label, seed in JACOBI_REPEATED:
            X = getattr(cases, label)(d, seed)
            for dt in (f64, f32):
                A = torch.from_numpy(X).to("cuda", dt)[None].contiguous()
                worst, sweeps = {}, {}
                for kind in JACOBI_KINDS:
                    worst[kind] = hold_jacobi(kind, dt, d, 1, A=A,
                                              what=f"{label} {seed}")
                    sweeps[kind] = jacobi_sweeps(kind, A)
                check(all(v is not None and v <= JACOBI_REPEATED_SWEEPS
                          for v in sweeps.values()),
                      f"jacobi {label} seed {seed} d={d} {dtname(dt)}: "
                      f"sweeps {sweeps} over {JACOBI_REPEATED_SWEEPS}")
                line("jacobi_repeated", case=label, seed=seed, d=d, B=1,
                     dtype=dtname(dt),
                     sweeps=",".join(f"{k}:{v}" for k, v in sweeps.items()),
                     bound=JACOBI_REPEATED_SWEEPS,
                     limit=jacobi_kernel.MAX_SWEEPS,
                     worst_over_tol=",".join(f"{k}:{v:.3g}"
                                             for k, v in worst.items()))
    records = {}
    for B, d in JACOBI_TIMED:
        for kind in JACOBI_KINDS:
            for dt in (f64, f32):
                A = jacobi_input(kind, B, d, dt, seed=B + d)
                reps = 20
                ms = cuda_ms(lambda: jacobi_run(kind, A), reps)
                plain = cuda_ms(lambda: jacobi_run(kind, A, plain=True), reps)
                library = cuda_ms(lambda: jacobi_library(kind, A), reps)
                bound, bound_by = jacobi_bound_ms(kind, B, d, dt)
                per_call = "untraced"
                if (B, d) == JACOBI_RECORD[kind]:
                    per_call = cuda_launches(lambda: jacobi_run(kind, A), 1)
                    check(per_call == 1, f"jacobi {kind} {dtname(dt)}: "
                          f"{per_call} CUDA launches per call")
                line("jacobi_time", kind=kind, B=B, d=d, dtype=dtname(dt),
                     kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                     library_ms=f"{library:.4f}", bound_ms=f"{bound:.6f}",
                     bound_by=bound_by, bound_share=f"{bound / ms:.5f}",
                     ratio_to_library=f"{ms / library:.3f}",
                     launches_per_call=per_call, reps=reps)
                if (B, d) == JACOBI_RECORD[kind]:
                    records[(kind, dt, False)] = ({
                        "name": f"jacobi_{kind}_{'f64' if dt == f64 else 'f32'}",
                        "route": "cuda",
                        "source": "conicip_tpu_torch/csrc/jacobi.cu",
                        "replaces": JACOBI_REPLACES[kind],
                        "shape": f"({B}, {d}, {d}) {dtname(dt)}",
                        "ms": ms, "plain_ms": plain, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": library})
    records.update(phase_jacobi_time_large())
    # the paths' own matrices: the first stack of each kind in two solves
    for (solve, kind), A in sorted(jacobi_path_inputs().items()):
        d, dt = A.shape[-1], A.dtype
        B = A.numel() // (d * d)
        hold_jacobi(kind, dt, d, B, A=A, what=f"{solve} first stack")
        reps = 20
        ms = cuda_ms(lambda: jacobi_run(kind, A), reps)
        plain = cuda_ms(lambda: jacobi_run(kind, A, plain=True), reps)
        library = cuda_ms(lambda: jacobi_library(kind, A), reps)
        bound, bound_by = jacobi_bound_ms(kind, B, d, dt)
        line("jacobi_time", kind=kind, B=B, d=d, dtype=dtname(dt),
             input=repr(f"{solve} first stack"),
             sweeps=jacobi_sweeps(kind, A), kernel_ms=f"{ms:.4f}",
             plain_ms=f"{plain:.4f}", library_ms=f"{library:.4f}",
             bound_ms=f"{bound:.6f}", bound_by=bound_by,
             bound_share=f"{bound / ms:.5f}",
             ratio_to_library=f"{ms / library:.3f}", reps=reps)
    return dict(sorted(records.items(), key=lambda kv: (
        kv[0][2], JACOBI_KINDS.index(kv[0][0]), kv[0][1] == f32)))


def budget_ms(fn, budget=250.0, most=20):
    """Mean device time of ``fn()`` over as many runs as fit in ``budget``
    ms (3 to ``most``), after one timed warm-up run; and that count."""
    first = event_ms(fn)
    reps = max(3, min(most, int(budget / max(first, 1e-3))))
    return cuda_ms(fn, reps), reps


def jacobi_plan_fields(kind, d, dt):
    """The block kernels' launch plan as line fields (ops/jacobi_kernel.py
    launch_plan)."""
    from conicip_tpu_torch.ops import jacobi_kernel

    p = jacobi_kernel.launch_plan(kind, d, dt)
    return dict(threads=p.threads, smem_bytes=p.smem_bytes,
                route=p.route, on_chip=int(p.on_chip))


def phase_jacobi_time_large():
    """[jacobi_time] above a warp's orders (JACOBI_TIMED_LARGE), each kind
    in f64 and f32: the kernel's ms beside its plain version's, the
    library's (cuSOLVER) and its bound, the sweeps it takes, what an entry
    at the sweep limit would take (the ms scaled by the sweeps to
    MAX_SWEEPS) and its launch plan; returns the block kernels' JSON
    records, (kind, f64, True) at JACOBI_BLOCK_RECORD.
    ``--phase jacobi_time_large --package DIR`` times another tree's."""
    from conicip_tpu_torch.ops import jacobi_kernel

    f32, f64 = torch.float32, torch.float64
    records = {}
    for B, d in JACOBI_TIMED_LARGE:
        for kind in JACOBI_KINDS:
            for dt in (f64, f32):
                A = jacobi_input(kind, B, d, dt, seed=B + d)
                ms, reps = budget_ms(lambda: jacobi_run(kind, A))
                plain, _ = budget_ms(lambda: jacobi_run(kind, A, plain=True))
                library, _ = budget_ms(lambda: jacobi_library(kind, A))
                bound, bound_by = jacobi_bound_ms(kind, B, d, dt)
                sweeps = jacobi_sweeps(kind, A)
                at_limit = (f"{ms * jacobi_kernel.MAX_SWEEPS / sweeps:.3f}"
                            if sweeps else "none")
                line("jacobi_time", kind=kind, B=B, d=d, dtype=dtname(dt),
                     sweeps=sweeps, kernel_ms=f"{ms:.4f}",
                     plain_ms=f"{plain:.4f}", library_ms=f"{library:.4f}",
                     bound_ms=f"{bound:.6f}", bound_by=bound_by,
                     bound_share=f"{bound / ms:.6f}",
                     ratio_to_library=f"{ms / library:.3f}", reps=reps,
                     ms_at_limit=at_limit, **jacobi_plan_fields(kind, d, dt))
                if ((B, d) == JACOBI_BLOCK_RECORD
                        and (kind, dt) in JACOBI_BLOCK_KINDS):
                    bits = "f64" if dt == f64 else "f32"
                    records[(kind, dt, True)] = {
                        "name": f"jacobi_{kind}_block_{bits}",
                        "route": "cuda",
                        "source": "conicip_tpu_torch/csrc/jacobi.cu",
                        "replaces": JACOBI_REPLACES[kind],
                        "shape": f"({B}, {d}, {d}) {dtname(dt)}",
                        "ms": ms, "plain_ms": plain, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": library}
    return records


# ── the R cones' kernels (csrc/rcone.cu) ──

# (B, m) the [rcone] phase holds and times every entry at: the Schur
# singles of box_qp_dense n=500 (m = 1000, the most run), the README box
# (m = 2000), the batched_box_qp(64, n=500) stack's rows per instance
# (m = 1000), and a wide single solve; then edge shapes, held only, with a
# NaN and an inf entry in the last instance's direction (a ragged end of
# a row at 8192 + 3)
RCONE_SHAPES = ((1, 1000), (1, 2000), (64, 1000), (1, 8192))
RCONE_EDGES = ((5, 300), (3, 1), (1, 8195))
RCONE_RECORD = (1, 2000)  # the kernels line's shape, f64
# per entry: (vectors read, vectors written, per-instance values read,
# per-instance values written, bool flags written, operations per element)
RCONE_IO = {"scaling": (2, 4, 0, 1, 0, 7), "reduce4_pre": (4, 2, 0, 0, 0, 3),
            "reduce4_post": (3, 1, 0, 0, 0, 3),
            "corrector": (5, 1, 1, 0, 0, 6), "k4": (5, 1, 0, 0, 0, 5),
            "gondzio": (5, 1, 2, 0, 0, 12), "predictor": (4, 0, 0, 6, 1, 14),
            "step": (4, 0, 0, 1, 1, 6)}
# the kernels of csrc/rcone.cu and their entries; what each replaces in
# the JAX package (plain jnp code: no TPU kernel)
RCONE_KERNELS = {
    "r_scaling": (("scaling",), "conicip_tpu/cones/scaling.py:113"),
    "r_reduce4": (("reduce4_pre", "reduce4_post"),
                  "conicip_tpu/solver/ipm.py:345"),
    "r_comp": (("corrector", "k4", "gondzio"),
               "conicip_tpu/solver/ipm.py:703"),
    "r_step": (("predictor", "step"), "conicip_tpu/cones/algebra.py:218"),
}
# |kernel - plain| of the reduced values (mubar, the fts dots, fts), over
# the magnitudes of their terms: another summation order
RCONE_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


def rcone_bound_ms(entry, B, m, dt):
    """Least time of one call: its vectors and values read once and its
    outputs written once at the memory rate, against its operations at the
    dtype's peak rate. Returns (ms, which)."""
    vr, vw, pr, pw, flags, ops = RCONE_IO[entry]
    size = torch.finfo(dt).bits // 8
    moved = ((vr + vw) * B * m + (pr + pw) * B) * size + flags * B
    t_bytes = moved / PEAK_BYTES
    t_ops = ops * B * m / PEAK_FLOPS[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rcone_inputs(B, m, dt, seed, edge=False):
    """An interior point (v, s), a direction (dv, ds), two more vectors,
    per-instance σμ and ã; with ``edge`` a NaN and an inf entry in the
    last instance's direction."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda", dtype=dt)

    def randn():
        return torch.randn(B, m, generator=g, device="cuda", dtype=dt)

    dv, ds = randn(), randn()
    if edge:
        dv[-1, 0] = float("nan")
        ds[-1, -1] = float("inf")
    return dict(v=rand(B, m) * 2.8 + 0.2, s=rand(B, m) * 2.8 + 0.2, dv=dv,
                ds=ds, x=randn(), y=randn(), smu=rand(B) * 0.3 + 0.3,
                atil=rand(B) * 0.5 + 0.5)


def rcone_calls(a):
    """entry: (kernel call, plain twin call, which outputs are reduced
    values with their terms) on the inputs ``a``."""
    from conicip_tpu_torch.ops import rcone

    v, s, dv, ds, smu, atil = (a[k] for k in ("v", "s", "dv", "ds", "smu",
                                               "atil"))
    r_d, rinv, lam, lam2, _ = rcone.r_scaling_plain(v, s)
    inv_dtb = 1.0 / (1.0 - 0.01)
    dots = torch.stack([v * s, v * ds, dv * s, dv * ds], -2)

    def pair(name, *args, **kw):
        return (lambda: getattr(rcone, name)(*args, **kw),
                lambda: getattr(rcone, f"{name}_plain")(*args, **kw))

    return {
        "scaling": (*pair("r_scaling", v, s), {4: v * s}),
        "reduce4_pre": (*pair("r_reduce4_pre", a["x"], lam, r_d, a["y"]),
                        {}),
        "reduce4_post": (*pair("r_reduce4_post", a["x"], r_d, dv), {}),
        "corrector": (*pair("r_corrector", lam2, r_d, rinv, dv, ds, smu),
                      {}),
        "k4": (*pair("r_k4", lam, r_d, rinv, dv, ds), {}),
        "gondzio": (*pair("r_gondzio", lam, r_d, rinv, dv, ds, atil, smu),
                    {}),
        "predictor": (*pair("r_step", v, s, dv, ds, fts=True),
                      {2: dots, 3: dots.reshape(dots.shape[0], -1)}),
        "step": (*pair("r_step", v, s, dv, ds, inv_dtb), {}),
    }


def hold_rcone(entry, kernel, plain, reduced, dt):
    """One entry against its plain twin on the same card tensors: every
    elementwise output, the step and the flags equal (NaN where the twin is
    NaN), the reduced values within RCONE_TOL of their terms' magnitudes.
    Returns the largest |kernel - plain| over finite entries."""
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"[rcone] {entry}: output {i} {x.dtype} {tuple(x.shape)}, "
              f"plain {y.dtype} {tuple(y.shape)}")
        if x.dtype == torch.bool:
            check(torch.equal(x, y), f"[rcone] {entry}: flags differ")
            continue
        nan, fin = torch.isnan(y), torch.isfinite(y)
        check(torch.equal(torch.isnan(x), nan),
              f"[rcone] {entry}: output {i} NaN where plain is not")
        diff = (x - y).abs()[fin]
        # a reduced value may differ where it is finite, and only there
        free = fin if i in reduced else torch.zeros_like(fin)
        check(bool(((x == y) | nan | free).all()),
              f"[rcone] {entry}: output {i} differs")
        if i in reduced:
            bound = (RCONE_TOL[dt] * reduced[i].abs().sum(-1))[fin]
            check(bool((diff <= bound).all()), f"[rcone] {entry}: reduced "
                  f"output {i} beyond {RCONE_TOL[dt]} of its terms")
        if diff.numel():
            worst = max(worst, diff.max().item())
    return worst


def graph_ms(fn, calls=20, replays=10):
    """Device ms of one call of ``fn`` as the main path runs it: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between
    two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (replays * calls)
    graph.reset()
    return ms


def rcone_plan(entry, a):
    """How ``entry`` launches on the inputs ``a``: the plan the wrapper
    takes (ops/rcone_kernel.py:launch_plan, from the same function); for
    an older checkout given by --package, one block of 256 threads per
    instance for an entry without a plan (its first design), and None
    for a package without launch plans."""
    from conicip_tpu_torch.ops import rcone_kernel

    if not hasattr(rcone_kernel, "launch_plan"):
        return None
    rows = [a[k] for k in ("v", "s", "dv", "ds", "x", "y")]
    B = rows[0].shape[0]
    if entry in rcone_kernel.PLANNED:
        return rcone_kernel.plan_of(rcone_kernel.PLANNED[entry], *rows)
    return rcone_kernel.Plan((B, 1), 256, None, False,
                             rcone_kernel.LANES[rows[0].dtype])


def plan_fields(plan):
    if plan is None:
        return dict(grid="B", cluster="none", vec=False)
    return dict(grid=f"{plan.grid[0]}x{plan.grid[1]}", threads=plan.threads,
                cluster=plan.cluster or "none", vec=plan.vec)


def graph_cond_ms(calls=20, replays=10):
    """Device ms of one conditional IF node of the device loop
    (csrc/graph_cond.cu: set_condition reads a bool, and the node) with an
    empty body, its flag true and false: ``calls`` nodes captured in one
    CUDA graph as solver/graph.py captures them, replayed ``replays``
    times between two CUDA events."""
    from conicip_tpu_torch.solver import graph as device_loop

    lib = device_loop._cond_library()
    stream, child = torch.cuda.Stream(), torch.cuda.Stream()
    out = {}
    for value in (True, False):
        flag = torch.full((), value, dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            g.capture_begin(capture_error_mode=device_loop.CAPTURE_MODE)
            errs = []
            for _ in range(calls):
                errs.append(lib.conicip_if_begin(
                    stream.cuda_stream, child.cuda_stream, flag.data_ptr(),
                    device_loop._CAPTURE_MODE_ENUM))
                errs.append(lib.conicip_if_end(child.cuda_stream))
            g.capture_end()
        check(not any(errs), f"[graph_cond] CUDA errors {set(errs)}")
        g.replay()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(replays):
            g.replay()
        t1.record()
        torch.cuda.synchronize()
        out[value] = t0.elapsed_time(t1) / (replays * calls)
        g.reset()
    return out


# iterations the WHILE node is held at against a host loop of its body
WHILE_LIMITS = (0, 1, 7, 100)
# bytes one iteration of that body must move: the counter read and
# written, read again and the flag written (the compare), the flag read
# (set_condition)
WHILE_BYTES = 8 + 8 + 8 + 1 + 1


def graph_while():
    """The device loop's WHILE node (csrc/graph_cond.cu: the node, and
    set_condition before it and as its body's last node) against a host
    loop of the same body: a device counter set to 0, then 1 added while
    it is below N, at N in WHILE_LIMITS; the node's graph replayed twice
    at each N, no host read; the host loop replays a graph of the body
    and reads the flag after each. Times (CUDA events, 10 replays of the
    graph): the node per iteration ((N=100 - N=0) / 100), the body's two
    kernels per iteration captured straight in a graph, their difference
    (the node's own cost per iteration: an empty body's), the node with
    its flag false (N=0), and the host loop per iteration. Returns the
    kernels line's record."""
    import ctypes

    from conicip_tpu_torch.solver import graph as device_loop

    lib = device_loop._cond_library()
    stream, child = torch.cuda.Stream(), torch.cuda.Stream()
    counter = torch.zeros((), dtype=torch.int64, device="cuda")
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    mode = device_loop.CAPTURE_MODE

    def body(limit):
        counter.add_(1)
        torch.lt(counter, limit, out=flag)

    def node_graph(limit):
        g = torch.cuda.CUDAGraph()
        handle = ctypes.c_ulonglong(0)
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            g.capture_begin(capture_error_mode=mode)
            counter.zero_()
            torch.lt(counter, limit, out=flag)
            errs = [lib.conicip_while_begin(
                stream.cuda_stream, child.cuda_stream, flag.data_ptr(),
                device_loop._CAPTURE_MODE_ENUM, ctypes.byref(handle))]
            with torch.cuda.stream(child):
                body(limit)
            errs.append(lib.conicip_while_end(child.cuda_stream, handle,
                                              flag.data_ptr()))
            g.capture_end()
        check(errs == [0, 0], f"[graph_cond] WHILE node: CUDA errors {errs}")
        return g

    def straight(limit, calls):
        g = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            g.capture_begin(capture_error_mode=mode)
            for _ in range(calls):
                body(limit)
            g.capture_end()
        return g

    def host_loop(limit, gb):
        counter.zero_()
        torch.lt(counter, limit, out=flag)
        reads = 1
        while bool(flag):
            gb.replay()
            reads += 1
        return reads

    def timed(fn, reps=10):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    worst, node_ms = 0, {}
    for limit in WHILE_LIMITS:
        g = node_graph(limit)
        got = []
        for _ in range(2):
            counter.fill_(-5)
            g.replay()
            torch.cuda.synchronize()
            got.append((int(counter), bool(flag)))
        gb = straight(limit, 1)
        reads = host_loop(limit, gb)
        host = int(counter)
        check(got == [(limit, False)] * 2 and host == limit
              and reads == limit + 1,
              f"[graph_cond] WHILE to {limit}: the node ran to {got}, the "
              f"host loop to {host} in {reads} reads")
        worst = max(worst, max(abs(v - host) for v, _ in got))
        if limit in (0, WHILE_LIMITS[-1]):
            node_ms[limit] = timed(g.replay)
        if limit == WHILE_LIMITS[-1]:
            host_ms = timed(lambda: host_loop(limit, gb), reps=3) / limit
            gs = straight(limit, limit)
            body_ms = timed(gs.replay) / limit
            gs.reset()
        g.reset()
        gb.reset()
    top = WHILE_LIMITS[-1]
    per_iter = (node_ms[top] - node_ms[0]) / top
    bound = WHILE_BYTES / PEAK_BYTES * 1e3
    line("graph_cond", node="while", kernel="set_condition",
         body="counter+1, compare", limits=",".join(map(str, WHILE_LIMITS)),
         held_against_host_loop=True, max_abs_err=worst,
         while_us_per_iter=f"{per_iter * 1e3:.3f}",
         body_us_per_iter=f"{body_ms * 1e3:.3f}",
         node_us_per_iter=f"{(per_iter - body_ms) * 1e3:.3f}",
         while_us_flag_false=f"{node_ms[0] * 1e3:.3f}",
         host_loop_us_per_iter=f"{host_ms * 1e3:.3f}",
         bound_ms=f"{bound:.3e}", bound_by="bytes", library_ms=None)
    return {"name": "graph_cond_while", "route": "cuda",
            "source": "conicip_tpu_torch/csrc/graph_cond.cu",
            "replaces": "conicip_tpu/solver/ipm.py:935",
            "shape": f"one iteration of a toy body (counter+1, compare), "
                     f"N = {top}",
            "ms": per_iter, "plain_ms": host_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None,
            "max_abs_err": float(worst), "launches": 0}


def phase_rcone():
    """The R cones' kernels against their plain twins, every entry in f64
    and f32 at RCONE_SHAPES and RCONE_EDGES, each line with its launch
    plan (grid, cluster, vector path), and each entry's time inside a
    captured CUDA graph beside the plain sequence's, its bound and the
    launch floor (an empty kernel launched by the same plan in the same
    graph: a node's fixed cost, which no kernel can beat); then the
    device loop's conditional nodes: the IF node's time, and the WHILE
    node held against a host loop and timed (graph_while). Returns the
    kernels line's records, one per kernel at RCONE_RECORD in f64 (the
    sums over its entries, one call of each; max_abs_err over every f64
    shape held), and under "while" the WHILE node's."""
    from conicip_tpu_torch.ops import rcone_kernel

    f64 = torch.float64
    records, worst_of = {}, Counter()
    for dt in (f64, torch.float32):
        for B, m in RCONE_SHAPES + RCONE_EDGES:
            edge = (B, m) in RCONE_EDGES
            a = rcone_inputs(B, m, dt, seed=B + m, edge=edge)
            for entry, (kernel, plain, reduced) in rcone_calls(a).items():
                before = rcone_kernel.launch_count(entry, dt)
                worst = hold_rcone(entry, kernel, plain, reduced, dt)
                check(rcone_kernel.launch_count(entry, dt) == before + 1,
                      f"[rcone] {entry}: not one launch counted per call")
                worst_of[entry, dt] = max(worst_of[entry, dt], worst)
                plan = rcone_plan(entry, a)
                if edge:
                    line("rcone", entry=entry, B=B, m=m, dtype=dtname(dt),
                         input="edge", max_abs_err=f"{worst:.3e}",
                         held=True, **plan_fields(plan))
                    continue
                ms, plain_ms = graph_ms(kernel), graph_ms(plain)
                floor = ("not measured" if plan is None else
                         f"{graph_ms(lambda: rcone_kernel.empty(plan)):.5f}")
                bound, by = rcone_bound_ms(entry, B, m, dt)
                line("rcone", entry=entry, B=B, m=m, dtype=dtname(dt),
                     max_abs_err=f"{worst:.3e}", kernel_ms=f"{ms:.5f}",
                     plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound:.6f}",
                     bound_by=by, bound_share=f"{bound / ms:.4f}",
                     launch_floor_ms=floor,
                     ratio_to_plain=f"{ms / plain_ms:.3f}", in_graph=True,
                     **plan_fields(plan))
                if (B, m) == RCONE_RECORD and dt == f64:
                    records[entry] = (ms, plain_ms, bound)
    cond = graph_cond_ms()
    line("graph_cond", kernel="set_condition", body="empty",
         node_ms_flag_true=f"{cond[True]:.5f}",
         node_ms_flag_false=f"{cond[False]:.5f}",
         bound_ms=f"{1 / PEAK_BYTES * 1e3:.3e}", bound_by="bytes",
         library_ms=None, in_graph=True)
    out = {"while": graph_while()}
    for name, (entries, replaces) in RCONE_KERNELS.items():
        ms, plain, bound = (sum(records[e][i] for e in entries)
                            for i in range(3))
        out[name] = {"name": f"rcone_{name}", "route": "cuda",
                     "source": "conicip_tpu_torch/csrc/rcone.cu",
                     "replaces": replaces,
                     "shape": f"{RCONE_RECORD} f64, one call of each entry "
                              f"({'+'.join(entries)})",
                     "ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": None,
                     "max_abs_err": max(worst_of[e, f64] for e in entries),
                     "entries": list(entries)}
    return out


def rcone_counts():
    """The R cones' kernels' launches so far, by entry."""
    from conicip_tpu_torch.ops import rcone_kernel

    return Counter({e: rcone_kernel.launch_count(e)
                    for e in rcone_kernel.ENTRIES})


def rcone_launched(label, used, only_r, gondzio):
    """Check the R cones' launches ``used`` of one solve: on an R-only
    spec every entry (the Gondzio trial only with a corrector), on any
    other none. Returns them as a line field."""
    from conicip_tpu_torch.ops import rcone_kernel

    if only_r:
        want = [e for e in rcone_kernel.ENTRIES if gondzio or e != "gondzio"]
        check(all(used[e] > 0 for e in want)
              and (gondzio or not used["gondzio"]),
              f"{label}: R cones' launches {dict(used)}")
    else:
        check(not +used, f"{label}: not R-only, yet the R cones' kernels "
              f"launched {dict(+used)}")
    return ",".join(f"{e}:{used[e]}" for e in rcone_kernel.ENTRIES) \
        if only_r else "none"


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


def predicated(dtype=None, n=None):
    """Predicated launches of the kernel (the Schur solver's ridge
    retries) so far."""
    from conicip_tpu_torch.ops import cholesky_kernel

    return cholesky_kernel.launch_count(dtype, n, counter="predicated")


def run_builds(r):
    """KKT builds the card ran in one interior-point run
    (``trace.kkt_builds``: on the device loop one per unit, a miss's
    prologue twice; on the eager loop one per step)."""
    from conicip_tpu_torch.trace import kkt_builds

    return kkt_builds(r)


def kkt_builds():
    """KKT builds of the latest conic_ip call's runs (run_builds)."""
    from conicip_tpu_torch import solver

    return sum(run_builds(r) for r in solver.runs)


def loops():
    """The loops the latest conic_ip call's runs took."""
    from conicip_tpu_torch import solver

    return "+".join(r.loop for r in solver.runs)


def jacobi_launches():
    """Launches of the Jacobi kernels so far, every kind and dtype."""
    from conicip_tpu_torch.ops import jacobi_kernel

    return jacobi_kernel.launch_count()


def has_sdp(cone_dims):
    return any(t == "S" for t, _ in cone_dims)


def phase_schur():
    from conicip_tpu_torch import conic_ip
    from conicip_tpu_torch.models import box_qp_dense

    for n in SCHUR_N:
        args = box_qp_dense(n=n, seed=42).args()
        before, pbefore = launches(), predicated()
        sol, ms = solve_timed(args, device="cuda")
        used, pred = launches() - before, predicated() - pbefore
        builds, loop = kkt_builds(), loops()
        resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
        check(sol.status == "Optimal", f"n={n}: status {sol.status}")
        check(resid < 1e-6, f"n={n}: residual {resid:.3e}")
        check(all(t.device.type == "cuda" for t in (sol.y, sol.w, sol.v)),
              f"n={n}: result tensors are not on cuda")
        # the device loop on the card (a CUDA graph); one factor per KKT
        # build, the cold start's and one per iteration the card ran (POLL
        # per chunk), and two predicated ridge retries beside each
        check(loop == "graph", f"n={n}: the {loop} loop ran")
        check(used == builds and pred == 2 * builds,
              f"n={n}: {used} kernel launches and {pred} predicated for "
              f"{builds} KKT builds")
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
            CPU_REF[f"box_qp_dense(n={n})"] = (ref.status, ref.Iter)
        line("schur", n=n, status=sol.status, Iter=sol.Iter,
             resid=f"{resid:.3e}", launches=used, predicated=pred,
             kkt_builds=builds, loop=loop,
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
    from conicip_tpu_torch import conic_ip

    n = 1000
    for eq in (False, True):
        args = diag_args(eq, n)
        before, rbefore = launches(), rcone_counts()
        sol, ms = solve_timed(args, device="cuda")
        used = launches() - before
        # the R cones' kernels, every entry but the Gondzio trial (the
        # diag backend runs no corrector)
        rcone = rcone_launched(f"diag eq={eq}", rcone_counts() - rbefore,
                               True, False)
        builds, loop = kkt_builds(), loops()
        _, ms2 = solve_timed(args, device="cuda")
        check(sol.status == "Optimal", f"diag eq={eq}: status {sol.status}")
        check(loop == "graph", f"diag eq={eq}: the {loop} loop ran")
        # the CPU's solve, which [graph] holds its solve to again
        ref = conic_ip(*args, device="cpu")
        CPU_REF[f"readme_box(n=1000{',eq' if eq else ''})"] = (ref.status,
                                                               ref.Iter)
        check((ref.status, ref.Iter) == (sol.status, sol.Iter),
              f"diag eq={eq}: cpu {ref.status}/{ref.Iter}, card "
              f"{sol.status}/{sol.Iter}")
        # the Woodbury equality mode factors two (p, p) matrices per KKT
        # build (K and S); without equalities nothing is factored
        check(used == (2 * builds if eq else 0),
              f"diag eq={eq}: {used} launches for {builds} KKT builds")
        line("diag", n=n, equality=eq, status=sol.status, Iter=sol.Iter,
             cpu_iter=ref.Iter,
             resid=f"{max(sol.prFeas, sol.duFeas, sol.muFeas):.3e}",
             launches=used, kkt_builds=builds, loop=loop, rcone=rcone,
             ms_per_solve=f"{ms2:.2f}",
             ms_per_iter=f"{ms2 / sol.Iter:.3f}", first_solve_ms=f"{ms:.2f}")


@functools.lru_cache(maxsize=None)
def conic_cases():
    """(label, problem, backend, launch rule) of the [conic] phase. The
    rule: "iter" one factor per KKT build (kkt_builds: the device loop's
    executed iterations, or the eager loop's steps, and the cold start),
    "2iter" two (the n and the p factor of an equality solve), each with
    two predicated ridge retries beside it, "none" no launch at all (the
    spectral backend factors nothing); ``cpu`` says whether Iter is held
    against the port's own CPU solve. The automatic backends and the
    Schur solver passed by hand take the device loop (a CUDA graph)."""
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
        before, jbefore = launches(), jacobi_launches()
        pbefore = predicated()
        sol, ms = solve_timed(P.args(), device="cuda", **kw)
        used, jused = launches() - before, jacobi_launches() - jbefore
        pred = predicated() - pbefore
        builds, loop = kkt_builds(), loops()
        resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
        what = f"{label} {backend}"
        # the automatic backend and the Schur backend passed by hand: both
        # the package's own, both on the device loop
        check(loop == "graph", f"{what}: the {loop} loop ran")
        check(sol.status == "Optimal", f"{what}: status {sol.status}")
        # an S cone's decompositions run the Jacobi kernels, nothing else does
        check((jused > 0) == has_sdp(P.cone_dims),
              f"{what}: {jused} Jacobi launches")
        check(resid < 1e-6, f"{what}: residual {resid:.3e}")
        check(all(t.device.type == "cuda" for t in (sol.y, sol.w, sol.v)),
              f"{what}: result tensors are not on cuda")
        need = {"iter": builds, "2iter": 2 * builds, "none": 0}[rule]
        check(used == need and pred == 2 * need,
              f"{what}: {used} kernel launches and {pred} predicated for "
              f"{builds} KKT builds (rule {rule})")
        extra = {}
        if cpu:
            ref = conic_ip(*P.args(), device="cpu", **kw)
            dy = (sol.y.cpu() - ref.y).abs().max().item()
            check(ref.status == sol.status and ref.Iter == sol.Iter,
                  f"{what}: cpu {ref.status}/{ref.Iter} vs gpu "
                  f"{sol.status}/{sol.Iter}")
            check(dy <= 1e-6, f"{what}: y diff {dy:.3e}")
            extra = dict(cpu_iter=ref.Iter, y_diff=f"{dy:.3e}")
            CPU_REF[f"{label} {backend}"] = (ref.status, ref.Iter)
        line("conic", instance=label, backend=backend, status=sol.status,
             Iter=sol.Iter, resid=f"{resid:.3e}", launches=used,
             predicated=pred, kkt_builds=builds, loop=loop,
             jacobi_launches=jused,
             ms_per_solve=f"{ms:.2f}", ms_per_iter=f"{ms / sol.Iter:.3f}",
             **extra)


# ── S cones above order 32: [sdp_large] ──
# (a) conic_ip on instance 0 of batched_small_sdp(1, k=SDP_LARGE_K): the PSD
# repair of one random symmetric 100 x 100 matrix (n = 5050, A = Q = I, the
# spectral backend, no factor); (b) solve_batch on batched_small_sdp(B,
# k=k) at SDP_LARGE_STACK (n = 2080; an f64 stack takes the dense Schur
# solver, one batched factor of order n per KKT build)
SDP_LARGE_K = 100
SDP_LARGE_STACK = (32, 64)
SDP_LARGE_HITS = 3  # solves after the miss, each a cache hit


def sdp_large_dims():
    """(cone_dims, instances) of the [sdp_large] solves."""
    B, k = SDP_LARGE_STACK
    return (([("S", tri(SDP_LARGE_K))], 1), ([("S", tri(k))], B))


def sdp_large_cases():
    """(label, arguments as numpy arrays, stack size or None) of the
    [sdp_large] solves, made from their seed (0)."""
    from conicip_tpu_torch import models

    Q, c, A, b, cones = models.batched_small_sdp(1, k=SDP_LARGE_K)
    B, k = SDP_LARGE_STACK
    yield (f"batched_small_sdp(1,k={SDP_LARGE_K})[0]",
           (Q[0], c[0], A[0], b[0], cones), None)
    del Q, c, A, b
    yield (f"batched_small_sdp({B},k={k})", models.batched_small_sdp(B, k=k),
           B)


def cpu_reference(args, B):
    """The port's CPU solve of [sdp_large] arguments (conic_ip for a single,
    solve_batch for a stack of B): statuses, Iter, KKT builds, trips and
    units (its chunk loop's: the eager loop's steps) of its runs, y, and
    its seconds."""
    from conicip_tpu_torch import conic_ip, solve_batch, solver
    from conicip_tpu_torch.parallel import batch as pbatch

    t = time.perf_counter()
    if B is None:
        ref = conic_ip(*args, device="cpu")
        runs, statuses, iters = solver.runs, [ref.status], [ref.Iter]
    else:
        ref = solve_batch(*args, device="cpu")
        runs, statuses = pbatch.runs, list(ref.statuses)
        iters = ref.Iter.tolist()
    return dict(statuses=statuses, iters=iters,
                builds=sum(run_builds(r) for r in runs),
                trips=sum(r.trips for r in runs),
                units=sum(r.units for r in runs), y=ref.y.numpy(),
                seconds=time.perf_counter() - t)


# the [sdp_large] stack's instances held against the CPU: its CPU solve
# whole takes minutes on the card's host, a stack of these four seconds
SDP_LARGE_SAMPLED = (0, 1, 16, 31)


def sampled_stack(args, idx):
    """solve_batch's positional arguments for the instances ``idx``."""
    Q, c, A, b, cones = args
    idx = list(idx)
    return (Q[idx], c[idx], A[idx], b[idx], cones)


def path_sweeps(solve):
    """{(kind, dtype, d, stack): the sweeps of each Jacobi launch above a
    warp's orders} of one ``solve()`` on the card's eager loop, where the
    wrapper sees every launch's input as the solve made it (the device
    loop's replays bypass it): the sweeps of the launch's slowest entry,
    found by bisecting the kernel's sweep limit, or MAX_SWEEPS where a
    finite entry comes back NaN at the limit. The launches of the solve
    and of the search leave the launch counts as they were."""
    from conicip_tpu_torch import solver
    from conicip_tpu_torch.ops import jacobi_kernel
    from conicip_tpu_torch.parallel import batch as pbatch

    launch = jacobi_kernel._launch
    saved = Counter(jacobi_kernel.jacobi_launches)
    reasons = solver._eager_reason, pbatch._eager_reason
    out = defaultdict(list)

    def finite(kind, A, limit):
        """Per entry of the stack A: every output finite at ``limit``."""
        B = A.numel() // A.shape[-1] ** 2
        ok = torch.ones(B, dtype=torch.bool, device=A.device)
        for o in launch(kind, A, max_sweeps=limit):
            if o is not None:
                ok &= torch.isfinite(o).reshape(B, -1).all(1)
        return ok

    def record(kind, A, *args, **kw):
        got = launch(kind, A, *args, **kw)
        d = A.shape[-1]
        if d > JACOBI_WARP_MAX_D:
            limit = jacobi_kernel.MAX_SWEEPS
            done = finite(kind, A, limit)
            clean = torch.isfinite(A).reshape(done.shape[0], -1).all(1)
            lo, hi = 0, limit  # every entry done at hi, not all below lo
            if bool((clean & ~done).any()):
                lo = limit
            while lo < hi:
                mid = (lo + hi) // 2
                if bool((finite(kind, A, mid) | ~done).all()):
                    hi = mid
                else:
                    lo = mid + 1
            out[(kind, A.dtype, d, done.shape[0])].append(lo)
        return got

    try:
        jacobi_kernel._launch = record
        solver._eager_reason = pbatch._eager_reason = (
            lambda *a: "chip_smoke: the paths' sweeps")
        solve()
    finally:
        jacobi_kernel._launch = launch
        solver._eager_reason, pbatch._eager_reason = reasons
        jacobi_kernel.jacobi_launches.clear()
        jacobi_kernel.jacobi_launches.update(saved)
    return out


def phase_sdp_large():
    """S cones above order 32 on the device loop, the block Jacobi kernels'
    main path (sdp_large_cases): each solve a miss after graph.clear(),
    then SDP_LARGE_HITS hits of the same arguments on the card; per hit
    every run on the device loop and a cache hit, one host read and one
    replay of the loop's WHILE node per run, at most one device-to-host
    copy in the loop (profiler). The single: status, Iter, KKT builds,
    refinement trips and units (the CPU's: the eager loop's steps) equal
    to its CPU solve, y within 1e-6 of it. The stack: the instances SDP_LARGE_SAMPLED solved as a stack of
    their own on the CPU and on the card (a hit), status, Iter,
    builds, trips and y equal between the two as for the single, and each
    of them in the whole stack at the same status and Iter, y within 1e-6.
    The Jacobi launches of one hit by (kind, dtype, d, stack), every one
    above a warp's orders and every kind the solve decomposes by, and the
    sweeps of each (path_sweeps, after the timed solves; none at the
    limit); ms of the miss and of the hits, and the CPU solve's seconds."""
    from conicip_tpu_torch import conic_ip, solve_batch, solver
    from conicip_tpu_torch.ops import jacobi_kernel
    from conicip_tpu_torch.parallel import batch as pbatch
    from conicip_tpu_torch.solver import graph

    for label, args, B in sdp_large_cases():
        card = on_card(args)
        if B is None:
            def solve(a=card, **kw):
                return conic_ip(*a, **kw)

            def runs():
                return list(solver.runs)
        else:
            def solve(a=card, **kw):
                return solve_batch(*a, **kw)

            def runs():
                return list(pbatch.runs)

        def status(sol):
            return ([sol.status] if B is None else list(sol.statuses),
                    [sol.Iter] if B is None else sol.Iter.tolist())

        graph.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve(device="cuda")
        torch.cuda.synchronize()
        ms_miss = (time.perf_counter() - t) * 1e3
        miss = runs()
        check(all(r.loop == "graph" and not r.cache_hit for r in miss),
              f"[sdp_large] {label}: the miss ran "
              f"{[(r.loop, r.cache_hit) for r in miss]}")
        ms_hits = []
        for _ in range(SDP_LARGE_HITS):
            before = Counter(jacobi_kernel.jacobi_launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sol = solve(device="cuda")
            torch.cuda.synchronize()
            ms_hits.append((time.perf_counter() - t) * 1e3)
            hit = runs()
            used = jacobi_kernel.jacobi_launches - before
            check(all(r.loop == "graph" and r.cache_hit and r.polls == 1
                      and r.replays == 1 for r in hit),
                  f"[sdp_large] {label}: a hit ran "
                  f"{[(r.loop, r.cache_hit, r.polls, r.replays) for r in hit]}")
        what = f"[sdp_large] {label}"
        builds = sum(run_builds(r) for r in hit)
        trips = sum(r.trips for r in hit)
        units = sum(r.units for r in hit)
        pg = profiled(lambda: solve(device="cuda"))
        check(pg["dtoh_loop"] <= 1 and pg["replay_host_launches"] == 0,
              f"{what}: {pg['dtoh_loop']} device-to-host copies in the "
              f"loop, {pg['replay_host_launches']} host launches during "
              f"replays")
        whole = got = status(sol)
        y = sol.y.cpu().numpy()
        if B is None:
            ref, cmp = cpu_reference(args, B), (builds, trips, units)
        else:
            # the sample as a stack of its own, on the CPU and on the card
            # (a hit: a miss builds the KKT system once more)
            idx = SDP_LARGE_SAMPLED
            ref = cpu_reference(sampled_stack(args, idx), len(idx))
            part_args = on_card(sampled_stack(args, idx))
            for _ in range(2):
                part = solve(part_args, device="cuda")
            sub = runs()
            check(all(r.loop == "graph" and r.cache_hit and r.polls == 1
                      for r in sub),
                  f"{what}: the sample ran "
                  f"{[(r.loop, r.cache_hit, r.polls) for r in sub]}")
            cmp = (sum(run_builds(r) for r in sub), sum(r.trips for r in sub),
                   sum(r.units for r in sub))
            dy_part = float(np.abs(part.y.cpu().numpy() - ref["y"]).max())
            check(status(part) == (ref["statuses"], ref["iters"])
                  and dy_part <= 1e-6,
                  f"{what}: the sample on the card {status(part)}, on the "
                  f"CPU {(ref['statuses'], ref['iters'])}, y diff "
                  f"{dy_part:.3e}")
            got = ([got[0][i] for i in idx], [got[1][i] for i in idx])
            y = y[list(idx)]
        want = (ref["statuses"], ref["iters"])
        dy = float(np.abs(y - ref["y"]).max())
        check(set(whole[0]) == {"Optimal"} and got == want,
              f"{what}: card {got}, cpu {want}")
        check(cmp == (ref["builds"], ref["trips"], ref["units"]),
              f"{what}: {cmp} KKT builds, trips and units on the card, "
              f"{(ref['builds'], ref['trips'], ref['units'])} on the CPU")
        check(dy <= 1e-6, f"{what}: y diff {dy:.3e}")
        # every decomposition of the solve on the block kernels
        kinds = {k for k, _, _, _ in used}
        check(all(d > JACOBI_WARP_MAX_D for _, _, d, _ in used)
              and {"svd", "eigvalsh"} <= kinds
              and ("eigh" in kinds or B is not None),
              f"{what}: Jacobi launches {dict(used)}")
        for (kind, dt, d, stack), c in sorted(used.items(), key=str):
            line("jacobi_launches", solve=repr(label), kind=kind,
                 dtype=dtname(dt), d=d, B=stack, per_solve=c)
        sweeps = path_sweeps(solve)
        limit = jacobi_kernel.MAX_SWEEPS
        check(set(used) <= set(sweeps)
              and all(max(v) < limit for v in sweeps.values()),
              f"{what}: sweeps {dict(sweeps)} (launches {dict(used)}, limit "
              f"{limit})")
        for (kind, dt, d, stack), v in sorted(sweeps.items(), key=str):
            line("jacobi_sweeps", solve=repr(label), kind=kind,
                 dtype=dtname(dt), d=d, B=stack, launches=len(v),
                 sweeps_min=min(v), sweeps_median=sorted(v)[len(v) // 2],
                 sweeps_max=max(v), limit=limit, loop="eager")
        line("sdp_large", instance=repr(label), B=B or 1,
             n=args[1].shape[-1],
             status=",".join(f"{k}x{v}" for k, v in
                             sorted(Counter(whole[0]).items())),
             Iter=f"{min(whole[1])}-{max(whole[1])}", cpu_iter="equal",
             loop="+".join(r.loop for r in hit),
             cache_hit=int(all(r.cache_hit for r in hit)),
             polls=sum(r.polls for r in hit),
             replays=sum(r.replays for r in hit), units=units,
             kkt_builds=builds, trips=trips, dtoh_loop=pg["dtoh_loop"],
             y_diff=f"{dy:.3e}",
             jacobi_per_solve=sum(used.values()), ms_miss=f"{ms_miss:.2f}",
             ms_hit=spread(ms_hits), cpu_held=(
                 "whole" if B is None else ",".join(map(str, idx))),
             cpu_seconds=f"{ref['seconds']:.1f}")
        del card, sol, ref
        graph.clear()
        torch.cuda.empty_cache()


def graph_cases():
    """(label, args, CPU_REF key) of the [graph] phase: every solve of the
    device loop's slice that the script runs ([schur], [diag] and the
    automatic-backend cases of [conic])."""
    from conicip_tpu_torch import models

    cases = [(f"box_qp_dense(n={n})", models.box_qp_dense(n=n, seed=42).args(),
              f"box_qp_dense(n={n})") for n in SCHUR_N]
    cases += [(f"readme_box(n=1000{',eq' if eq else ''})", diag_args(eq),
               f"readme_box(n=1000{',eq' if eq else ''})")
              for eq in (False, True)]
    cases += [(label, P.args(), f"{label} auto")
              for label, P, kkt, _, _ in conic_cases() if kkt is None]
    return cases


def event_ms(fn):
    """Milliseconds of one call of ``fn`` between two CUDA events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def profiled(fn):
    """One call of ``fn`` under the profiler: kernels, device-to-host
    copies, and the device loop's own counts (trace.loop_counts). The
    phases profile a case after timing it, and a hit only: a graph
    instantiated while the profiler runs runs slower ever after, and one
    from before runs up to 9 % slower for a while after the session
    (PERF.md §6). On a hit of the loop's WHILE node the profiler records
    only part of its body, so the kernel count is not the loop's."""
    from torch.profiler import ProfilerActivity, profile

    from conicip_tpu_torch.trace import loop_counts

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = loop_counts(events)
    out["kernels"] = sum(1 for e in events if e.get("cat") == "kernel")
    out["dtoh"] = out["dtoh_loop"] + out["dtoh_fixed"]
    return out


def graph_f32_cases():
    """(label, problem, conic_ip keywords) of the [f32] phase's solves, as
    [graph] and [graph_cache] drive them: conic_ip's own f32 path (the
    last-mile Schur generator with mixed residuals), and mixed_rqs on that
    generator passed by hand (the package's own: the device loop too)."""
    out = []
    for label, P, kkt in f32_cases():
        kw = dict(factor_dtype=torch.float32)
        if kkt is not None:
            kw.update(kktsolver=kkt, lastmileProactive=50.0)
        out.append((f"{label} f32", P, kw))
    return out


def launch_counts():
    """The kernels' launches so far by entry and dtype: the Cholesky
    kernel's unconditional and predicated factors, each Jacobi kind and
    each entry of the R cones' kernels."""
    from conicip_tpu_torch.ops import (cholesky_kernel, jacobi_kernel,
                                       rcone_kernel)

    out = Counter()
    for name, counter in (("cholesky", cholesky_kernel.cholesky_launches),
                          ("predicated", cholesky_kernel.predicated_launches)):
        for key, c in counter.items():
            out[f"{name}_{dtname(key[0])}"] += c
    for (kind, dt, _, _), c in jacobi_kernel.jacobi_launches.items():
        out[f"{kind}_{dtname(dt)}"] += c
    for (entry, dt, _, _), c in rcone_kernel.rcone_launches.items():
        out[f"rcone_{entry}_{dtname(dt)}"] += c
    return out


def counted(fn):
    """``fn()`` and the launches it made (launch_counts)."""
    before = launch_counts()
    out = fn()
    return out, launch_counts() - before


def phase_graph():
    """Each solve of the slice through conic_ip (the device loop, CUDA
    graphs kept across calls) and through the eager loop on the same
    arguments (ipm_solve without a device loop): the same status and Iter,
    also as the CPU's (an f32 solve's Iter within 2 of it), and y bit for
    bit; then the same device operands through the device loop again, a
    cache hit: the same bits, the KKT builds, steps on each variant,
    recomputes, refinement trips and kernel launches by entry and dtype of
    the eager loop; on a miss and on the hit one host read (the final
    copy), one replay of the loop's WHILE node and units equal to the
    eager loop's steps; then each loop alone: ms per solve (median of 3, CUDA events),
    kernels and device-to-host copies per iteration (profiler); during the
    replays the host launches no kernel. The f32 solves (graph_f32_cases)
    run every body of the device loop: the variants' scalings and steps,
    the mixed-residual recompute and the refinement trips nested in a
    step, each a conditional graph node."""
    from conicip_tpu_torch import conic_ip, solver
    from conicip_tpu_torch.solver import graph, ipm
    from conicip_tpu_torch.solver.state import Solution

    real, seen = graph.solve, {}

    def spy(*args, **kw):
        seen["call"] = (args, kw)
        return real(*args, **kw)

    cases = [(label, args, key, {}) for label, args, key in graph_cases()]
    cases += [(label, P.args(), None, kw)
              for label, P, kw in graph_f32_cases()]
    for label, args, key, ckw in cases:
        graph.solve = spy
        try:
            sol = conic_ip(*args, device="cuda", **ckw)
        finally:
            graph.solve = real
        a, kw = seen.pop("call")
        (first,) = solver.runs

        # the two loops on the same device operands: graph.solve, which
        # conic_ip reached, and ipm_solve without a device loop
        def graphed(stats=None):
            return Solution.from_state(real(*a, warm=kw["warm"],
                                            stats=stats))

        def eager(stats=None):
            return Solution.from_state(ipm.ipm_solve(*a, warm=kw["warm"],
                                                     stats=stats))

        est = {}
        ref, eager_launches = counted(lambda: eager(est))
        check(first.loop == "graph",
              f"[graph] {label}: the {first.loop} loop ran")
        check(sol.status == ref.status and sol.Iter == ref.Iter,
              f"[graph] {label}: graph {sol.status}/{sol.Iter}, eager "
              f"{ref.status}/{ref.Iter}")
        if ckw:
            # the CPU's f32 solve, which [f32] holds its solve to again
            cpu_sol = conic_ip(*args, device="cpu", **ckw)
            cpu = CPU_REF[label] = (cpu_sol.status, cpu_sol.Iter)
            check(cpu[0] == sol.status and abs(cpu[1] - sol.Iter) <= 2,
                  f"[graph] {label}: graph {sol.status}/{sol.Iter}, cpu "
                  f"{cpu}")
        else:
            cpu = CPU_REF.get(key)
            check(cpu is None or cpu == (sol.status, sol.Iter),
                  f"[graph] {label}: graph {sol.status}/{sol.Iter}, cpu "
                  f"{cpu}")
        dy = (sol.y - ref.y).abs().max().item()
        check(dy == 0, f"[graph] {label}: |y - y_eager| {dy:.3e}")
        hst = {}
        hit, hit_launches = counted(lambda: graphed(hst))
        run = solver.Run(None, hit.status, hit.Iter, **hst)
        check(run.cache_hit and torch.equal(hit.y, sol.y)
              and (hit.status, hit.Iter) == (sol.status, sol.Iter),
              f"[graph] {label}: the second solve of the same operands "
              f"(cache hit {run.cache_hit}) differs from the first")
        erun = solver.Run(None, ref.status, ref.Iter, **est)
        builds, ebuilds = run_builds(run), run_builds(erun)
        counts = ("fast_steps", "slow_steps", "recertified", "trips")
        check(builds == ebuilds and all(
            getattr(run, k) == getattr(erun, k) for k in counts),
              f"[graph] {label}: {builds} KKT builds, "
              f"{[getattr(run, k) for k in counts]} {counts} on the device "
              f"loop, {ebuilds} and {[getattr(erun, k) for k in counts]} "
              f"on the eager loop")
        check(hit_launches == eager_launches,
              f"[graph] {label}: launches {dict(hit_launches)} on a hit, "
              f"{dict(eager_launches)} on the eager loop")
        rcone = rcone_launched(f"[graph] {label}", Counter({
            k[len("rcone_"):].rsplit("_", 1)[0]: v
            for k, v in hit_launches.items() if k.startswith("rcone_")}),
            a[6].only_r, a[8].centralityCorrectors > 0)
        # the loop one WHILE node: a hit and a miss read the device once
        # (the final copy) and replay the loop's graph once; the units it
        # ran are the eager loop's steps in chunks of POLL (one variant
        # per step), a miss's eager first chunk among them
        steps = erun.fast_steps + erun.slow_steps
        units = ipm.POLL * -(-steps // ipm.POLL)
        check(run.polls == first.polls == 1
              and run.replays == first.replays == 1
              and run.units == first.units == units,
              f"[graph] {label}: {run.polls} polls, {run.replays} "
              f"replays, {run.units} units on a hit, {first.polls}, "
              f"{first.replays}, {first.units} on a miss, for {steps} "
              f"steps of the eager loop at POLL {ipm.POLL}")
        ms_g = float(np.median([event_ms(graphed) for _ in range(3)]))
        ms_e = float(np.median([event_ms(eager) for _ in range(3)]))
        pg = profiled(graphed)
        pe = profiled(eager)
        # the tracer may lose events, never invents one: at most one copy
        # inside the loop, and no kernel launched by the host while the
        # graph is replayed
        check(pg["dtoh_loop"] <= 1 and pg["replay_host_launches"] == 0,
              f"[graph] {label}: {pg['dtoh_loop']} device-to-host copies in "
              f"the loop, {pg['replay_host_launches']} host launches during "
              f"replays")
        it = sol.Iter
        line("graph", instance=label, status=sol.status, Iter=it,
             cpu_iter=cpu[1] if cpu else "-", y_diff_eager=f"{dy:.3e}",
             first_call="hit" if first.cache_hit else "miss",
             kkt_builds_graph=builds, kkt_builds_eager=ebuilds,
             fast_steps=run.fast_steps, slow_steps=run.slow_steps,
             recertified=run.recertified,
             launches=",".join(f"{k}:{v}" for k, v in
                               sorted(hit_launches.items())
                               if not k.startswith("rcone_")) or "none",
             rcone=rcone, launches_equal_eager=True,
             trips_per_iter_graph=f"{run.trips / it:.2f}",
             trips_per_iter_eager=f"{erun.trips / it:.2f}",
             poll=ipm.POLL, polls=run.polls, replays=run.replays,
             units=run.units, ms_graph=f"{ms_g:.2f}", ms_eager=f"{ms_e:.2f}",
             dtoh_per_iter_graph=f"{pg['dtoh'] / it:.2f}",
             dtoh_per_iter_eager=f"{pe['dtoh'] / it:.2f}",
             dtoh_loop=pg["dtoh_loop"], dtoh_fixed=pg["dtoh_fixed"],
             kernels_per_iter_graph="not_measured",  # WHILE body: profiled()
             kernels_per_iter_eager=f"{pe['kernels'] / it:.1f}",
             replay_host_launches=pg["replay_host_launches"])


def readme_box(seed, n=1000, eq=False, pattern=False):
    """The README box QP (diag backend) with its objective shifted by the
    seed; with one equality; or with A's rows in another order, signs and
    scales (one nonzero each, the box kept by b), so that the diag
    backend's level-1 data (columns, coefficients, incidence) differ from
    one instance to the next."""
    H, c, A, b, cones, G, d = diag_args(eq, n)
    rng = np.random.default_rng(seed)
    c = c + rng.standard_normal(n)
    if pattern:
        perm = rng.permutation(n)
        signs = rng.choice([-1.0, 1.0], size=2 * n)
        scale = rng.uniform(0.5, 2.0, size=2 * n)
        A = (signs * scale)[:, None] * np.vstack([np.eye(n)[perm],
                                                  -np.eye(n)[perm]])
        b = -scale
    return H, c, A, b, cones, G, d


def graph_cache_cases():
    """(label, instance at a seed, conic_ip keywords) of the [graph_cache]
    phase: the eight solves of PERF.md §5's table, a README box with an
    equality (the diag backend's Woodbury buffers) and one whose A changes
    its sign pattern from one instance to the next; then conic_ip's own
    f32 solves of the [f32] phase (graph_f32_cases but the generator
    passed by hand, which [graph] holds)."""
    from conicip_tpu_torch import models

    f32 = dict(factor_dtype=torch.float32)
    cases = [(label, make, {}) for label, make in (
        ("box_qp_dense(n=500)", lambda s: models.box_qp_dense(500, s).args()),
        ("box_qp_dense(n=1024)",
         lambda s: models.box_qp_dense(1024, s).args()),
        ("box_qp_dense(n=4096)",
         lambda s: models.box_qp_dense(4096, s).args()),
        ("single_soc(n=500)", lambda s: models.single_soc(500, s).args()),
        ("single_soc(n=4096)", lambda s: models.single_soc(4096, s).args()),
        ("many_small_socs(k=250)",
         lambda s: models.many_small_socs(seed=s).args()),
        ("larger_sdp(k=30)", lambda s: models.larger_sdp(seed=s).args()),
        ("mixed_rqs(n=86)", lambda s: models.mixed_rqs(seed=s).args()),
        ("readme_box(n=1000,eq)", lambda s: readme_box(s, eq=True)),
        ("readme_box(n=1000,sign pattern)",
         lambda s: readme_box(s, pattern=True)),
    )]
    return cases + [
        ("box_qp_dense(n=1024) f32",
         lambda s: models.box_qp_dense(1024, s).args(), f32),
        ("box_qp_dense(n=4096) f32",
         lambda s: models.box_qp_dense(4096, s).args(), f32),
        ("single_soc(n=4096) f32",
         lambda s: models.single_soc(4096, s).args(), f32),
        ("many_small_socs(k=250,n=500) f32",
         lambda s: models.many_small_socs(seed=s).args(), f32),
    ]


CHAIN = 6  # instances of one shape per [graph_cache] case


def spread(ms):
    """median, least and most of a list of times, as line fields"""
    ms = sorted(ms)
    return f"{ms[len(ms) // 2]:.2f}/{ms[0]:.2f}/{ms[-1]:.2f}"


def phase_graph_cache():
    """The device loop's cache (solver/graph.py) on each case of
    graph_cache_cases(): a chain of CHAIN instances of one shape (seeds
    1...CHAIN). The first call misses and builds the entry, the other five
    hit it (one capture for the key), each with one host read, one replay
    of the loop's WHILE node and a unit per step (in f64 the CPU's units,
    the eager loop's steps); torch.cuda.memory_reserved() is flat
    across the hits; the first solution is unchanged after the last call.
    Then each hit's instance again after graph.clear() (a miss): the same
    status, Iter and y, w, v bit for bit, and, in f64, the CPU's status
    and Iter ([graph] holds one f32 solve of each case to the CPU's).
    One solve of another shape misses, and filling the cache past its
    bound with small solves evicts the case's entry, whose memory pools
    leave no segment behind. ms per solve (host clock around a
    synchronised call on the device operands conic_ip made, the result's
    scalars read; median, least and most of the five): hit, miss and the
    eager loop; seconds of the case, and of its CPU solves in it."""
    from conicip_tpu_torch import conic_ip, models, solver
    from conicip_tpu_torch.solver import graph, ipm
    from conicip_tpu_torch.solver.state import Solution

    real, seen = graph.solve, {}

    def spy(*args, **kw):
        seen["call"] = (args, kw)
        return real(*args, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def pools_left(ids):
        return sum(1 for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in ids)

    for label, make, kw in graph_cache_cases():
        started = time.perf_counter()
        graph.clear()
        instances = [make(seed) for seed in range(1, CHAIN + 1)]
        first = conic_ip(*instances[0], device="cuda", **kw)
        check(not solver.runs[0].cache_hit, f"[graph_cache] {label}: the "
              "first call of an empty cache hit")
        (key,) = graph.cache_info()
        kept = first.y.clone()
        hits, reserved = [], []
        rbefore = rcone_counts()
        units = []
        for args in instances[1:]:
            sol = conic_ip(*args, device="cuda", **kw)
            (run,) = solver.runs
            check(run.cache_hit and run.loop == "graph"
                  and graph.cache_info() == [key],
                  f"[graph_cache] {label}: a call of the chain missed")
            # one read, one replay of the WHILE node, a unit per step
            steps = run.fast_steps + run.slow_steps
            check(run.polls == 1 and run.replays == 1
                  and run.units == ipm.POLL * -(-steps // ipm.POLL),
                  f"[graph_cache] {label}: {run.polls} polls, "
                  f"{run.replays} replays, {run.units} units on a hit of "
                  f"{steps} steps")
            units.append(run.units)
            reserved.append(torch.cuda.memory_reserved())
            hits.append((sol.status, sol.Iter,
                         *(getattr(sol, f).cpu() for f in "ywv")))
            del sol
        rused = rcone_counts() - rbefore
        check(len(set(reserved)) == 1,
              f"[graph_cache] {label}: memory reserved across the hits "
              f"{reserved}")
        check(torch.equal(first.y, kept),
              f"[graph_cache] {label}: the first solution changed")

        # the times, on the device operands conic_ip made (graph.solve and
        # ipm_solve as [graph] calls them): hits, then the eager loop
        operands = []
        for args in instances[1:]:
            graph.solve = spy
            try:
                conic_ip(*args, device="cuda", **kw)
            finally:
                graph.solve = real
            operands.append(seen.pop("call")[0])
        # the hits' R cones' launches, every entry on an R-only spec
        rcone = rcone_launched(f"[graph_cache] {label}", rused,
                               operands[0][6].only_r,
                               operands[0][8].centralityCorrectors > 0)

        def loop(a, stats=None):
            return Solution.from_state(real(*a, stats=stats))

        ms_hit = [timed(lambda: loop(a))[1] for a in operands]
        ms_eager = [timed(lambda: Solution.from_state(ipm.ipm_solve(*a)))[1]
                    for a in operands]
        ms_miss, cpu_iters, cpu_s = [], [], 0.0
        for args, a, (status, Iter, y, w, v), hit_units in zip(
                instances[1:], operands, hits, units):
            graph.clear()
            stats = {}
            fresh, ms = timed(lambda: loop(a, stats))
            check(not stats["cache_hit"]
                  and (fresh.status, fresh.Iter) == (status, Iter)
                  and all(torch.equal(getattr(fresh, f).cpu(), x)
                          for f, x in zip("ywv", (y, w, v))),
                  f"[graph_cache] {label}: a hit {status}/{Iter} differs "
                  f"from the solve after clear() {fresh.status}/"
                  f"{fresh.Iter}")
            ms_miss.append(ms)
            if kw:
                continue
            t = time.perf_counter()
            cpu = conic_ip(*args, device="cpu")
            cpu_s += time.perf_counter() - t
            check((cpu.status, cpu.Iter) == (status, Iter)
                  and solver.runs[0].units == hit_units,
                  f"[graph_cache] {label}: card {status}/{Iter} in "
                  f"{hit_units} units, cpu {cpu.status}/{cpu.Iter} in "
                  f"{solver.runs[0].units}")
            cpu_iters.append(cpu.Iter)
        del operands
        # the entry of this key again, then a solve of another shape
        conic_ip(*instances[0], device="cuda", **kw)
        entry = graph._cache[key]
        ids = {tuple(entry.pool.id), tuple(entry.body_pool.id)}
        check(pools_left(ids) > 0, f"[graph_cache] {label}: no segment in "
              "the entry's pools")
        del entry
        conic_ip(*models.box_qp_dense(n=8).args(), device="cuda")
        other_missed = not solver.runs[0].cache_hit
        check(other_missed, f"[graph_cache] {label}: another shape hit the "
              "cache")
        # past the bound: the key goes once CACHE_SIZE newer entries are
        # kept (the CPU solves above keep entries of their own, older)
        added = 1
        while key in graph.cache_info() and added <= graph.CACHE_SIZE:
            conic_ip(*models.box_qp_dense(n=8 + added).args(), device="cuda")
            added += 1
        check(key not in graph.cache_info() and added == graph.CACHE_SIZE
              and len(graph.cache_info()) == graph.CACHE_SIZE,
              f"[graph_cache] {label}: the entry was evicted after {added} "
              f"newer ones, {len(graph.cache_info())} kept")
        left = pools_left(ids)
        check(left == 0, f"[graph_cache] {label}: {left} segments of the "
              "evicted entry's pools remain")
        line("graph_cache", instance=label, status=first.status,
             Iter=first.Iter, chain=CHAIN, hits=len(hits), captures=1,
             hits_equal_fresh=True,
             cpu_iters=",".join(map(str, cpu_iters)) or "-",
             units=",".join(map(str, units)), polls_per_hit=1,
             first_unchanged=True, reserved_mb=f"{reserved[0] / 2**20:.0f}",
             rcone_hits=rcone,
             other_shape_missed=other_missed, evicted_pool_segments=left,
             ms_hit=spread(ms_hit), ms_miss=spread(ms_miss),
             ms_eager=spread(ms_eager),
             seconds=f"{time.perf_counter() - started:.1f}",
             cpu_seconds=f"{cpu_s:.1f}")
    graph.clear()


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
    recertifications of the mixed residuals, the number of runs (more
    than one: the escalation ladder or an elimination retry ran) and the
    loops they took. A run on the device loop builds once per iteration it
    executed (run_builds)."""
    from conicip_tpu_torch import solver

    out = dict(f32_builds=0, f64_builds=0, lastmile_steps=0, recertified=0,
               runs=len(solver.runs), loops={r.loop for r in solver.runs})
    for r in solver.runs:
        kw = getattr(r.kktsolver, "keywords", {})
        if kw.get("factor_dtype") == torch.float32:
            out["f32_builds"] += r.fast_steps + r.cold_start
            out["f64_builds"] += r.slow_steps
            out["lastmile_steps"] += r.slow_steps
        else:
            out["f64_builds"] += run_builds(r)
        out["recertified"] += r.recertified
    return out


def phase_f32():
    """f32 factors with the last-mile switch, against the f64 solve of the
    same instance from the same run. No speed is asserted."""

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
        # the CPU's solve of the same call, which [graph] ran
        cpu_status, cpu_iter = CPU_REF[f"{label} f32"]
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
        check(abs(cpu_iter - sol.Iter) <= 2 and cpu_status == sol.status,
              f"{label}: cpu {cpu_status}/{cpu_iter} vs gpu "
              f"{sol.status}/{sol.Iter}")
        # conic_ip's own f32 path and the package's generator passed by
        # hand, both on the device loop
        check(stats["loops"] == {"graph"},
              f"{label}: the {stats['loops']} loop ran")
        line("f32", instance=label, status=sol.status, Iter=sol.Iter,
             f64_iter=ref.Iter, cpu_iter=cpu_iter, resid=f"{resid:.3e}",
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
        builds, loop = kkt_builds(), loops()
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
        # n - p, one per KKT build; in f64 it takes the device loop
        check(used == builds and at_order == used and "eager" not in loop,
              f"{P.name}: {used} launches for {builds} KKT builds "
              f"({loop}), {at_order} at order {n - p}")
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
    builds = kkt_builds()
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
    # the direct saddle: the n and the p factor per KKT build
    check(used == 2 * builds, f"{P.name}: {used} launches for {builds} KKT "
          f"builds")
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
    solver, whose two small factors run the kernel. Each is the package's
    own, so conic_ip runs it on the device loop: a miss, then a hit, which
    equals the eager loop (ipm_solve without a device loop) on the same
    operands in status, Iter, KKT builds and launches, y bit for bit."""
    from conicip_tpu_torch import conic_ip, kktsolver_lu, kktsolver_qr, models
    from conicip_tpu_torch import solver
    from conicip_tpu_torch.cones.spec import ConeSpec
    from conicip_tpu_torch.kkt.lowrank import (lowrank_applicable,
                                               lowrank_kktsolver)
    from conicip_tpu_torch.solver import graph, ipm
    from conicip_tpu_torch.solver.state import Solution

    low = lowrank_case()
    check(lowrank_applicable(low.Q, low.A, low.G, ConeSpec(low.cone_dims)),
          "the low-rank backend does not apply to its own family")
    real, seen = graph.solve, {}

    def spy(*args, **kw):
        seen["call"] = (args, kw)
        return real(*args, **kw)

    for name, P, kkt in (("qr", models.mixed_rq_eq(), kktsolver_qr),
                         ("lu", models.mixed_rq_eq(), kktsolver_lu),
                         ("lowrank", low, lowrank_kktsolver())):
        reason = solver._eager_reason(kkt, "cuda")
        check(reason is None, f"{name}: kept on the eager loop: {reason}")
        solve_timed(P.args(), device="cuda", kktsolver=kkt)  # warm-up, miss
        n, p = P.Q.shape[0], P.G.shape[0]
        r = P.A.shape[0] - n + p
        before = {k: launches(n=k) for k in (n, p, r)}
        total = launches()
        graph.solve = spy
        try:
            sol, ms = solve_timed(P.args(), device="cuda", kktsolver=kkt)
        finally:
            graph.solve = real
        (run,) = solver.runs
        by_order = {k: launches(n=k) - v for k, v in before.items()}
        used = launches() - total
        builds = run_stats()["f64_builds"]
        a, kw = seen.pop("call")
        est = {}
        eager_before = {k: launches(n=k) for k in (n, p, r)}
        ref_e = Solution.from_state(ipm.ipm_solve(*a, warm=kw["warm"],
                                                  stats=est))
        eager_by_order = {k: launches(n=k) - v
                          for k, v in eager_before.items()}
        erun = solver.Run(None, ref_e.status, ref_e.Iter, **est)
        ms_e = float(np.median([event_ms(lambda: ipm.ipm_solve(
            *a, warm=kw["warm"])) for _ in range(3)]))
        check(run.loop == "graph" and run.cache_hit,
              f"{name}: loop {run.loop}, cache hit {run.cache_hit}")
        check((sol.status, sol.Iter) == (ref_e.status, ref_e.Iter)
              and torch.equal(sol.y, ref_e.y)
              and builds == run_builds(erun)
              and by_order == eager_by_order,
              f"{name}: hit {sol.status}/{sol.Iter}, {builds} KKT builds, "
              f"launches {by_order}; eager {ref_e.status}/{ref_e.Iter}, "
              f"{run_builds(erun)}, {eager_by_order}, y equal "
              f"{torch.equal(sol.y, ref_e.y)}")
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
            at_r, at_p = by_order[r], by_order[p]
            check(at_r == at_p == builds and by_order[n] == 0
                  and used == 2 * builds,
                  f"lowrank: {at_r} launches at r={r}, {at_p} at p={p}, "
                  f"{by_order[n]} at n={n}, {used} in all, for {builds} KKT "
                  f"builds")
            extra = dict(r=r, p=p, launches_at_r=at_r, launches_at_p=at_p,
                         launches_at_n=0)
        else:
            check(used == 0, f"{name}: {used} Cholesky launches")
        line("backends", backend=name, instance=P.name, status=sol.status,
             Iter=sol.Iter, cpu_iter=ref.Iter, resid=f"{resid:.3e}",
             y_diff=f"{dy:.3e}", loop=run.loop, cache_hit=run.cache_hit,
             polls=run.polls, replays=run.replays, kkt_builds=builds,
             y_equal_eager=True, launches=used, ms_per_solve=f"{ms:.2f}",
             eager_ms_per_solve=f"{ms_e:.2f}", **extra)
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
    from conicip_tpu_torch.parallel import batch as pbatch

    label, args = batch_cases()[1][:2]
    timed_batch(args, kktsolver=kkt)  # warm-up
    before = Counter(cholesky_kernel.cholesky_launches)
    out, ms = timed_batch(args, kktsolver=kkt)
    got, singles = launched_since(before)
    loops = [(r.loop, r.cache_hit) for r in pbatch.runs]
    resid = torch.maximum(out.prFeas, torch.maximum(
        out.duFeas, out.muFeas)).max().item()
    statuses, iters = out.statuses, out.Iter.tolist()
    what = f"{name} on {label}"
    # the package's backend passed by hand: the device loop, a hit
    check(loops == [("graph", True)], f"{what}: (loop, cache hit) {loops}")
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
         y_diff_single=f"{dy:.3e}", launches=0, loop="graph", cache_hit=True,
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
    shapes = {(BATCH, PLANTED_N), (BATCH, tri(BACKSTOP_K)),
              (SDP_LARGE_STACK[0], tri(SDP_LARGE_STACK[1]))}
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
    factor per order of its backend and per KKT build of a run
    (run_builds: its cold start, twice on a device loop's miss, and every
    step)."""
    from conicip_tpu_torch.kkt.lowrank import lowrank_kktsolver
    from conicip_tpu_torch.kkt.spectral import spectral_kktsolver

    want = Counter()
    for r in runs:
        builds = run_builds(r)
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
    from conicip_tpu_torch.cones.spec import ConeSpec
    from conicip_tpu_torch.ops import cholesky_kernel
    from conicip_tpu_torch.parallel import batch as pbatch

    for label, args, kw, single_kw, orders in batch_cases():
        f32 = "factor_dtype" in kw
        timed_batch(args, **kw)  # warm-up
        before = Counter(cholesky_kernel.cholesky_launches)
        jbefore, rbefore = jacobi_launches(), rcone_counts()
        out, ms = timed_batch(args, **kw)
        jused = jacobi_launches() - jbefore
        # solve_batch runs one Gondzio corrector by default
        rcone = rcone_launched(label, rcone_counts() - rbefore,
                               ConeSpec(args[4]).only_r,
                               kw.get("centralityCorrectors", 1) > 0)
        runs = list(pbatch.runs)
        got, singles = launched_since(before)
        # the solver's own runs (f64, f32 factors with mixed residuals,
        # the S-cone policy behind f32, the fused tiers) take the device
        # loop, hits after the warm-up
        check(all((r.loop, r.cache_hit) == ("graph", True) for r in runs
                  if not r.tier.startswith("backstop")),
              f"{label}: the runs took the loops "
              f"{[(r.tier, r.loop, r.cache_hit) for r in runs]}")
        check(all(r.loop == "eager" for r in runs
                  if r.tier.startswith("backstop")),
              f"{label}: a backstop sub-batch left the eager loop")
        check((jused > 0) == has_sdp(args[4]),
              f"{label}: {jused} Jacobi launches")
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
             loops="+".join(r.loop for r in runs),
             batched_launches=",".join(
                 f"{str(dt).split('.')[-1]}@{k}:{v}"
                 for (dt, k), v in sorted(got.items(), key=str)) or "none",
             kkt_builds=sum(want.values()), ridge_retries=retries,
             jacobi_launches=jused, rcone=rcone,
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


def phase_batch_graph():
    """Each stack of batch_cases() (f64, and f32 with mixed residuals) on
    the device loop and on the eager loop, on the same device operands, as
    [graph] holds the single solves: the operands solve_batch's main run
    gave graph.solve; a miss after
    graph.clear() (the batched launches it made, one more cold-start factor
    per order than a hit, and the memory the card reserved for the entry),
    the eager loop (ipm_solve without a device loop) and a hit: per
    instance the same status and Iter, also as the CPU's, y bit for bit,
    the same KKT builds, recomputes, refinement trips and kernel launches
    by entry and dtype (launch_counts); a hit and the miss read the
    device once (the final copy), replay the loop's WHILE node once and
    run the eager loop's steps as units, a hit copies at most once to the
    host inside the loop, and the host launches no kernel during the
    replays. ms per stack (median, least and most of 3, CUDA events): hit,
    miss and the eager loop; kernels and device-to-host copies per
    iteration of the stack (profiler). An f32 stack's Iter is held within
    2 of the CPU's. Then a stack split across the variants
    (split_stack_of_variants)."""
    from conicip_tpu_torch import solve_batch
    from conicip_tpu_torch.ops import cholesky_kernel
    from conicip_tpu_torch.parallel import batch as pbatch
    from conicip_tpu_torch.solver import graph, ipm

    real, seen = graph.solve, []

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    for label, args, kw, _, orders in batch_cases():
        f32 = "factor_dtype" in kw
        graph.solve = spy
        try:
            full = solve_batch(*args, device="cuda", **kw)
        finally:
            graph.solve = real
        # the main run, which the fused tiers (f32) may follow
        main = pbatch.runs[0]
        (a, akw) = seen[0]
        seen.clear()

        def graphed(stats=None):
            return pbatch.BatchSolution.from_state(
                real(*a, warm=akw["warm"], stats=stats))

        def eager(stats=None):
            return pbatch.BatchSolution.from_state(
                ipm.ipm_solve(*a, warm=akw["warm"], stats=stats))

        def run_of(sol, stats):
            return pbatch.BatchRun(main.kktsolver, "main",
                                   tuple(sol.status.tolist()),
                                   tuple(sol.Iter.tolist()), **stats)

        graph.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = Counter(cholesky_kernel.cholesky_launches)
        fst = {}
        first = graphed(fst)
        torch.cuda.synchronize()
        got, singles = launched_since(before)
        torch.cuda.empty_cache()
        entry_mb = (torch.cuda.memory_reserved() - reserved) / 2**20
        est, hst = {}, {}
        ref, eager_launches = counted(lambda: eager(est))
        hit, hit_launches = counted(lambda: graphed(hst))
        frun, erun, run = (run_of(first, fst), run_of(ref, est),
                           run_of(hit, hst))
        statuses, iters = first.statuses, first.Iter.tolist()
        check(main.loop == "graph" and frun.loop == "graph"
              and not frun.cache_hit and run.cache_hit,
              f"[batch_graph] {label}: solve_batch's main run took the "
              f"{main.loop} loop; a miss after clear() hit "
              f"{frun.cache_hit}, the next call hit {run.cache_hit}")
        check(statuses == ref.statuses == hit.statuses
              and iters == ref.Iter.tolist() == hit.Iter.tolist(),
              f"[batch_graph] {label}: statuses or Iter differ between the "
              f"miss, the eager loop and the hit")
        dy = (first.y - ref.y).abs().max().item()
        check(dy == 0 and torch.equal(hit.y, first.y),
              f"[batch_graph] {label}: |y - y_eager| {dy:.3e}, hit equal "
              f"to the miss {torch.equal(hit.y, first.y)}")
        builds, ebuilds, mbuilds = (run_builds(run), run_builds(erun),
                                    run_builds(frun))
        check(builds == ebuilds and run.fast_steps == erun.fast_steps
              and run.recertified == erun.recertified
              and mbuilds == ebuilds + 1,
              f"[batch_graph] {label}: {builds} KKT builds on a hit, "
              f"{mbuilds} on a miss, {ebuilds} on the eager loop; "
              f"{run.recertified} and {erun.recertified} recomputes")
        check(hit_launches == eager_launches,
              f"[batch_graph] {label}: launches {dict(hit_launches)} on a "
              f"hit, {dict(eager_launches)} on the eager loop")
        want = expected_batched_launches([frun], orders)
        check(got == want and singles == 0,
              f"[batch_graph] {label}: a miss launched {dict(got)} batched "
              f"factors for {dict(want)} and {singles} single ones")
        check(run.trips == erun.trips,
              f"[batch_graph] {label}: {run.trips} refinement trips on the "
              f"device loop, {erun.trips} on the eager loop")
        steps = erun.fast_steps + erun.slow_steps
        units = ipm.POLL * -(-steps // ipm.POLL)
        check(run.polls == frun.polls == 1
              and run.replays == frun.replays == 1
              and run.units == frun.units == units,
              f"[batch_graph] {label}: {run.polls} polls, {run.replays} "
              f"replays, {run.units} units on a hit, {frun.polls}, "
              f"{frun.replays}, {frun.units} on a miss, for {steps} steps "
              f"of the eager loop at POLL {ipm.POLL}")
        ms_hit = [event_ms(graphed) for _ in range(3)]
        ms_eager = [event_ms(eager) for _ in range(3)]
        pg = profiled(graphed)
        pe = profiled(eager)
        check(pg["dtoh_loop"] <= 1 and pg["replay_host_launches"] == 0,
              f"[batch_graph] {label}: {pg['dtoh_loop']} device-to-host "
              f"copies in the loop, {pg['replay_host_launches']} host "
              f"launches during replays")
        ms_miss = []
        for _ in range(3):
            graph.clear()
            ms_miss.append(event_ms(graphed))
        cpu_full = solve_batch(*(x.cpu() if isinstance(x, torch.Tensor)
                                 else x for x in args), device="cpu", **kw)
        cpu = pbatch.runs[0]  # the CPU's main run
        if f32:
            # f32 rounding decides which instances stall near the
            # tolerance for the tiers behind to finish, on the card and on
            # the CPU alike: the call's answers agree, and Iter within 2
            # where the main run finished an instance on both
            both = [i for i, (a_, b_) in enumerate(zip(
                cpu.status, first.status.tolist())) if a_ == b_ == 1]
            band = max((abs(cpu.Iter[i] - iters[i]) for i in both),
                       default=0)
            check(cpu_full.statuses == full.statuses and band <= 2,
                  f"[batch_graph] {label}: card {Counter(full.statuses)}, "
                  f"cpu {Counter(cpu_full.statuses)}, main-run Iter {band} "
                  f"apart")
        else:
            band = max(abs(i - j) for i, j in zip(cpu.Iter, iters))
            check(list(cpu.status) == first.status.tolist() and band == 0,
                  f"[batch_graph] {label}: card {Counter(statuses)}, cpu "
                  f"{Counter(cpu.status)}, Iter {band} apart")
        it = max(iters)
        line("batch_graph", family=repr(label), B=BATCH,
             status=",".join(f"{k}x{v}" for k, v in
                             sorted(Counter(statuses).items())),
             Iter=f"{min(iters)}-{it}",
             cpu_iter=f"within {band}" if f32 else "equal",
             loop=run.loop, cache_hit=run.cache_hit,
             y_diff_eager=f"{dy:.3e}", kkt_builds_graph=builds,
             kkt_builds_miss=mbuilds, kkt_builds_eager=ebuilds,
             recertified=run.recertified,
             launches=",".join(f"{k}:{v}" for k, v in
                               sorted(hit_launches.items())),
             trips_per_iter_graph=f"{run.trips / it:.2f}",
             trips_per_iter_eager=f"{erun.trips / it:.2f}",
             poll=ipm.POLL, polls=run.polls, replays=run.replays,
             units=run.units, ms_hit=spread(ms_hit), ms_miss=spread(ms_miss),
             ms_eager=spread(ms_eager),
             dtoh_per_iter_graph=f"{pg['dtoh'] / it:.2f}",
             dtoh_per_iter_eager=f"{pe['dtoh'] / it:.2f}",
             dtoh_loop=pg["dtoh_loop"], dtoh_fixed=pg["dtoh_fixed"],
             kernels_per_iter_graph="not_measured",  # WHILE body: profiled()
             kernels_per_iter_eager=f"{pe['kernels'] / it:.1f}",
             replay_host_launches=pg["replay_host_launches"],
             reserved_mb_entry=f"{entry_mb:.1f}")
        del first, ref, hit, a, akw
    graph.clear()
    split_stack_of_variants()
    graph.clear()


def split_stack_of_variants():
    """A stack of BATCH box QPs on the two-variant f32 generator (the
    last-mile Schur solver, mixed residuals) through graph.solve, whose
    instances enter the full-precision variant on different iterations:
    on some iteration both variants' conditional bodies run, each instance
    taking its own. No solve_batch route reaches this (its f32 generator
    has one variant); the device loop's handling of it is held to the
    eager loop on the same operands (per instance the same status and
    Iter, y bit for bit, the same steps per variant, recomputes, trips and
    launches by entry and dtype: one f32 factor per fast build, one f64
    factor per last-mile build) and to the CPU (Iter within 2)."""
    from conicip_tpu_torch import models, solver
    from conicip_tpu_torch.cones.spec import ConeSpec
    from conicip_tpu_torch.solver import graph, ipm
    from conicip_tpu_torch.solver.state import STATUS_NAMES

    f32 = torch.float32
    Q, c, A, b, cones = on_card(models.batched_box_qp(BATCH, n=PLANTED_N,
                                                      seed=4))
    n = c.shape[-1]
    G = torch.zeros(BATCH, 0, n, dtype=c.dtype, device="cuda")
    d = torch.zeros(BATCH, 0, dtype=c.dtype, device="cuda")
    rest = (ConeSpec(cones), solver._default_kktsolver(f32, lastmile=True),
            ipm.IPMOptions(mixedResiduals=True, lastmileProactive=50.0,
                           optTol=1e-9))
    a = (Q, c, A, b, G, d)
    label = f"batched_box_qp(64,n={PLANTED_N}) two-variant f32"
    graph.clear()
    fst, est, hst = {}, {}, {}
    first = graph.solve(*a, *rest, stats=fst)
    ref, eager_launches = counted(lambda: ipm.ipm_solve(*a, *rest,
                                                        stats=est))
    hit, hit_launches = counted(lambda: graph.solve(*a, *rest, stats=hst))
    counts = ("fast_steps", "slow_steps", "recertified", "trips")
    steps = est["polls"] - est["recertified"] - 1  # iterations stepped
    check(fst["loop"] == hst["loop"] == "graph" and hst["cache_hit"],
          f"[batch_graph] {label}: loops {fst['loop']}, {hst['loop']}, hit "
          f"{hst['cache_hit']}")
    check(torch.equal(first.status, ref.status)
          and torch.equal(first.Iter, ref.Iter)
          and torch.equal(first.y, ref.y) and torch.equal(hit.y, first.y),
          f"[batch_graph] {label}: the device loop differs from the eager "
          f"loop")
    check(all(hst[k] == est[k] for k in counts)
          and hit_launches == eager_launches,
          f"[batch_graph] {label}: {[hst[k] for k in counts]} {counts} and "
          f"launches {dict(hit_launches)} on a hit, "
          f"{[est[k] for k in counts]} and {dict(eager_launches)} on the "
          f"eager loop")
    check(hst["polls"] == 1 and hst["units"] == ipm.POLL * -(
        -steps // ipm.POLL),
          f"[batch_graph] {label}: {hst['polls']} polls and {hst['units']} "
          f"units on a hit for {steps} steps")
    check(hst["slow_steps"] > 0 and hst["fast_steps"] + hst["slow_steps"]
          > steps,
          f"[batch_graph] {label}: no iteration split across the variants "
          f"({hst['fast_steps']} fast, {hst['slow_steps']} slow, {steps} "
          f"steps)")
    check(hit_launches["cholesky_float32"] == 1 + hst["fast_steps"]
          and hit_launches["cholesky_float64"] == hst["slow_steps"],
          f"[batch_graph] {label}: launches {dict(hit_launches)} for "
          f"{hst['fast_steps']} fast and {hst['slow_steps']} slow steps")
    cpu = graph.solve(*(x.cpu() for x in a), *rest)
    band = int((cpu.Iter - first.Iter.cpu()).abs().max())
    check(torch.equal(cpu.status, first.status.cpu()) and band <= 2,
          f"[batch_graph] {label}: cpu status or Iter ({band} apart)")
    ms_hit = [event_ms(lambda: graph.solve(*a, *rest)) for _ in range(3)]
    ms_eager = [event_ms(lambda: ipm.ipm_solve(*a, *rest))
                for _ in range(3)]
    statuses = Counter(STATUS_NAMES[s] for s in first.status.tolist())
    line("batch_graph", family=repr(label), B=BATCH,
         status=",".join(f"{k}x{v}" for k, v in sorted(statuses.items())),
         Iter=f"{int(first.Iter.min())}-{int(first.Iter.max())}",
         cpu_iter=f"within {band}", steps=steps,
         fast_steps=hst["fast_steps"], slow_steps=hst["slow_steps"],
         split_iterations=hst["fast_steps"] + hst["slow_steps"] - steps,
         recertified=hst["recertified"], trips=hst["trips"],
         launches=",".join(f"{k}:{v}" for k, v in
                           sorted(hit_launches.items())),
         launches_equal_eager=True, y_diff_eager="0.000e+00",
         polls=hst["polls"], replays=hst["replays"], units=hst["units"],
         ms_hit=spread(ms_hit), ms_eager=spread(ms_eager))


def phase_checkpoint():
    """solve_batch_resumable stopped after its first chunk and resumed in
    chunks of the same size: each chunk a warm stacked solve of one
    configuration, so the resumed chunks after the first hit the device
    loop's entry."""
    from conicip_tpu_torch import models, solve_batch
    from conicip_tpu_torch.parallel import batch as pbatch
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
        chunks = []

        def recorded(*a, **k):
            out = orig(*a, **k)
            chunks.append([(r.loop, r.cold_start, r.cache_hit)
                           for r in pbatch.runs])
            return out

        cp.solve_batch = recorded
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = cp.solve_batch_resumable(*args, store=store, chunk_iters=3,
                                           maxIters=60, device="cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        finally:
            cp.solve_batch = orig
        done = cp.load_snapshot(store)
    # the first resumed chunk builds the warm entry, every later one hits it
    check(len(chunks) >= 2 and chunks[0] == [("graph", 0, False)]
          and all(c == [("graph", 0, True)] for c in chunks[1:]),
          f"checkpoint: resumed chunks' (loop, cold start, cache hit) "
          f"{chunks}")
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
         resumed="Optimal x64", resumed_chunks=len(chunks),
         resumed_hits=sum(c[0][2] for c in chunks),
         Iter=f"{int(out.Iter.min())}-"
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
        before, jbefore = launches(), jacobi_launches()
        got = through_frontend(route, P, options)  # on the card by default
        used, jused = launches() - before, jacobi_launches() - jbefore
        builds = kkt_builds()
        check((jused > 0) == has_sdp(P.cone_dims),
              f"{what}: {jused} Jacobi launches")
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
        need = {"iter": builds, "none": 0}[rule]
        check(used == need,
              f"{what}: {used} kernel launches for {builds} KKT builds "
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
             jacobi_launches=jused,
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
    # every tier on the device loop, each its own entry of the cache
    # (CACHE_SIZE of them): after the warm-up, every one a hit
    check(all((r.loop, r.cache_hit) == ("graph", True) for r in runs),
          f"{what}: {[(r.loop, r.cache_hit) for r in runs]}")
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
         loops=">".join(f"{r.loop}:{'hit' if r.cache_hit else 'miss'}"
                        for r in runs),
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


CUSTOM_BOX_N = 1000  # [custom_kkt] (a): the README box QP
CUSTOM_DENSE_N = 1024  # (b)-(d): box_qp_dense
CUSTOM_CHAIN = 6  # chained hits of (a) and (b) after their miss


def schur_matrix(Q, A, F):
    """Q + Aᵀ(FᵀF)⁻¹A for R cones (F = diag(r_d))."""
    winv = 1.0 / (F.r_d * F.r_d)
    return Q + A.mT @ (winv[..., :, None] * A)


def dense_schur_2x2(Q, A, G, spec):
    """A caller's own dense Schur 2x2 solver (R cones, no equalities),
    written with the port's public ``ops.cholesky`` and ``ops.cho_solve``
    only: the Cholesky kernel, launched from a caller's level 2."""
    from conicip_tpu_torch.ops import cho_solve, cholesky

    def solve2x2gen(F, FinvT):
        L = cholesky(schur_matrix(Q, A, F))
        return lambda by, bw: (cho_solve(L, by), bw)

    return solve2x2gen


def dense_schur_2x2_linalg(Q, A, G, spec):
    """The same solver factoring with ``torch.linalg.cholesky``, which
    checks ``info`` on the host: it reads the device."""
    from conicip_tpu_torch.ops import cho_solve

    def solve2x2gen(F, FinvT):
        L = torch.linalg.cholesky(schur_matrix(Q, A, F))
        return lambda by, bw: (cho_solve(L, by), bw)

    return solve2x2gen


def through(fn, real, seen):
    """``fn()`` with ``graph.solve`` replaced by a spy that keeps the
    operands of its latest call in ``seen``."""
    from conicip_tpu_torch.solver import graph

    def spy(*a, **k):
        seen["call"] = (a, k)
        seen["calls"] = seen.get("calls", 0) + 1
        return real(*a, **k)

    graph.solve = spy
    try:
        return fn()
    finally:
        graph.solve = real


def custom_case(label, P, kkt):
    """(a) or (b): a caller's kktsolver made once, a miss and a hit
    through conic_ip, the hit held to the eager loop on the operands
    conic_ip handed graph.solve (status, Iter, KKT builds, trips and
    Cholesky launches by order equal, y bit for bit) and to the CPU
    (status, Iter); CUSTOM_CHAIN chained hits; ms of a hit and of the
    eager loop, chained; DtoH and kernels per iteration and host launches
    during replays (profiler). Returns the hit's solution."""
    from conicip_tpu_torch import conic_ip, solver
    from conicip_tpu_torch.solver import graph, ipm
    from conicip_tpu_torch.solver.state import Solution

    what = f"[custom_kkt] {label}"
    args = on_card(P)
    real, seen = graph.solve, {}
    through(lambda: conic_ip(*args, kktsolver=kkt, device="cuda"), real,
            seen)
    miss = solver.runs[-1]
    a, akw = seen.pop("call")
    before = chol_by_order()
    sol = conic_ip(*args, kktsolver=kkt, device="cuda")
    run = solver.runs[-1]
    hit_launches = chol_by_order() - before

    def eager(stats=None):
        return Solution.from_state(ipm.ipm_solve(*a, warm=akw["warm"],
                                                 stats=stats))

    def graphed(stats=None):
        return Solution.from_state(real(*a, warm=akw["warm"], stats=stats))

    est = {}
    before = chol_by_order()
    ref = eager(est)
    eager_launches = chol_by_order() - before
    erun = solver.Run(None, ref.status, ref.Iter, **est)
    builds = run_builds(run)
    check(miss.loop == run.loop == "graph" and not miss.cache_hit
          and run.cache_hit and run.replays > 0,
          f"{what}: loops {miss.loop}/{run.loop}, hits "
          f"{miss.cache_hit}/{run.cache_hit}, {run.replays} replays")
    check((sol.status, sol.Iter) == (ref.status, ref.Iter)
          and torch.equal(sol.y, ref.y),
          f"{what}: hit {sol.status}/{sol.Iter}, eager "
          f"{ref.status}/{ref.Iter}, y equal {torch.equal(sol.y, ref.y)}")
    check(builds == run_builds(erun) and run.trips == erun.trips
          and hit_launches == eager_launches,
          f"{what}: {builds} KKT builds, {run.trips} trips, launches "
          f"{dict(hit_launches)} on a hit; {run_builds(erun)}, "
          f"{erun.trips}, {dict(eager_launches)} on the eager loop")
    units = ipm.POLL * -(-(erun.fast_steps + erun.slow_steps) // ipm.POLL)
    check(run.polls == 1 and run.replays == 1 and run.units == units,
          f"{what}: {run.polls} polls, {run.replays} replays, {run.units} "
          f"units on a hit, for {units} units of the eager loop's steps")
    cpu = conic_ip(*P, kktsolver=kkt, device="cpu")
    check((cpu.status, cpu.Iter) == (sol.status, sol.Iter)
          and solver.runs[-1].loop == "chunks",
          f"{what}: cpu {cpu.status}/{cpu.Iter} on "
          f"{solver.runs[-1].loop}, card {sol.status}/{sol.Iter}")
    hits, ms_hit = chained_ms(lambda: (
        conic_ip(*args, kktsolver=kkt, device="cuda"),
        solver.runs[-1].cache_hit), CUSTOM_CHAIN)
    check(all(h for _, h in hits)
          and all(torch.equal(x.y, sol.y) for x, _ in hits),
          f"{what}: a chained solve missed or differs from the first hit")
    _, ms_eager = chained_ms(eager, CUSTOM_CHAIN)
    pg, pe = profiled(graphed), profiled(eager)
    check(pg["dtoh_loop"] <= 1 and pg["replay_host_launches"] == 0,
          f"{what}: {pg['dtoh_loop']} device-to-host copies in the loop, "
          f"{pg['replay_host_launches']} host launches during replays")
    by_order = {f"{dtname(k[0])}@{k[1]}": v for k, v in
                sorted(hit_launches.items(), key=str)}
    it = max(sol.Iter, 1)
    line("custom_kkt", case=repr(label), loop=run.loop,
         cache_hit=run.cache_hit, polls=run.polls, replays=run.replays,
         units=run.units,
         trips=run.trips, status=sol.status, Iter=sol.Iter,
         cpu_iter=cpu.Iter, y_diff_eager=f"{(sol.y - ref.y).abs().max():.3e}",
         kkt_builds=builds, cholesky_launches_hit=by_order or "none",
         launches_equal_eager=True,
         ms_per_solve_hit=f"{ms_hit:.2f}",
         ms_per_solve_eager=f"{ms_eager:.2f}", chained=CUSTOM_CHAIN,
         dtoh_per_iter_graph=f"{pg['dtoh'] / it:.2f}",
         dtoh_per_iter_eager=f"{pe['dtoh'] / it:.2f}",
         kernels_per_iter_graph="not_measured",  # WHILE body: profiled()
         kernels_per_iter_eager=f"{pe['kernels'] / it:.1f}",
         replay_host_launches=pg["replay_host_launches"])
    return sol


def dense_schur_2x2_from_host(Q, A, G, spec):
    """``dense_schur_2x2`` whose level 1 makes a tensor of host data on the
    card (a pageable host-to-device copy)."""
    one = torch.as_tensor(np.ones(1), device=Q.device)
    return dense_schur_2x2(one * Q, A, G, spec)


def reads_the_device_case(P, ref, factor, label):
    """(c): the dense solver reading the device (``factor``: on
    ``torch.linalg.cholesky``, which checks ``info`` on the host, or making
    a tensor of host data in its level 1). The first call runs its
    callbacks under the guard before any capture, finds the read and
    solves on the eager loop (its reason naming the call ``label``; no
    capture attempted, no entry kept or stranded); the second call decides
    before the solve (graph.solve is not called). Both give (b)'s status
    and Iter (``ref``)."""
    from conicip_tpu_torch import pivot, solver
    from conicip_tpu_torch.solver import graph, ipm

    what = f"[custom_kkt] (c) {label}"
    kkt = pivot(factor)
    args = on_card(P)
    stranded, captures = len(graph._stranded), []
    real_capture, real, seen = graph._capture, graph.solve, {}

    def spy_capture(entry, fn):
        captures.append(fn)
        return real_capture(entry, fn)

    graph._capture = spy_capture
    try:
        first, ms_first = through(lambda: solve_timed(
            args, kktsolver=kkt, device="cuda"), real, seen)
        r1 = solver.runs[-1]
        decided = solver._eager_reason(kkt, "cuda")
        second, ms_second = through(lambda: solve_timed(
            args, kktsolver=kkt, device="cuda"), real, seen)
        r2 = solver.runs[-1]
    finally:
        graph._capture = real_capture
    check(r1.loop == r2.loop == "eager" and label in (r1.reason or ""),
          f"{what}: loops {r1.loop}/{r2.loop}, reason {r1.reason!r}")
    check(not captures and len(graph._stranded) == stranded
          and not any(k[5] is kkt for k in graph.cache_info()),
          f"{what}: {len(captures)} captures, "
          f"{len(graph._stranded) - stranded} entries stranded")
    check(seen.get("calls") == 1 and decided == r1.reason == r2.reason,
          f"{what}: graph.solve called {seen.get('calls')} times, the "
          f"second call's reason {r2.reason!r}")
    check(all((s.status, s.Iter) == (ref.status, ref.Iter)
              for s in (first, second)),
          f"{what}: {first.status}/{first.Iter}, {second.status}/"
          f"{second.Iter}; (b) {ref.status}/{ref.Iter}")
    line("custom_kkt", case=repr(f"(c) dense Schur 2x2 reading the device: "
                                 f"{label}"),
         loop=r1.loop, second_call=r2.loop, status=first.status,
         Iter=first.Iter, captures=len(captures),
         stranded=len(graph._stranded) - stranded,
         decided_before_the_solve=True,
         y_diff_b=f"{(first.y - ref.y).abs().max():.3e}",
         ms_first=f"{ms_first:.2f}", ms_second=f"{ms_second:.2f}",
         reason=repr(r1.reason))


def printed(fn):
    """``fn()``'s standard output and the latest conic_ip run."""
    import contextlib
    import io

    from conicip_tpu_torch import solver

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue(), solver.runs[-1]


def verbose_case(P):
    """(d): ``verbose=True`` with the default backend on the device loop,
    a miss and a hit, each printing exactly what the eager loop (the rule
    overridden for this one call) prints, row for row; on a hit one
    device-to-host copy per poll (the flag and the unit's row) and no
    host launch during the replays; ms of a hit and of the eager loop,
    chained, printing to a buffer, beside a hit without verbose output."""
    from conicip_tpu_torch import conic_ip, solver
    from conicip_tpu_torch.solver import graph

    what = "[custom_kkt] (d)"
    args = on_card(P)

    def solve(**kw):
        return conic_ip(*args, device="cuda", verbose=True, **kw)

    def eager_rule(*a):
        return "the eager loop, for comparison"

    def eager():
        real = solver._eager_reason
        solver._eager_reason = eager_rule
        try:
            return solve()
        finally:
            solver._eager_reason = real

    out_miss, miss = printed(solve)
    out_hit, hit = printed(solve)
    out_eager, erun = printed(eager)
    rows = [ln for ln in out_eager.splitlines()
            if ln.count("│") == 4 and "Iter" not in ln]
    check(miss.loop == hit.loop == "graph" and not miss.cache_hit
          and hit.cache_hit and erun.loop == "eager",
          f"{what}: loops {miss.loop}/{hit.loop}/{erun.loop}, hits "
          f"{miss.cache_hit}/{hit.cache_hit}")
    check(out_miss == out_eager and out_hit == out_eager
          and len(rows) == 1 + hit.fast_steps,
          f"{what}: {len(rows)} rows on the eager loop for "
          f"{hit.fast_steps} steps; the miss's text equal "
          f"{out_miss == out_eager}, the hit's {out_hit == out_eager}")
    pg = profiled(lambda: printed(solve))
    check(pg["dtoh_loop"] <= hit.polls and pg["replay_host_launches"] == 0,
          f"{what}: {pg['dtoh_loop']} device-to-host copies in the loop for "
          f"{hit.polls} polls, {pg['replay_host_launches']} host launches "
          f"during replays")
    _, ms_hit = chained_ms(lambda: printed(solve), CUSTOM_CHAIN)
    _, ms_eager = chained_ms(lambda: printed(eager), CUSTOM_CHAIN)
    conic_ip(*args, device="cuda")  # the entry without verbose output
    _, ms_quiet = chained_ms(lambda: conic_ip(*args, device="cuda"),
                             CUSTOM_CHAIN)
    check(solver.runs[-1].cache_hit, f"{what}: the solve without verbose "
          "output missed")
    it = max(hit.fast_steps, 1)
    line("custom_kkt", case="'(d) verbose=True, default backend'",
         loop=hit.loop, cache_hit=hit.cache_hit, polls=hit.polls,
         replays=hit.replays, rows=len(rows), text_equal_eager=True,
         dtoh_loop=pg["dtoh_loop"], dtoh_per_iter=f"{pg['dtoh'] / it:.2f}",
         replay_host_launches=pg["replay_host_launches"],
         ms_per_solve_hit=f"{ms_hit:.2f}",
         ms_per_solve_eager=f"{ms_eager:.2f}",
         ms_per_solve_hit_quiet=f"{ms_quiet:.2f}", chained=CUSTOM_CHAIN,
         entries=len(graph.cache_info()))


def phase_custom_kkt():
    """A caller's own kktsolver and verbose output on the device loop:
    (a) the example's box 2x2 solver on the README box QP and (b) a dense
    Schur 2x2 solver on the port's ops.cholesky, each made once, a miss
    then hits (custom_case); (c) the same solver on
    torch.linalg.cholesky, and with a host-to-device copy in its level 1,
    each reading the device and keeping the eager loop
    (reads_the_device_case); (d) verbose output (verbose_case)."""
    from conicip_tpu_torch import models, pivot
    from conicip_tpu_torch.trace import example_box_kktsolver

    dense = models.box_qp_dense(n=CUSTOM_DENSE_N, seed=42).args()
    custom_case(f"(a) examples/torch/custom_kkt.py box_kktsolver, README "
                f"box n={CUSTOM_BOX_N}", diag_args(False, CUSTOM_BOX_N),
                example_box_kktsolver())
    ref = custom_case(f"(b) dense Schur 2x2 on ops.cholesky, box_qp_dense "
                      f"n={CUSTOM_DENSE_N}", dense, pivot(dense_schur_2x2))
    reads_the_device_case(dense, ref, dense_schur_2x2_linalg,
                          "torch.linalg.cholesky")
    reads_the_device_case(dense, ref, dense_schur_2x2_from_host,
                          "torch.as_tensor")
    verbose_case(dense)


DIST_N = 4096  # box_qp_dense order of [distributed]'s world of one
DIST_PAIR_N = 1024  # ... and of its two ranks sharing the card
DIST_RANKS = 2
DIST_TIMEOUT = 300.0  # seconds the two ranks may take in all
TP_CHAIN = 5  # chained hits of each TP solve of the world of one


@functools.lru_cache(maxsize=None)
def multichip_problem():
    """The production-sized problem the reference's multichip dry run
    solves through its kktsolver_schur_tp (``__graft_entry__.py``): n = 512,
    R(1024) x Q(32) x Q(32), m = 1088, p = 16, diagonal Q, strictly
    feasible (``trace.rq_eq`` at seed 0)."""
    from conicip_tpu_torch.trace import rq_eq

    return rq_eq(seed=0)


@functools.lru_cache(maxsize=None)
def retry_problem(n=1024, delta=1e-12):
    """``box_qp_dense(n)`` beside two free variables whose 2x2 block of Q,
    [[1, 1 + delta], [1 + delta, 1]], has the eigenvalue -delta: beyond
    the distributed factor's base ridge (30 eps = 6.7e-15) and within its
    retry's (1e5 times it), so every KKT build's first factor fails and
    the retry, the body of a conditional graph node, factors it. The free
    variables' gradient is 0, so they stay 0, and the rest is the box QP."""
    from conicip_tpu_torch import models

    Q, c, A, b, cones = models.box_qp_dense(n=n).args()[:5]
    Q2 = np.zeros((n + 2, n + 2))
    Q2[:n, :n] = Q
    Q2[n:, n:] = [[1.0, 1.0 + delta], [1.0 + delta, 1.0]]
    return models.Problem(f"box_qp_dense(n={n})+indefinite_2x2", Q2,
                          np.r_[c, 0.0, 0.0],
                          np.hstack([A, np.zeros((A.shape[0], 2))]), b,
                          cones)


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
        # every KKT build's first factor fails and retries
        (retry_problem().name, retry_problem(), {}, {}, False),
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


def tp_solve(P, kkt, **kw):
    """P through the TP solver ``kkt`` on the card, from inputs already
    there: (solution, ms, KKT builds, unconditional kernel launches of the
    solve)."""
    from conicip_tpu_torch import conic_ip, solver
    from conicip_tpu_torch.ops import cholesky_kernel

    before = Counter(cholesky_kernel.cholesky_launches)
    args = on_card(P.args())
    torch.cuda.synchronize()
    t = time.perf_counter()
    sol = conic_ip(*args, kktsolver=kkt, device="cuda", **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return (sol, ms, run_builds(solver.runs[-1]),
            cholesky_kernel.cholesky_launches - before)


def chol_by_order():
    """The Cholesky kernel's launches so far by (dtype, order), the
    predicated ones apart ("pred", dtype, order)."""
    from conicip_tpu_torch.ops import cholesky_kernel

    return Counter(cholesky_kernel.cholesky_launches) + Counter(
        {("pred",) + k: v for k, v in
         cholesky_kernel.predicated_launches.items()})


def chained_ms(fn, k):
    """``fn()`` k times back to back, synchronised at the two ends: the
    results and ms per call."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = [fn() for _ in range(k)]
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3 / k


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
    distributed_cases() on the device loop (tp_case: a miss and chained
    hits, against the eager loop bit for bit and against the port's
    single-device Schur solve with 0 correctors, and its CPU solve where it
    is small; one case retries every factor), solve_batch over a mesh
    against the unsharded stack; (b) two ranks sharing the card (gloo, so
    the eager loop), this script run with --distributed-rank. Returns the
    Cholesky and the Jacobi launches the two ranks made, which main()
    counts as this phase's."""
    import torch.distributed as dist

    from conicip_tpu_torch import make_mesh, models, solve_batch
    from conicip_tpu_torch.parallel import batch as pbatch
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
            loops = [(r.loop, r.cache_hit) for r in pbatch.runs]
            check(loops == [("graph", True)],
                  f"solve_batch over a mesh of one: (loop, cache hit) "
                  f"{loops}")
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
                 loop="graph", ms_per_batch=f"{ms:.2f}",
                 unsharded_ms=f"{plain_ms:.2f}")
        finally:
            dist.destroy_process_group()
    return pair_of_ranks(one)


def tp_case(label, P, mesh, kkt_kw, kw, cpu, one):
    """One TP solve of the world of one on the device loop. The solver is
    made once (the cache keys on it): a miss, a hit and TP_CHAIN chained
    hits through conic_ip. The hit equals the eager loop (ipm_solve
    without a device loop, on the operands conic_ip handed graph.solve) in
    status, Iter, KKT builds, refinement trips and Cholesky launches by
    (dtype, order), y bit for bit; it is held, hit against hit, to the
    single-device Schur solve passed by hand (0 correctors; an eager line
    beside it) and, where ``cpu``, to the CPU's. ms per solve chained (hits
    and the eager loop), DtoH and kernels per iteration and host launches
    during replays (profiler)."""
    from conicip_tpu_torch import conic_ip, kktsolver_schur_tp, solver
    from conicip_tpu_torch.kkt import kktsolver_schur
    from conicip_tpu_torch.solver import graph, ipm
    from conicip_tpu_torch.solver.state import Solution

    what = f"world of one, {label}"
    f32 = "factor_dtype" in kkt_kw
    args = on_card(P.args())
    kkt = kktsolver_schur_tp(mesh, "tp", **kkt_kw)
    real, seen = graph.solve, {}

    def spy(*a, **k):
        seen["call"] = (a, k)
        return real(*a, **k)

    def through_graph(fn):
        graph.solve = spy
        try:
            return fn()
        finally:
            graph.solve = real

    _, ms_miss, _, _ = through_graph(lambda: tp_solve(P, kkt, **kw))
    miss = solver.runs[-1]
    a, akw = seen.pop("call")
    before = chol_by_order()
    sol, _, builds, got = tp_solve(P, kkt, **kw)
    run = solver.runs[-1]
    hit_launches = chol_by_order() - before

    def eager(stats=None):
        return Solution.from_state(ipm.ipm_solve(*a, warm=akw["warm"],
                                                 stats=stats))

    def graphed(stats=None):
        return Solution.from_state(real(*a, warm=akw["warm"], stats=stats))

    est = {}
    before = chol_by_order()
    ref_e = eager(est)
    eager_launches = chol_by_order() - before
    erun = solver.Run(None, ref_e.status, ref_e.Iter, **est)
    check(miss.loop == run.loop == "graph" and not miss.cache_hit
          and run.cache_hit,
          f"{what}: loops {miss.loop}/{run.loop}, hits "
          f"{miss.cache_hit}/{run.cache_hit}")
    check((sol.status, sol.Iter) == (ref_e.status, ref_e.Iter)
          and torch.equal(sol.y, ref_e.y),
          f"{what}: hit {sol.status}/{sol.Iter}, eager "
          f"{ref_e.status}/{ref_e.Iter}, y equal "
          f"{torch.equal(sol.y, ref_e.y)}")
    check(builds == run_builds(erun) and run.trips == erun.trips
          and hit_launches == eager_launches,
          f"{what}: {builds} KKT builds, {run.trips} trips, launches "
          f"{dict(hit_launches)} on a hit; {run_builds(erun)}, "
          f"{erun.trips}, {dict(eager_launches)} on the eager loop")
    units = ipm.POLL * -(-(erun.fast_steps + erun.slow_steps) // ipm.POLL)
    check(run.polls == 1 and run.replays == 1 and run.units == units,
          f"{what}: {run.polls} polls, {run.replays} replays, {run.units} "
          f"units on a hit, for {units} units of the eager loop's steps")
    hits, ms_hit = chained_ms(lambda: (
        conic_ip(*args, kktsolver=kkt, device="cuda", **kw),
        solver.runs[-1].cache_hit), TP_CHAIN)
    check(all(h for _, h in hits)
          and all(torch.equal(x.y, sol.y) for x, _ in hits),
          f"{what}: a chained solve missed or differs from the first hit")
    _, ms_eager = chained_ms(eager, TP_CHAIN)
    pg, pe = profiled(graphed), profiled(eager)
    check(pg["dtoh_loop"] <= 1 and pg["replay_host_launches"] == 0,
          f"{what}: {pg['dtoh_loop']} device-to-host copies in the loop, "
          f"{pg['replay_host_launches']} host launches during replays")

    # the single-device Schur solve, hit against hit, an eager line beside
    single_kw = dict(kktsolver=kktsolver_schur, centralityCorrectors=0, **kw)
    if f32:
        single_kw["kktsolver"] = functools.partial(
            kktsolver_schur, factor_dtype=kkt_kw["factor_dtype"])
    through_graph(lambda: conic_ip(*args, device="cuda", **single_kw))
    sa, skw = seen.pop("call")
    refs, single_ms = chained_ms(lambda: (
        conic_ip(*args, device="cuda", **single_kw), solver.runs[-1]), 3)
    ref, sref = refs[-1]
    check(sref.loop == "graph" and sref.cache_hit,
          f"{what}: single solve {sref.loop}, hit {sref.cache_hit}")
    _, single_eager_ms = chained_ms(lambda: ipm.ipm_solve(
        *sa, warm=skw["warm"]), 3)
    resid = max(sol.prFeas, sol.duFeas, sol.muFeas)
    dy = (sol.y - ref.y).abs().max().item()
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
    # a retry repeats the first factor: launches at r beyond one per build
    n_pad = P.Q.shape[0]
    dt = kkt_kw.get("factor_dtype", torch.float64)
    retries = got[(dt, n_pad)] - builds
    if kkt_kw.get("distributed_factor") is False:
        retries = 0  # predicated: launched every build, counted apart
    if P is retry_problem():
        check(retries == builds > 0,
              f"{what}: {retries} retries for {builds} KKT builds")
    it = max(sol.Iter, 1)
    line("distributed", world=1, backend="nccl", case=repr(label),
         loop=run.loop, cache_hit=run.cache_hit, polls=run.polls,
         replays=run.replays, units=run.units, trips=run.trips,
         status=sol.status, Iter=sol.Iter, single_iter=ref.Iter, **extra,
         resid=f"{resid:.3e}", y_diff_single=f"{dy:.3e}",
         y_equal_eager=True, kkt_builds=builds, launches=by_order,
         launches_equal_eager=True, retries=retries,
         predicated=sum(v for k, v in hit_launches.items()
                        if k[0] == "pred"),
         ms_per_solve_hit=f"{ms_hit:.2f}",
         ms_per_solve_eager=f"{ms_eager:.2f}", ms_miss=f"{ms_miss:.2f}",
         single_ms_per_solve_hit=f"{single_ms:.2f}",
         single_ms_per_solve_eager=f"{single_eager_ms:.2f}",
         chained=TP_CHAIN,
         dtoh_per_iter_graph=f"{pg['dtoh'] / it:.2f}",
         dtoh_per_iter_eager=f"{pe['dtoh'] / it:.2f}",
         kernels_per_iter_graph="not_measured",  # WHILE body: profiled()
         kernels_per_iter_eager=f"{pe['kernels'] / it:.1f}",
         replay_host_launches=pg["replay_host_launches"])
    return dict(status=sol.status, Iter=sol.Iter, y=sol.y.cpu(), ms=ms_hit,
                single_ms=single_ms)


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
    ranks, ranks_jacobi = Counter(), Counter()
    for k, text in enumerate(world.out):
        rec = json.loads(next(s for s in text.splitlines()
                              if s.startswith('{"rank_launches"')))
        for dt, n, B, count in rec["rank_launches"]:
            key = (getattr(torch, dt), n) + ((B,) if B else ())
            ranks[key] += count
        for kind, dt, d, B, count in rec["rank_jacobi_launches"]:
            ranks_jacobi[(kind, getattr(torch, dt), d, B)] += count
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
        # gloo on CUDA tensors: the eager loop, by the rule, for its reason
        check(a["loop"] == b["loop"] == "eager"
              and a["reason"] and "gloo" in a["reason"],
              f"{what}: loops {a['loop']} / {b['loop']}, reason "
              f"{a['reason']!r}")
        line("distributed", world=DIST_RANKS, backend="gloo",
             device="cuda:0 shared", case=repr(label), loop=a["loop"],
             reason=repr(a["reason"]), status=a["status"],
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
    check(a["loops"] == b["loops"] == [("graph", True)],
          f"{DIST_RANKS} ranks, solve_batch: (loop, cache hit) "
          f"{a['loops']} / {b['loops']}")
    line("distributed", world=DIST_RANKS, backend="gloo",
         case=f"'solve_batch batched_box_qp({BATCH},n=500)'",
         mesh=f"({DIST_RANKS},) batch", per_rank=BATCH // DIST_RANKS,
         status=f"Optimal x{BATCH}", Iter="equal to unsharded", loop="graph",
         ms_per_batch=f"{a['ms']:.2f}", unsharded_ms=f"{ref['ms']:.2f}")
    line("distributed", world=DIST_RANKS, backend="gloo",
         collectives="all_reduce,reduce_scatter,all_gather,broadcast",
         on="CUDA tensors", staged="none", world_seconds=f"{seconds:.1f}")
    return ranks, ranks_jacobi


def distributed_rank(rank, init, out):
    """One of the two ranks of [distributed] (b): both on the one card,
    gloo. Saves its answers to ``out/rank<k>.pt`` and prints its kernel
    launches as a JSON line."""
    import torch.distributed as dist

    from conicip_tpu_torch import (kktsolver_schur_tp, make_mesh, models,
                                   solver)
    from conicip_tpu_torch.ops import cholesky_kernel, jacobi_kernel
    from conicip_tpu_torch.parallel import batch as pbatch
    from conicip_tpu_torch.parallel.mesh import start_rank

    start_rank(rank, DIST_RANKS, init, "cuda")
    res = {}
    try:
        check(dist.get_backend() == "gloo", "ranks sharing a card: not gloo")
        tp = make_mesh((DIST_RANKS,), ("tp",))
        for label, P in pair_cases():
            kkt = kktsolver_schur_tp(tp, "tp")
            tp_solve(P, kkt)  # warm-up
            sol, ms, builds, got = tp_solve(P, kkt)
            run = solver.runs[-1]
            ok, by_order = tp_launches_ok(P, got, builds, DIST_RANKS, {})
            res[label] = dict(status=sol.status, Iter=sol.Iter,
                              y=sol.y.cpu(), ms=ms, builds=builds,
                              launches=by_order, launches_ok=ok,
                              loop=run.loop, reason=solver._eager_reason(
                                  kkt, "cuda"))
        args = on_card(models.batched_box_qp(BATCH, n=500))
        bmesh = make_mesh((DIST_RANKS,), ("batch",))
        timed_batch(args, mesh=bmesh)  # warm-up
        bs, ms = timed_batch(args, mesh=bmesh)
        res["batch"] = dict(status=bs.status.cpu(), Iter=bs.Iter.cpu(),
                            y=bs.y.cpu(), ms=ms, loops=[
                                (r.loop, r.cache_hit) for r in pbatch.runs])
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    print(json.dumps({"rank_launches": [
        [str(k[0]).split(".")[-1], k[1], k[2] if len(k) == 3 else None, c]
        for k, c in sorted(cholesky_kernel.cholesky_launches.items(),
                           key=str)], "rank_jacobi_launches": [
        [kind, dtname(dt), d, B, c] for (kind, dt, d, B), c in sorted(
            jacobi_kernel.jacobi_launches.items(), key=str)]}), flush=True)


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
    if "--phase" in sys.argv:
        import argparse

        parser = argparse.ArgumentParser()
        parser.add_argument("--phase", required=True)
        parser.add_argument("--package")
        a = parser.parse_args()
        if a.package:
            sys.path.insert(0, os.path.abspath(a.package))
        phase_environment()
        phase_build()
        t = time.perf_counter()
        globals()[f"phase_{a.phase}"]()
        line("phase_time", of=f"phase_{a.phase}",
             package=os.path.abspath(a.package or ROOT),
             seconds=f"{time.perf_counter() - t:.1f}")
        return 0
    start = time.perf_counter()
    phase_environment()
    phase_build()
    single, batched64, batched32 = phase_kernel()
    inverse, inverse_batched = phase_inverse()
    jacobi = phase_jacobi()
    rcone = phase_rcone()
    node = rcone.pop("while")
    line("phase_time", of="build+kernel+jacobi+rcone",
         seconds=f"{time.perf_counter() - start:.1f}")

    from conicip_tpu_torch.ops import (cholesky_kernel, jacobi_kernel,
                                       rcone_kernel)
    from conicip_tpu_torch.solver import graph as device_loop

    # each path of the main run is driven with the counts at 0 and read
    # just after; the comparison launches of the kernel phases do not count
    f32, f64 = torch.float32, torch.float64
    single.update(launches=0, launches_f64=0, launches_f32=0,
                  launches_predicated=0, launches_predicated_f32=0)
    batched64["launches"] = batched32["launches"] = 0
    batched64["launches_predicated"] = batched32["launches_predicated"] = 0
    inverse["launches"] = inverse_batched["launches"] = 0
    for rec in (*jacobi.values(), *rcone.values()):
        rec["launches"] = 0
    launched = set()  # the counters' keys: every shape a path gave an entry
    jacobi_main = Counter()  # launches by (kind, dtype, d, stack)
    rcone_main = Counter()  # the R cones' kernels' launches by entry
    # the phases that solve S-cone problems, whose decompositions are the
    # Jacobi kernels' (and no other phase's)
    s_cone = (phase_conic, phase_sdp_large, phase_graph, phase_graph_cache,
              phase_f32, phase_batch, phase_batch_graph, phase_frontend,
              phase_ladder, phase_distributed)
    for phase in (phase_schur, phase_diag, phase_conic, phase_graph,
                  phase_graph_cache, phase_sdp_large, phase_f32, phase_eq,
                  phase_backends, phase_custom_kkt, phase_batch,
                  phase_batch_graph, phase_checkpoint, phase_frontend,
                  phase_ladder, phase_distributed):
        cholesky_kernel.reset_launch_count()
        jacobi_kernel.reset_launch_count()
        rcone_kernel.reset_launch_count()
        device_loop.while_launches.clear()
        # launches of the ranks a phase spawned, counted by their wrappers
        t = time.perf_counter()
        ranks, ranks_jacobi = phase() or (Counter(), Counter())
        line("phase_time", of=phase.__name__,
             seconds=f"{time.perf_counter() - t:.1f}")
        counts = cholesky_kernel.cholesky_launches + ranks
        pcounts = Counter(cholesky_kernel.predicated_launches)
        icounts = Counter(cholesky_kernel.inverse_launches)
        jcounts = jacobi_kernel.jacobi_launches + ranks_jacobi
        used = sum(counts.values())
        used32 = sum(c for k, c in counts.items() if k[0] == f32)
        stacked = {dt: sum(c for k, c in counts.items()
                           if k[0] == dt and len(k) == 3)
                   for dt in (f32, f64)}
        check(used > 0, f"{phase.__name__} never launched the kernel")
        check((used32 > 0) == (phase in (phase_graph, phase_graph_cache,
                                         phase_f32, phase_batch,
                                         phase_batch_graph, phase_ladder,
                                         phase_distributed)),
              f"{phase.__name__}: {used32} launches of the f32 entries")
        # the stacked solves run the batched entries, and nothing else does
        check((sum(stacked.values()) > 0)
              == (phase in (phase_sdp_large, phase_batch, phase_batch_graph,
                            phase_checkpoint, phase_ladder,
                            phase_distributed)),
              f"{phase.__name__}: {stacked} launches of the batched entries")
        by_kind = Counter()
        for (kind, dt, d, _), c in jcounts.items():
            by_kind[kind] += c
            key = (kind, dt, d > JACOBI_WARP_MAX_D)
            check(key in jacobi, f"{phase.__name__}: {c} launches of the "
                  f"{kind} {dtname(dt)} kernel at d = {d}, which the kernels "
                  "line does not list")
            jacobi[key]["launches"] += c
        if phase in s_cone:
            check(by_kind["svd"] > 0 and by_kind["eigh"] + by_kind["eigvalsh"] > 0,
                  f"{phase.__name__}: Jacobi launches {dict(by_kind)}")
        else:
            check(not jcounts, f"{phase.__name__} solves no S cone but "
                  f"launched the Jacobi kernels {dict(by_kind)}")
        pstacked = {dt: sum(c for k, c in pcounts.items()
                            if k[0] == dt and len(k) == 3)
                    for dt in (f32, f64)}
        rused = rcone_counts()
        for rec in rcone.values():
            rec["launches"] += sum(rused[e] for e in rec["entries"])
        loops = sum(device_loop.while_launches.values())
        node["launches"] += loops
        line("launches", of=phase.__name__, f64=used - used32, f32=used32,
             batched_f64=stacked[f64], batched_f32=stacked[f32],
             predicated=sum(pcounts.values()),
             inverse=sum(icounts.values()),
             jacobi=",".join(f"{k}:{by_kind[k]}" for k in JACOBI_KINDS),
             rcone=",".join(f"{e}:{rused[e]}" for e in rcone_kernel.ENTRIES),
             while_node=loops)
        single["launches"] += used - sum(stacked.values())
        single["launches_f64"] += used - used32 - stacked[f64]
        single["launches_f32"] += used32 - stacked[f32]
        batched64["launches"] += stacked[f64]
        batched32["launches"] += stacked[f32]
        single["launches_predicated"] += (sum(pcounts.values())
                                          - sum(pstacked.values()))
        single["launches_predicated_f32"] += sum(
            c for k, c in pcounts.items() if k[0] == f32) - pstacked[f32]
        batched64["launches_predicated"] += pstacked[f64]
        inverse["launches"] += sum(c for k, c in icounts.items()
                                   if len(k) == 2)
        inverse_batched["launches"] += sum(c for k, c in icounts.items()
                                           if len(k) == 3)
        batched32["launches_predicated"] += pstacked[f32]
        launched |= set(counts) | set(pcounts)
        jacobi_main += jcounts
        rcone_main += rused
    for rec in (single, batched64, batched32, inverse, inverse_batched,
                *jacobi.values(), *rcone.values(), node):
        check(rec["launches"] > 0, f"{rec['name']} was never launched on "
              "the main paths")
    # the f32 Schur builds' ridge retries, inside the device loop's graphs
    check(single["launches_predicated_f32"] > 0
          and batched32["launches_predicated"] > 0,
          "the f32 predicated entries were never launched on the main paths")
    # a shape the paths gave the kernel that the kernel phase did not
    # foresee (a rescue tier's sub-batch) is held against the plain version
    # now, after the counts were read (untraced: after this much work the
    # tracer returns no events)
    for dt, n, *B in sorted(launched - set(HELD), key=str):
        if B:
            hold_batched(B[0], n, dt, True, traced=False)
        else:
            hold_single(n, dt, True)
    for (kind, dt, d, B), c in sorted(jacobi_main.items(), key=lambda kv: (
            JACOBI_KINDS.index(kv[0][0]), kv[0][1] == torch.float32,
            kv[0][2], kv[0][3])):
        line("jacobi_launches", kind=kind, dtype=dtname(dt), d=d, B=B,
             main_path_launches=c)
    for kind, dt, d, B in sorted(set(jacobi_main) - set(JACOBI_HELD),
                                 key=str):
        worst = hold_jacobi(kind, dt, d, B)
        line("jacobi", d=d, B=B, kind=kind, dtype=dtname(dt), main_path=True,
             foreseen=False, worst_over_tol=f"{worst:.3g}")
    for rec, dt, batched in ((single, f64, False), (batched64, f64, True),
                             (batched32, f32, True)):
        rec["max_abs_err"] = max(err for key, err in HELD.items() if
                                 key[0] == dt and (len(key) == 3) == batched)
    for (kind, dt, block), rec in jacobi.items():
        rec["max_abs_err"] = max(
            err for key, err in JACOBI_HELD.items() if key[:2] == (kind, dt)
            and (key[2] > JACOBI_WARP_MAX_D) == block)

    line("phase_time", of="all", seconds=f"{time.perf_counter() - start:.1f}")
    for name, rec in rcone.items():
        entries = rec.pop("entries")
        check(all(rcone_main[e] > 0 for e in entries),
              f"rcone_{name}: an entry was never launched on the main "
              f"paths {dict(rcone_main)}")
    print(json.dumps({"kernels": [single, batched64, batched32, inverse,
                                  inverse_batched, *jacobi.values(),
                                  *rcone.values(), node]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
