"""Where one solve's device time goes: a profiler trace of ``conic_ip``.

    python -m conicip_tpu_torch.trace [--family box_qp_dense] [--n 4096]
                                      [--k 10] [--seed 42]
                                      [--factor-dtype float64]
                                      [--batch B] [--poll K] [--chain K]
                                      [--kkt auto|schur|tp|custom]
                                      [--verbose]

Solves one instance of a problem family (``--n`` sizes ``box_qp_dense`` and
``single_soc``, ``--k`` the S order of ``small_sdp_instance``, instance 0
of ``batched_small_sdp(1, k)``; the other families take their default
sizes) from inputs already on the card, once to warm up, five times
unprofiled and once under ``torch.profiler``, and prints one line each
for: the solve (wall time of the profiled solve and the median of the
unprofiled ones, device busy time as the union of kernel and copy
intervals, iterations, kernel launches and elementwise launches per
iteration, device-to-host copies per iteration,
launches of the Cholesky kernel's f64 and f32 entries and of the Jacobi
kernels by kind, and the count of cuSOLVER eigen- or singular-value kernels,
which an S-cone solve no longer runs; and the interior-point loop: whether
it ran as a CUDA graph (``graph=1``), its host reads of the status
(``polls``: 1 on a hit, the final copy, where the loop is one WHILE node
on the card), the graph's ``replays``, the units the loop ran
(``units``), the device-to-host copies inside the
loop and outside it, and the kernels the host launched during the replays,
which must be none), the Cholesky kernel split into its
diagonal-block, panel and trailing kernels, the Jacobi kernels' device time,
the R cones' kernels' launches with the copies issued on their stream
right before them (``[rcone]``, with the conditional nodes'
``set_condition`` launches), and the other device operations by total
time.
``--factor-dtype float32`` profiles the f32-factor solve (mixed residuals,
last-mile switch, ladder) in place of the full-precision default.
``--kkt`` picks the KKT solver: ``auto`` (``conic_ip``'s own choice, the
default), ``schur`` (``kktsolver_schur`` passed by hand, as a caller
passes it: no centrality corrector), ``tp`` (``kktsolver_schur_tp`` over
a world of one rank that this command starts, NCCL on the card) or
``custom`` (a caller's own: the box 2x2 solver of
``examples/torch/custom_kkt.py`` under ``pivot``, for ``--family
readme_box``, the README's box QP), made once and passed to every solve;
with ``--factor-dtype float32`` ``schur`` and ``tp`` factor in f32.
``rq_eq`` is the problem of the reference's multichip dry run (n = 512,
R(1024) x Q(32) x Q(32), p = 16). ``--verbose`` solves with
``verbose=True``, its rows printed to a buffer that is dropped.
``--batch B`` profiles one ``solve_batch`` of a stack of B instances of the
family's batched form instead (``box_qp_dense`` sized by ``--n``,
``mixed_rq_eq`` at n=200, ``mixed_rqs``, ``small_sdp`` at ``--k``): the
same lines, per iteration of the stack (``Iter`` is the slowest
instance's), with the launches of the kernel's batched entries.
``--poll K`` profiles the device loop at K units per chunk in place of
``solver.ipm.POLL`` (how that constant was chosen). The [solve] line
also says whether the profiled solve hit the device loop's cache
(``cache_hit``; the unprofiled solves before it repeat its instance, so
it does), the refinement trips it ran, its steps on the generator's fast
and last-mile variants and its full-precision recomputes of the mixed
residuals.
Where the solve ran the loop's WHILE node (csrc/graph_cond.cu) the
profiler records only part of the node's body (about one unit's kernels
a graph launch) where the graph was instantiated before the profiler
started, as the cache's entries are; all of it for a graph instantiated
while the profiler runs, which then runs slower ever after (PERF.md §6).
So there the line takes
``device_busy_ms`` from the program's CUDA events around each graph
replay of an unprofiled solve (``busy_from=graph_events``: the graphs'
device spans, the copies in and out left out; ``telemetry.Record
.replay_ms`` under ``telemetry.watch(replays=True)``, the entries
captured with telemetry off) and ``device_idle_share`` against the
unprofiled wall time, gives each unit's device time by phase from the
phase clock (:func:`phase_ms`: before the profile, an entry captured with
``telemetry.enable()``, whose graphs carry the clock's stamps, three
one-thread kernels a unit; ``kkt_build_ms_per_unit``,
``step_ms_per_unit``, ``evaluate_ms_per_unit``, their sum
``phases_ms_per_unit`` beside ``graphs_ms_per_unit``, over the same
unprofiled solves of that entry), prints ``not_measured`` for the
profiler's kernel counts per iteration and for the [cholesky], [jacobi],
[rcone] and [op] lines (``--verbose`` keeps the host-polled chunk, whose
kernels the profiler records), and adds a [while_profile] line: the graphs' device ms
before the profiled solve, after it, and for an entry captured inside a
profiler session, the R-cone and Jacobi kernels that the profiler
recorded of the wrappers' count, for a hit of an entry captured before
the session and inside it, and the kernels and elementwise kernels per
iteration of the latter hit, which the profiler records whole. Every line gives the wrappers' launches
(``hand_launches``, Cholesky factors, Jacobi and R-cone kernels) and the
units the loop ran.
``--chain K`` adds a [chain] line, timed after the warm-up solve and
before anything is profiled:
K instances of the family (seeds
``seed`` ... ``seed + K - 1``, inputs already on the card; with
``--batch B`` K stacks of B) solved back to back, the cache emptied first,
for one round and then :data:`ROUNDS` more; ms per solve (per stack) of
each later round (median, least and most), of the first round (one miss
per configuration), the hits and captures (misses) of all rounds, and the
device loop's entries after the first round with the memory the card
reserved for them (``torch.cuda.memory_reserved()`` across the first
round, the allocator's free blocks released on both sides), the device
ms per solve (per stack) of the graphs the hits replay
(:func:`graph_device_ms` over :data:`REPEATS` more rounds: no host gap
between graphs counted), and the last round's runs by loop with their
polls, units, steps per variant, recomputes and trips summed. The [solve]
line names the loop each run took (``loop``, "graph" or "eager", one per
run) and counts the KKT builds the card ran (:func:`kkt_builds`). It
needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import tempfile
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from . import conic_ip, solve_batch, solver, telemetry
from . import models
from .cones.spec import ConeSpec
from .ops import cholesky_kernel, control, jacobi_kernel, rcone_kernel
from .parallel import batch as parallel_batch
from .solver import graph, ipm

# problem families, made at size n where they take one
FAMILIES = {
    "box_qp_dense": lambda n, seed: models.box_qp_dense(n=n, seed=seed),
    "single_soc": lambda n, seed: models.single_soc(n=n, seed=seed),
    "many_small_socs": lambda n, seed: models.many_small_socs(seed=seed),
    "larger_sdp": lambda n, seed: models.larger_sdp(seed=seed),
    "mixed_rqs": lambda n, seed: models.mixed_rqs(seed=seed),
    "mixed_rq_eq": lambda n, seed: models.mixed_rq_eq(seed=seed),
    "rq_eq": lambda n, seed: rq_eq(seed=seed),
    "readme_box": lambda n, seed: readme_box(n=n, seed=seed),
    "small_sdp_instance": lambda n, seed, k=10: small_sdp_instance(
        k=k, seed=seed),
}

# --batch: stacks of B instances, (Q, c, A, b, cone_dims[, G, d])
BATCH_FAMILIES = {
    "box_qp_dense": lambda B, n, seed: models.batched_box_qp(B, n=n, seed=seed),
    "mixed_rq_eq": lambda B, n, seed: models.batched_mixed_rq_eq(
        B, n=200, seed=seed, n_q=51, p=10),
    "mixed_rqs": lambda B, n, seed: models.batched_mixed_rqs(B, seed=seed),
    "small_sdp": lambda B, n, seed, k=10: models.batched_small_sdp(
        B, k=k, seed=seed),
}

# the families sized by --k (the S order of the small SDPs)
TAKES_K = ("small_sdp_instance", "small_sdp")

# the Cholesky kernel's parts, by kernel name (csrc/cholesky.cu)
CHOLESKY_PARTS = ("copy_lower", "factor_diag", "panel_product",
                  "trailing_update")
# the Jacobi kernels, by kernel name (csrc/jacobi.cu): one warp per matrix
# for d <= 32, one block per matrix above
JACOBI_PARTS = ("eigh_jacobi_warp", "svd_jacobi_warp", "eigh_jacobi",
                "svd_jacobi")
# the R cones' kernels (csrc/rcone.cu), by kernel name
RCONE_PARTS = ("r_scaling", "r_reduce4", "r_comp", "r_step")
# pieces of the names of cuSOLVER's eigen- and singular-value kernels
CUSOLVER_EIG_SVD = ("syevj", "syevd", "sytrd", "gesvdj", "batched_svd")


def rq_eq(n=512, p=16, seed=0):
    """The problem the reference's multichip dry run solves through its
    kktsolver_schur_tp (``__graft_entry__.py``): R(2n) x Q(32) x Q(32),
    diagonal Q, p equalities, strictly feasible; n = 512 gives m = 1088."""
    cones = [("R", 2 * n), ("Q", 32), ("Q", 32)]
    m = sum(k for _, k in cones)
    rng = np.random.default_rng(seed)
    Q = np.diag(1.0 + rng.random(n))
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n),
                   rng.standard_normal((m - 2 * n, n)) * 0.1])
    y0 = rng.standard_normal(n) * 0.1
    b = A @ y0 - ConeSpec(cones).identity
    G = rng.standard_normal((p, n))
    return models.Problem(f"rq_eq(n={n},m={m},p={p})", Q, c, A, b,
                          cones, G, G @ y0)


def small_sdp_instance(k=10, seed=0):
    """Instance 0 of ``batched_small_sdp(1, k)``: the PSD repair of one
    random symmetric k x k matrix (A = Q = I, the spectral backend)."""
    Q, c, A, b, cones = models.batched_small_sdp(1, k=k, seed=seed)
    return models.Problem(f"small_sdp_instance(k={k})", Q[0], c[0], A[0],
                          b[0], cones)


def readme_box(n=1000, seed=0):
    """The README's box QP (½yᵀHy − cᵀy, H = I/2, −1 ≤ y ≤ 1,
    c = H·(1..n)) with the seed's normal draw added to c."""
    H = 0.5 * np.eye(n)
    rng = np.random.default_rng(seed)
    c = H @ np.arange(1.0, n + 1) + rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    return models.Problem(f"readme_box(n={n})", H, c, A, -np.ones(2 * n),
                          [("R", 2 * n)])


@functools.lru_cache(maxsize=None)
def example_box_kktsolver():
    """``examples/torch/custom_kkt.py``'s box 2x2 solver under ``pivot``,
    made once by the example (``box_kktsolver``), loaded from the
    checkout this package sits in."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch", "custom_kkt.py")
    spec = importlib.util.spec_from_file_location("custom_kkt_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.box_kktsolver


def kktsolver(name, factor_dtype, device):
    """The ``--kkt`` solver on ``device`` (module docstring), or None for
    ``auto``; ``tp`` starts the world of one it runs over (NCCL on the
    card, gloo on the CPU), which :func:`stop_world` ends."""
    from .kkt import kktsolver_schur
    from .parallel import kktsolver_schur_tp, make_mesh
    from .parallel.mesh import start_rank

    fd = FACTOR_DTYPES[factor_dtype]
    fd = None if fd == "auto" else fd
    if name == "schur":
        return (kktsolver_schur if fd is None else
                functools.partial(kktsolver_schur, factor_dtype=fd))
    if name == "tp":
        device = torch.device(device)
        start_rank(0, 1, "file://" + os.path.join(tempfile.mkdtemp(),
                                                  "rendezvous"), device.type)
        mesh = make_mesh((1,), ("tp",), device_type=device.type)
        return kktsolver_schur_tp(mesh, "tp", factor_dtype=fd)
    if name == "custom":
        return example_box_kktsolver()
    return None


def stop_world():
    """End the world a ``--kkt tp`` run started."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _busy_us(events):
    """Length of the union of the events' [ts, ts + dur) intervals."""
    total, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def _kernel_name(name):
    for part in CHOLESKY_PARTS + JACOBI_PARTS:
        if f"{part}<" in name:
            return part
    return name.split("(")[0][:60]


def _is_cusolver_eig_svd(name):
    return any(piece in name for piece in CUSOLVER_EIG_SVD)


def rcone_copies(device):
    """From a trace's device events: each R-cone kernel's launches and the
    copies (copy kernels and device-to-device memcpys) issued on its
    stream right before each launch, where ``ops/rcone.py:_stack``'s
    copies of strided or broadcast operands fall; and the conditional
    nodes' ``set_condition`` launches (csrc/graph_cond.cu)."""
    streams = defaultdict(list)
    for e in sorted(device, key=lambda e: e["ts"]):
        streams[e.get("args", {}).get("stream")].append(e)
    out = Counter()
    for seq in streams.values():
        run = 0
        for e in seq:
            name = e["name"]
            part = next((p for p in RCONE_PARTS if f"{p}<" in name), None)
            if part:
                out[part] += 1
                out[f"{part}_copies"] += run
                run = 0
            elif "copy_kernel" in name or "DtoD" in name:
                run += 1
            else:
                run = 0
                out["set_condition"] += name.startswith("set_condition")
    return out


# host calls that launch a kernel (through the CUDA runtime or the driver
# API), and the one that launches a graph
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def loop_counts(events):
    """From a chrome trace of one solve: the device-to-host copies made
    while the device loop (solver/graph.py) ran and outside it, and the
    kernels the host launched while its graph was replayed (on the device
    loop none: the replays are graph launches and the status reads)."""
    def spans(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "user_annotation" and e["name"] == name]

    def inside(ts, within):
        return any(lo <= ts <= hi for lo, hi in within)

    host = {e["args"]["correlation"]: e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}
    loop, replay = spans(graph.LOOP), spans(graph.REPLAY)
    dtoh_loop = dtoh = 0
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]:
            dtoh += 1
            call = host.get(e.get("args", {}).get("correlation"))
            dtoh_loop += call is not None and inside(call["ts"], loop)
    launched = sum(1 for e in host.values()
                   if e["name"] in HOST_LAUNCHES and inside(e["ts"], replay))
    return dict(dtoh_loop=dtoh_loop, dtoh_fixed=dtoh - dtoh_loop,
                replay_host_launches=launched)


# unprofiled solves before the profiled one, whose median wall time the
# [solve] line reports beside the profiled one's
REPEATS = 5

# rounds of a --chain after its first, whose ms per solve the [chain] line
# reports (median, least, most)
ROUNDS = 5

# per-run counts the [chain] line sums over its last round
CHAIN_COUNTS = ("polls", "units", "fast_steps", "slow_steps", "recertified",
                "trips")

# --factor-dtype: the keyword conic_ip gets ("auto" is full precision)
FACTOR_DTYPES = {"float64": "auto", "float32": torch.float32}

# --kkt: conic_ip's own choice, or a solver passed by hand
KKT_SOLVERS = ("auto", "schur", "tp", "custom")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="box_qp_dense",
                    choices=sorted(set(FAMILIES) | set(BATCH_FAMILIES)))
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10,
                    help="S order of small_sdp_instance and of the small_sdp "
                         "stack")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--factor-dtype", choices=sorted(FACTOR_DTYPES),
                    default="float64")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile solve_batch on a stack of this many "
                         "instances")
    ap.add_argument("--poll", type=int, default=0,
                    help="units per chunk of the device loop for this "
                         "profile (default: solver.ipm.POLL)")
    ap.add_argument("--chain", type=int, default=0,
                    help="also time this many instances solved back to "
                         "back")
    ap.add_argument("--kkt", choices=KKT_SOLVERS, default="auto",
                    help="the KKT solver: conic_ip's choice, "
                         "kktsolver_schur passed by hand, "
                         "kktsolver_schur_tp over a world of one, or a "
                         "caller's own box 2x2 solver (readme_box)")
    ap.add_argument("--verbose", action="store_true",
                    help="solve with verbose=True (rows printed to a "
                         "dropped buffer)")
    args = ap.parse_args(argv)
    if args.family not in (BATCH_FAMILIES if args.batch else FAMILIES):
        ap.error(f"--family {args.family} has no "
                 f"{'batched' if args.batch else 'single-instance'} form")
    if args.kkt == "tp" and args.batch:
        ap.error("--kkt tp solves one instance: no --batch")
    if args.kkt == "custom" and args.family != "readme_box":
        ap.error("--kkt custom solves --family readme_box")
    if args.verbose and args.batch:
        ap.error("--verbose solves one instance: no --batch")
    return args


def kkt_builds(r) -> int:
    """KKT builds the card ran in one interior-point run (a ``Run`` or a
    ``BatchRun``): the cold start's and one per step. On the device loop
    one per unit (``r.units``: :data:`~conicip_tpu_torch.solver.ipm.POLL`
    per chunk, a miss's eager first unit among them, also where the
    prologue ended the solve); a miss runs its prologue
    twice (eagerly, then from its graph), and with a caller's own
    kktsolver a third time and one unit more, eagerly under the guard,
    every body masked (solver/graph.py; counted for a one-variant
    generator, as the caller's of ``--kkt custom``: a two-variant one
    builds both variants in that unit). A two-variant generator builds,
    in a unit, the variant each instance is on: one per unit for a single
    solve at ``POLL`` = 1 (a frozen unit at a larger ``POLL`` builds
    nothing), both where a stack is split across the variants, which
    ``solve_batch``'s own runs never are (its f32 generator has one
    variant)."""
    if r.loop == "eager":
        return r.cold_start + r.fast_steps + r.slow_steps
    miss = r.loop == "graph" and not r.cache_hit
    probe = (miss and r.kktsolver is not None
             and control.callers_own(r.kktsolver))
    return r.cold_start * (1 + miss + probe) + probe + r.units


def _hand_launches():
    """The kernels' wrappers' launches so far, summed: the Cholesky
    factors, and the Jacobi and R-cone kernels apart."""
    return (sum(cholesky_kernel.cholesky_launches.values()),
            sum(jacobi_kernel.jacobi_launches.values())
            + sum(rcone_kernel.rcone_launches.values()))


def graph_device_ms(solve, reps=REPEATS, runs=None):
    """Device ms of the CUDA graphs one ``solve()`` replays, from the
    program's CUDA events around each replay (``telemetry.Record
    .replay_ms`` of the calls the solve makes, under
    ``telemetry.watch(replays=True)``; no profiler, telemetry on or off):
    the median of ``reps`` solves, the WHILE node launches of the last,
    and, with ``runs`` (the list the solve leaves its run records in:
    ``solver.runs``, ``parallel.batch.runs``) whose every run carries the
    phase clock's reading, ms per unit over the ``reps`` solves of each
    phase and of the graphs (``graphs_ms``); else None."""
    per_solve, units, phase_ns, clocked = [], 0, Counter(), runs is not None
    for _ in range(reps):
        before = sum(graph.while_launches.values())
        with telemetry.watch(replays=True) as calls:
            solve()
        torch.cuda.synchronize()
        per_solve.append(sum(rec.replay_ms() for rec in calls))
        for r in runs or ():
            units += r.units
            clocked = clocked and r.phases is not None
            phase_ns.update(r.phases or {})
    per_unit = None
    if clocked and units:
        per_unit = {f"{p}_ms": phase_ns[p] * 1e-6 / units
                    for p in telemetry.PHASES}
        per_unit["graphs_ms"] = sum(per_solve) / units
    return (sorted(per_solve)[reps // 2],
            sum(graph.while_launches.values()) - before, per_unit)


def phase_ms(solve, runs, reps=REPEATS):
    """Device ms a unit of each phase and of the graphs
    (:func:`graph_device_ms`) over ``reps`` hits of an entry captured with
    ``telemetry.enable()``, made by a first ``solve()``: its graphs carry
    the phase clock, and those of telemetry off stay as they were. None
    where the runs carry no clock (the eager loop)."""
    telemetry.enable()
    try:
        solve()  # the miss: an entry with the phase clock
        torch.cuda.synchronize()
        return graph_device_ms(solve, reps, runs)[2]
    finally:
        telemetry.disable()


def _profiled(solve):
    """One ``solve()`` under the profiler: its result, wall ms and
    chrome-trace events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return out, wall_ms, json.load(f)["traceEvents"]


def _recorded(events):
    """R-cone and Jacobi kernels among a trace's device events."""
    return sum(1 for e in events if e.get("cat") == "kernel"
               and any(f"{p}<" in e["name"]
                       for p in JACOBI_PARTS + RCONE_PARTS))


def while_profile(solve, before_ms, events, counted, iters):
    """The [while_profile] line (module docstring): ``before_ms`` the
    graphs' device ms before any profiled solve, ``events`` and
    ``counted`` (the wrappers' R-cone and Jacobi launches) of the profiled
    hit of that entry, ``iters`` its iterations. Empties the cache and
    leaves an entry captured inside a profiler session, which runs
    slower and, as every capture under a profiler, carries the phase
    clock's stamps."""
    from torch.profiler import ProfilerActivity, profile

    after_ms, _, _ = graph_device_ms(solve)
    graph.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        solve()  # the miss: captured inside the session
        torch.cuda.synchronize()
    base = _hand_launches()[1]
    _, _, inside = _profiled(solve)
    counted_inside = _hand_launches()[1] - base
    telemetry.enable()  # the key of the entry captured in the session
    try:
        inside_ms, _, _ = graph_device_ms(solve)
    finally:
        telemetry.disable()
    kernels = [e for e in inside if e.get("cat") == "kernel"]
    elementwise = sum(1 for e in kernels if "elementwise" in e["name"])
    print(f"[while_profile] graphs_ms_before_profile={before_ms:.3f} "
          f"graphs_ms_after_profile={after_ms:.3f} "
          f"graphs_ms_captured_in_profile={inside_ms:.3f} "
          f"rcone_jacobi_counted={counted} "
          f"rcone_jacobi_recorded={_recorded(events)} "
          f"rcone_jacobi_counted_captured_in_profile={counted_inside} "
          f"rcone_jacobi_recorded_captured_in_profile={_recorded(inside)} "
          f"kernels_per_iter_captured_in_profile="
          f"{len(kernels) / iters:.1f} "
          f"elementwise_per_iter_captured_in_profile="
          f"{elementwise / iters:.1f} "
          f"device={torch.cuda.get_device_name(0)!r}")


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("trace: no CUDA device", file=sys.stderr)
        return 2
    default = ipm.POLL
    ipm.POLL = args.poll or default
    try:
        return _profile(args)
    finally:
        ipm.POLL = default
        stop_world()


def _family(args, seed):
    """The --family problem of ``seed``, or its --batch stack."""
    kw = {"k": args.k} if args.family in TAKES_K else {}
    if args.batch:
        return BATCH_FAMILIES[args.family](args.batch, args.n, seed, **kw)
    return FAMILIES[args.family](args.n, seed, **kw)


def _profile(args):
    dev = torch.device("cuda")
    kw = dict(device=dev, factor_dtype=FACTOR_DTYPES[args.factor_dtype])
    if args.verbose:
        kw["verbose"] = True
    kkt = kktsolver(args.kkt, args.factor_dtype, dev)
    if kkt is not None:
        kw["kktsolver"] = kkt

    def on_card(x):
        return (None if x is None else
                torch.as_tensor(x, dtype=torch.float64, device=dev))

    if args.batch:
        data = _family(args, args.seed)
        cones = data[4]
        tensors = [on_card(x) for x in data[:4] + data[5:]]
        name = f"batched_{args.family}(B={args.batch},n={data[1].shape[-1]})"

        def solve():
            return solve_batch(*tensors[:4], cones, *tensors[4:], **kw)
    else:
        P = _family(args, args.seed)
        tensors = [on_card(x) for x in (P.Q, P.c, P.A, P.b, P.G, P.d)]
        cones, name = P.cone_dims, P.name

        def solve():
            with _quiet(args.verbose):
                return conic_ip(*tensors[:4], cones, *tensors[4:], **kw)

    solve()  # warm-up, builds
    torch.cuda.synchronize()
    if args.chain:
        # before the profiler, after which a WHILE body runs slower for a
        # while (PERF.md §6)
        _chain(args, kw, on_card)
    unprofiled = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        unprofiled.append((time.perf_counter() - t) * 1e3)
    wall_unprofiled = sorted(unprofiled)[REPEATS // 2]
    graphs_ms, whiles, _ = graph_device_ms(solve)
    per_unit = phase_ms(solve, parallel_batch.runs if args.batch
                        else solver.runs)
    cholesky_kernel.reset_launch_count()
    jacobi_kernel.reset_launch_count()
    rcone_kernel.reset_launch_count()
    sol, wall_ms, events = _profiled(solve)
    chol_launches, counted = _hand_launches()
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        key = _kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        by_name[key][0] += e["dur"]
        by_name[key][1] += 1
    kernels = [e for e in device if e["cat"] == "kernel"]
    elementwise = sum(1 for e in kernels if "elementwise" in e["name"])
    dtoh = sum(1 for e in device if "DtoH" in e["name"])
    cusolver = sum(1 for e in kernels if _is_cusolver_eig_svd(e["name"]))
    if args.batch:
        counts = {}
        for st in sol.statuses:
            counts[st] = counts.get(st, 0) + 1
        status = ",".join(f"{k}x{v}" for k, v in sorted(counts.items()))
        iters = int(sol.Iter.max())
        runs = parallel_batch.runs
    else:
        status, iters = sol.status, sol.Iter
        runs = solver.runs
    loop = loop_counts(events)
    it = max(iters, 1)
    units = sum(r.units for r in runs)
    # the profiler sees part of a WHILE node's body (module docstring)
    partial = whiles > 0
    if partial:
        busy_ms, idle = graphs_ms, 1 - graphs_ms / wall_unprofiled
        per_iter = dict(kernels_per_iter="not_measured",
                        elementwise_per_iter="not_measured")
    else:
        busy_ms = _busy_us(device) / 1e3
        idle = 1 - busy_ms / wall_ms
        per_iter = dict(kernels_per_iter=f"{len(kernels) / it:.1f}",
                        elementwise_per_iter=f"{elementwise / it:.1f}")
    hand = chol_launches + counted
    if per_unit:
        per_unit["phases_ms"] = sum(per_unit[f"{p}_ms"]
                                    for p in telemetry.PHASES)
        phases = "".join(f"{k}_per_unit={v:.4f} "
                         for k, v in per_unit.items())
    else:
        phases = "phases_per_unit=not_measured "
    print(f"[solve] family={name} factor_dtype={args.factor_dtype} "
          f"kkt={args.kkt} "
          f"status={status} Iter={iters} "
          f"wall_ms={wall_ms:.2f} "
          f"wall_ms_unprofiled={wall_unprofiled:.2f} "
          f"device_busy_ms={busy_ms:.2f} "
          f"busy_from={'graph_events' if partial else 'profiler'} "
          f"device_idle_share={idle:.3f} "
          + "".join(f"{k}={v} " for k, v in per_iter.items())
          + phases
          + f"hand_launches={hand} "
          f"hand_launches_per_unit="
          f"{f'{hand / units:.1f}' if units else '-'} "
          f"dtoh_per_iter={dtoh / it:.2f} "
          f"loop={'+'.join(r.loop for r in runs)} "
          f"while_launches={whiles} "
          f"kkt_builds={sum(kkt_builds(r) for r in runs)} "
          f"poll={ipm.POLL} polls={sum(r.polls for r in runs)} "
          f"replays={sum(r.replays for r in runs)} "
          f"units={units} "
          f"cache_hit={int(all(getattr(r, 'cache_hit', 0) for r in runs))} "
          f"trips={sum(getattr(r, 'trips', -1) for r in runs)} "
          f"fast_steps={sum(r.fast_steps for r in runs)} "
          f"slow_steps={sum(r.slow_steps for r in runs)} "
          f"recertified={sum(r.recertified for r in runs)} "
          f"dtoh_loop={loop['dtoh_loop']} dtoh_fixed={loop['dtoh_fixed']} "
          f"replay_host_launches={loop['replay_host_launches']} "
          f"cholesky_f64={cholesky_kernel.launch_count(torch.float64)} "
          f"cholesky_f32={cholesky_kernel.launch_count(torch.float32)} "
          f"cholesky_batched={cholesky_kernel.launch_count(batch=True)} "
          f"cholesky_predicated="
          f"{cholesky_kernel.launch_count(counter='predicated')} "
          f"inverse={cholesky_kernel.launch_count(counter='inverse')} "
          + "".join(f"jacobi_{k}={jacobi_kernel.launch_count(k)} "
                    for k in jacobi_kernel.KINDS)
          + "".join(f"rcone_{e}={rcone_kernel.launch_count(e)} "
                    for e in rcone_kernel.ENTRIES)
          + f"cusolver_eig_svd_kernels={cusolver} "
          f"device={torch.cuda.get_device_name(0)!r}")
    if partial:
        for tag in ("cholesky", "jacobi", "rcone", "op"):
            print(f"[{tag}] not_measured=while_body_recorded_in_part")
        while_profile(solve, graphs_ms, events, counted, it)
        return 0
    chol = [e for e in device if _kernel_name(e["name"]) in CHOLESKY_PARTS]
    print(f"[cholesky] busy_ms={_busy_us(chol) / 1e3:.2f} " + " ".join(
        f"{p}_ms={by_name[p][0] / 1e3:.2f}/{by_name[p][1]}"
        for p in CHOLESKY_PARTS))
    jac = [e for e in device if _kernel_name(e["name"]) in JACOBI_PARTS]
    print(f"[jacobi] busy_ms={_busy_us(jac) / 1e3:.2f} " + " ".join(
        f"{p}_ms={by_name[p][0] / 1e3:.2f}/{by_name[p][1]}"
        for p in JACOBI_PARTS))
    rc = rcone_copies(device)
    print("[rcone] " + " ".join(
        f"{p}={rc[p]} {p}_copies_before={rc[p + '_copies']}"
        for p in RCONE_PARTS) + f" set_condition={rc['set_condition']}")
    others = sorted(((v[0], k, v[1]) for k, v in by_name.items()
                     if k not in CHOLESKY_PARTS + JACOBI_PARTS), reverse=True)
    for us, name, count in others[:10]:
        print(f"[op] ms={us / 1e3:.2f} calls={count} name={name!r}")
    return 0


def _quiet(verbose):
    """With ``--verbose``: the solve's rows printed to a buffer that is
    dropped (the print is part of the measured work)."""
    if not verbose:
        return contextlib.nullcontext()
    return contextlib.redirect_stdout(io.StringIO())


def _chain(args, kw, on_card):
    """The [chain] line (module docstring)."""
    problems = []
    for seed in range(args.seed, args.seed + args.chain):
        if args.batch:
            data = _family(args, seed)
            problems.append(([on_card(x) for x in data[:4] + data[5:]],
                             data[4]))
        else:
            P = _family(args, seed)
            problems.append(([on_card(x) for x in (P.Q, P.c, P.A, P.b, P.G,
                                                    P.d)], P.cone_dims))
    solve, runs = ((solve_batch, parallel_batch.runs) if args.batch
                   else (conic_ip, solver.runs))
    graph.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    hits = misses = 0
    per_solve = []
    for _ in range(ROUNDS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        last = Counter()  # this round's loops and counts
        for tensors, cones in problems:
            with _quiet(args.verbose):
                solve(*tensors[:4], cones, *tensors[4:], **kw)
            hit = all(r.cache_hit for r in runs)
            hits += hit
            misses += not hit
            for r in runs:
                last[f"loop_{r.loop}"] += 1
                last.update({k: getattr(r, k) for k in CHAIN_COUNTS})
        torch.cuda.synchronize()
        per_solve.append((time.perf_counter() - t) * 1e3 / len(problems))
        if len(per_solve) == 1:
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved() - reserved
            entries = len(graph.cache_info())
    later = sorted(per_solve[1:])

    def round_():
        for tensors, cones in problems:
            with _quiet(args.verbose):
                solve(*tensors[:4], cones, *tensors[4:], **kw)

    graphs_ms, _, _ = graph_device_ms(round_)
    unit = "stack" if args.batch else "solve"
    batch = f" B={args.batch}" if args.batch else ""
    print(f"[chain] family={args.family}{batch} kkt={args.kkt} "
          f"n={problems[0][0][1].shape[-1]} "
          f"instances={args.chain} rounds={ROUNDS} "
          f"ms_per_{unit}={later[ROUNDS // 2]:.2f} "
          f"ms_per_{unit}_min={later[0]:.2f} "
          f"ms_per_{unit}_max={later[-1]:.2f} "
          f"first_round_ms_per_{unit}={per_solve[0]:.2f} "
          f"graphs_ms_per_{unit}={graphs_ms / len(problems):.3f} "
          f"hits={hits} captures={misses} entries={entries} "
          f"reserved_mb_entries={reserved / 2**20:.1f} "
          + "".join(f"{k}={v} " for k, v in sorted(last.items()))
          + f"device={torch.cuda.get_device_name(0)!r}")


if __name__ == "__main__":
    sys.exit(main())
