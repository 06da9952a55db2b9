"""The benchmark of ``conicip_tpu_torch``: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The run builds the cell's pool of instances
on the card from ``--seed``, warms the cell's one shape (a miss of the
program's graph cache, then hits), drives one client in a closed loop for
``--seconds``, judges every answer of the window against the plain
reference (``check.py``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``check``, each compared
number beside its limit (also the last lines of standard error).

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics: the window with CUDA events around the program's graph
replays, then a profiled stretch of hits of graphs captured inside the
profiler's session (``harness.profiled_stretch``).

Exit codes: 0 with a result; 2 for a bad argument or no such cell; 3 when
there is no CUDA card, or fewer than the cell asks for; 4 when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from collections import Counter
from types import SimpleNamespace

from . import harness

# modules the port must never load, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "conicip_tpu")
# profiled stretch of hits in a traced run, s
STRETCH_S = 0.3
# warm-up: at least this many calls and seconds of the cell's own calls
# (a miss, then hits), so that the card's clocks and the allocator settle
WARM_CALLS, WARM_S = 3, 2.0


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def fix_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at a fixed path
    (the program builds its CUDA sources into its own ``_build/``)."""
    base = harness.ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def measure(cell, seed, seconds, trace, device="cuda", t_start=None):
    """One run of ``cell`` (``harness.Cell``) on ``device``: the result's
    fields as a dict, ``check`` a list of (name, value, limit). On the CPU
    (the tests) the program runs its CPU path and nothing is traced."""
    import torch

    import conicip_tpu_torch as program

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    t_pool = time.perf_counter()
    pool = harness.Pool(cell.config, cell.traffic, seed, device)
    harness.sync(device)
    call = harness.make_call(program, cell.traffic,
                             cell.config.get("options", {}), device)
    # set-up: the cell's one shape, a miss and then hits
    t_warm = time.perf_counter()
    calls = 0
    while calls < WARM_CALLS or (
            cuda and time.perf_counter() - t_warm < WARM_S):
        call(pool.operands(calls % pool.slots))
        calls += 1
    harness.sync(device)
    # what set-up made lives on: keep the collector from walking it again
    # while the window runs
    gc.collect()
    gc.freeze()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    print(f"setup: {t_pool - t_start:.3f} s to the pool, "
          f"{t_warm - t_pool:.3f} s the pool, {t_window - t_warm:.3f} s "
          f"{calls} warm-up calls", file=sys.stderr)

    spans = (harness.GraphSpans(program.solver.graph) if trace and cuda
             else None)
    if spans:
        with spans:
            records, window_s = harness.closed_loop(call, pool, seconds,
                                                        device, spans)
    else:
        records, window_s = harness.closed_loop(call, pool, seconds, device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    prof = None
    if trace and cuda:
        prof = harness.profiled_stretch(program, call, pool, STRETCH_S)
    program.solver.graph.clear()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    for r in records:
        if isinstance(r.answer.iters, torch.Tensor):
            r.answer.iters = r.answer.iters.tolist()
    units = Counter(sum(run.units for run in r.answer.runs) for r in records)
    print(f"window: {len(records)} calls in {window_s:.3f} s, calls by "
          f"units run: {dict(sorted(units.items()))}", file=sys.stderr)
    statuses = [s for r in records for s in r.answer.status]
    ctx = SimpleNamespace(
        cell=cell, device=device, setup_s=setup_s, window_s=window_s,
        records=records, traced=spans is not None, prof=prof,
        attempted=len(statuses),
        certified=sum(s == "Optimal" for s in statuses))
    ctx.trace = _reduce(prof) if prof else None

    from . import check
    solved = check.reference_solutions(cell.config, pool, torch.float64)[3]
    values = check.numbers(pool, [(r.slot, r.answer) for r in records],
                           solved)
    rows, correct = check.judge(values, cell.limits)

    if trace:
        metrics = harness.read_metrics(cell.per_layer, "metrics", ctx)
    else:
        metrics = harness.read_metrics(cell.end_to_end, "endtoend", ctx)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=cell.chips, memory_peak_bytes=peak)
    out = dict(correct=correct, attempted=ctx.attempted,
               failed=ctx.attempted - ctx.certified, metrics=metrics,
               device=dev)
    if ctx.trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown
    out["check"] = rows
    return out


def _reduce(prof):
    """The profiled stretch's device activity (``tracefile``)."""
    from . import tracefile as tf

    lo, hi = tf.stretch(prof.events, harness.STRETCH)
    device = tf.device_events(prof.events, lo, hi)
    return SimpleNamespace(
        lo=lo, hi=hi, device=device,
        kernels=[e for e in device if e["cat"] == "kernel"],
        busy_s=tf.busy_us(device, lo, hi) * 1e-6,
        window_s=(hi - lo) * 1e-6,
        breakdown=dict(device_ops=tf.device_ops(device),
                       idle_gaps=tf.idle_gaps(prof.events, device, lo, hi,
                                              skip=(harness.STRETCH,))))


def finite(x):
    """``x`` with every non-finite float replaced by its name ("nan",
    "inf"), so that the result line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def check_lines(rows) -> list:
    return [f"check {name}: {value!r} (limit {limit!r})"
            for name, value, limit in rows]


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age_s()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = harness.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"portbench: no cell {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    fix_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = measure(cell, args.seed, args.seconds, args.trace, "cuda", t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: forbidden modules loaded: {leaked}",
              file=sys.stderr)
        return 4
    out["check"] = {name: {"value": value, "limit": limit}
                    for name, value, limit in out["check"]}
    print("\n".join(check_lines((k, v["value"], v["limit"])
                                for k, v in out["check"].items())),
          file=sys.stderr)
    print(json.dumps(finite(out), allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
