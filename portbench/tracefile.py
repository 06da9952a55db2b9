"""Reduction of a profiler's chrome trace to the profiled stretch's
device activity: its device events, busy time, idle gaps and the
breakdown that the result line carries."""

from __future__ import annotations

from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
# entries of each list of the breakdown
TOP = 10


def stretch(events, name):
    """(start, end) in µs of the host span ``name``."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    if len(spans) != 1:
        raise ValueError(f"expected one span {name!r}, found {len(spans)}")
    return spans[0]


def device_events(events, lo, hi):
    """Kernels, copies and memsets that start inside [lo, hi]."""
    return [e for e in events if e.get("cat") in DEVICE_CATS
            and lo <= e["ts"] <= hi]


def busy_intervals(device, lo, hi):
    """The union of the events' intervals, clipped to [lo, hi], as a
    sorted list of disjoint (start, end)."""
    merged = []
    for e in sorted(device, key=lambda e: e["ts"]):
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(x) for x in merged]


def busy_us(device, lo, hi) -> float:
    return sum(b - a for a, b in busy_intervals(device, lo, hi))


def kernel_name(name: str) -> str:
    """A kernel's function name with its template arguments, without its
    return type and argument list, cut to 80 characters."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.endswith(")"):  # the argument list: the last balanced (...)
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i].rstrip()
                break
    depth, cut = 0, 0  # the return type: up to the last top-level space
    for i, ch in enumerate(s):
        depth += {"<": 1, "(": 1, ">": -1, ")": -1}.get(ch, 0)
        if ch == " " and depth == 0:
            cut = i + 1
    return (s[cut:] or s)[:80]


def op_name(event) -> str:
    """A device event's name: a kernel's by :func:`kernel_name`, a copy's
    or memset's as the profiler gives it."""
    if event.get("cat") == "kernel":
        return kernel_name(event["name"])
    return event["name"][:80]


def device_ops(device):
    """[name, seconds] of the device operations that took most time."""
    total = defaultdict(float)
    for e in device:
        total[op_name(e)] += e["dur"] * 1e-6
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:TOP]


def idle_gaps(events, device, lo, hi, skip=()):
    """[what the host was doing, seconds] for the device's idle time in
    [lo, hi]: each gap between busy intervals is put down to the innermost
    host event (latest start) that spans its middle, or to untraced host
    code; summed by that name, the longest first."""
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("name") not in skip and "dur" in e
                   and e["ts"] <= hi and e["ts"] + e["dur"] >= lo),
                  key=lambda e: e["ts"])
    busy = busy_intervals(device, lo, hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    total = defaultdict(float)
    live, j = [], 0  # host events begun by the gap's middle, by start
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(host) and host[j]["ts"] <= mid:
            live.append(host[j])
            j += 1
        live = [e for e in live if e["ts"] + e["dur"] >= mid]
        name = f"host: {live[-1]['name'][:70]}" if live else "host: untraced"
        total[name] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:TOP]
