"""Layer: device. 100 × the profiled stretch's device idle time that lies
outside every ``conicip::wait`` range, over the stretch's length, in %:
the card idle while the host did not wait on it, so the card waited on
the host. A ``conicip::wait`` span (a host read that blocks until the
card is done) opens a profiler range of its name while the profiler
runs; each idle interval is split at the ranges' edges. ``device_idle_share``
less this is the card's own idle time inside the solves' graphs, while
the host waited. Nothing to read without a profiled stretch or where the
program opens no such range."""

from .. import tracefile

WAIT = "conicip::wait"


def merged(intervals):
    """The union of (start, end) intervals, as a sorted list of disjoint
    ones."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    lo, hi = ctx.trace.lo, ctx.trace.hi
    waits = merged((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in ctx.prof.events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == WAIT and "dur" in e)
    if not waits:
        return None
    busy = tracefile.busy_intervals(ctx.trace.device, lo, hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    outside = sum(b - a for a, b in idle) - overlap(idle, waits)
    return 100.0 * outside / (hi - lo)
