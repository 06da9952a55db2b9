"""Layer: entry (``conic_ip`` / ``solve_batch``). Each window call's host
time outside its waits on the card, read from the program's own spans:
its root span ``conicip::call`` less its ``conicip::wait`` spans (the
call's span record, which every run record of the call points to:
``Run.spans`` in ``solver.runs`` / ``parallel.batch.runs``), in ms,
averaged over every call of the traced run's window. Nothing to read in
an untraced run, on the CPU, or where the program records no spans."""

CALL, WAIT = "conicip::call", "conicip::wait"


def spans_of(answer):
    """The span record of a call, from the first of its runs that holds
    one; None if none does."""
    for run in answer.runs:
        record = getattr(run, "spans", None)
        if record is not None:
            return record
    return None


def busy_ns(record) -> int:
    root = next(s for s in record.spans if s.name == CALL and s.parent is None)
    waits = sum(s.end_ns - s.start_ns for s in record.spans if s.name == WAIT)
    return root.end_ns - root.start_ns - waits


def read(ctx):
    if not ctx.traced or not ctx.records:
        return None
    records = [spans_of(r.answer) for r in ctx.records]
    if any(rec is None for rec in records):
        return None
    return sum(busy_ns(rec) for rec in records) * 1e-6 / len(records)
