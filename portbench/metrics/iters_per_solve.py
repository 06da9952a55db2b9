"""Layer: IPM loop. Interior-point iterations per instance
(``Solution.Iter``, a ``BatchSolution``'s ``Iter``), averaged over every
instance of the window."""


def read(ctx):
    iters = [i for r in ctx.records for i in r.answer.iters]
    return sum(iters) / len(iters) if iters else None
