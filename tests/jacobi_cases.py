"""Inputs of the Jacobi tests, numpy only (no JAX, no torch): the CPU tests
(tests/test_torch_jacobi.py), the card tests (tests/test_torch_cuda.py),
tests/jacobi_sweeps.py and chip_smoke.py draw the same matrices from
here."""

import numpy as np


def sym(rng, *shape):
    X = rng.standard_normal(shape)
    return (X + np.swapaxes(X, -1, -2)) / 2


def clustered(rng, d):
    """Symmetric with repeated eigenvalues: three values, d//3 times or more
    each (the central path's mat(λ) of small_sdp has them)."""
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    w = np.repeat([2.0, -0.5, 1.0], -(-d // 3))[:d]
    return (Q * w) @ Q.T


def reflected(d, seed, values=(2.0, -0.5, 1.0)):
    """Three values, each repeated ⌈d/3⌉ times (the last cut at d),
    reflected by the Householder matrix I - 2 v vᵀ of a unit v drawn from
    ``default_rng(seed)``: an exactly repeated spectrum, which took the
    model 27 to more than 40 sweeps at d = 33-200 (NaN past the limit)
    without the negligible-element rule (tests/jacobi_sweeps.py)."""
    v = np.random.default_rng(seed).standard_normal(d)
    v /= np.linalg.norm(v)
    H = np.eye(d) - 2 * np.outer(v, v)
    return (H * np.repeat(values, -(-d // 3))[:d]) @ H.T


def projector(d, seed):
    """``reflected`` with the values 1, 0, 0: a projector of rank ⌈d/3⌉."""
    return reflected(d, seed, (1.0, 0.0, 0.0))


def rule_edge(a, d):
    """(at, past): order-d matrices whose round-0 pair (0, d - 1) has
    a_pp = a_qq = a and a_pq the largest value that the rule takes
    (|a| + a_pq == |a|), or the next double, which it does not; the pair
    (1, d - 2) of the same round holds 0.5 between 0.25 and -0.25, so a
    sweep runs, and no other entry is off the diagonal."""
    at = np.spacing(abs(a)) / 2
    if abs(a) + at != abs(a):  # a tie that rounds up
        at = np.nextafter(at, 0)
    past = np.nextafter(at, 1)
    assert abs(a) + at == abs(a) and abs(a) + past != abs(a)
    out = []
    for g in (at, past):
        A = np.zeros((d, d))
        A[0, 0] = A[d - 1, d - 1] = a
        A[0, d - 1] = A[d - 1, 0] = g
        A[1, 1], A[d - 2, d - 2] = 0.25, -0.25
        A[1, d - 2] = A[d - 2, 1] = 0.5
        out.append(A)
    return out


def rotated_pair(U, d):
    """Whether U's columns mix e_0 and e_(d-1): two columns with a nonzero
    entry in row 0, else one that is ±e_0 exactly."""
    cols = np.flatnonzero(U[0] != 0)
    if len(cols) == 1:
        assert abs(U[0, cols[0]]) == 1 and U[d - 1, cols[0]] == 0
        return False
    assert len(cols) == 2
    return True


def rule_edge_triples(count, seed=1):
    """(a_pp, a_pq, a_qq) arrays of ``count`` triples with a_pq at the
    rule's edge for |a_pp| (the largest a_pq with |a_pp| + a_pq == |a_pp|)
    in the first half and one unit in the last place past it in the second;
    a_qq = a_pp in every 3rd, else 1 or 2 times it in magnitude, so the
    test on a_pp decides."""
    rng = np.random.default_rng(seed)
    app = rng.uniform(0.5, 1.0, count) * 2.0 ** rng.integers(-60, 1, count)
    app *= rng.choice([-1.0, 1.0], count)
    at = np.spacing(np.abs(app)) / 2
    up = np.abs(app) + at != np.abs(app)  # ties that round up
    at[up] = np.nextafter(at[up], 0)
    apq = np.where(np.arange(count) < count // 2, at, np.nextafter(at, 1))
    apq *= rng.choice([-1.0, 1.0], count)
    aqq = app * np.where(np.arange(count) % 3 == 0, 1.0,
                         rng.choice([1.0, -1.0, 2.0, -2.0], count))
    return app, apq, aqq
