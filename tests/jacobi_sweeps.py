"""Sweeps of the Jacobi eigendecomposition on the matrices that need the most.

    python tests/jacobi_sweeps.py [--orders 33 64 128 200] [--rule kernels]

For each order, on the test cases of tests/jacobi_cases.py, prints
the sweeps ``jacobi_model.eigh_one`` takes and, per sweep, the
off-diagonal norm over the convergence threshold eps |A|_F: a three-value
spectrum, each value repeated d/3 times, reflected by a Householder matrix
(``reflected``, seeds 1000-1004) and as a projector of rank d/3
(``projector``, seeds 1000-1002); the same three values in a random
orthogonal basis (``clustered``) in f64 and f32, and split by 1e-12; a
random matrix; and the clustered spectrum in a row-cyclic ordering (one
rotation at a time, p < q by rows) in place of the kernels' circle
ordering. ``--rule`` swaps the negligible-element rule the kernels take
(``kernels``: |a_pq| added to |a_pp| and |a_qq| changes neither) for the
Handbook's (``handbook``: 100 |a_pq| added) or for none (``none``: every
pair with a_pq != 0 rotates, as before the rule). A count past the limit
prints as ``>MAX_SWEEPS``. The numbers behind ``MAX_SWEEPS``
(conicip_tpu_torch/ops/jacobi_kernel.py); numpy only, on the CPU.
"""

import argparse

import numpy as np

import jacobi_model as model
from jacobi_cases import clustered, projector, reflected, sym

KERNELS = model.negligible


def handbook(app, apq, aqq):
    """The Handbook's rule: 100 |a_pq| added to |a_pp| and |a_qq|."""
    g = 100 * np.abs(apq)
    return ((apq != 0) & (np.abs(app) + g == np.abs(app))
            & (np.abs(aqq) + g == np.abs(aqq)))


def never(app, apq, aqq):
    return np.zeros(np.shape(apq), bool)


RULES = {"kernels": KERNELS, "handbook": handbook, "none": never}


def row_cyclic(X):
    """The norms of ``eigh_one(X, norms=...)`` with one rotation at a time,
    the pairs p < q by rows, in place of the circle ordering's rounds."""
    A, _ = model._scaled(np.tril(X) + np.tril(X, -1).T)
    d = A.shape[0]
    off_diag = ~np.eye(d, dtype=bool)
    tol = np.finfo(np.float64).eps * np.sqrt(np.sum(A * A))
    out = []
    for _ in range(model.MAX_SWEEPS + 1):
        out.append(np.sqrt(np.sum(A[off_diag] ** 2)) / tol)
        if out[-1] <= 1:
            break
        for i in range(d):
            for j in range(i + 1, d):
                p, q = np.array([i]), np.array([j])
                on, c, s, t, new_p, new_q = model.round_rotations(A, p, q)
                p, q = p[on], q[on]
                x, y = A[p, :].copy(), A[q, :].copy()
                A[p, :] = c[:, None] * x - s[:, None] * y
                A[q, :] = s[:, None] * x + c[:, None] * y
                model._rotate_columns(A, p, q, c, s)
                A[p, p], A[q, q], A[p, q], A[q, p] = new_p, new_q, 0, 0
    return out


def norms(X, rows=False):
    """Off-diagonal norm over eps |A|_F before each sweep, to convergence
    or the sweep limit (``rows``: row-cyclic)."""
    if rows:
        return row_cyclic(X)
    out = []
    model.eigh_one(X, vectors=False, norms=out)
    return out


def cases(d):
    """(label, matrix, row-cyclic) at order d."""
    rng = np.random.default_rng(d)
    R = sym(rng, d, d)  # the draws of eigh_cases, in its order
    C = clustered(rng, d)
    w, Q = np.linalg.eigh(C)
    split = (Q * (w + 1e-12 * np.arange(d))) @ Q.T
    out = [(f"reflected seed {s}", reflected(d, s), False)
           for s in range(1000, 1005)]
    out += [(f"projector seed {s}", projector(d, s), False)
            for s in range(1000, 1003)]
    return out + [("clustered f64", C, False),
                  ("clustered f32", C.astype(np.float32), False),
                  ("clustered split 1e-12", split, False),
                  ("random f64", R, False),
                  ("clustered f64 row-cyclic", C, True)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--orders", type=int, nargs="+",
                    default=[5, 10, 20, 33, 64, 100, 128, 200])
    ap.add_argument("--rule", choices=sorted(RULES), default="kernels")
    a = ap.parse_args(argv)
    model.negligible = RULES[a.rule]
    try:
        for d in a.orders:
            for label, X, rows in cases(d):
                out = norms(X, rows)
                done = out[-1] <= 1
                sweeps = (len(out) - 1 if done
                          else f">{model.MAX_SWEEPS}")
                print(f"d={d} rule={a.rule} {label}: {sweeps} sweeps; "
                      "off/threshold " + " ".join(f"{x:.1e}" for x in out),
                      flush=True)
    finally:
        model.negligible = KERNELS


if __name__ == "__main__":
    main()
