"""Sweeps of the Jacobi eigendecomposition on the matrices that need the most.

    python tests/jacobi_sweeps.py [--orders 33 40 100]

For each order, on tests/test_torch_jacobi.py's cases (its seed), prints
the sweeps ``jacobi_model.eigh_one`` takes and, per sweep, the
off-diagonal norm over the convergence threshold eps |A|_F: the clustered
spectrum in f64 and f32, the same spectrum split by 1e-12, a random
matrix, and the clustered spectrum in a row-cyclic ordering (one rotation
at a time, p < q by rows) in place of the kernels' circle ordering. The
numbers behind ``MAX_SWEEPS`` (conicip_tpu_torch/ops/jacobi_kernel.py);
numpy only, on the CPU.
"""

import argparse

import numpy as np

import jacobi_model as model
from test_torch_jacobi import clustered, sym


def norms(X, rows=False):
    """Off-diagonal norm over eps |A|_F before each sweep, to convergence
    or the sweep limit, in the circle ordering (``rows``: row-cyclic)."""
    A, _ = model._scaled(np.tril(X) + np.tril(X, -1).T)
    d = A.shape[0]
    n = d + (d & 1)
    off_diag = ~np.eye(d, dtype=bool)
    tol = np.finfo(np.float64).eps * np.sqrt(np.sum(A * A))
    out = []
    for _ in range(model.MAX_SWEEPS + 1):
        out.append(np.sqrt(np.sum(A[off_diag] ** 2)) / tol)
        if out[-1] <= 1:
            break
        rounds = ([(np.array([p]), np.array([q])) for p in range(d)
                   for q in range(p + 1, d)] if rows else
                  [model.pairs(r, n) for r in range(n - 1)])
        for P, Q in rounds:
            p, q = P[Q < d], Q[Q < d]
            apq, app, aqq = A[p, q], A[p, p], A[q, q]
            c, s, t = model.rotation(app, apq, aqq)
            on = s != 0
            p, q, c, s, t = p[on], q[on], c[on], s[on], t[on]
            new_p, new_q = app[on] - t * apq[on], aqq[on] + t * apq[on]
            x, y = A[p, :].copy(), A[q, :].copy()
            A[p, :] = c[:, None] * x - s[:, None] * y
            A[q, :] = s[:, None] * x + c[:, None] * y
            model._rotate_columns(A, p, q, c, s)
            A[p, p], A[q, q], A[p, q], A[q, p] = new_p, new_q, 0, 0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--orders", type=int, nargs="+", default=[33, 40, 100])
    a = ap.parse_args(argv)
    for d in a.orders:
        rng = np.random.default_rng(d)
        R = sym(rng, d, d)  # the draws of eigh_cases, in its order
        C = clustered(rng, d)
        w, Q = np.linalg.eigh(C)
        split = (Q * (w + 1e-12 * np.arange(d))) @ Q.T
        for label, X, rows in (("clustered f64", C, False),
                               ("clustered f32", C.astype(np.float32), False),
                               ("clustered split 1e-12", split, False),
                               ("random f64", R, False),
                               ("clustered f64 row-cyclic", C, True)):
            out = norms(X, rows)
            print(f"d={d} {label}: {len(out) - 1} sweeps; off/threshold "
                  + " ".join(f"{x:.1e}" for x in out))


if __name__ == "__main__":
    main()
