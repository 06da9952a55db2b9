"""The Jacobi kernels' arithmetic (conicip_tpu_torch/csrc/jacobi.cu) in numpy.

Step for step as the kernels do it, one matrix at a time and in double
whatever the input's type (the f32 entries read and write f32): the
power-of-two scaling, the circle ordering of the pairs, Rutishauser's
rotation and his negligible-element rule (:func:`negligible`), the row
update, the column update and the exact 2 x 2 block of each round, the
convergence tests, the sweep limit and the sort (stable: ties by index).
Only the order of the sums in the reductions differs (and the kernels
round one product of each rotated value and fuse the other into an FMA),
so a result may differ from the kernel's in the last bits and, at a
convergence test that lands on its threshold, by one sweep. Change both
together.

The kernels rotate a round as one pass over 2 x 2 blocks (rows, then
columns, from each block's own four values) where this model makes a row
pass and then a column pass; :func:`fused_round` is that pass in numpy,
and ``eigh_one(..., fused=True)`` runs it in their place. The two give the
same bits (tests/test_torch_jacobi.py). The block kernels (d > 32) label a
round's pairs by :func:`pairs_ab` and sum a sweep's off-diagonal squares in
its last round, where this model sums them before the next sweep: the same
pairs and the same entries, in another order.

It imports no JAX: tests/test_torch_jacobi.py holds it against LAPACK and
the JAX package, tests/test_torch_cuda.py holds the kernels against it.
"""

import numpy as np

MAX_SWEEPS = 40  # as conicip_tpu_torch.ops.jacobi_kernel.MAX_SWEEPS


def pairs(r, n):
    """Pairs (p < q) of round r of the circle ordering of n (even) indices:
    index n - 1 stays, the others turn."""
    k = np.arange(n // 2)
    a = np.where(k == 0, n - 1, (r + k) % (n - 1))
    b = np.where(k == 0, r, (r - k + (n - 1)) % (n - 1))
    return np.minimum(a, b), np.maximum(a, b)


def pairs_ab(r, n):
    """The same pairs as ``pairs(r, n)`` as the block kernels label and
    orient them (csrc/jacobi.cu pair_ab): pair j < n/2 - 1 is (r + 1 + j,
    r - 1 - j) mod (n - 1), the last (r, n - 1); a and b in that order, not
    sorted."""
    L, j = n - 1, np.arange(n // 2 - 1)
    return (np.append((r + 1 + j) % L, r).astype(int),
            np.append((r - 1 - j) % L, L).astype(int))


def rotation(app, apq, aqq):
    """(c, s, t) zeroing [[app, apq], [apq, aqq]], elementwise; s = 0 where
    apq = 0."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        theta = (aqq - app) / (2 * apq)
        t = np.where(theta >= 0, 1.0, -1.0) / (np.abs(theta)
                                               + np.hypot(theta, 1.0))
    t = np.where(apq != 0, t, 0.0)
    c = 1 / np.sqrt(1 + t * t)
    return c, t * c, t


def negligible(app, apq, aqq):
    """Rutishauser's negligible-element rule (Handbook for Automatic
    Computation II/1, "jacobi"), elementwise: a_pq != 0 whose magnitude,
    added to |a_pp| and to |a_qq|, changes neither. The eigh kernels set
    such an a_pq to 0 and do not rotate its pair. The Handbook adds 100
    |a_pq|; the kernels add |a_pq| itself, so the rule takes every a_pq
    below half a unit in the last place of both diagonal entries: the
    rounding noise of an exactly repeated eigenvalue's block, whose
    rotations would otherwise be large turns on noise that mix its rows'
    couplings to the other eigenvalues back in (tests/jacobi_sweeps.py).
    Zeroing such an a_pq changes A by less than rounding its diagonal."""
    g = np.abs(apq)
    return ((apq != 0) & (np.abs(app) + g == np.abs(app))
            & (np.abs(aqq) + g == np.abs(aqq)))


def round_rotations(A, p, q):
    """The rotations of one round of A's pairs (p, q), as the eigh kernels
    compute them: sets each negligible a_pq (and a_qp) of A to 0, and
    returns the mask of the pairs that rotate (s != 0, a_pq not
    negligible), their (c, s, t) and the closed form of their rotated
    diagonal (a_pp - t a_pq, a_qq + t a_pq)."""
    apq, app, aqq = A[p, q], A[p, p], A[q, q]
    c, s, t = rotation(app, apq, aqq)
    zero = negligible(app, apq, aqq)
    A[p[zero], q[zero]] = A[q[zero], p[zero]] = 0
    on = (s != 0) & ~zero
    t, apq = t[on], apq[on]
    return on, c[on], s[on], t, app[on] - t * apq, aqq[on] + t * apq


def _scaled(X):
    """X in double, scaled by 2^-e to a largest entry in [1/2, 1), and e."""
    X = X.astype(np.float64)
    big = np.abs(X).max()
    e = int(np.frexp(big)[1]) if big > 0 else 0
    return np.ldexp(X, -e), e


def _rotate_columns(X, p, q, c, s):
    x, y = X[:, p].copy(), X[:, q].copy()
    X[:, p] = x * c - y * s
    X[:, q] = x * s + y * c


def fused_round(A, P, Q, k, c, s):
    """Round (pairs P, Q of ``pairs``) of A (d x d, in place) as the d <= 32
    kernels compute it: every 2 x 2 block A[{P_k, Q_k}, {P_l, Q_l}] on its
    own, its rows rotated by J_k and then its columns by J_l, for the
    rotating pairs ``k`` (cosines c, sines s); the other pairs (s = 0, a
    negligible a_pq, and the idle index of odd d, padded with a zero row
    and column) leave their rows and columns as they are. The diagonal
    blocks are the caller's."""
    d = A.shape[0]
    n = d + (d & 1)
    on = np.zeros(n // 2, bool)
    cf, sf = np.ones(n // 2), np.zeros(n // 2)
    on[k], cf[k], sf[k] = True, c, s
    Ap = np.zeros((n, n))
    Ap[:d, :d] = A
    X00, X01 = Ap[np.ix_(P, P)], Ap[np.ix_(P, Q)]
    X10, X11 = Ap[np.ix_(Q, P)], Ap[np.ix_(Q, Q)]
    ck, sk, rk = cf[:, None], sf[:, None], on[:, None]
    # rows P_k, Q_k by J_k
    Y00 = np.where(rk, ck * X00 - sk * X10, X00)
    Y10 = np.where(rk, sk * X00 + ck * X10, X10)
    Y01 = np.where(rk, ck * X01 - sk * X11, X01)
    Y11 = np.where(rk, sk * X01 + ck * X11, X11)
    # then columns P_l, Q_l by J_l
    cl, sl, rl = cf[None, :], sf[None, :], on[None, :]
    Ap[np.ix_(P, P)] = np.where(rl, Y00 * cl - Y01 * sl, Y00)
    Ap[np.ix_(P, Q)] = np.where(rl, Y00 * sl + Y01 * cl, Y01)
    Ap[np.ix_(Q, P)] = np.where(rl, Y10 * cl - Y11 * sl, Y10)
    Ap[np.ix_(Q, Q)] = np.where(rl, Y10 * sl + Y11 * cl, Y11)
    A[:] = Ap[:d, :d]


def eigh_one(X, vectors=True, max_sweeps=MAX_SWEEPS, fused=False,
             norms=None):
    """(w ascending, U or None) of the symmetric matrix whose lower
    triangle X holds; NaN where X is not finite or at the sweep limit.
    ``fused`` rotates each round with :func:`fused_round`; a list
    ``norms`` gets the off-diagonal norm over the convergence threshold
    eps |A|_F before each sweep (its length less one is the sweeps
    taken)."""
    d, dt = X.shape[-1], X.dtype
    nan = (np.full(d, np.nan, dt), np.full((d, d), np.nan, dt) if vectors
           else None)
    if not np.isfinite(X).all():
        return nan
    A, e = _scaled(np.tril(X) + np.tril(X, -1).T)
    U = np.eye(d)
    eps = np.finfo(np.float64).eps
    tol2 = eps * eps * np.sum(A * A)
    n = d + (d & 1)
    off_diag = ~np.eye(d, dtype=bool)
    sweep = 0
    while True:
        off = np.sum(A[off_diag] ** 2)
        if norms is not None:
            norms.append(np.sqrt(off / tol2) if tol2 > 0 else 0.0)
        if off <= tol2:
            break
        if sweep == max_sweeps:
            return nan
        for r in range(n - 1):
            P, Q = pairs(r, n)
            p, q = P[Q < d], Q[Q < d]
            on, c, s, t, new_p, new_q = round_rotations(A, p, q)
            p, q = p[on], q[on]
            if fused:
                fused_round(A, P, Q, np.flatnonzero(Q < d)[on], c, s)
            else:
                x, y = A[p, :].copy(), A[q, :].copy()
                A[p, :] = c[:, None] * x - s[:, None] * y
                A[q, :] = s[:, None] * x + c[:, None] * y
                _rotate_columns(A, p, q, c, s)
            if vectors:
                _rotate_columns(U, p, q, c, s)
            A[p, p], A[q, q], A[p, q], A[q, p] = new_p, new_q, 0, 0
        sweep += 1
    w = np.diag(A).copy()
    order = np.argsort(w, kind="stable")
    return (np.ldexp(w[order], e).astype(dt),
            U[:, order].astype(dt) if vectors else None)


def svd_one(X, max_sweeps=MAX_SWEEPS):
    """(U, σ descending) of the square X by one-sided Jacobi on its
    columns; NaN where X is not finite or at the sweep limit."""
    d, dt = X.shape[-1], X.dtype
    nan = (np.full((d, d), np.nan, dt), np.full(d, np.nan, dt))
    if not np.isfinite(X).all():
        return nan
    W, e = _scaled(X)
    tol = d * np.finfo(np.float64).eps
    n = d + (d & 1)
    for _ in range(max_sweeps):
        rotated = False
        for r in range(n - 1):
            p, q = pairs(r, n)
            p, q = p[q < d], q[q < d]
            a = np.sum(W[:, p] * W[:, p], axis=0)
            b = np.sum(W[:, q] * W[:, q], axis=0)
            g = np.sum(W[:, p] * W[:, q], axis=0)
            c, s, _ = rotation(a, g, b)
            need = np.abs(g) > tol * np.sqrt(a) * np.sqrt(b)
            on = need & (s != 0)
            rotated |= bool(on.any())
            _rotate_columns(W, p[on], q[on], c[on], s[on])
        if not rotated:
            break
    else:
        return nan
    sig = np.sqrt(np.sum(W * W, axis=0))
    order = np.argsort(-sig, kind="stable")
    with np.errstate(divide="ignore", invalid="ignore"):
        U = np.where(sig > 0, W / sig, 0.0)
    return U[:, order].astype(dt), np.ldexp(sig[order], e).astype(dt)


def _stacked(one, X, *outs):
    """Apply ``one`` to every matrix of the stack X (..., d, d)."""
    X = np.asarray(X)
    flat = X.reshape((-1,) + X.shape[-2:])
    res = [one(M) for M in flat]
    return tuple(None if res[0][i] is None else
                 np.stack([r[i] for r in res]).reshape(X.shape[:-2] + shape)
                 for i, shape in enumerate(outs))


def eigh(X, max_sweeps=MAX_SWEEPS):
    d = X.shape[-1]
    return _stacked(lambda M: eigh_one(M, True, max_sweeps), X, (d,), (d, d))


def eigvalsh(X, max_sweeps=MAX_SWEEPS):
    d = X.shape[-1]
    return _stacked(lambda M: eigh_one(M, False, max_sweeps), X, (d,),
                    (d, d))[0]


def svd(X, max_sweeps=MAX_SWEEPS):
    d = X.shape[-1]
    return _stacked(lambda M: svd_one(M, max_sweeps), X, (d, d), (d,))
