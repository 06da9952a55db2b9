"""Intra-problem (tensor) parallelism: sharded Schur assembly and
distributed factorization over ``torch.distributed``.

Counterpart of ``conicip_tpu/parallel/distributed.py``, with the same
design. For one large problem the per-iteration Schur matrix

    M = Q + Atilᵀ Atil,     Atil = F⁻ᵀ A

is a sum over constraint-row blocks, and both O(·³) stages are sharded over
the ``ntp`` ranks of one mesh axis:

1. **Assembly** (O(mn²)): each rank forms the Gram partial of its rows of
   ``Atil`` and one ``reduce_scatter`` sums the partials straight into
   block rows of M; no rank holds the whole (n, n) matrix.
2. **Factorization** (O(n³)): a 1-D block-row panel Cholesky, one panel
   per rank. Per panel the block column is all-gathered, the r×r diagonal
   block is factored on every rank by :func:`~conicip_tpu_torch.ops.cholesky.cholesky`
   (the hand-written kernel on the card, its f64 or f32 single entry at
   order r = n_pad / ntp), and each rank updates its own rows.
3. **Back-solves**: the factorization also forms the explicit inverse
   ``W = L⁻¹``, column-sharded, by forward block rows (L's block rows are
   broadcast one by one). Every right-hand side then costs two sharded
   GEMVs, ``M̃⁻¹x = D·Wᵀ(W(D·x))``: one ``all_reduce`` and one
   ``all_gather`` of an n-vector.

The NT scaling ``Atil = F⁻ᵀA`` is sharded over the cone blocks too
(``shard_scaling=True``): A's rows are grouped per cone batch once, each
group's cone axis split over the ranks, and each rank scales its own cones
only. Groups and rows are zero-padded to multiples of ``ntp`` (zero rows add
nothing to the Gram); n is identity-padded. Equalities are handled as in
``kkt/schur.py``: ``M̃ = M + γGᵀG`` and a replicated p×p second Schur
complement, whose factor runs the kernel at order p.

**One process per rank (SPMD).** ``shard_map`` runs one program over many
devices from one controller; here every rank is a process that calls
``conic_ip(Q, c, A, b, cones, kktsolver=kktsolver_schur_tp(mesh, "tp"))``
on the same replicated problem. The interior-point loop, the cone algebra
and the status logic run replicated on every rank; only the KKT build and
solve below are sharded, each rank taking its block rows, columns or cones
by its place along ``mesh[axis]``. Two rules keep the ranks in step:

- The replicated state is built only from what collectives return
  (``all_reduce``, ``all_gather``, ``broadcast`` give every rank the same
  bits) and from deterministic arithmetic on it, so every rank's loop takes
  the same path.
- Every host branch here (the ridge retry) reads a flag that went through
  an ``all_reduce``. A rank that took another branch than the others would
  wait forever in a collective they never enter.

Padding (``n_pad``, ``m_pad``, the cone-group counts) is computed from
shapes alone, the same on every rank. A world of one reduces to the
single-device path: one panel factored by the kernel, ``W`` from one
triangular solve.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cones import scaling as sc
from ..cones.spec import ConeSpec
from ..cones.symm import mat, vecm
from ..kkt.pivot import pivot
from ..ops.cholesky import cholesky, tri_inv
from .mesh import MeshAxis

__all__ = ["kktsolver_schur_tp", "distributed_normal_matrix"]


def _ceil_to(x: int, k: int) -> int:
    return -(-x // k) * k


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _all_ranks_finite(ax: MeshAxis, X: torch.Tensor) -> bool:
    """Whether X is finite on every rank of the axis: one all_reduce and
    one host read, the same answer on every rank."""
    flag = torch.isfinite(X).all().to(X.dtype).reshape(1)
    return bool(ax.all_reduce(flag)[0] == ax.size)


def distributed_normal_matrix(Q, A, dinv, mesh, axis: str):
    """``Q + (diag(dinv) A)ᵀ (diag(dinv) A)`` with the rows of A split over
    ``mesh[axis]`` (the last block short: the zero-padded rows would add
    nothing) and one ``all_reduce``. The result is replicated. Tensors stay
    on their device; arrays go to the mesh's."""
    ax = MeshAxis(mesh, axis)
    device = (Q.device if isinstance(Q, torch.Tensor)
              else torch.device(mesh.device_type))
    Q, A, dinv = (_tensor(x, device) for x in (Q, A, dinv))
    k = _ceil_to(A.shape[0], ax.size) // ax.size
    mine = slice(ax.rank * k, (ax.rank + 1) * k)
    Atil = A[mine] * dinv[mine, None]
    return Q + ax.all_reduce(Atil.mT @ Atil)


# ──────────────────────────────────────────────────────────────────────
#  Distributed factorization
# ──────────────────────────────────────────────────────────────────────


def _factor_body(ax: MeshAxis, M_blk, G_pad, ridge, n_pad: int, p: int):
    """This rank's r rows of the assembled augmented Schur matrix → Jacobi
    equilibration → panel Cholesky → column-sharded W = L⁻¹ → equality
    coupling Y. Returns ``(W_loc, dscale, Y, ok)``: W's (n_pad, r) column
    block of this rank, the (n_pad,) scale and the (n_pad, p) ``W (D Gᵀ)``,
    both replicated, and whether W is finite on every rank."""
    ntp, me = ax.size, ax.rank
    r = n_pad // ntp
    fd, dev = M_blk.dtype, M_blk.device
    rows = torch.arange(r, device=dev)
    rowid = me * r + rows
    mine = slice(me * r, (me + 1) * r)

    # Jacobi equilibration from the gathered diagonal
    dscale = torch.rsqrt(torch.clamp(ax.all_gather(M_blk[rows, rowid]),
                                     min=torch.finfo(fd).tiny))
    ds_loc = dscale[mine]
    A_loc = M_blk * ds_loc[:, None] * dscale[None, :]
    A_loc[rows, rowid] += ridge

    # Phase 1: right-looking panel Cholesky, L block-row sharded. Panel j
    # is gathered and its diagonal block factored on every rank; the ranks
    # below it solve for their rows of the panel and update their trailing
    # columns (columns up to the panel are never read again).
    L_loc = torch.zeros_like(A_loc)
    for j in range(ntp):
        c0, c1 = j * r, (j + 1) * r
        C = ax.all_gather(A_loc[:, c0:c1])  # (n_pad, r)
        Ld = cholesky(C[c0:c1])
        if me == j:
            L_loc[:, c0:c1] = Ld
        elif me > j:
            Lb = torch.linalg.solve_triangular(Ld, C[c1:].mT,
                                               upper=False).mT
            L_me = Lb[(me - j - 1) * r:(me - j) * r]
            L_loc[:, c0:c1] = L_me
            A_loc[:, c1:] -= L_me @ Lb.mT

    # Phase 2: W = L⁻¹ column-sharded, by forward block rows. W's column
    # block of this rank is zero above its diagonal block, which is the
    # inverse of this rank's diagonal block of L.
    W_loc = torch.zeros((n_pad, r), dtype=fd, device=dev)
    eye = torch.eye(r, dtype=fd, device=dev)
    for i in range(ntp):
        Lrow = ax.broadcast(L_loc if me == i else torch.empty_like(L_loc), i)
        if i < me:
            continue
        rhs = eye if i == me else -(Lrow[:, :i * r] @ W_loc[:i * r])
        W_loc[i * r:(i + 1) * r] = torch.linalg.solve_triangular(
            Lrow[:, i * r:(i + 1) * r], rhs, upper=False)

    # equality coupling Y = W (D Gᵀ), replicated (p is small)
    if p:
        X_loc = ds_loc[:, None] * G_pad[:, mine].mT  # my rows of D Gᵀ
        Y = ax.all_reduce(W_loc @ X_loc)
    else:
        Y = torch.zeros((n_pad, 0), dtype=fd, device=dev)
    return W_loc, dscale, Y, _all_ranks_finite(ax, W_loc)


def _make_factor_kernel(mesh, axis: str, n_pad: int, p: int, dtype):
    """The factorization from a replicated, pre-scaled ``Atil``: sharded
    Gram reduction → block-row M → panel Cholesky → column-sharded L⁻¹.

    Returns ``factor(Atil_pad, Q_pad, G_pad, gamma, ridge) -> (W_loc,
    dscale, Y, ok)`` (:func:`_factor_body`); every rank passes the whole
    (m_pad, n_pad) ``Atil_pad`` and (n_pad, n_pad) ``Q_pad`` and takes its
    own row blocks of them."""
    ax = MeshAxis(mesh, axis)
    r = n_pad // ax.size
    mine = slice(ax.rank * r, (ax.rank + 1) * r)

    def factor(Atil_pad, Q_pad, G_pad, gamma, ridge):
        k = Atil_pad.shape[0] // ax.size
        Atil_blk = Atil_pad[ax.rank * k:(ax.rank + 1) * k].to(dtype)
        M_blk = ax.reduce_scatter(Atil_blk.mT @ Atil_blk) + Q_pad[mine]
        if p:
            M_blk = M_blk + gamma * (G_pad[:, mine].mT @ G_pad)
        return _factor_body(ax, M_blk, G_pad, ridge, n_pad, p)

    return factor


def _make_apply(mesh, axis: str, n_pad: int):
    """``apply(W_loc, dscale, x) = D Wᵀ W D x`` with W column-sharded: the
    distributed M̃⁻¹ (two sharded GEMVs, one all_reduce, one all_gather)."""
    ax = MeshAxis(mesh, axis)
    r = n_pad // ax.size
    mine = slice(ax.rank * r, (ax.rank + 1) * r)

    def apply(W_loc, dscale, x):
        v = dscale * x
        y = ax.all_reduce(W_loc @ v[mine])  # W (D x)
        return dscale * ax.all_gather(W_loc.mT @ y)

    return apply


def _make_matapply_T(mesh, axis: str):
    """``matapply(W_loc, Y) = Wᵀ Y`` for the (n_pad, p) equality coupling:
    each rank forms its rows, one all_gather assembles them."""
    ax = MeshAxis(mesh, axis)

    def matapply(W_loc, Y):
        return ax.all_gather(W_loc.mT @ Y)

    return matapply


# ──────────────────────────────────────────────────────────────────────
#  Cone-block-sharded scaling
# ──────────────────────────────────────────────────────────────────────


def _my_cones(ax: MeshAxis, x: torch.Tensor, fill) -> torch.Tensor:
    """This rank's share of a per-cone array ``x`` (count, ...): the cone
    axis padded with ``fill`` to a multiple of the axis size, then split in
    contiguous blocks."""
    count = x.shape[0]
    k = _ceil_to(count, ax.size) // ax.size
    part = x[ax.rank * k:(ax.rank + 1) * k]
    short = k - part.shape[0]
    if short:
        fill = torch.as_tensor(fill, dtype=x.dtype, device=x.device)
        part = torch.cat([part, fill.expand((short,) + tuple(x.shape[1:]))])
    return part


def _shard_cone_rows(ax: MeshAxis, spec: ConeSpec, A, n_pad: int, fd):
    """One-time setup: this rank's rows of A, grouped per cone batch
    (``(R rows, SOC groups, SDP groups)``, each group (k_loc, dim, n_pad)),
    with the columns zero-padded to n_pad and the padded cones' rows
    zero."""
    Af = torch.zeros((A.shape[0], n_pad), dtype=fd, device=A.device)
    Af[:, :A.shape[1]] = A.to(fd)

    def rows(idx):
        return Af[torch.as_tensor(np.asarray(idx, np.int64), device=A.device)]

    r_part = _my_cones(ax, rows(spec.r_idx), 0.0) if spec.nr else None
    soc = tuple(_my_cones(ax, rows(g.idx), 0.0) for g in spec.soc_groups)
    sdp = tuple(_my_cones(ax, rows(g.idx), 0.0) for g in spec.sdp_groups)
    return r_part, soc, sdp


def _pad_scaling_shards(ax: MeshAxis, spec: ConeSpec, FinvT, fd):
    """Per iteration: this rank's share of the F⁻ᵀ scaling, cast to
    ``fd``, padded cones filled with the identity (their rows of A are
    zero, so they scale nothing, and the fill keeps them finite)."""
    Fi = sc.cast(FinvT, fd)
    r_part = _my_cones(ax, Fi.r_d, 1.0) if spec.nr else None
    soc = tuple((_my_cones(ax, s.d, 1.0), _my_cones(ax, s.u, 0.0),
                 _my_cones(ax, s.alpha, 0.0)) for s in Fi.soc)
    sdp = tuple(_my_cones(ax, s.S, torch.eye(g.order, dtype=fd,
                                             device=s.S.device))
                for g, s in zip(spec.sdp_groups, Fi.sdp))
    return r_part, soc, sdp


def _make_factor_kernel_sharded(mesh, axis: str, n_pad: int, p: int, dtype):
    """The cone-sharded variant of :func:`_make_factor_kernel`: each rank
    applies the NT scaling to its own cones (:func:`_pad_scaling_shards`,
    :func:`_shard_cone_rows`) and feeds the scaled rows straight into its
    Gram partial, so the full (m, n) ``Atil`` never exists. It also forms
    ``gamma``, which needs Σ‖Atil‖², from one scalar all_reduce.

    Returns ``factor(scal, arows, Q_pad, G_pad, trQ, gG, ridge) -> (W_loc,
    dscale, Y, gamma, ok)``."""
    ax = MeshAxis(mesh, axis)
    r = n_pad // ax.size
    mine = slice(ax.rank * r, (ax.rank + 1) * r)

    def factor(scal, arows, Q_pad, G_pad, trQ, gG, ridge):
        (rd, socs, sdps), (A_r, A_soc, A_sdp) = scal, arows
        part = torch.zeros((n_pad, n_pad), dtype=dtype, device=Q_pad.device)
        sumsq = torch.zeros(1, dtype=dtype, device=Q_pad.device)

        def accum(rows):
            part.addmm_(rows.mT, rows)
            sumsq.add_(torch.sum(rows * rows))

        if rd is not None:
            accum(rd[:, None] * A_r)
        for (d_, u_, al_), Ag in zip(socs, A_soc):
            # diagonal plus rank 1 per cone (cones/scaling.py:_apply_mat)
            uA = torch.einsum("kd,kdn->kn", u_, Ag)
            accum((d_[:, :, None] * Ag + al_[:, None, None] * u_[:, :, None]
                   * uA[:, None, :]).reshape(-1, n_pad))
        for S, Ag in zip(sdps, A_sdp):
            X = mat(Ag.mT)  # (k_loc, n_pad, d, d)
            Sk = S[:, None]
            accum(vecm((Sk.mT @ X) @ Sk).mT.reshape(-1, n_pad))

        M_blk = ax.reduce_scatter(part) + Q_pad[mine]
        # γ balances the M and GᵀG scales (kkt/schur.py); Σ‖Atil‖² is a
        # one-scalar all_reduce over the sharded rows
        if p:
            gamma = (trQ + ax.all_reduce(sumsq)[0]) / n_pad / gG
            gamma = torch.where(torch.isfinite(gamma) & (gamma > 0), gamma,
                                torch.ones_like(gamma))
            M_blk = M_blk + gamma * (G_pad[:, mine].mT @ G_pad)
        else:
            gamma = torch.ones((), dtype=dtype, device=Q_pad.device)
        W_loc, dscale, Y, ok = _factor_body(ax, M_blk, G_pad, ridge, n_pad,
                                            p)
        return W_loc, dscale, Y, gamma, ok

    return factor


# ──────────────────────────────────────────────────────────────────────
#  The TP KKT solver (3-level plugin contract)
# ──────────────────────────────────────────────────────────────────────


def kktsolver_schur_tp(mesh, axis: str = "tp", factor_dtype=None,
                       distributed_factor: bool = True,
                       shard_scaling: bool = True):
    """Sharded variant of :func:`~conicip_tpu_torch.kkt.kktsolver_schur`.

    Returns a KKT solver (same 3-level protocol) whose Schur assembly and,
    with ``distributed_factor=True`` (default), the Cholesky factorization
    and every back-solve are split over the ranks of ``mesh[axis]``. Every
    rank of the mesh calls ``conic_ip`` with it on the same problem (module
    docstring). All cone specs are supported; m and n are padded to
    multiples of the axis size internally. It solves one instance: a
    stacked operand raises (``solve_batch(mesh=...)`` shards stacks).

    ``shard_scaling=True`` (default, with ``distributed_factor``) also
    shards the NT-scaling application over the cone blocks; ``False`` forms
    the scaled ``Atil`` replicated. ``distributed_factor=False`` keeps the
    sharded assembly and factors the whole matrix on every rank.

    ``factor_dtype=torch.float32`` runs the sharded assembly and
    factorization in f32; the IPM's iterative refinement restores accuracy,
    as on the single-device path.
    """
    ax = MeshAxis(mesh, axis)
    ntp = ax.size

    def kktsolver(Q, A, G, spec: ConeSpec):
        if Q.dim() != 2:
            raise ValueError(
                f"kktsolver_schur_tp solves one instance; got Q of shape "
                f"{tuple(Q.shape)} (shard a stack with solve_batch(mesh=...))")
        n, m, p = Q.shape[0], A.shape[0], G.shape[0]
        wd = Q.dtype
        fd = wd if factor_dtype is None else factor_dtype
        like = dict(dtype=fd, device=Q.device)
        tiny = torch.finfo(fd).tiny

        m_pad = _ceil_to(max(m, 1), ntp)
        n_pad = _ceil_to(n, ntp)

        # Identity-extended Q: the padded Schur matrix is [[M, 0], [0, I]],
        # and its factor and inverse carry the identity corner untouched.
        Q_pad = torch.zeros((n_pad, n_pad), **like)
        Q_pad[:n, :n] = Q.to(fd)
        Q_pad.diagonal()[n:] = 1.0
        G_pad = torch.zeros((p, n_pad), **like)
        G_pad[:, :n] = G.to(fd)
        Gf = G.to(fd)
        ridge0 = 30.0 * torch.finfo(fd).eps

        def kkt2x2(Q_, A_, G_, spec_):
            use_sharded = bool(distributed_factor and shard_scaling)
            if distributed_factor:
                factor = _make_factor_kernel(mesh, axis, n_pad, p, fd)
                minv_apply = _make_apply(mesh, axis, n_pad)
                matapply_T = _make_matapply_T(mesh, axis)
            if use_sharded:
                # one-time regrouping of this rank's rows of A per cone batch
                arows = _shard_cone_rows(ax, spec_, A_, n_pad, fd)
                factor_sh = _make_factor_kernel_sharded(mesh, axis, n_pad, p,
                                                        fd)
                trQ = torch.trace(Q_pad)
                gG = (torch.sum(Gf * Gf) / p + tiny if p
                      else torch.ones((), **like))

            def solve2x2gen(F, FinvT):
                if use_sharded:
                    scal = _pad_scaling_shards(ax, spec_, FinvT, fd)
                    W, dscale, Y, gamma, ok = factor_sh(
                        scal, arows, Q_pad, G_pad, trQ, gG, ridge0)
                    # escalating-ridge retry (cf. kkt/schur.py); ok is the
                    # same on every rank, so every rank retries or none
                    if not ok:
                        W, dscale, Y, gamma, _ = factor_sh(
                            scal, arows, Q_pad, G_pad, trQ, gG, 1e5 * ridge0)
                    return _finish_gen(W, dscale, Y, gamma)

                # the scaled rows, replicated: O(m·n·d), far below the
                # sharded O(mn²) Gram; every cone spec
                Atil = sc.apply_mat(spec_, sc.cast(FinvT, fd), A_.to(fd))
                Atil_pad = torch.zeros((m_pad, n_pad), **like)
                Atil_pad[:m, :n] = Atil
                if p:
                    # γ balances the M and GᵀG scales (kkt/schur.py)
                    tr_est = (torch.trace(Q_pad)
                              + torch.sum(Atil_pad * Atil_pad)) / n_pad
                    gamma = tr_est / (torch.sum(Gf * Gf) / p + tiny)
                    gamma = torch.where(torch.isfinite(gamma) & (gamma > 0),
                                        gamma, torch.ones_like(gamma))
                else:
                    gamma = torch.ones((), **like)

                if not distributed_factor:
                    return _replicated_gen(ax, Atil_pad, Q_pad, G_pad, Gf,
                                           gamma, ridge0, n, n_pad, p, wd)

                W, dscale, Y, ok = factor(Atil_pad, Q_pad, G_pad, gamma,
                                          ridge0)
                # escalating-ridge retry: a rounded f32 assembly can leave
                # M̃ indefinite beyond the base ridge
                if not ok:
                    W, dscale, Y, _ = factor(Atil_pad, Q_pad, G_pad, gamma,
                                             1e5 * ridge0)
                return _finish_gen(W, dscale, Y, gamma)

            def _finish_gen(W, dscale, Y, gamma):
                """Second Schur complement on G and the per-RHS solve: the
                common tail of both factor paths."""
                if p:
                    S = Y.mT @ Y  # (p, p) SPD
                    ss = torch.rsqrt(torch.clamp(torch.diagonal(S), min=tiny))
                    Ls = cholesky(S * ss[:, None] * ss[None, :]
                                  + ridge0 * torch.eye(p, **like))
                    Lsinv = tri_inv(Ls)
                    # Z = M̃⁻¹Gᵀ = D Wᵀ Y, once per iteration
                    Z = dscale[:, None] * matapply_T(W, Y)  # (n_pad, p)

                    def sinv(x):
                        return ss * (Lsinv.mT @ (Lsinv @ (ss * x)))

                def solve2x2(by, bw):
                    by = by.to(fd)
                    bw = bw.to(fd)
                    rhs = torch.zeros(n_pad, **like)
                    rhs[:n] = by + gamma * (Gf.mT @ bw) if p else by
                    t = minv_apply(W, dscale, rhs)
                    if p:
                        b2 = sinv(G_pad @ t - bw)
                        a = t - Z @ b2
                        return a[:n].to(wd), b2.to(wd)
                    return t[:n].to(wd), by[:0].to(wd)

                return solve2x2

            return solve2x2gen

        return pivot(kkt2x2, factor_dtype=factor_dtype)(Q, A, G, spec)

    return kktsolver


def _replicated_gen(ax: MeshAxis, Atil_pad, Q_pad, G_pad, Gf, gamma, ridge0,
                    n, n_pad, p, wd):
    """Sharded assembly, replicated factorization
    (``distributed_factor=False``): every rank factors the whole n_pad
    matrix from the all-reduced Gram."""
    fd = Q_pad.dtype
    like = dict(dtype=fd, device=Q_pad.device)
    tiny = torch.finfo(fd).tiny
    k = Atil_pad.shape[0] // ax.size
    Atil_blk = Atil_pad[ax.rank * k:(ax.rank + 1) * k]
    M = Q_pad + ax.all_reduce(Atil_blk.mT @ Atil_blk)
    if p:
        M = M + gamma * (G_pad.mT @ G_pad)
    dscale = torch.rsqrt(torch.clamp(torch.diagonal(M), min=tiny))
    Ms = M * dscale[:, None] * dscale[None, :]
    eye = torch.eye(n_pad, **like)
    L = cholesky(Ms + ridge0 * eye)
    if not _all_ranks_finite(ax, L):
        L = cholesky(Ms + (1e5 * ridge0) * eye)
    Linv = tri_inv(L)

    def minv(x):
        return dscale * (Linv.mT @ (Linv @ (dscale * x)))

    if p:
        E = Linv @ (dscale[:, None] * G_pad.mT)
        S = E.mT @ E
        ss = torch.rsqrt(torch.clamp(torch.diagonal(S), min=tiny))
        Ls = cholesky(S * ss[:, None] * ss[None, :]
                      + ridge0 * torch.eye(p, **like))
        Lsinv = tri_inv(Ls)

        def sinv(x):
            return ss * (Lsinv.mT @ (Lsinv @ (ss * x)))

    def solve2x2(by, bw):
        by = by.to(fd)
        bw = bw.to(fd)
        rhs = torch.zeros(n_pad, **like)
        rhs[:n] = by + gamma * (Gf.mT @ bw) if p else by
        t = minv(rhs)
        if p:
            b2 = sinv(G_pad @ t - bw)
            a = t - minv(G_pad.mT @ b2)
            return a[:n].to(wd), b2.to(wd)
        return t[:n].to(wd), by[:0].to(wd)

    return solve2x2
