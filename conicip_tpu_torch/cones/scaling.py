"""Structured Nesterov-Todd scaling operators.

Counterpart of ``conicip_tpu/cones/scaling.py``. The
scaling keeps one structure per cone group and is never materialized:

- R block:  ``F = diag(r_d)``
- Q group:  per cone ``F = diag(d) + alpha * u uᵀ`` (diagonal plus rank 1)
- S group:  per cone ``F x = vecm(Sᵀ mat(x) S)`` (a congruence)

Applying F, Fᵀ or F⁻ᵀ to a vector or to the rows of a matrix is a few
batched elementwise products and matmuls per group. Every function takes a
stack of instances as leading dims: points and vectors (..., m), matrices
(..., m, n), and a scaling whose fields carry the same leading dims.

The S-cone scaling takes the reference's off-TPU branch: ``Lz = chol(Z)``,
``Ls = chol(S)``, ``U, λ = svd(Lzᵀ Ls)``, ``R = Lz⁻ᵀ U diag(√λ)``. Where
``mat(z)`` or ``mat(s)`` is not positive definite the cone's factors are
NaN, as JAX's are, and nothing raises: the IPM's non-finite guard reads
them on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import Tuple

import numpy as np
import torch

from ..ops.batched import safe_svd
from ..ops.cholesky_kernel import cholesky_plain
from .segment import (put_group, put_r, put_rows_group, put_rows_r,
                      take_group, take_r, take_rows_group, take_rows_r)
from .spec import ConeSpec
from .symm import mat, vecm

__all__ = [
    "SocScaling",
    "SdpScaling",
    "NTScaling",
    "nt_scaling",
    "nt_identity",
    "nt_inv_adjoint",
    "apply",
    "apply_adjoint",
    "apply_mat",
    "apply_adjoint_mat",
    "dense_gram",
    "dense",
    "cast",
]


@dataclass(frozen=True)
class SocScaling:
    d: torch.Tensor  # (..., k, dim) diagonal entries
    u: torch.Tensor  # (..., k, dim) rank-1 factor
    alpha: torch.Tensor  # (..., k) rank-1 weight


@dataclass(frozen=True)
class SdpScaling:
    S: torch.Tensor  # (..., k, d, d): F x = vecm(Sᵀ mat(x) S)
    Sinv: torch.Tensor  # (..., k, d, d), in closed form from the construction
    # eigenvalues of the scaled point: mat(F z) = RᵀZR = diag(lam) exactly,
    # so the λ-frame needs no eigendecomposition of mat(λ)
    lam: torch.Tensor  # (..., k, d)


@dataclass(frozen=True)
class NTScaling:
    r_d: torch.Tensor  # (..., nr)
    soc: Tuple[SocScaling, ...] = ()
    sdp: Tuple[SdpScaling, ...] = ()


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _qf(x):
    """SOC quadratic form x₁² − ‖x₂:‖²."""
    return 2.0 * x[..., 0] * x[..., 0] - _dot(x, x)


def _t(X):
    return X.transpose(-1, -2)


def _soc_scaling(zg: torch.Tensor, sg: torch.Tensor) -> SocScaling:
    qz = _qf(zg)
    qs = _qf(sg)
    beta = (qs / qz) ** 0.25  # (..., k)
    zb = zg / torch.sqrt(qz)[..., None]
    sb = sg / torch.sqrt(qs)[..., None]
    gam = torch.sqrt((1.0 + _dot(zb, sb)) / 2.0)  # (..., k)
    Jzb = torch.cat([zb[..., :1], -zb[..., 1:]], dim=-1)
    w = (sb + Jzb) / (2.0 * gam[..., None])
    w = torch.cat([w[..., :1] + 1.0, w[..., 1:]], dim=-1)
    w = w * (torch.sqrt(beta) / torch.sqrt(w[..., 0]))[..., None]
    dvec = torch.cat([-beta[..., None],
                      beta[..., None].expand(*beta.shape, zg.shape[-1] - 1)],
                     dim=-1)
    return SocScaling(d=dvec, u=w, alpha=torch.ones_like(beta))


def _sdp_scaling(Z: torch.Tensor, Sm: torch.Tensor) -> SdpScaling:
    Lz = cholesky_plain(Z)
    Ls = cholesky_plain(Sm)
    LzT = _t(Lz)
    # σ(LzᵀLs) = Λ: RᵀZR = √Λ·UᵀLz⁻¹(LzLzᵀ)Lz⁻ᵀU·√Λ = Λ
    U, lam = safe_svd(LzT @ Ls)
    # R = Lz⁻ᵀ U diag(√λ), and in closed form R⁻¹ = diag(1/√λ) Uᵀ Lzᵀ
    X = torch.linalg.solve_triangular(LzT, U, upper=True)
    sl = torch.sqrt(lam)
    return SdpScaling(S=X * sl[..., None, :], Sinv=(_t(U) @ LzT) / sl[..., :, None],
                      lam=lam)


def nt_scaling(spec: ConeSpec, z: torch.Tensor, s: torch.Tensor,
               eig_dtype=None) -> NTScaling:
    """NT scaling F with ``F z = F⁻ᵀ s = λ``.

    ``eig_dtype`` (a dtype) runs the S-cone factorizations (two Choleskys,
    one SVD, one triangular solve per group) in that precision and returns
    the scaling in the working dtype; ``None`` and ``"refined"`` run them
    in the working dtype."""
    r_d = (torch.sqrt(take_r(spec, s) / take_r(spec, z)) if spec.nr
           else z[..., :0])
    soc = tuple(_soc_scaling(take_group(g, z), take_group(g, s))
                for g in spec.soc_groups)
    wd = z.dtype
    ed = wd if eig_dtype in (None, "refined") else eig_dtype
    sdp = []
    for g in spec.sdp_groups:
        sd = _sdp_scaling(mat(take_group(g, z)).to(ed),
                          mat(take_group(g, s)).to(ed))
        sdp.append(SdpScaling(S=sd.S.to(wd), Sinv=sd.Sinv.to(wd),
                              lam=sd.lam.to(wd)))
    return NTScaling(r_d=r_d, soc=soc, sdp=tuple(sdp))


def nt_identity(spec: ConeSpec, dtype=torch.float64, device="cpu",
                batch_shape=()) -> NTScaling:
    """Identity scaling, used for the cold-start KKT solve; ``batch_shape``
    gives its fields the leading dims of a stack of instances."""
    kw = dict(dtype=dtype, device=device)
    bs = tuple(batch_shape)
    soc = tuple(SocScaling(d=torch.ones(*bs, g.count, g.dim, **kw),
                           u=torch.zeros(*bs, g.count, g.dim, **kw),
                           alpha=torch.zeros(*bs, g.count, **kw))
                for g in spec.soc_groups)
    sdp = []
    for g in spec.sdp_groups:
        eye = torch.eye(g.order, **kw).expand(*bs, g.count, g.order, g.order)
        # only used with the cone identity as the scaled point: mat(e) = I
        sdp.append(SdpScaling(S=eye, Sinv=eye,
                              lam=torch.ones(*bs, g.count, g.order, **kw)))
    return NTScaling(r_d=torch.ones(*bs, spec.nr, **kw), soc=soc,
                     sdp=tuple(sdp))


def nt_inv_adjoint(spec: ConeSpec, F: NTScaling) -> NTScaling:
    """F⁻ᵀ with the same structure. R and Q blocks are symmetric, so
    F⁻ᵀ = F⁻¹ (Sherman-Morrison keeps diagonal plus rank 1); S blocks map
    S → S⁻ᵀ and keep the scaled point's λ."""
    soc = []
    for sc in F.soc:
        dinv = 1.0 / sc.d
        uh = sc.u * dinv
        denom = 1.0 + sc.alpha * _dot(sc.u, uh)
        soc.append(SocScaling(d=dinv, u=uh, alpha=-sc.alpha / denom))
    sdp = tuple(SdpScaling(S=_t(sd.Sinv), Sinv=_t(sd.S), lam=sd.lam)
                for sd in F.sdp)
    return NTScaling(r_d=1.0 / F.r_d, soc=tuple(soc), sdp=sdp)


def cast(F: NTScaling, dtype) -> NTScaling:
    """All scaling fields converted to ``dtype``."""

    def conv(blk):
        return type(blk)(**{f.name: getattr(blk, f.name).to(dtype)
                            for f in fields(blk)})

    return NTScaling(r_d=F.r_d.to(dtype), soc=tuple(map(conv, F.soc)),
                     sdp=tuple(map(conv, F.sdp)))


def _apply(spec: ConeSpec, F: NTScaling, x: torch.Tensor, transpose_sdp: bool):
    if spec.only_r:
        return F.r_d * x
    o = torch.zeros_like(x)
    if spec.nr:
        put_r(spec, o, F.r_d * take_r(spec, x))
    for g, sc in zip(spec.soc_groups, F.soc):
        xg = take_group(g, x)
        put_group(g, o,
                  sc.d * xg + (sc.alpha * _dot(sc.u, xg))[..., None] * sc.u)
    for g, sd in zip(spec.sdp_groups, F.sdp):
        X = mat(take_group(g, x))
        S = sd.S
        Y = (S @ X) @ _t(S) if transpose_sdp else (_t(S) @ X) @ S
        put_group(g, o, vecm(Y))
    return o


def apply(spec: ConeSpec, F: NTScaling, x: torch.Tensor) -> torch.Tensor:
    """F @ x."""
    return _apply(spec, F, x, transpose_sdp=False)


def apply_adjoint(spec: ConeSpec, F: NTScaling, x: torch.Tensor) -> torch.Tensor:
    """Fᵀ @ x (differs from F @ x only on S blocks)."""
    return _apply(spec, F, x, transpose_sdp=True)


def _apply_mat(spec: ConeSpec, F: NTScaling, A: torch.Tensor,
               transpose_sdp: bool):
    """F @ A for A of shape (..., m, n), column by column: row scaling on R,
    batched rank-1 updates on Q, batched congruences on S. The Schur
    assembly builds ``Atil = F⁻ᵀ A`` this way."""
    if spec.only_r:
        return F.r_d[..., None] * A
    o = torch.zeros_like(A)
    if spec.nr:
        put_rows_r(spec, o, F.r_d[..., None] * take_rows_r(spec, A))
    for g, sc in zip(spec.soc_groups, F.soc):
        Ag = take_rows_group(g, A)  # (..., k, dim, n)
        uA = torch.einsum("...kd,...kdn->...kn", sc.u, Ag)
        put_rows_group(g, o, sc.d[..., None] * Ag
                       + sc.alpha[..., None, None] * sc.u[..., None]
                       * uA[..., None, :])
    for g, sd in zip(spec.sdp_groups, F.sdp):
        X = mat(_t(take_rows_group(g, A)))  # (..., k, n, d, d)
        S = sd.S[..., None, :, :]
        Y = (S @ X) @ _t(S) if transpose_sdp else (_t(S) @ X) @ S
        put_rows_group(g, o, _t(vecm(Y)))
    return o


def apply_mat(spec: ConeSpec, F: NTScaling, A: torch.Tensor) -> torch.Tensor:
    return _apply_mat(spec, F, A, transpose_sdp=False)


def apply_adjoint_mat(spec: ConeSpec, F: NTScaling, A: torch.Tensor) -> torch.Tensor:
    return _apply_mat(spec, F, A, transpose_sdp=True)


def _index(idx, dev):
    return torch.from_numpy(idx.astype(np.int64)).to(dev)


@functools.lru_cache(maxsize=None)
def spec_index(spec: ConeSpec, dev) -> tuple:
    """The rows of each cone batch on a device: the R rows (None without
    R cones), and per SOC and per SDP group its (k, dim) rows. Made by the
    first solve of a configuration, eagerly, so that a captured call
    (solver/graph.py) copies nothing from the host."""
    return (_index(spec.r_idx, dev) if spec.nr else None,
            tuple(_index(g.idx, dev) for g in spec.soc_groups),
            tuple(_index(g.idx, dev) for g in spec.sdp_groups))


def _put_blocks(M, ix, blk):
    """Write the (..., k, dim, dim) blocks onto the diagonal of M (..., m, m)
    at the device rows/cols ix (k, dim)."""
    M[..., ix[:, :, None], ix[:, None, :]] = blk.to(M.dtype)


def dense_gram(spec: ConeSpec, F: NTScaling, dtype=None) -> torch.Tensor:
    """``FᵀF`` as an (..., m, m) block-diagonal matrix, built from the structured
    parts in O(Σ k·d³): R rows square the diagonal; Q blocks form the
    (dim, dim) factor and square it; S blocks use that the congruence
    ``X ↦ SᵀXS`` composed with its adjoint is the congruence by the
    symmetric ``P = SSᵀ``."""
    dtype = dtype or F.r_d.dtype
    dev = F.r_d.device
    M = torch.zeros(*F.r_d.shape[:-1], spec.m, spec.m, dtype=dtype, device=dev)
    r_ix, soc_ix, sdp_ix = spec_index(spec, dev)

    if spec.nr:
        M[..., r_ix, r_ix] = (F.r_d * F.r_d).to(dtype)
    for ix, sc in zip(soc_ix, F.soc):
        blk = (torch.diag_embed(sc.d) + sc.alpha[..., None, None]
               * sc.u[..., :, None] * sc.u[..., None, :])
        _put_blocks(M, ix, blk @ blk)
    for g, ix, sd in zip(spec.sdp_groups, sdp_ix, F.sdp):
        basis = mat(torch.eye(g.tdim, dtype=sd.S.dtype, device=dev))  # (t, d, d)
        P = sd.S @ _t(sd.S)
        Pk = P[..., None, :, :]
        Y = (Pk @ basis) @ Pk  # (..., k, t, d, d)
        _put_blocks(M, ix, _t(vecm(Y)))
    return M


def dense(spec: ConeSpec, F: NTScaling, dtype=None) -> torch.Tensor:
    """F itself as an (..., m, m) block-diagonal matrix: the diagonal on R, the
    (dim, dim) diagonal-plus-rank-1 block per Q cone, and per S cone the
    matrix whose column j is ``vecm(Sᵀ mat(e_j) S)``. For solvers that need
    the full operator; the Schur path never calls it."""
    dtype = dtype or F.r_d.dtype
    dev = F.r_d.device
    M = torch.zeros(*F.r_d.shape[:-1], spec.m, spec.m, dtype=dtype, device=dev)
    r_ix, soc_ix, sdp_ix = spec_index(spec, dev)

    if spec.nr:
        M[..., r_ix, r_ix] = F.r_d.to(dtype)
    for ix, sc in zip(soc_ix, F.soc):
        _put_blocks(M, ix, torch.diag_embed(sc.d)
                    + sc.alpha[..., None, None] * sc.u[..., :, None]
                    * sc.u[..., None, :])
    for g, ix, sd in zip(spec.sdp_groups, sdp_ix, F.sdp):
        basis = mat(torch.eye(g.tdim, dtype=sd.S.dtype, device=dev))  # (t, d, d)
        S = sd.S[..., None, :, :]
        Y = (_t(S) @ basis) @ S  # (..., k, t, d, d): Y[k, j] = Sᵀ mat(e_j) S
        _put_blocks(M, ix, _t(vecm(Y)))
    return M
