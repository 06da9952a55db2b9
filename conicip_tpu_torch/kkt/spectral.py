"""Closed-form spectral KKT solver for PSD-projection structure.

Counterpart of ``conicip_tpu/kkt/spectral.py``. With
``A = I``, no equalities and ``Q = q·I`` the 3x3 contract reads

    q·a − c = x        (dual row)
    a + FᵀF c = z      (cone row)

and eliminating ``c = q·a − x`` leaves ``(I + q·FᵀF) a = z + FᵀF x``, which
is block-diagonal per cone group and inverts in closed form:

- R: elementwise, ``a = (z + r_d² x) / (1 + q r_d²)``;
- Q: ``FᵀF`` is diagonal plus rank 2, inverted by Woodbury with an
  explicit 2×2;
- S: ``FᵀF x = vecm(P mat(x) P)`` with ``P = S Sᵀ = V Θ Vᵀ``, so in the V
  basis ``Ã = (Z̃ + θᵢθⱼ X̃) / (1 + q·θᵢθⱼ)``: one batched d×d
  eigendecomposition per iteration and no factorization at all.

One defect-correction pass against the exact ``FᵀF`` follows, as in the
reference. The solver runs no Cholesky, so it never launches the CUDA
kernel. Applicability is checked on the host by :func:`spectral_applicable`
(like ``kkt/diag.separable``); the solver trusts its caller. This module is
not exported from :mod:`conicip_tpu_torch.kkt`, as in the reference. With a
stack of instances (leading dims on Q and on every vector) ``q`` is one
value per instance and everything else is already per cone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cones.segment import put_group, put_r, take_group, take_r
from ..cones.spec import ConeSpec
from ..cones.symm import mat, vecm
from ..cones.algebra import _eigh_d
from ..ops.control import takes_device_loop
from .diag import _where_it_is

__all__ = ["kktsolver_spectral", "spectral_applicable", "spectral_kktsolver"]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _t(X):
    return X.transpose(-1, -2)


def spectral_applicable(Q, A, G, spec: ConeSpec) -> bool:
    """Host-side structure check: no equalities, ``A = I`` and ``Q = q·I``
    with q ≥ 0 (q > 0 when there are Q cones, whose 2x2 uses 1/q), for
    every instance of a leading batch dim."""
    if G is not None and np.ndim(G) >= 2 and np.shape(G)[-2] > 0:
        return False
    Qt = _where_it_is(Q)
    At = _where_it_is(A)
    n = Qt.shape[-1]
    if spec.soc_groups and float(Qt.reshape(-1, n, n)[0, 0, 0]) <= 0:
        return False
    if At.shape[-2] != n or At.shape[-1] != n:
        return False
    if not bool((At == torch.eye(n, dtype=At.dtype, device=At.device)).all()):
        return False
    q = Qt[..., :1, :1]
    eye = torch.eye(n, dtype=Qt.dtype, device=Qt.device)
    return bool(((q >= 0) & (Qt == q * eye)).all())


@takes_device_loop
def kktsolver_spectral(Q, A, G, spec: ConeSpec, *, eig_dtype=None):
    """3-level KKT callback (module docstring). ``eig_dtype`` follows the
    cone layer's contract: ``None`` decomposes ``P`` in the working dtype,
    a dtype decomposes there and returns the working dtype, ``"refined"``
    is accepted and is the working-dtype decomposition."""
    q = Q[..., 0, 0]
    # per-instance q against vectors (..., m), groups (..., k, dim) and
    # eigenvalue grids (..., k, d, d)
    q1 = q[..., None] if q.dim() else q
    q2 = q[..., None, None] if q.dim() else q
    q3 = q[..., None, None, None] if q.dim() else q

    def solve3x3gen(F, FinvT):
        # per group: P = S Sᵀ and its eigendecomposition
        eigs = []
        for sd in F.sdp:
            P = sd.S @ _t(sd.S)
            P = 0.5 * (P + _t(P))
            theta, V = _eigh_d(P, eig_dtype)
            eigs.append((theta, V, P))
        w_r = F.r_d * F.r_d if spec.nr else None
        # SOC: FᵀF = F² = diag(d²) + α(v₁uᵀ + uv₁ᵀ) + α²(uᵀu)uuᵀ, v₁ = d∘u
        socs = [(sc_, sc_.d * sc_.u, _dot(sc_.u, sc_.u)) for sc_ in F.soc]

        def _soc_ftf(sc_, v1, s_uu, xg):
            ux = _dot(sc_.u, xg)[..., None]
            v1x = _dot(v1, xg)[..., None]
            return (sc_.d * sc_.d * xg
                    + sc_.alpha[..., None] * (v1 * ux + sc_.u * v1x)
                    + (sc_.alpha * sc_.alpha * s_uu)[..., None] * sc_.u * ux)

        def _soc_solve(sc_, v1, s_uu, rhs):
            # (D + q·U C Uᵀ)⁻¹ rhs with U = [u, v₁], C = [[α²s, α], [α, 0]],
            # D = diag(1 + q d²): Woodbury through the 2x2 K = C⁻¹/q +
            # UᵀD⁻¹U, scaled by α so that the α = 0 limit stays exact
            D = 1.0 + q2 * sc_.d * sc_.d
            ir, iu, iv = rhs / D, sc_.u / D, v1 / D
            a11, a12, a22 = _dot(sc_.u, iu), _dot(sc_.u, iv), _dot(v1, iv)
            al = sc_.alpha
            k11 = al * a11
            k12 = 1.0 / q1 + al * a12
            k22 = -al * s_uu / q1 + al * a22
            det = k11 * k22 - k12 * k12
            r1 = al * _dot(sc_.u, ir)
            r2 = al * _dot(v1, ir)
            y1 = (k22 * r1 - k12 * r2) / det
            y2 = (k11 * r2 - k12 * r1) / det
            return ir - (iu * y1[..., None] + iv * y2[..., None])

        def base_solve(x, z):
            a = torch.zeros_like(x)
            if spec.nr:
                xr, zr = take_r(spec, x), take_r(spec, z)
                put_r(spec, a, (zr + w_r * xr) / (1.0 + q1 * w_r))
            for g, (sc_, v1, s_uu) in zip(spec.soc_groups, socs):
                rhs = take_group(g, z) + _soc_ftf(sc_, v1, s_uu, take_group(g, x))
                put_group(g, a, _soc_solve(sc_, v1, s_uu, rhs))
            for g, (theta, V, _P) in zip(spec.sdp_groups, eigs):
                X, Z = mat(take_group(g, x)), mat(take_group(g, z))
                Vt = _t(V)
                Xt = (Vt @ X) @ V
                Zt = (Vt @ Z) @ V
                tt = theta[..., :, None] * theta[..., None, :]
                At = (Zt + tt * Xt) / (1.0 + q3 * tt)
                put_group(g, a, vecm((V @ At) @ Vt))
            return a

        def cone_residual(a, c, z):
            # z − a − FᵀF c with FᵀF applied exactly per block
            r = z - a
            if spec.nr:
                put_r(spec, r, take_r(spec, r) - w_r * take_r(spec, c))
            for g, (sc_, v1, s_uu) in zip(spec.soc_groups, socs):
                put_group(g, r, take_group(g, r)
                          - _soc_ftf(sc_, v1, s_uu, take_group(g, c)))
            for g, (_theta, _V, P) in zip(spec.sdp_groups, eigs):
                C = mat(take_group(g, c))
                put_group(g, r, take_group(g, r) - vecm((P @ C) @ P))
            return r

        def solve3x3(x, y, z):
            # c = qa − x satisfies the dual row exactly; one defect
            # correction on the cone row squares the eigenbasis error
            a = base_solve(x, z)
            e = cone_residual(a, q1 * a - x, z)
            a = a + base_solve(torch.zeros_like(x), e)
            return a, y[..., :0], q1 * a - x

        return solve3x3

    return solve3x3gen


@functools.lru_cache(maxsize=None)
def _spectral_kktsolver_cached(eig_dtype):
    def kkt(Q, A, G, spec):
        return kktsolver_spectral(Q, A, G, spec, eig_dtype=eig_dtype)

    return takes_device_loop(kkt)


def spectral_kktsolver(eig_dtype=None):
    """The spectral backend as a plain ``kktsolver`` callback, one object
    per ``eig_dtype`` (what ``conic_ip``'s automatic choice returns)."""
    return _spectral_kktsolver_cached(eig_dtype)
