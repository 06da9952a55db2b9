"""Euclidean-Jordan-algebra operations over a cone product, per cone group.

Counterpart of ``conicip_tpu/cones/algebra.py``. Every
cone group (all R coordinates; all Q cones of one dim; all S cones of one
order) is processed by one batched expression:

- ``cone_prod(spec, x, y)``  = x ∘ y   (Jordan product)
- ``cone_div(spec, x, y)``   = o such that y ∘ o = x (divides x *by* y)
- ``maxstep(spec, x, d)``    = sup { α : x - α d ∈ K }
- ``maxstep_multi``          = the same against several directions, with
  the S-cone eigenproblems of all directions stacked into one call
- ``maxstep_to_cone(spec, x)`` = 0 if x is strictly interior, else the
  negative shift that pushes the initial point inside
- ``centrality_correction(spec, w, lo, hi)``: the Gondzio term
  ``max(clip(λ, lo, hi) - λ, -hi)`` on the spectral values λ of w

R is elementwise, Q takes the arrow-matrix closed forms, S the batched
decompositions of ``ops/batched.py`` (the Jacobi kernels on the card,
``torch.linalg`` on the CPU; NaN, never an exception, on a bad batch
entry). No function reads a value back to the host. All take ``(..., m)`` tensors, the last axis the cone axis and any
leading dims a stack of instances, and return tensors on their device: a
step length or shift has the leading dims' shape, and no reduction crosses
them.

``eig_dtype`` on the S-cone functions picks the precision of their d x d
decompositions: ``None`` is the working dtype, a dtype (``torch.float32``)
computes there and returns the working dtype, and ``"refined"`` is accepted
and computes the working-dtype decomposition (the reference's refined
kernels exist for hardware without native f64).
"""

from __future__ import annotations

import torch

from ..ops.batched import bcast, safe_eigh, safe_eigvalsh
from .segment import put_group, put_r, take_group, take_r
from .spec import ConeSpec
from .symm import mat, vecm

__all__ = [
    "cone_prod",
    "cone_div",
    "maxstep",
    "maxstep_multi",
    "sdp_eighs",
    "maxstep_to_cone",
    "lyap_solve",
    "centrality_correction",
]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _t(X):
    return X.transpose(-1, -2)


def cone_prod(spec: ConeSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if spec.only_r:
        return x * y
    o = torch.zeros_like(x)
    if spec.nr:
        put_r(spec, o, take_r(spec, x) * take_r(spec, y))
    for g in spec.soc_groups:
        xg, yg = take_group(g, x), take_group(g, y)  # (..., k, dim)
        tail = xg[..., :1] * yg[..., 1:] + yg[..., :1] * xg[..., 1:]
        put_group(g, o, torch.cat([_dot(xg, yg)[..., None], tail], dim=-1))
    for g in spec.sdp_groups:
        X, Y = mat(take_group(g, x)), mat(take_group(g, y))  # (..., k, d, d)
        put_group(g, o, vecm(X @ Y + Y @ X))  # symmetrized product
    return o


def _eigh_d(A: torch.Tensor, eig_dtype):
    """Batched symmetric eigendecomposition under the ``eig_dtype``
    contract (module docstring); factors come back in A's dtype."""
    if eig_dtype is not None and eig_dtype != "refined" and eig_dtype != A.dtype:
        w, U = safe_eigh(A.to(eig_dtype))
        return w.to(A.dtype), U.to(A.dtype)
    return safe_eigh(A)


def _arith_dtype(wd, eig_dtype):
    """Dtype of the arithmetic around a decomposition: the working dtype
    unless an explicit lower ``eig_dtype`` asks the whole block to run there."""
    return wd if eig_dtype in (None, "refined") else eig_dtype


def sdp_eighs(spec: ConeSpec, x: torch.Tensor, eig_dtype=None):
    """Per-S-group ``(w, U)`` of ``mat(x)``, computed once and passed to
    :func:`cone_div` and :func:`maxstep_multi`."""
    wd = x.dtype
    ed = _arith_dtype(wd, eig_dtype)
    out = []
    for g in spec.sdp_groups:
        w, U = _eigh_d(mat(take_group(g, x)).to(ed), eig_dtype)
        out.append((w.to(wd), U.to(wd)))
    return tuple(out)


def lyap_solve(Y: torch.Tensor, X: torch.Tensor, eig_dtype=None,
               y_eig=None) -> torch.Tensor:
    """Solve ``Y O + O Y = X`` for symmetric Y, X, batched over leading dims:
    with Y = U diag(w) Uᵀ, O = U ((Uᵀ X U)_ij / (w_i + w_j)) Uᵀ. ``y_eig``
    supplies ``(w, U)``; ``U = None`` means Y is diag(w) in the standard
    basis (the NT-scaled point), and the solve is elementwise. ``eig_dtype``
    runs the eigendecomposition in another precision, the combination in
    the working dtype."""
    w, U = _eigh_d(Y, eig_dtype) if y_eig is None else y_eig
    denom = w[..., :, None] + w[..., None, :]
    if U is None:
        return X / denom
    Ut = _t(U)
    return (U @ (((Ut @ X) @ U) / denom)) @ Ut


def cone_div(spec: ConeSpec, x: torch.Tensor, y: torch.Tensor,
             eig_dtype=None, y_eigs=None) -> torch.Tensor:
    if spec.only_r:
        return x / y
    o = torch.zeros_like(x)
    if spec.nr:
        put_r(spec, o, take_r(spec, x) / take_r(spec, y))
    for g in spec.soc_groups:
        # inverse of the arrow matrix of y, applied to x
        xg, yg = take_group(g, x), take_group(g, y)
        y1, yb = yg[..., :1], yg[..., 1:]
        x1, xb = xg[..., :1], xg[..., 1:]
        alpha = y1 * y1 - _dot(yb, yb)[..., None]  # (..., k, 1)
        ybxb = _dot(yb, xb)[..., None]
        head = (y1 * x1 - ybxb) / alpha
        beta1 = (-x1 / alpha) + ybxb / (y1 * alpha)
        tail = yb * beta1 + xb * (1.0 / y1)
        put_group(g, o, torch.cat([head, tail], dim=-1))
    for gi, g in enumerate(spec.sdp_groups):
        X, Y = mat(take_group(g, x)), mat(take_group(g, y))
        y_eig = None if y_eigs is None else y_eigs[gi]
        put_group(g, o, vecm(lyap_solve(Y, X, eig_dtype, y_eig=y_eig)))
    return o


def _qf(x):
    """SOC quadratic form x₁² − ‖x₂:‖²."""
    return 2.0 * x[..., 0] * x[..., 0] - _dot(x, x)


def _soc_frame(xg):
    sg = torch.sqrt(_qf(xg))  # (..., k)
    return sg, xg / sg[..., None]


def _soc_step(sg, xbar, dg, inf):
    """Closed-form SOC step sup{α : x − α d ∈ Q} from x's frame (sg, xbar)."""
    dn = -dg
    beta = 2.0 * xbar[..., 0] * dn[..., 0] - _dot(xbar, dn)
    rho1 = beta / sg
    mu = (beta + dn[..., 0]) / (xbar[..., 0] + 1.0)
    rho2 = dn[..., 1:] - mu[..., None] * xbar[..., 1:]
    a = torch.linalg.norm(rho2, dim=-1) / sg - rho1
    return torch.amin(torch.where(a < 0, inf, 1.0 / a), dim=-1)


def _r_step(xr, dr, inf):
    return torch.amin(torch.where(dr > 0, xr / dr, inf), dim=-1)


def _least(steps, like):
    """The smallest of per-group values (each of the stack's shape), which
    is ``like``'s without its last axis; +inf when there is no group."""
    if not steps:
        return like.new_full(like.shape[:-1], float("inf"))
    if len(steps) == 1:
        return steps[0]
    return torch.amin(torch.stack(steps, dim=-1), dim=-1)


def _sdp_step(lam, pd, inf):
    """Step from the eigenvalues (..., k, d) of X^{-1/2} D X^{-1/2}: 1/λmax
    over positive λ, inf when none is, inf where X is not PD."""
    all_neg = torch.all(lam < 0, dim=-1)
    mx = torch.max(torch.where(lam < 0, -inf, lam), dim=-1).values
    a = torch.where(all_neg, inf, 1.0 / mx)
    return torch.amin(torch.where(pd, a, inf), dim=-1)


def _inv_sqrt_parts(wX):
    """PD mask and 1/√w with w floored at the smallest normal number."""
    pd = torch.all(wX > 0, dim=-1)
    return pd, torch.rsqrt(torch.clamp(wX, min=torch.finfo(wX.dtype).tiny))


def maxstep(spec: ConeSpec, x: torch.Tensor, d: torch.Tensor,
            eig_dtype=None) -> torch.Tensor:
    """``sup { α : x - α d ∈ K }`` per instance (inf when unbounded).
    ``eig_dtype`` runs the S-cone eigendecompositions in another precision:
    a ~1e-7 relative error of the step sits far inside the 1 %
    fraction-to-boundary margin."""
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    steps = []
    if spec.nr:
        steps.append(_r_step(take_r(spec, x), take_r(spec, d), inf))
    for g in spec.soc_groups:
        sg, xbar = _soc_frame(take_group(g, x))
        steps.append(_soc_step(sg, xbar, take_group(g, d), inf))
    ed = _arith_dtype(x.dtype, eig_dtype)
    for g in spec.sdp_groups:
        X, D = mat(take_group(g, x)).to(ed), mat(take_group(g, d)).to(ed)
        wX, U = _eigh_d(X, eig_dtype)
        pd, rs = _inv_sqrt_parts(wX)
        Xih = (U * rs[..., None, :]) @ _t(U)
        M = (Xih @ D) @ Xih
        lam = _eigh_d(0.5 * (M + _t(M)), eig_dtype)[0].to(x.dtype)
        steps.append(_sdp_step(lam, pd, inf))
    return _least(steps, x)


def maxstep_multi(spec: ConeSpec, x: torch.Tensor, ds, eig_dtype=None,
                  x_eigs=None):
    """Max-steps of ``x`` against each direction in ``ds``, as a tuple.

    The S-cone matrices ``M = X^{-1/2} D X^{-1/2}`` of all directions are
    stacked into one batched eigenvalue call per group, which runs in f32
    as the reference's does (a step length needs λmax to ~1e-3 relative,
    inside the 1 % fraction-to-boundary margin). ``x_eigs``
    (:func:`sdp_eighs`) supplies the decomposition of ``mat(x)``; ``U =
    None`` there means ``mat(x) = diag(w)`` (the NT-scaled point)."""
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    steps = [[] for _ in ds]
    if spec.nr:
        xr = take_r(spec, x)
        for i, d in enumerate(ds):
            steps[i].append(_r_step(xr, take_r(spec, d), inf))
    for g in spec.soc_groups:
        sg, xbar = _soc_frame(take_group(g, x))
        for i, d in enumerate(ds):
            steps[i].append(_soc_step(sg, xbar, take_group(g, d), inf))
    ed = _arith_dtype(x.dtype, eig_dtype)
    for gi, g in enumerate(spec.sdp_groups):
        if x_eigs is None:
            wX, U = _eigh_d(mat(take_group(g, x)).to(ed), eig_dtype)
        else:
            wX, U = x_eigs[gi]
            wX = wX.to(ed)
            U = None if U is None else U.to(ed)
        pd, rs = _inv_sqrt_parts(wX)
        if U is not None:
            Xih = (U * rs[..., None, :]) @ _t(U)
        Ms = []
        for d in ds:
            D = mat(take_group(g, d)).to(ed)
            M = (D * rs[..., :, None] * rs[..., None, :] if U is None
                 else (Xih @ D) @ Xih)
            Ms.append(0.5 * (M + _t(M)))
        Mc = torch.cat(Ms, dim=-3)  # the directions stacked on the cone axis
        if Mc.dtype == torch.float64:
            lam_all = safe_eigvalsh(Mc.to(torch.float32))
        else:
            lam_all = _eigh_d(Mc, eig_dtype)[0]
        lam_all = lam_all.to(x.dtype)
        for i, lam in enumerate(torch.split(lam_all, g.count, dim=-2)):
            steps[i].append(_sdp_step(lam, pd, inf))
    return tuple(_least(s, x) for s in steps)


def centrality_correction(spec: ConeSpec, w: torch.Tensor, lo, hi,
                          eig_dtype=None) -> torch.Tensor:
    """Gondzio centrality-corrector term ``q = Π_{[lo,hi]}(λ) − λ`` on the
    spectral values λ of ``w``, with the floor clamp ``q ≥ −hi``:
    componentwise on R, the two-eigenvalue Jordan frame on Q, a batched
    eigendecomposition on S."""

    def _clip(lmb):
        # lo and hi are one value per instance: trailing dims up to lmb's
        lo_, hi_ = bcast(lo, lmb), bcast(hi, lmb)
        return torch.maximum(
            torch.minimum(torch.maximum(lmb, lo_), hi_) - lmb, -hi_)

    lo = torch.as_tensor(lo, dtype=w.dtype, device=w.device)
    hi = torch.as_tensor(hi, dtype=w.dtype, device=w.device)
    if spec.only_r:
        return _clip(w)
    q = torch.zeros_like(w)
    if spec.nr:
        put_r(spec, q, _clip(take_r(spec, w)))
    for g in spec.soc_groups:
        wg = take_group(g, w)  # (..., k, dim)
        w0 = wg[..., 0]
        nrm = torch.linalg.norm(wg[..., 1:], dim=-1)
        dplus, dminus = _clip(w0 + nrm), _clip(w0 - nrm)  # (..., k)
        # q = δ₊c₊ + δ₋c₋, c± = ½(1, ±ŵ), ŵ = w̄/‖w̄‖ (0 when w̄ = 0)
        what = wg[..., 1:] / torch.clamp(
            nrm, min=torch.finfo(w.dtype).tiny)[..., None]
        head = 0.5 * (dplus + dminus)
        tail = 0.5 * (dplus - dminus)[..., None] * what
        put_group(g, q, torch.cat([head[..., None], tail], dim=-1))
    ed = _arith_dtype(w.dtype, eig_dtype)
    for g in spec.sdp_groups:
        lmb, U = _eigh_d(mat(take_group(g, w)).to(ed), eig_dtype)
        lmb, U = lmb.to(w.dtype), U.to(w.dtype)
        put_group(g, q, vecm((U * _clip(lmb)[..., None, :]) @ _t(U)))
    return q


def maxstep_to_cone(spec: ConeSpec, x: torch.Tensor) -> torch.Tensor:
    """0 if x is strictly in the cone, otherwise the negative shift
    ``-1 + (most negative spectral value)`` that pushes the initial point
    inside."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    steps = []
    if spec.nr:
        mn = torch.amin(take_r(spec, x), dim=-1)
        steps.append(torch.where(mn > 0, zero, mn - 1.0))
    for g in spec.soc_groups:
        xg = take_group(g, x)
        a = torch.linalg.norm(xg[..., 1:], dim=-1) - xg[..., 0]
        steps.append(torch.amin(torch.where(a < 0, zero, -1.0 - a), dim=-1))
    for g in spec.sdp_groups:
        mn = torch.amin(safe_eigvalsh(mat(take_group(g, x))), dim=-1)
        steps.append(torch.amin(torch.where(mn > 0, zero, mn - 1.0), dim=-1))
    if not steps:
        return x.new_zeros(x.shape[:-1])
    return _least(steps, x)
