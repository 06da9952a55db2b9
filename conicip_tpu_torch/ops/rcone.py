"""The R cones' share of one interior-point iteration.

For a spec whose cones are all R (``ConeSpec.only_r``) the loop
(solver/ipm.py) calls these in place of the generic sequence of
``cones/scaling.py`` and ``cones/algebra.py`` calls:

- :func:`r_scaling`: the NT scaling r_d = √(s/v) and 1/r_d, the scaled
  point λ = r_d v, λ∘λ and μ̄ = vᵀs (``nt_scaling``, ``nt_inv_adjoint``,
  ``apply`` and ``residual_block``'s ``cone_prod`` and dot);
- :func:`r_reduce4_pre`, :func:`r_reduce4_post`: the 4x4 → 3x3 reduction
  around the caller's 3x3 solve (``make_solve4``);
- :func:`r_corrector`, :func:`r_k4`, :func:`r_gondzio`: the
  complementarity vectors of ``take_step`` (the corrector's s-row, the
  refinement residual's, the Gondzio trial's correction);
- :func:`r_step`: the fraction-to-boundary step (``maxstep`` of v and s
  with its clamps), the finite test of the direction and, on the
  predictor, ``fts``.

Each dispatches on the device of its tensors, as ``ops/cholesky.py`` does:
for tensors on the CPU the plain PyTorch twin beside it, which issues the
generic path's operations in its order, so that a CPU solve is bit for bit
what the generic path gives; for CUDA tensors the hand-written kernel of
``csrc/rcone.cu`` (``ops/rcone_kernel.py``), one launch, which raises where
it cannot run and never falls back. The kernel's elementwise outputs and
its step are the twin's bits; its reduced values (μ̄, the dots, fts)
differ in summation order. Vectors are (..., m), any leading dims a stack
of instances (one launch for the stack; a vector without them, such as
the cone identity of the initial point, is broadcast), per-instance values
(...,).
"""

from __future__ import annotations

import math

import torch

from . import rcone_kernel
from .batched import col, dot

__all__ = ["r_scaling", "r_reduce4_pre", "r_reduce4_post", "r_corrector",
           "r_k4", "r_gondzio", "r_step", "r_scaling_plain",
           "r_reduce4_pre_plain", "r_reduce4_post_plain", "r_corrector_plain",
           "r_k4_plain", "r_gondzio_plain", "r_step_plain"]


def _on_cpu(*xs) -> bool:
    """Whether the operands lie on the CPU (the plain twins), after checking
    that they share one device and one dtype."""
    dev, dt = xs[0].device, xs[0].dtype
    for x in xs[1:]:
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"rcone: operands on {x.device} {x.dtype} and "
                             f"{dev} {dt}")
    return dev.type == "cpu"


def _stack(vecs, scalars=()):
    """The vectors as contiguous (B, m) rows and the per-instance values as
    contiguous (B,), broadcast to one stack; and the stack's shape."""
    shape = torch.broadcast_shapes(*(x.shape for x in vecs))
    bs, m = shape[:-1], shape[-1]
    B = math.prod(bs)
    rows = [x.expand(shape).reshape(B, m).contiguous() for x in vecs]
    each = [s.expand(bs).reshape(B).contiguous() for s in scalars]
    return rows, each, bs


# ── the plain twins: the generic path's operations, in its order ──


def r_scaling_plain(v, s):
    r_d = torch.sqrt(s / v)
    rinv = 1.0 / r_d
    lam = r_d * v
    return r_d, rinv, lam, lam * lam, dot(v, s)


def r_reduce4_pre_plain(rs, lam, r_d, rv):
    t1 = r_d * (rs / lam)
    return t1, rv + t1


def r_reduce4_post_plain(t1, r_d, dv):
    return t1 - r_d * (r_d * dv)


def r_corrector_plain(rls, r_d, rinv, dv, ds, smu):
    # σμ e is σμ on R (e is all ones)
    FiTds, Fdv = rinv * ds, r_d * dv
    return rls - (-(FiTds * Fdv) + col(smu))


def r_k4_plain(lam, r_d, rinv, dv, ds):
    return lam * (r_d * dv) + lam * (rinv * ds)


def r_gondzio_plain(lam, r_d, rinv, dv, ds, atil, smu):
    Fdv, FiTds = r_d * dv, rinv * ds
    w = (lam - col(atil) * Fdv) * (lam - col(atil) * FiTds)
    lo, hi = col(0.1 * smu), col(10.0 * smu)
    return -torch.maximum(torch.minimum(torch.maximum(w, lo), hi) - w, -hi)


def r_step_plain(v, s, dv, ds, scale=None, fts=False):
    ok = torch.isfinite(dv).all(-1) & torch.isfinite(ds).all(-1)
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    sdv, sds = (dv, ds) if scale is None else (dv * scale, ds * scale)
    av = torch.amin(torch.where(sdv > 0, v / sdv, inf), dim=-1)
    as_ = torch.amin(torch.where(sds > 0, s / sds, inf), dim=-1)
    alpha = torch.minimum(torch.clamp(av, max=1.0), torch.clamp(as_, max=1.0))
    if not fts:
        return alpha, ok
    dots = (dot(v, s), dot(v, ds), dot(dv, s), dot(dv, ds))
    f = dots[0] - alpha * dots[1] - alpha * dots[2] + alpha * alpha * dots[3]
    return alpha, ok, torch.stack(dots, dim=-1), f


# ── the entries: the twin on the CPU, the kernel on CUDA ──


def r_scaling(v, s):
    """``(r_d, 1/r_d, λ, λ∘λ, μ̄)`` of the iterate (v, s) = (z.v, z.s):
    r_d = √(s/v), λ = r_d v (= F z.v = F⁻ᵀ z.s), μ̄ = vᵀs per instance."""
    if _on_cpu(v, s):
        return r_scaling_plain(v, s)
    (v2, s2), _, bs = _stack((v, s))
    *vecs, mubar = rcone_kernel.scaling(v2, s2)
    shape = bs + v2.shape[-1:]
    return (*(x.reshape(shape) for x in vecs), mubar.reshape(bs))


def r_reduce4_pre(rs, lam, r_d, rv):
    """Before the 3x3 solve: ``(t1, r.v + t1)``, t1 = r_d (r.s ⊘ λ)
    (``apply_adjoint(F, cone_div(r.s, λ))``)."""
    if _on_cpu(rs, lam, r_d, rv):
        return r_reduce4_pre_plain(rs, lam, r_d, rv)
    rows, _, bs = _stack((rs, lam, r_d, rv))
    shape = bs + rows[0].shape[-1:]
    return tuple(x.reshape(shape) for x in rcone_kernel.reduce4_pre(*rows))


def r_reduce4_post(t1, r_d, dv):
    """After the 3x3 solve: ds = t1 − r_d (r_d dv)
    (``t1 − apply_adjoint(F, apply(F, dv))``)."""
    if _on_cpu(t1, r_d, dv):
        return r_reduce4_post_plain(t1, r_d, dv)
    rows, _, bs = _stack((t1, r_d, dv))
    return rcone_kernel.reduce4_post(*rows).reshape(bs + rows[0].shape[-1:])


def r_corrector(rls, r_d, rinv, dv, ds, smu):
    """The corrector's s-row rleft.s − lc, lc = −(F⁻ᵀds)∘(F dv) + σμ e,
    from the predictor's direction; ``smu`` = σμ per instance."""
    if _on_cpu(rls, r_d, rinv, dv, ds, smu):
        return r_corrector_plain(rls, r_d, rinv, dv, ds, smu)
    (r2, d2, i2, v2, s2), (m2,), bs = _stack((rls, r_d, rinv, dv, ds), (smu,))
    out = rcone_kernel.comp("corrector", r2, d2, i2, v2, s2, x=r2, smu=m2)
    return out.reshape(bs + r2.shape[-1:])


def r_k4(lam, r_d, rinv, dv, ds):
    """The refinement residual's s-row λ∘(F dv) + λ∘(F⁻ᵀds)."""
    if _on_cpu(lam, r_d, rinv, dv, ds):
        return r_k4_plain(lam, r_d, rinv, dv, ds)
    rows, _, bs = _stack((lam, r_d, rinv, dv, ds))
    return rcone_kernel.comp("k4", *rows).reshape(bs + rows[0].shape[-1:])


def r_gondzio(lam, r_d, rinv, dv, ds, atil, smu):
    """The Gondzio corrector's right-hand s-row −q: the trial
    w = (λ − ã F dv)∘(λ − ã F⁻ᵀds) and q = max(min(max(w, 0.1σμ), 10σμ) −
    w, −10σμ) (``centrality_correction`` on R); ``atil`` = ã and ``smu`` =
    σμ per instance."""
    if _on_cpu(lam, r_d, rinv, dv, ds, atil, smu):
        return r_gondzio_plain(lam, r_d, rinv, dv, ds, atil, smu)
    rows, (a2, m2), bs = _stack((lam, r_d, rinv, dv, ds), (atil, smu))
    out = rcone_kernel.comp("gondzio", *rows, smu=m2, atil=a2)
    return out.reshape(bs + rows[0].shape[-1:])


def r_step(v, s, dv, ds, scale=None, fts=False):
    """The step of (v, s) = (z.v, z.s) along (dv, ds), scaled by ``scale``
    first where given: min(clamp(maxstep(v, dv'), max=1), clamp(maxstep(s,
    ds'), max=1)) per instance, and whether every entry of dv and ds is
    finite. With ``fts`` also the four dots (vᵀs, vᵀds, dvᵀs, dvᵀds) as
    (..., 4) and fts = (v − α dv)ᵀ(s − α ds) from them."""
    if _on_cpu(v, s, dv, ds):
        return r_step_plain(v, s, dv, ds, scale, fts)
    rows, _, bs = _stack((v, s, dv, ds))
    out = rcone_kernel.step(*rows, 1.0 if scale is None else scale, fts)
    return tuple(x.reshape(bs + x.shape[1:]) for x in out)
