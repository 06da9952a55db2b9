"""The PSD cone S(n) of order k, n = k(k+1)/2 entries packed as
:mod:`..psd_projection` packs them."""

import torch

from .. import psd_projection


def distance(x):
    """Frobenius distance of each packed row of ``x`` to the cone: the
    norm of its negative eigenvalues."""
    lam = torch.linalg.eigvalsh(psd_projection.mat(x))
    return torch.linalg.norm(lam.clamp(max=0), dim=-1)


def jordan_norm(s, v):
    """‖λ ∘ λ‖ for the scaled point λ of s and v: √tr(SVSV), the norm of
    the eigenvalues of S^½VS^½, the same for any NT scaling."""
    S, V = psd_projection.mat(s), psd_projection.mat(v)
    M = S @ V
    return (M * M.transpose(-1, -2)).sum((-1, -2)).clamp(min=0).sqrt()
