"""The nonnegative orthant R(m): a block of m entries, each ≥ 0."""

import torch


def distance(x):
    """Euclidean distance of each row of ``x`` to the cone."""
    return torch.linalg.norm(x.clamp(max=0), dim=-1)


def jordan_norm(s, v):
    """‖s ∘ v‖₂ with ∘ the entrywise product."""
    return torch.linalg.norm(s * v, dim=-1)
