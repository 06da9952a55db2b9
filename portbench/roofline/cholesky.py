"""The work of one Cholesky factor of an n×n SPD matrix: n³/3 flops
(Golub and Van Loan, Matrix Computations, 4th ed., §4.2), the matrix read
once and the factor written once (n² elements each)."""

import torch

from . import peaks


def flops(n: int) -> float:
    return n ** 3 / 3


def nbytes(n: int, dtype) -> float:
    return 2 * n * n * torch.empty((), dtype=dtype).element_size()


def bound_s(n: int, dtype) -> float:
    return peaks.bound_s(flops(n), nbytes(n, dtype), dtype)
