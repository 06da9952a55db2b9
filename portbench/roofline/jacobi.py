"""The work of the S cones' d×d decompositions, by the operation counts
of the textbook methods, whatever algorithm and sweeps compute them
(Golub and Van Loan, Matrix Computations, 4th ed.): the symmetric
eigenproblem by tridiagonalisation and QR, 4d³/3 flops for the values
alone and 9d³ with the vectors (§8.3); the SVD of a square matrix by
Golub-Kahan-Reinsch with Σ and U (the program's ``svd`` returns those
two), 14d³ − 2d³ = 12d³ (§8.6, Σ and U₁ of an m×n matrix: 14mn² − 2n³).
The bytes: the input read once, every output written once."""

import torch

from . import peaks

# kind: (flops over d³, output elements as (over d², over d))
WORK = {
    "eigh": (9.0, (1, 1)),  # vectors and values
    "eigvalsh": (4.0 / 3.0, (0, 1)),  # values
    "svd": (12.0, (1, 1)),  # U and the singular values
}


def flops(kind: str, d: int) -> float:
    return WORK[kind][0] * d ** 3


def nbytes(kind: str, d: int, dtype) -> float:
    sq, lin = WORK[kind][1]
    size = torch.empty((), dtype=dtype).element_size()
    return (d * d + sq * d * d + lin * d) * size


def bound_s(kind: str, d: int, dtype) -> float:
    return peaks.bound_s(flops(kind, d), nbytes(kind, d, dtype), dtype)
