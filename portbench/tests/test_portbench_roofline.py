"""The roofline formulas at small shapes."""

import pytest
import torch

from portbench.roofline import cholesky, jacobi, peaks


def test_cholesky_work():
    assert cholesky.flops(3) == pytest.approx(9.0)
    assert cholesky.nbytes(4, torch.float64) == 2 * 16 * 8
    assert cholesky.nbytes(4, torch.float32) == 2 * 16 * 4
    # n = 500 f64: the bytes bound (4 MB at 3.35 TB/s) beats the flops'
    assert cholesky.bound_s(500, torch.float64) == pytest.approx(
        2 * 500 * 500 * 8 / 3.35e12)
    # n = 8192 f64: the flops bound
    assert cholesky.bound_s(8192, torch.float64) == pytest.approx(
        8192 ** 3 / 3 / 67e12)


def test_jacobi_work():
    d = 10
    assert jacobi.flops("eigh", d) == pytest.approx(9 * d ** 3)
    assert jacobi.flops("eigvalsh", d) == pytest.approx(4 / 3 * d ** 3)
    assert jacobi.flops("svd", d) == pytest.approx(12 * d ** 3)
    f64 = torch.float64
    # input read once; outputs written once
    assert jacobi.nbytes("eigh", d, f64) == (d * d + d * d + d) * 8
    assert jacobi.nbytes("eigvalsh", d, f64) == (d * d + d) * 8
    assert jacobi.nbytes("svd", d, torch.float32) == (d * d + d * d + d) * 4
    assert jacobi.bound_s("eigh", 100, f64) == pytest.approx(
        max(9e6 / 67e12, (2e4 + 100) * 8 / 3.35e12))


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(67e12, 0, torch.float64) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, torch.float64) == pytest.approx(1.0)
