"""S cones of order above 32: the port against conicip_tpu on the CPU.

On the card these orders run the block Jacobi kernels of
``csrc/jacobi.cu`` (one thread block per matrix); on the CPU the port's
decompositions are the plain ``torch.linalg`` ones, so these tests hold the
solve around them: the spectral backend, the cone algebra and the device
loop at d = 40 and 36, against the reference's ``jnp.linalg`` path. Each
instance is made with numpy from a seed (``batched_small_sdp``: the PSD
projection of a random symmetric matrix, A = Q = I, the covariance repair
of k assets) and solved by both packages in f64.

Tolerances: status and ``Iter`` equal; for the single solve y, the slack
s = Ay - b and the cone multipliers v (z) within 1e-8 relative to
max(1, |x|_inf), two f64 solves that differ only in the order of their
sums; per instance of the stack the same, y and v.
"""

import numpy as np
import pytest
import torch

import conicip_tpu as ct
import conicip_tpu.parallel as ct_parallel
import conicip_tpu_torch as pt
from conicip_tpu_torch import solver
from conicip_tpu_torch.kkt.spectral import spectral_kktsolver
from conicip_tpu_torch.models import batched_small_sdp

torch.set_num_threads(1)

REL = 1e-8


def single(k, seed):
    """conic_ip's arguments for instance 0 of batched_small_sdp(1, k)."""
    Q, c, A, b, cones = batched_small_sdp(1, k=k, seed=seed)
    return Q[0], c[0], A[0], b[0], cones


@pytest.mark.parametrize("k, seed", [(40, 0)])
def test_a_single_s_cone_of_order_40_matches_the_reference(k, seed):
    args = single(k, seed)
    ref = ct.conic_ip(*args)
    sol = pt.solution_to_numpy(pt.conic_ip(*args, device="cpu"))
    # the spectral backend on the device loop, as on the card
    assert [r.kktsolver for r in solver.runs] == [spectral_kktsolver()]
    assert [r.loop for r in solver.runs] == ["chunks"]
    assert sol.status == ref.status == "Optimal"
    assert sol.Iter == ref.Iter
    A, b = args[2], args[3]
    assert sol.w.shape == np.asarray(ref.w).shape == (0,)
    for f, got, r in (("y", sol.y, ref.y), ("v", sol.v, ref.v),
                      ("s", A @ sol.y - b, A @ np.asarray(ref.y) - b)):
        r = np.asarray(r)
        assert got.shape == r.shape == (k * (k + 1) // 2,), f
        scale = max(1.0, float(np.abs(r).max()))
        assert np.abs(got - r).max() <= REL * scale, f


@pytest.mark.parametrize("batch, k, seed", [(4, 36, 1)])
def test_a_stack_of_s_cones_of_order_36_matches_the_reference(batch, k,
                                                               seed):
    args = batched_small_sdp(batch, k=k, seed=seed)
    ref = ct_parallel.solve_batch(*args)
    out = pt.solve_batch(*args, device="cpu")
    sol = pt.batch_solution_to_numpy(out)
    assert sol.statuses == ref.statuses == ["Optimal"] * batch
    assert np.array_equal(sol.Iter, np.asarray(ref.Iter))
    for f in ("y", "v"):
        r = np.asarray(getattr(ref, f))
        scale = np.maximum(1.0, np.abs(r).max(axis=-1, keepdims=True))
        assert (np.abs(getattr(sol, f) - r) / scale).max() <= REL, f
