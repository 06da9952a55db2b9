"""Custom KKT solvers: the framework's signature extension point.

The per-iteration Newton solve is pluggable through a 3-level closure
contract:

    kktsolver(Q, A, G, spec)        # LEVEL 1: one-time symbolic setup
      -> solve3x3gen(F, FinvT)      # LEVEL 2: per-iteration refactorization
         -> solve3x3(x, y, z)       # LEVEL 3: per-RHS solve
            -> (a, b, c)  with  Qa + Gᵀb − Aᵀc = x,  Ga = y,  Aa + FᵀFc = z

The operands are tensors on the solve's device; ``F``/``FinvT`` are
structured scalings (diag / diag+rank-1 / congruence) applied in closed
form.

This example exploits box-QP structure by hand: with A = [I; −I] and
diagonal Q, the Schur matrix Q + Aᵀ(FᵀF)⁻¹A is DIAGONAL, so the
per-iteration "factorization" is elementwise arithmetic. We write it as a
2×2 solver and lift it to the 3×3 contract with ``ct.pivot``.

``conic_ip`` runs a caller's solver on its device loop, as the reference's
``jit`` traces it: on the card the loop is a pair of captured CUDA graphs,
kept across calls. So, as under ``jit``:

- the three levels must not read the device: no ``.item()``, no
  ``bool(tensor)``, no ``torch.linalg.cholesky`` or ``torch.linalg.solve``
  (both check ``info`` on the host), no tensor made from host data. Use
  ``torch.linalg.cholesky_ex``, ``torch.linalg.solve_ex``, or the
  package's ``conicip_tpu_torch.ops.cholesky`` and ``ops.cho_solve``. A
  solver that does read the device still solves, on the eager loop (one
  host read per iteration), and ``conicip_tpu_torch.solver.runs[-1]``
  says so (``loop``) and why (``reason``);
- make the solver once and reuse it, as below: the loop's cache keys on
  the object, so a new closure per call (``ct.pivot(fn)`` inside a loop)
  misses it and captures anew;
- Python side effects in the callbacks (a counter, a list, a cache) run
  when the loop is captured, not once per iteration.

Run: python examples/torch/custom_kkt.py  (on the GPU;
     CONICIP_TORCH_DEVICE=cpu runs it on the CPU)
"""

import os

import numpy as np
import torch

import conicip_tpu_torch as ct
from conicip_tpu_torch import solver

device = os.environ.get("CONICIP_TORCH_DEVICE", "cuda")


def box_kktsolver_2x2(Q, A, G, spec):
    """LEVEL 1: runs once. Capture static structure; Q's diagonal here."""
    qd = torch.diagonal(Q, dim1=-2, dim2=-1)
    n = qd.shape[-1]

    def solve2x2gen(F, FinvT):
        """LEVEL 2: runs every IPM iteration with the fresh NT scaling.

        For pure R cones F = diag(r_d), so (FᵀF)⁻¹ = diag(1/r_d²); with
        A = [I; −I] the Schur matrix is diagonal:
        M = Q + diag(w₁ + w₂) with w the two halves of 1/r_d².
        """
        winv = 1.0 / (F.r_d * F.r_d)
        mdiag = qd + winv[..., :n] + winv[..., n:]

        def solve2x2(by, bw):
            """LEVEL 3: runs 3-6 times per iteration (predictor, corrector,
            refinement). bw is empty: no equalities here."""
            return by / mdiag, bw

        return solve2x2

    return solve2x2gen


# made once and passed to every solve
box_kktsolver = ct.pivot(box_kktsolver_2x2)


def main():
    n = 300
    rng = np.random.default_rng(3)
    Q = np.diag(1.0 + rng.random(n))
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = -np.ones(2 * n)
    # two objectives of one shape: the second solve reuses the first's loop
    for c in (rng.standard_normal(n), rng.standard_normal(n)):
        sol = ct.conic_ip(Q, c, A, b, [("R", 2 * n)],
                          kktsolver=box_kktsolver, device=device)
        run = solver.runs[-1]
        ref = ct.conic_ip(Q, c, A, b, [("R", 2 * n)], device=device)

        print("custom :", sol.status, " iterations:", sol.Iter,
              " loop:", run.loop, " cache hit:", run.cache_hit)
        print("default:", ref.status, " iterations:", ref.Iter)
        assert sol.status == "Optimal"
        assert max(sol.prFeas, sol.duFeas, sol.muFeas) < 1e-6
        assert float((sol.y - ref.y).abs().max()) < 1e-5

    # The built-in auto-selected backend (kktsolver_diag) generalizes exactly
    # this trick, structure detection included. Your own callbacks win when
    # you know structure the library cannot see (e.g. FFT-diagonalizable Q,
    # Kronecker products, graph Laplacians).
    print("ok")


if __name__ == "__main__":
    main()
