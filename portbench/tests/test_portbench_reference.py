"""The plain reference agrees with a CPU ``conicip_tpu_torch.conic_ip`` at
a small size of each family, its packing is the program's, and the
certificate's cone measures (one module a cone kind) and its equality
terms hold the program's answers."""

import pytest
import torch

import conicip_tpu_torch as program
from conicip_tpu_torch.cones import symm
from portbench import harness
from portbench.families import box_qp, psd_projection
from portbench.reference import certificate
from portbench.reference import psd_projection as ref_psd
from portbench.reference.cones import r, s


def solve_both(fam, config, count=3, seed=2**31 + 99):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    pool = harness.Pool(dict(config, family=fam.__name__.rsplit(".")[-1]),
                        dict(entry="conic_ip", batch=1, pool=count), seed,
                        "cpu")
    ops = pool.stack(slice(0, count))
    y_ref, w_ref, v_ref, ok = fam.reference(ops, torch.float64)
    assert ok.all()
    for i in range(count):
        sol = program.conic_ip(**pool.operands(i), device="cpu")
        assert sol.status == "Optimal"
        one = pool.stack(slice(i, i + 1))
        got = certificate.numbers(one, sol.y[None], sol.w[None], sol.v[None])
        want = certificate.numbers(one, y_ref[i:i + 1], w_ref[i:i + 1],
                                   v_ref[i:i + 1])
        # both optimal to their tolerances: the objectives agree to optTol
        gap = (got["obj"] - want["obj"]).abs() / (1 + want["obj"].abs())
        assert gap.item() < 1e-6
        assert want["dual_res"].item() < 1e-9
        assert got["dual_res"].item() < 1e-12
        for key in ("primal_viol", "dual_viol", "compl"):
            assert got[key].item() < 1e-6 and want[key].item() < 1e-9


def test_box_qp_reference_agrees_with_the_program():
    torch.set_num_threads(1)
    solve_both(box_qp, dict(n=30, dtype="float64"))


def test_psd_reference_agrees_with_the_program():
    torch.set_num_threads(1)
    solve_both(psd_projection, dict(k=7, dtype="float64"))


def test_packing_is_the_programs():
    X = torch.randn(2, 5, 5, dtype=torch.float64)
    X = X + X.transpose(-1, -2)
    assert torch.allclose(ref_psd.vecm(X), symm.vecm(X))
    assert torch.equal(ref_psd.mat(ref_psd.vecm(X)), X) or torch.allclose(
        ref_psd.mat(ref_psd.vecm(X)), X, rtol=0, atol=1e-15)


def test_the_cones_distances():
    x = torch.tensor([[3.0, -4.0, 0.0], [-1.0, 0.0, 2.0]], dtype=torch.float64)
    assert r.distance(x).tolist() == pytest.approx([4.0, 1.0])
    # S: the norm of the negative eigenvalues
    lam = torch.tensor([2.0, -3.0, -4.0], dtype=torch.float64)
    V = torch.linalg.qr(torch.randn(3, 3, dtype=torch.float64))[0]
    X = ref_psd.vecm((V * lam) @ V.T)
    assert s.distance(X[None]).item() == pytest.approx(5.0)


def test_the_certificate_holds_equalities():
    """A box QP with one equality (Σy = ½) solved on the CPU: every
    measure under optTol, and each fault the equality's terms exist for
    reads above it."""
    torch.set_num_threads(1)
    pool = harness.Pool(dict(family="box_qp", n=20, dtype="float64"),
                        dict(entry="conic_ip", batch=1, pool=1), 2**31 + 5,
                        "cpu")
    ops = pool.stack(slice(0, 1))
    ops["G"] = torch.ones(1, 1, 20, dtype=torch.float64)
    ops["d"] = torch.full((1, 1), 0.5, dtype=torch.float64)
    sol = program.conic_ip(**{k: x if k == "cone_dims" else x[0]
                              for k, x in ops.items()}, device="cpu")
    assert sol.status == "Optimal"
    y, w, v = sol.y[None], sol.w[None], sol.v[None]
    assert w.abs().item() > 1e-3  # the equality binds
    got = certificate.numbers(ops, y, w, v)
    for key in ("dual_res", "primal_viol", "dual_viol", "compl"):
        assert got[key].item() < 1e-6, key
    # w's sign and Gᵀw are in the stationarity residual
    assert certificate.numbers(ops, y, -w, v)["dual_res"].item() > 1e-4
    # Gy = d is held: y moved off it, inside the box
    free = (y.abs() < 0.9).to(y.dtype)
    assert free.sum() > 0
    moved = certificate.numbers(ops, y + 1e-4 * free, w, v)["primal_viol"]
    assert moved.item() == pytest.approx(1e-4 * free.sum().item() / 1.5)
