"""The device generators: deterministic per seed, with each family's
structure (on the CPU; the card runs the same code)."""

import torch

from portbench.families import box_qp, psd_projection
from portbench.reference import psd_projection as reference_psd

BOX = dict(n=12, dtype="float64")
PSD = dict(k=6, dtype="float64")


def draw(fam, config, seed, count=3):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return fam.instances(config, count, gen, "cpu")


def test_each_family_is_deterministic_per_seed():
    for fam, config in ((box_qp, BOX), (psd_projection, PSD)):
        a, b = draw(fam, config, 2**31 + 7), draw(fam, config, 2**31 + 7)
        other = draw(fam, config, 2**31 + 8)
        for part in ("each", "shared"):
            assert a[part].keys() == b[part].keys()
            for key in a[part]:
                assert torch.equal(a[part][key], b[part][key]), key
        assert set(a["each"]) | set(a["shared"]) == {"Q", "c", "A", "b"}
        assert not torch.equal(a["each"]["c"], other["each"]["c"])
        assert a["cone_dims"] == b["cone_dims"]


def test_box_qp_structure():
    made = draw(box_qp, BOX, 5)
    d = dict(made["each"], **made["shared"], cones=made["cone_dims"])
    n = BOX["n"]
    eye = torch.eye(n, dtype=torch.float64)
    assert torch.equal(d["A"], torch.cat([eye, -eye]))
    assert torch.equal(d["b"], -torch.ones(2 * n, dtype=torch.float64))
    assert d["cones"] == [("R", 2 * n)]
    Q = d["Q"]
    assert Q.shape == (3, n, n)
    assert torch.equal(Q, Q.transpose(-1, -2))
    assert torch.linalg.eigvalsh(Q).min() > -1e-12
    # every instance its own Q and c
    assert not torch.equal(Q[0], Q[1])
    assert not torch.equal(d["c"][0], d["c"][1])


def test_psd_projection_structure():
    made = draw(psd_projection, PSD, 5)
    d = dict(made["each"], **made["shared"], cones=made["cone_dims"])
    k = PSD["k"]
    n = k * (k + 1) // 2
    eye = torch.eye(n, dtype=torch.float64)
    assert torch.equal(d["Q"], eye) and torch.equal(d["A"], eye)
    assert torch.equal(d["b"], torch.zeros(n, dtype=torch.float64))
    assert d["cones"] == [("S", n)]
    C = reference_psd.mat(d["c"])
    assert torch.equal(C, C.transpose(-1, -2))
    lam = torch.linalg.eigvalsh(C)
    # the cone binds: every instance has negative and positive eigenvalues
    assert (lam.min(-1).values < 0).all() and (lam.max(-1).values > 0).all()
