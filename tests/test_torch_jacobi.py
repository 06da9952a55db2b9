"""The S cones' small decompositions: the Jacobi kernels' arithmetic and the
CPU route of ``conicip_tpu_torch.ops.batched``.

The CUDA kernels (``csrc/jacobi.cu``) cannot run here. Their arithmetic is
held through ``tests/jacobi_model.py``, which follows them step for step,
against LAPACK (numpy) and against the JAX package's ``jnp.linalg.eigh`` /
``eigvalsh`` / ``svd`` on numpy-seeded stacks, with quantities that do not
depend on the choice of signs or bases: the values, |U diag(w) Uᵀ − A|_F,
|UᵀU − I|_F and, for the SVD, |Uᵀ M Mᵀ U − diag(σ²)|_F. The kernels
themselves are held against the model on the card (tests/test_torch_cuda.py)
and against their plain versions by chip_smoke.py.

Tolerances, relative to max(1, |A|_F) (|M|_F² for the Gram identity, which
is quadratic in M): 1e-12 in f64 and 1e-5 in f32, the rounding of the
working type at these orders with a margin for the two summation orders.
The kernels compute in double for both entries; an f32 Jacobi would not
meet 1e-5 for |UᵀU − I|_F (one rounding per rotation, some 10 ε32 after
5-7 sweeps: 2e-5 at d = 30 on this model), where f32 LAPACK does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conicip_tpu  # noqa: F401  (turns on x64 for the f64 comparisons)
import jacobi_model as model
from jacobi_cases import (clustered, projector, reflected, rotated_pair,
                          rule_edge, sym)
from conicip_tpu_torch.ops import batched, jacobi_kernel

torch.set_num_threads(1)

# the block kernels' orders (d > 32) after the warp kernels' and their edge
BLOCK_ORDERS = (40, 64, 100)
ORDERS = (1, 2, 5, 10, 20, 30, 33) + BLOCK_ORDERS
# the fused round against the two-pass one: a warp's orders, its edge and
# the block kernels' orders up to 64
FUSED_ORDERS = ORDERS[:-1]
DTYPES = (np.float64, np.float32)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def spd(rng, d, kappa):
    """SPD of order d with eigenvalues spread over [1/kappa, 1]."""
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (Q * np.logspace(0, -np.log10(kappa), d)) @ Q.T


def eigh_cases(rng, d):
    """(label, matrix) of the eigendecomposition cases at order d."""
    return (("random", sym(rng, d, d)), ("identity", np.eye(d)),
            ("clustered", clustered(rng, d)),
            ("indefinite", sym(rng, d, d) - 2.0 * np.eye(d)),
            ("spd", spd(rng, d, 1e6)))


def lz_ls(rng, d):
    """Lzᵀ Ls of the NT scaling for an ill-conditioned pair Z, S."""
    Lz = np.linalg.cholesky(spd(rng, d, 1e8))
    Ls = np.linalg.cholesky(spd(rng, d, 1e5))
    return Lz.T @ Ls


def svd_cases(rng, d):
    return (("random", rng.standard_normal((d, d))), ("identity", np.eye(d)),
            ("lz_ls", lz_ls(rng, d)))


def scale(A):
    return max(1.0, float(np.linalg.norm(A.astype(np.float64))))


def check_eigh(A, w, U, tol, against):
    A, w, U = (x.astype(np.float64) for x in (A, w, U))
    d, s = A.shape[-1], scale(A)
    assert np.abs(w - against).max() <= tol * s
    assert np.all(np.diff(w) >= 0)
    assert np.linalg.norm(U @ np.diag(w) @ U.T - A) <= tol * s
    assert np.linalg.norm(U.T @ U - np.eye(d)) <= tol * s


def check_svd(M, U, sig, tol, against):
    M, U, sig = (x.astype(np.float64) for x in (M, U, sig))
    d, s = M.shape[-1], scale(M)
    assert np.abs(sig - against).max() <= tol * s
    assert np.all(np.diff(sig) <= 0) and np.all(sig >= 0)
    G = U.T @ M @ M.T @ U - np.diag(sig ** 2)
    assert np.linalg.norm(G) <= tol * s * s
    assert np.linalg.norm(U.T @ U - np.eye(d)) <= tol * s


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", ORDERS)
def test_eigh_model_against_lapack_and_jax(d, dtype):
    rng = np.random.default_rng(d)
    tol = TOL[dtype]
    for label, A in eigh_cases(rng, d):
        A = A.astype(dtype)
        w, U = model.eigh_one(A)
        assert w.dtype == U.dtype == dtype, label
        check_eigh(A, w, U, tol, np.linalg.eigvalsh(A.astype(np.float64)))
        wj, Uj = jnp.linalg.eigh(jnp.asarray(A))
        check_eigh(A, w, U, tol, np.asarray(wj))
        # values only: the same arithmetic on A, so the same values
        assert np.array_equal(model.eigh_one(A, vectors=False)[0], w), label
        wv = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(A)), np.float64)
        assert np.abs(w - wv).max() <= tol * scale(A), label


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", ORDERS)
def test_svd_model_against_lapack_and_jax(d, dtype):
    rng = np.random.default_rng(100 + d)
    tol = TOL[dtype]
    for label, M in svd_cases(rng, d):
        M = M.astype(dtype)
        U, sig = model.svd_one(M)
        assert U.dtype == sig.dtype == dtype, label
        check_svd(M, U, sig, tol,
                  np.linalg.svd(M.astype(np.float64), compute_uv=False))
        Uj, sj, _ = jnp.linalg.svd(jnp.asarray(M))
        check_svd(M, U, sig, tol, np.asarray(sj))
        # the reference's U spans the same columns: |Uᵀ U_ref| = I where
        # the singular values are apart (the random and lz_ls cases)
        if label != "identity":
            P = np.abs(U.astype(np.float64).T @ np.asarray(Uj, np.float64))
            if d not in BLOCK_ORDERS:
                assert np.abs(P - np.eye(d)).max() <= 1e3 * tol, label
            else:
                check_span_past_the_reference(M, U, P, tol, label)


def check_span_past_the_reference(M, U, P, tol, label):
    """The span check of the block kernels' orders (BLOCK_ORDERS): every
    column of |Uᵀ U_ref| within the bound of I, but for a column whose
    singular value lies closer to its neighbours than the reference's
    working precision resolves (eps σ₁ / gap above the bound: lz_ls in f32
    from d = 40, gaps of 3e-7 σ₁), which an f32 reference leaves
    undetermined; such a column is held against LAPACK's f64 U of the same
    input instead, within the same bound."""
    d, dtype = M.shape[-1], M.dtype
    far = np.abs(P - np.eye(d)).max(axis=0) > 1e3 * tol
    if not far.any():
        return
    s64 = np.linalg.svd(M.astype(np.float64), compute_uv=False)
    gap = np.minimum(np.abs(np.diff(s64, prepend=np.inf)),
                     np.abs(np.diff(s64, append=-np.inf)))
    blind = np.finfo(dtype).eps * s64[0] / gap > 1e3 * tol
    assert np.all(blind[far]), (label, np.flatnonzero(far))
    U64 = np.linalg.svd(M.astype(np.float64))[0]
    P64 = np.abs(U.astype(np.float64).T @ U64)
    assert np.abs(P64 - np.eye(d)).max() <= 1e3 * tol, label


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", FUSED_ORDERS)
def test_the_fused_round_gives_the_two_pass_rounds_bits(d, dtype):
    # the kernels rotate each 2 x 2 block rows-then-columns in one pass
    # (one warp a matrix up to d = 32, one block above): the same products
    # in the same order as the row pass followed by the column pass, so
    # the same bits, values and vectors
    rng = np.random.default_rng(d)
    for label, A in eigh_cases(rng, d):
        A = A.astype(dtype)
        for vectors in (True, False):
            two = model.eigh_one(A, vectors)
            one = model.eigh_one(A, vectors, fused=True)
            for a, b in zip(two, one):
                assert (a is None and b is None) or np.array_equal(a, b), (
                    label, vectors)


def test_the_ordering_pairs_every_index_once_a_round_and_every_pair_once():
    for d in (1, 2, 3, 10, 33):
        n = d + (d & 1)
        seen = set()
        for r in range(n - 1):
            p, q = model.pairs(r, n)
            assert sorted(np.concatenate([p, q])) == list(range(n))
            assert np.all(p < q)
            seen |= {(a, b) for a, b in zip(p, q) if b < d}
        assert seen == {(a, b) for a in range(d) for b in range(a + 1, d)}


@pytest.mark.parametrize("d", [33, 34, 40, 64, 99, 100, 128, 201])
def test_the_block_kernels_pairs_are_the_orderings_pairs(d):
    # the block kernels (d > 32) label and orient a round's pairs their own
    # way (pair_ab): the same pairs as the circle ordering's, so the same
    # rotations; the last is the pair of the index that stays, n - 1
    n = d + (d & 1)
    for r in range(n - 1):
        a, b = model.pairs_ab(r, n)
        p, q = model.pairs(r, n)
        assert sorted(zip(np.minimum(a, b), np.maximum(a, b))) == sorted(
            zip(p, q))
        assert (a[-1], b[-1]) == (r, n - 1)


def test_the_block_eigh_pass_meets_at_most_two_lanes_a_bank():
    # the block eigh kernel's half-warps (16 lanes, one 64-bit wavefront)
    # each read one row at the columns a_l (then b_l) of 16 consecutive
    # pairs l; shared memory has 16 banks of 8 bytes, so within a row the
    # bank is the column mod 16 whatever the row and its stride. 16
    # consecutive indices mod n - 1 fall on 16 banks: two lanes meet in a
    # bank only where a window crosses the circle's turn or holds the
    # index n - 1, never more than two (the padding of odd d is not read)
    met = windows = 0
    for d in range(33, 257):
        n = d + (d & 1)
        m = n // 2
        for r in range(n - 1):
            for cols in model.pairs_ab(r, n):
                for h in range(0, m, 16):
                    win = cols[h:h + 16]
                    win = win[win < d]
                    if not win.size:
                        continue
                    most = np.bincount(win % 16).max()
                    assert most <= 2, (d, r, h)
                    met += most == 2
                    windows += 1
    assert met < 0.25 * windows, (met, windows)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_launch_plan(dtype):
    # csrc/jacobi.cu takes the plan the wrapper passes (plan_ok checks it):
    # one warp up to d = 32; above, one block of whole warps, at most 1024
    # threads, the shared memory an H100 block may use, and the matrices on
    # chip up to eigh's d = 119 and eigvalsh's and svd's 169
    plan = jacobi_kernel.launch_plan
    for kind in jacobi_kernel.KINDS:
        for d in range(1, 33):
            p = plan(kind, d, dtype)
            assert (p.route, p.threads, p.on_chip, p.work_elems) == (
                "warp", 32, True, 0)
            assert p.smem_bytes <= 49152  # no shared-memory opt-in
        edge = 119 if kind == "eigh" else 169
        assert plan(kind, edge, dtype).on_chip
        assert not plan(kind, edge + 1, dtype).on_chip
        mats = 2 if kind == "eigh" else 1
        for d in list(range(33, 260)) + [511, 1000, 2047, 2048]:
            p = plan(kind, d, dtype)
            m = (d + 1) // 2
            assert p.route == "block" and p == plan(kind, d, torch.float64)
            assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
            assert p.threads % p.lanes == 0
            assert p.smem_bytes == jacobi_kernel.smem_bytes(kind, d,
                                                            p.on_chip)
            assert p.smem_bytes <= jacobi_kernel.MAX_SMEM
            assert p.on_chip == (jacobi_kernel.smem_bytes(kind, d, True)
                                 <= jacobi_kernel.MAX_SMEM)
            assert p.work_elems == (0 if p.on_chip else mats * d * d)
            if kind == "svd":
                assert p.lanes == (32 if m <= 32 else 16)
                assert p.threads >= min(m, 1024 // p.lanes) * p.lanes
            else:
                # a row of pairs is whole half-warps; as many rows as fit
                assert p.lanes % 16 == 0 and m <= p.lanes < m + 32
                assert p.threads + 2 * p.lanes > min(m * p.lanes, 1024)
    # the edges in bytes: A and U (16 d^2) beside 5 m + 32 doubles
    assert jacobi_kernel.smem_bytes("eigh", 119) == 16 * 119 ** 2 + 8 * 332
    assert jacobi_kernel.smem_bytes("eigvalsh", 169) == (8 * 169 ** 2
                                                         + 8 * 457)
    assert jacobi_kernel.smem_bytes("svd", 170, False) == 8 * (2 * 170 + 32)
    for bad in (0, 2049):
        with pytest.raises(ValueError, match="order"):
            plan("eigh", bad, dtype)
    with pytest.raises(ValueError, match="kind"):
        plan("eig", 40, dtype)
    with pytest.raises(TypeError, match="dtype"):
        plan("svd", 40, torch.float16)


@pytest.mark.parametrize("d", [40, 100, 120, 170])
def test_the_block_route_refuses_cpu_tensors(d):
    # above a warp's orders too the CPU takes ops.batched's plain version
    A = torch.eye(d, dtype=torch.float64).expand(2, d, d).contiguous()
    for fn in (jacobi_kernel.eigh, jacobi_kernel.eigvalsh, jacobi_kernel.svd):
        with pytest.raises(ValueError, match="device"):
            fn(A)
    assert jacobi_kernel.launch_count(d=d) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_non_finite_entry_is_nan_alone(dtype):
    rng = np.random.default_rng(7)
    A = sym(rng, 4, 6, 6).astype(dtype)
    A[1, 2, 3] = np.nan
    A[2, 0, 5] = np.inf  # in the upper triangle: still not finite input
    w, U = model.eigh(A)
    Us, sig = model.svd(A)
    for out in (w, U, Us, sig):
        assert np.isnan(out[[1, 2]]).all() and np.isfinite(out[[0, 3]]).all()
    w0, U0 = model.eigh_one(A[0])
    assert np.array_equal(w[0], w0) and np.array_equal(U[0], U0)
    assert np.array_equal(model.eigvalsh(A)[3], model.eigh_one(A[3])[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_sweep_limit_gives_nan_alone(dtype):
    rng = np.random.default_rng(8)
    A = np.stack([np.diag(rng.standard_normal(5)), sym(rng, 5, 5)]).astype(
        dtype)
    # a diagonal matrix is converged before any sweep, a full one is not
    # after one
    w, U = model.eigh(A, max_sweeps=1)
    assert np.isfinite(w[0]).all() and np.isnan(w[1]).all()
    assert np.isfinite(U[0]).all() and np.isnan(U[1]).all()
    assert np.isnan(model.eigvalsh(A, max_sweeps=1)[1]).all()
    # the SVD stops after a sweep with no rotation: one for a diagonal M
    Us, sig = model.svd(A, max_sweeps=1)
    assert np.isfinite(sig[0]).all() and np.isnan(sig[1]).all()
    assert np.isnan(Us[1]).all()
    # and with room enough both converge
    assert np.isfinite(model.eigh(A)[0]).all()
    assert np.isfinite(model.svd(A)[1]).all()


def test_the_model_keeps_the_kernels_sweep_limit():
    assert model.MAX_SWEEPS == jacobi_kernel.MAX_SWEEPS == 40


# ── Rutishauser's negligible-element rule: exactly repeated spectra ───────

@pytest.mark.parametrize("seed", [1000, 1003])
def test_an_exactly_repeated_spectrum_gives_the_references(seed):
    # the reflected three-value spectrum at d = 64 did not converge within
    # 80 sweeps before the rule (seeds 1000 and 1003): eigh and eigvalsh
    # returned NaN where LAPACK and jnp.linalg give each value
    A = reflected(64, seed)
    tol = TOL[np.float64]
    w, U = model.eigh_one(A)
    assert np.isfinite(w).all() and np.isfinite(U).all()
    check_eigh(A, w, U, tol, np.linalg.eigvalsh(A))
    wj, _ = jnp.linalg.eigh(jnp.asarray(A))
    check_eigh(A, w, U, tol, np.asarray(wj))
    values = np.sort(np.repeat([2.0, -0.5, 1.0], 22)[:64])
    assert np.abs(w - values).max() <= tol * scale(A)
    wv = model.eigh_one(A, vectors=False)[0]
    assert np.array_equal(wv, w)
    wvj = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(A)))
    assert np.abs(wv - wvj).max() <= tol * scale(A)


# the model's sweeps on the random matrices of eigh_cases (sym(rng, d, d),
# rng = default_rng(d)), the same with the rule as without it
RANDOM_SWEEPS = {10: 6, 20: 7, 33: 7, 64: 8}


@pytest.mark.parametrize("case", ["reflected", "projector", "clustered",
                                  "random"])
@pytest.mark.parametrize("d", sorted(RANDOM_SWEEPS))
def test_a_repeated_spectrum_takes_no_more_sweeps_than_the_bound(d, case):
    # an exactly repeated spectrum (reflected seed 1000, the projector,
    # clustered's random basis) within 30 sweeps, under the limit of 40;
    # a random matrix in its count from before the rule. The fused round
    # gives the two-pass round's bits with the rule too (a warp's orders
    # and the block kernels' first)
    rng = np.random.default_rng(d)
    A = {"reflected": lambda: reflected(d, 1000),
         "projector": lambda: projector(d, 1000),
         "clustered": lambda: clustered(rng, d),
         "random": lambda: sym(rng, d, d)}[case]()
    norms = []
    w, U = model.eigh_one(A, norms=norms)
    sweeps = len(norms) - 1
    assert np.isfinite(w).all() and norms[-1] <= 1
    if case == "random":
        assert sweeps == RANDOM_SWEEPS[d]
    else:
        assert sweeps <= 30, sweeps
    check_eigh(A, w, U, TOL[np.float64], np.linalg.eigvalsh(A))
    if d <= 33:
        wf, Uf = model.eigh_one(A, fused=True)
        assert np.array_equal(wf, w) and np.array_equal(Uf, U)


@pytest.mark.parametrize("a", [0.75, 0.6, -0.9])
@pytest.mark.parametrize("d", [4, 40])
def test_the_rule_takes_a_pq_up_to_its_edge_and_one_ulp_past_rotates(d, a):
    # the Handbook's test with |a_pq| itself added: at its edge the pair is
    # not rotated and a_pq is set to 0 (the value a twice, e_0 and e_(d-1)
    # its vectors); one unit in the last place past it, the pair rotates
    # (a_pp = a_qq: by 45 degrees). d = 4 a warp kernel's order, 40 a
    # block kernel's; 0.75's tie rounds down (to even), 0.6's up
    at, past = rule_edge(a, d)
    for A, rotates in ((at, False), (past, True)):
        norms = []
        w, U = model.eigh_one(A, norms=norms)
        assert len(norms) - 1 == 1
        assert rotated_pair(U, d) == rotates
        assert (np.count_nonzero(w == a) == 2) != rotates
        assert np.array_equal(model.eigh_one(A, vectors=False)[0], w)
        assert np.array_equal(model.eigh_one(A, fused=True)[1], U)
    assert model.negligible(a, at[0, d - 1], a)
    assert not model.negligible(a, past[0, d - 1], a)
    assert not model.negligible(a, 0.0, a)  # nothing to set to 0


# ── the CPU route of ops/batched.py: the plain versions, as before ─────────

def test_cpu_route_is_the_plain_library_call():
    rng = np.random.default_rng(3)
    for dt in (torch.float64, torch.float32):
        A = torch.from_numpy(sym(rng, 3, 5, 5)).to(dt)
        w, U = batched.safe_eigh(A)
        wl, Ul = torch.linalg.eigh(A)
        assert torch.equal(w, wl) and torch.equal(U, Ul)
        assert torch.equal(batched.safe_eigvalsh(A), torch.linalg.eigvalsh(A))
        Us, sig = batched.safe_svd(A)
        Ul, sl, _ = torch.linalg.svd(A)
        assert torch.equal(Us, Ul) and torch.equal(sig, sl)
        for safe, plain in ((batched.safe_eigh, batched.eigh_plain),
                            (batched.safe_svd, batched.svd_plain)):
            for a, b in zip(safe(A), plain(A)):
                assert torch.equal(a, b)


def test_cpu_route_nan_fills_a_non_finite_entry():
    rng = np.random.default_rng(4)
    A = torch.from_numpy(sym(rng, 3, 4, 4))
    A[1, 0, 0] = float("inf")
    w, U = batched.safe_eigh(A)
    Us, sig = batched.safe_svd(A)
    for out in (w, U, Us, sig, batched.safe_eigvalsh(A)):
        assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()
    assert torch.equal(w[[0, 2]], torch.linalg.eigh(A[[0, 2]])[0])


def test_kernel_module_imports_without_a_card_and_refuses_other_devices():
    A = torch.eye(3, dtype=torch.float64)
    for fn in (jacobi_kernel.eigh, jacobi_kernel.eigvalsh, jacobi_kernel.svd):
        # the CPU takes ops.batched's plain version, never these
        with pytest.raises(ValueError, match="device"):
            fn(A)
        with pytest.raises(ValueError, match="device"):
            fn(A.to("meta"))
    for fn in (batched.safe_eigh, batched.safe_eigvalsh, batched.safe_svd):
        with pytest.raises(ValueError, match="device"):
            fn(A.to("meta"))
    assert jacobi_kernel.launch_count() == 0  # nothing launched here


def test_launch_count_filters_by_kind_dtype_and_order():
    f64, f32 = torch.float64, torch.float32
    saved = jacobi_kernel.jacobi_launches.copy()
    try:
        jacobi_kernel.reset_launch_count()
        jacobi_kernel.jacobi_launches.update({("svd", f64, 10, 64): 3,
                                              ("eigvalsh", f32, 10, 128): 2,
                                              ("eigh", f64, 5, 1): 1})
        assert jacobi_kernel.launch_count() == 6
        assert jacobi_kernel.launch_count("svd") == 3
        assert jacobi_kernel.launch_count(dtype=f32) == 2
        assert jacobi_kernel.launch_count(d=10) == 5
        assert jacobi_kernel.launch_count("eigh", f64, 5) == 1
        jacobi_kernel.reset_launch_count()
        assert jacobi_kernel.launch_count() == 0
    finally:
        jacobi_kernel.jacobi_launches.clear()
        jacobi_kernel.jacobi_launches.update(saved)


def test_no_other_module_of_the_port_calls_a_library_decomposition():
    # every eigen- and singular-value decomposition of the port goes
    # through ops/batched.py, so a CUDA tensor reaches the kernels
    import pathlib
    import re

    import conicip_tpu_torch

    root = pathlib.Path(conicip_tpu_torch.__file__).parent
    pattern = re.compile(r"torch\.linalg\.(eigh|eigvalsh|svd|svdvals|eig|"
                         r"eigvals)\b")
    hits = [str(p.relative_to(root)) for p in root.rglob("*.py")
            if pattern.search(p.read_text())]
    assert hits == ["ops/batched.py"]
