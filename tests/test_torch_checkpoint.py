"""Checkpoint/resume of batched solves in the port.

Counterparts of tests/test_checkpoint.py (all but the mesh one), on the
CPU, plus the exchange of snapshots between the two packages: a snapshot is
an ``.npz`` of numpy arrays with the same field names on both sides, so a
run interrupted in one package resumes in the other. Statuses must be
equal; iterates of two tolerance-accurate solves agree to 2e-3, as in the
reference's own test (a chunk boundary warm-restarts the iteration).
"""

import numpy as np
import pytest
import torch

import conicip_tpu.parallel as ct_parallel
import conicip_tpu.parallel.checkpoint as ct_cp
import conicip_tpu_torch.parallel.checkpoint as cp
from conicip_tpu_torch import batch_solution_to_numpy
from conicip_tpu_torch.models import batched_box_qp
from conicip_tpu_torch.parallel import (SnapshotInfo, load_snapshot,
                                        solve_batch, solve_batch_resumable)

torch.set_num_threads(1)


@pytest.fixture
def batch_problem():
    return batched_box_qp(batch=6, n=20)


def resid(bs):
    return torch.maximum(bs.prFeas, torch.maximum(bs.duFeas, bs.muFeas))


def interrupt_second_chunk(module, monkeypatch):
    """Make ``module``'s second chunk die, as a preemption would."""
    orig = module.solve_batch
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt
        return orig(*a, **k)

    monkeypatch.setattr(module, "solve_batch", flaky)
    return lambda: monkeypatch.setattr(module, "solve_batch", orig)


def test_uninterrupted_matches_solve_batch(batch_problem, tmp_path):
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")
    out = solve_batch_resumable(Q, c, A, b, cones, store=store,
                                chunk_iters=50, optTol=1e-7, device="cpu")
    assert out.statuses == ["Optimal"] * 6
    ref = solve_batch(Q, c, A, b, cones, optTol=1e-7, device="cpu")
    # one chunk holds the whole solve: the same run
    assert torch.equal(out.y, ref.y) and torch.equal(out.Iter, ref.Iter)
    info = load_snapshot(store)
    assert isinstance(info, SnapshotInfo) and info.done
    assert (info.batch, info.n_finished, info.iters_done) == (6, 6, 50)


def test_preemption_resumes_from_snapshot(batch_problem, tmp_path,
                                          monkeypatch):
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")
    restore = interrupt_second_chunk(cp, monkeypatch)
    with pytest.raises(KeyboardInterrupt):
        solve_batch_resumable(Q, c, A, b, cones, store=store, chunk_iters=3,
                              maxIters=60, optTol=1e-7, device="cpu")
    restore()

    info = load_snapshot(store)
    assert info is not None
    assert info.iters_done == 3
    assert not info.done  # box QPs need ~7 iterations; 3 is mid-flight

    out = solve_batch_resumable(Q, c, A, b, cones, store=store,
                                chunk_iters=50, maxIters=60, optTol=1e-7,
                                device="cpu")
    assert out.statuses == ["Optimal"] * 6
    assert float(resid(out).max()) < 1e-7
    # cumulative iteration counts include the pre-preemption chunk
    assert int(out.Iter.min()) > 3
    ref = solve_batch(Q, c, A, b, cones, optTol=1e-7, device="cpu")
    assert out.statuses == ref.statuses
    assert (out.y - ref.y).abs().max() <= 2e-3
    assert load_snapshot(store).done


def test_resume_rejects_different_data(batch_problem, tmp_path):
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")
    solve_batch_resumable(Q, c, A, b, cones, store=store, chunk_iters=50,
                          device="cpu")
    with pytest.raises(ValueError, match="different problem data"):
        solve_batch_resumable(Q, np.asarray(c) * 2.0, A, b, cones,
                              store=store, chunk_iters=50, device="cpu")


def test_iteration_exhaustion_is_abandoned(batch_problem, tmp_path):
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")
    out = solve_batch_resumable(Q, c, A, b, cones, store=store,
                                chunk_iters=1, maxIters=2, optTol=1e-12,
                                device="cpu")
    assert all(s in ("Abandoned", "Optimal") for s in out.statuses)
    assert "Abandoned" in out.statuses  # 1e-12 in 2 iters is not happening
    assert load_snapshot(store).iters_done == 2


def test_snapshot_matches_the_reference_field_for_field(batch_problem,
                                                        tmp_path):
    """The same interrupted run in both packages leaves the same file:
    same keys, shapes, fingerprint and statuses, iterates within 1e-6."""
    Q, c, A, b, cones = batch_problem
    mine, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    kw = dict(chunk_iters=3, maxIters=3, optTol=1e-7)
    solve_batch_resumable(Q, c, A, b, cones, store=mine, device="cpu", **kw)
    ct_parallel.solve_batch_resumable(Q, c, A, b, cones, store=theirs, **kw)
    za, zb = np.load(mine), np.load(theirs)
    assert sorted(za.files) == sorted(zb.files)
    assert str(za["fingerprint"]) == str(zb["fingerprint"])
    for k in za.files:
        assert za[k].shape == zb[k].shape, k
        if za[k].dtype.kind == "f":
            np.testing.assert_allclose(za[k], zb[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_array_equal(za["status"], zb["status"])
    np.testing.assert_array_equal(za["Iter"], zb["Iter"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_crosses_between_the_packages(batch_problem, tmp_path,
                                               monkeypatch, writer):
    """A run preempted after its first chunk in one package is resumed by
    the other, with the statuses of an uninterrupted solve."""
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")
    kw = dict(store=store, maxIters=60, optTol=1e-7)
    first, module, first_kw = (
        (ct_parallel.solve_batch_resumable, ct_cp, {}) if writer == "reference"
        else (solve_batch_resumable, cp, dict(device="cpu")))
    restore = interrupt_second_chunk(module, monkeypatch)
    with pytest.raises(KeyboardInterrupt):
        first(Q, c, A, b, cones, chunk_iters=3, **first_kw, **kw)
    restore()
    info = load_snapshot(store)
    assert vars(info) == vars(ct_parallel.load_snapshot(store))
    assert info.iters_done == 3 and not info.done

    if writer == "reference":
        out = batch_solution_to_numpy(solve_batch_resumable(
            Q, c, A, b, cones, chunk_iters=50, device="cpu", **kw))
    else:
        out = ct_parallel.solve_batch_resumable(Q, c, A, b, cones,
                                                chunk_iters=50, **kw)
    ref = solve_batch(Q, c, A, b, cones, optTol=1e-7, device="cpu")
    assert out.statuses == ref.statuses == ["Optimal"] * 6
    assert np.asarray(out.Iter).min() > 3
    np.testing.assert_allclose(np.asarray(out.y), ref.y.numpy(), atol=2e-3)
    assert load_snapshot(store).done
