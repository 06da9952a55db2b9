"""The memo of ``ops/control.py``: which kktsolvers read the device.

A caller's kktsolver whose callbacks were found to read the device under
``control.guarded`` is remembered, so that a later call on CUDA decides
before the solve (``control.eager_reason``). A bound method (``obj.kkt``)
is a new object at each attribute access; the memo keys it by its
``__self__`` and then its ``__func__``, weakly, so the same method of the
same object is found again, another object's is not, and the memo keeps
no object alive. PyTorch's sync debug mode, which this CPU build lacks, is
stood in for as in ``tests/test_torch_custom_kkt_graph.py``.
"""

import gc

import pytest
import torch

from conicip_tpu_torch.ops import control


@pytest.fixture
def sync_debug_mode(monkeypatch):
    """PyTorch's sync debug mode stood in for: the modes set, in order."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


class Solver:
    """A caller's KKT solver as an object; its level 1 is a method."""

    def __init__(self, modes):
        self.modes = modes

    def kkt(self, Q, A, G, spec):
        def solve3x3gen(F, FinvT):
            if self.modes[-1] == "error":  # what .item() raises in it
                raise RuntimeError("called a synchronizing CUDA operation")
            return None
        return solve3x3gen


class Slotted:
    """The same solver as an object that cannot be weakly referenced."""

    __slots__ = ("modes",)
    __init__ = Solver.__init__
    kkt = Solver.kkt


def found(kktsolver):
    """Run ``kktsolver`` under the guard until its read raises; returns
    the reason given."""
    with pytest.raises(control.ReadsDevice) as err:
        control.guarded(kktsolver)(None, None, None, None)(None, None)
    return err.value.reason


def test_a_bound_method_that_reads_the_device_is_remembered(sync_debug_mode):
    s, other = Solver(sync_debug_mode), Solver(sync_debug_mode)
    reason = found(s.kkt)
    assert "in solve3x3gen" in reason
    # a new bound method object of the same object and function
    assert s.kkt is not s.kkt
    assert control.eager_reason(s.kkt, "cuda") == reason
    # another object's method, and the function itself, are not decided
    assert control.eager_reason(other.kkt, "cuda") is None
    assert control.eager_reason(Solver.kkt, "cuda") is None
    # on the CPU nothing is captured: the device loop takes it
    assert control.eager_reason(s.kkt, "cpu") is None


def test_the_memo_keeps_no_object_alive(sync_debug_mode):
    s = Solver(sync_debug_mode)
    found(s.kkt)
    assert s in control._method_reads
    del s
    gc.collect()
    assert not any(isinstance(k, Solver) for k in control._method_reads)


def test_a_plain_callable_keeps_its_own_key(sync_debug_mode):
    s = Solver(sync_debug_mode)

    def kkt(*args):
        return s.kkt(*args)

    reason = found(kkt)
    assert control.eager_reason(kkt, "cuda") == reason
    assert control.eager_reason(s.kkt, "cuda") is None


def test_what_cannot_be_weakly_referenced_is_never_remembered(
        sync_debug_mode):
    s = Slotted(sync_debug_mode)
    found(s.kkt)
    assert control.eager_reason(s.kkt, "cuda") is None
