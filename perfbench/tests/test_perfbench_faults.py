"""The timed path broken underneath: each fault a cell can have makes its
run come out not correct (the exchange between chips: no cell has one)."""

import pytest
import torch

from repro_torch.core import coordinate_descent
from repro_torch.sim import AsyncEngine, CDUpdate, DPCDUpdate
from perfbench.tests.small import CELLS, run

ASYNC = [c for c in CELLS if not c.endswith(".sync")]


def _unchanged_slots(monkeypatch):
    monkeypatch.setattr(AsyncEngine, "advance", lambda self, state, slots: state)


def _half_batch(monkeypatch):
    orig = AsyncEngine._compact

    def half(self, wake):
        woken, rows, valid, dropped = orig(self, wake)
        return woken, rows, valid & (self._arange_b % 2 == 0), dropped
    monkeypatch.setattr(AsyncEngine, "_compact", half)


def _altered_row(monkeypatch):
    for cls in (CDUpdate, DPCDUpdate):
        apply, fused = cls.apply, cls.apply_fused

        def altered(self, *a, _f=apply, **k):
            new, applied, st = _f(self, *a, **k)
            new = new.clone()
            new[0] *= 1.5
            return new, applied, st

        def altered_fused(self, slab, rows, valid, *a, _f=fused, **k):
            slab, applied, st = _f(self, slab, rows, valid, *a, **k)
            first = torch.clamp(rows[:1], max=slab.shape[0] - 1)
            slab[first] *= torch.where(applied[:1], 1.5, 1.0)[:, None]
            return slab, applied, st
        monkeypatch.setattr(cls, "apply", altered)
        monkeypatch.setattr(cls, "apply_fused", altered_fused)


def _altered_chunk(monkeypatch):
    """A row altered in the chunk alone: ``advance`` over whole chunks
    (what the timed window replays) changes a row that it wrote, while
    the one-slot calls that the checked slots make stay sound."""
    orig = AsyncEngine.advance

    def chunked(self, state, slots):
        out = orig(self, state, slots)
        if slots >= self.steps_per_chunk:
            moved = torch.nonzero((out.Theta != 0).any(1)).squeeze(1)
            if moved.numel():
                out.Theta[moved[0]] *= 1.5
        return out
    monkeypatch.setattr(AsyncEngine, "advance", chunked)


def _round_fault(kind):
    orig = coordinate_descent.synchronous_round

    def broken(obj, theta):
        if kind == "unchanged":
            return theta
        out = orig(obj, theta)
        if kind == "half":
            out[1::2] = theta[1::2]
        else:
            out[0] *= 1.5
        return out
    return broken


ASYNC_FAULTS = {"unchanged": _unchanged_slots, "half_batch": _half_batch,
                "altered": _altered_row, "altered_chunk": _altered_chunk}


@pytest.mark.parametrize("fault", sorted(ASYNC_FAULTS))
@pytest.mark.parametrize("name", ASYNC)
def test_async_fault_is_not_correct(name, fault, monkeypatch):
    ASYNC_FAULTS[fault](monkeypatch)
    r = run(name)
    assert r["correct"] is False, r["checks"]
    if fault == "altered_chunk":  # only the tie of the chunk to the checked slot sees it
        failed = {k for k, (v, limit) in r["checks"].items() if v > limit}
        assert "chunk_mismatch" in failed, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_round_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(coordinate_descent, "synchronous_round", _round_fault(fault))
    r = run("rgg500k_p100.sync")
    assert r["correct"] is False, r["checks"]
