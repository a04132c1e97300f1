"""The fused update's indexed contract on the CPU: whole per-agent tables
and a source index against the row-gathered inputs, bit for bit.

The single-device engine hands ``fused_row_update`` its whole (n, .)
tables and ``src = slot_rows``; the kernel reads each woken row's entries
where they lie. The sharded engine, ``chip_smoke.py`` and the kernel
benches keep the row-gathered contract (``src=None``). Both must give the
same bits: the plain version at ``src`` against the plain version on
``table[src]``, the coefficient pack made once against the per-slot pack,
and a fused engine's slots against the same slots through the
row-gathered contract. ``tests/test_torch_cuda.py`` holds the kernel to
the same on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import AgentData, DPConfig, knn_graph, make_objective
from repro_torch.kernels import ops
from repro_torch.kernels.fused_row_update import fused_row_update_cuda, fused_row_update_plain
from repro_torch.sim import AsyncEngine, CDUpdate, DPCDUpdate
from repro_torch.sim.updates import _eq4_fused_args, fused_rows, fused_tables

from fused_routes import row_gathered


def _objective(n, p, m, clip, seed):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    mask = (rng.random((n, m)) < 0.8).astype(np.float64)
    return make_objective(graph, AgentData(X=X, y=y, mask=mask), "quadratic", mu=0.5,
                          clip=clip, mix_mode="sparse")


def _update(obj, private):
    if private:
        return DPCDUpdate.plan(obj, DPConfig(eps_bar=0.5), planned_Ti=3)
    return CDUpdate(obj)


# (private, clip, slab): CD and DP noise, the clip on and off (the private
# step needs one), and a sharded-style slab whose limit lies below its rows.
CASES = [(False, None, "theta"), (False, None, "slab"), (False, 1.0, "slab"),
         (True, 1.0, "theta"), (True, 0.3, "slab")]


@pytest.mark.parametrize("private,clip,slab", CASES)
def test_indexed_tables_give_the_row_gathered_bits(private, clip, slab):
    n, p, m, B = 96, 12, 5, 40
    obj = _objective(n, p, m, clip, seed=3)
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(7)

    # 1. The plain version at src over whole tables, against it on table[src].
    tab = fused_tables(obj, cpu)
    assert tab["coef"].shape == (n, 4) and tab["X"] is obj.tensors(cpu, torch.float32)["X"]
    idx = torch.randint(0, n, (n, 9), generator=g, dtype=torch.int32)
    w = torch.rand((n, 9), generator=g)
    w[torch.rand((n, 9), generator=g) < 0.4] = 0.0
    if slab == "slab":  # owned rows [0, limit), halo rows above; sentinel = limit
        limit, nt = n + 8, n + 30
        idx = idx + torch.randint(0, 2, (n, 9), generator=g, dtype=torch.int32) * (nt - n)
    else:
        limit = nt = n
    src = torch.randperm(n, generator=g)[:B].to(torch.int32)
    rows = torch.randperm(limit, generator=g)[:B].to(torch.int32)
    rows[torch.arange(B) % 7 == 3] = limit  # sentinels
    noise = 0.05 * torch.randn((B, p), generator=g) if private else None
    theta = torch.randn((nt, p), generator=g)
    tables = (idx, w, tab["coef"], tab["X"], tab["y"], tab["mask"])
    s = src.long()
    got, want, via_ops = theta.clone(), theta.clone(), theta.clone()
    fused_row_update_plain(rows, *tables, noise, got, limit, clip, src=src)
    fused_row_update_plain(rows, *(t[s] for t in tables), noise, want, limit, clip)
    ops.fused_row_update(rows, *tables, noise, via_ops, limit, clip, src=src)
    assert torch.equal(got, want) and torch.equal(via_ops, want)
    assert not torch.equal(want, theta)
    assert torch.equal(want[limit:], theta[limit:])  # sentinels and halo rows unwritten

    # 2. The pack made once, row for row, against the per-slot pack of the
    # constants gathered at the woken rows (padding clamped, as the slot has it).
    woken = torch.sort(src.long()).values
    woken[-5:] = n
    valid = woken < n
    krows, consts = fused_rows(obj, woken, valid, cpu)
    per_slot = _eq4_fused_args(obj, krows, None, None, consts, None)[3]
    assert torch.equal(tab["coef"][woken.clamp(max=n - 1)], per_slot)

    # The wrapper's checks of the indexed form run before any build.
    with pytest.raises(TypeError, match="int32"):
        fused_row_update_cuda(rows, *tables, noise, theta.clone(), limit, clip, src=s)
    with pytest.raises(ValueError, match="src must have shape"):
        fused_row_update_cuda(rows, *tables, noise, theta.clone(), limit, clip, src=src[1:])
    with pytest.raises(ValueError, match="coef must be"):
        fused_row_update_cuda(rows, idx, w, tab["coef"][1:], *tables[3:], noise,
                              theta.clone(), limit, clip, src=src)


# (private, clip): CD with the clip off and on, DP with two clips.
@pytest.mark.parametrize("private,clip", [(False, None), (False, 1.0), (True, 1.0), (True, 0.3)])
def test_fused_engine_indexed_route_equals_row_gathered(private, clip):
    """A fused engine on the CPU: 16 forced-wake slots through the indexed
    route against the same slots through the row-gathered contract, every
    state tensor and the generator bit for bit."""
    n, p, m = 96, 12, 5
    obj = _objective(n, p, m, clip, seed=3)
    upd = _update(obj, private)
    masks = list(np.random.default_rng(5).random((16, n)) < 0.35)
    Theta0 = np.random.default_rng(6).normal(size=(n, p))
    out = []
    for u in (upd, row_gathered(upd)):
        eng = AsyncEngine(u, slot_wakes=24.0, batch_size=48, seed=2, fused=True, device="cpu")
        assert eng.fused
        state = eng.init_state(Theta0)
        for mask in masks:
            state = eng.step(state, mask)
        out.append(state)
    a, b = out
    assert int(a.applied) > 0 and int(a.ptr) == 16
    for name in ("Theta", "active", "applied", "dropped", "messages", "ptr"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    if private:
        assert torch.equal(a.ustate, b.ustate)
        assert int((a.ustate >= 3).sum()) > 0  # budget sentinels were reached
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
