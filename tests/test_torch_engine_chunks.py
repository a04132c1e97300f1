"""The engine's chunked driving against the reference, and what the
captured chunk needs of the slot, checked on the CPU.

``_drive_slots``/``_event_stride`` are the reference's (``repro.sim.engine``):
fed the same recording ``advance``, both call it with the same chunk
lengths and fire their events at the same slot counts, over a grid of
(slots, periods, steps_per_chunk); ``run`` records the objective at the
reference's slots and chunks like it. A CUDA graph replays fixed
addresses, so every state tensor must keep its address across
``advance``; and a state whose tensors are not the live buffers
(``sim/capture.py``'s ``ChunkGraphs.bind``, run here with eager slots in
place of replays) must give exactly the result of running it directly.
The replays themselves run on the card (``tests/test_torch_cuda.py``).
"""

import itertools

import numpy as np
import pytest
import torch

import repro.sim as jsim
import repro.sim.engine as jengine
from repro.core import AgentData, knn_graph, make_objective
from repro_torch.convert import objective_from_reference
from repro_torch.core import DPConfig
from repro_torch.sim import (
    AsyncEngine,
    CDUpdate,
    ChurnConfig,
    DelayConfig,
    DPCDUpdate,
    PropagationUpdate,
    Scenario,
    StragglerConfig,
)
from repro_torch.sim import engine as tengine
from repro_torch.sim.capture import ChunkGraphs


def _problem(n=40, p=4, m=3, seed=0, clip=None):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse", clip=clip)
    return ref, objective_from_reference(ref)


def _recorded(driver, slots, stride, periods):
    calls, fired = [], []

    def advance(state, k):
        calls.append(k)
        return state + k

    events = [(every, (lambda tag: lambda s: fired.append((tag, s)))(i))
              for i, every in enumerate(periods)]
    end = driver(0, slots, stride, advance, events)
    return end, calls, fired


@pytest.mark.parametrize("slots", [0, 1, 5, 16, 37, 50])
@pytest.mark.parametrize("periods", [(), (1,), (4,), (6, 4), (16,), (0, 5)])
@pytest.mark.parametrize("spc", [1, 4, 16])
def test_drive_slots_and_event_stride_match_reference(slots, periods, spc):
    events = [(every, print) for every in periods]
    stride = tengine._event_stride(events, spc)
    assert stride == jengine._event_stride(events, spc)
    got = _recorded(tengine._drive_slots, slots, stride, periods)
    want = _recorded(jengine._drive_slots, slots, stride, periods)
    assert got == want
    assert got[0] == slots and set(got[1]) <= {stride, 1}


def _count_chunks(engine):
    calls = []
    inner = engine.advance

    def advance(state, k):
        calls.append(k)
        return inner(state, k)

    engine.advance = advance
    return calls


@pytest.mark.parametrize("slots,every,spc", [(37, 0, 16), (37, 10, 16), (20, 6, 4),
                                             (9, 0, 4), (12, 3, 1)])
def test_run_chunks_and_records_like_the_reference(slots, every, spc):
    ref, port = _problem(seed=1)
    Theta0 = np.random.default_rng(2).normal(size=(ref.n, ref.p))
    eng = AsyncEngine(CDUpdate(port), slot_wakes=8.0, seed=0, device="cpu", steps_per_chunk=spc)
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, seed=0, steps_per_chunk=spc)
    calls, jcalls = _count_chunks(eng), _count_chunks(jeng)
    res = eng.run(Theta0, slots=slots, record_every=every)
    jres = jeng.run(Theta0, slots=slots, record_every=every)
    assert calls == jcalls and sum(calls) == slots == res.slots
    if every:
        assert res.objective.shape == jres.objective.shape == (1 + -(-slots // every),)
        np.testing.assert_allclose(res.objective[0], jres.objective[0], rtol=1e-5)
    else:
        assert res.objective is None and jres.objective is None


CASES = ["cd", "cd_fused", "dp", "dp_fused", "delay", "churn_straggler", "propagation",
         "metrics"]


def _engine(case, **kw):
    ref, port = _problem(seed=3, clip=1.0 if case.startswith("dp") else None)
    kw.setdefault("slot_wakes", 8.0)
    kw.update(seed=4, device="cpu", fused=case.endswith("fused"))
    if case == "delay":
        kw["scenario"] = Scenario(delay=DelayConfig(max_delay=2, edge_delays=1))
    elif case in ("churn_straggler", "metrics"):
        kw["scenario"] = Scenario(churn=ChurnConfig(leave_prob=0.1, rejoin_prob=0.3),
                                  straggler=StragglerConfig(drop_prob=0.2))
    if case == "metrics":
        kw["metrics"] = True
    if case.startswith("dp"):
        upd = DPCDUpdate.plan(port, DPConfig(eps_bar=0.5), planned_Ti=2)
    elif case == "propagation":
        loc = np.random.default_rng(5).normal(size=(port.n, port.p))
        upd = PropagationUpdate(port.graph, loc, 0.4, port.confidences)
    else:
        upd = CDUpdate(port)
    return AsyncEngine(upd, **kw), np.random.default_rng(6).normal(size=(port.n, port.p))


def _leaves(state):
    out = {k: getattr(state, k) for k in ("Theta", "hist", "ptr", "active", "applied",
                                          "dropped", "messages")}
    if isinstance(state.ustate, torch.Tensor):
        out["ustate"] = state.ustate
    out.update({f"metrics.{k}": v for k, v in (state.metrics or {}).items()})
    return out


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("case", CASES)
def test_state_tensors_keep_their_addresses_across_advance(case):
    """The precondition for capture: the slot updates every state tensor in
    place, so after any number of slots the state holds the very tensors
    (same objects, same storage) it started with."""
    eng, Theta0 = _engine(case)
    state = eng.init_state(Theta0)
    before = {k: (v, v.data_ptr()) for k, v in _leaves(state).items()}
    gen = state.generator
    out = eng.advance(state, 7)
    out = eng.step(out, np.random.default_rng(1).random(eng.n) < 0.5)
    after = _leaves(out)
    assert after.keys() == before.keys()
    for k, (t, ptr) in before.items():
        assert after[k] is t and after[k].data_ptr() == ptr, k
    assert out.generator is gen and int(out.ptr) == 8


@pytest.mark.parametrize("case", ["cd", "dp_fused", "delay", "metrics"])
def test_a_foreign_state_gives_the_result_of_the_live_one(case):
    """``ChunkGraphs.bind`` copies a state that is not the live buffers
    into them (tensors, then the generator's seed and offset): a second
    ``init_state``, another engine's state and a resumed ``SimResult.state``
    each run on as if they had been advanced directly."""
    eng, Theta0 = _engine(case)
    want = eng._eager_slots(eng.init_state(Theta0), 15)
    graphs = ChunkGraphs(eng)
    live = eng._eager_slots(graphs.bind(eng.init_state(Theta0)), 3)  # adopted, then run
    foreign = eng.init_state(Theta0)
    bound = graphs.bind(foreign)
    assert bound.Theta is live.Theta and bound.generator is live.generator
    _assert_equal(bound, eng.init_state(Theta0))
    _assert_equal(eng._eager_slots(bound, 15), want)

    other, _ = _engine(case)
    half = other.run(Theta0, 9).state  # another engine's SimResult.state
    resumed = eng._eager_slots(graphs.bind(half), 6)
    assert resumed.Theta is live.Theta
    _assert_equal(resumed, want)
    again = graphs.bind(resumed)  # the live tensors bind as they are
    assert all(a is b for a, b in zip(_leaves(again).values(), _leaves(resumed).values()))


def test_cpu_engines_hold_no_graphs():
    eng, _ = _engine("cd")
    assert eng._graphs is None and eng.steps_per_chunk == 16


@pytest.mark.parametrize("spc,slots", list(itertools.product([1, 3, 16], [0, 2, 17])))
def test_advance_counts_every_slot_whatever_the_chunk(spc, slots):
    eng, Theta0 = _engine("churn_straggler", steps_per_chunk=spc)
    a = eng.advance(eng.init_state(Theta0), slots)
    b = eng._eager_slots(eng.init_state(Theta0), slots)
    assert int(a.ptr) == slots
    _assert_equal(a, b)
