"""The loop ``sharded_engine``: ``ShardedAsyncEngine.advance`` over the configuration.

The configuration's ``shards`` group (the number of silos S, the relabel,
the block cut) and ``exchange`` group (the wire's method, dtype and error
feedback) build the engine, the silos stacked on one device. The engine
gets the deployment's graph under its own names, the base graph's:
``data/problem.py`` renames the agents by the run's seed, and the RCM
relabel breaks degree ties by name, so under the run's names the silo cut
(its border and halo sizes) would change from seed to seed; the silos are
part of the deployment. The agents' data and every comparison keep the
run's names (``Layout`` maps them). A mix that
names this loop sets the timed call's slots (``call_slots``), the traced
stretch's calls (``trace_calls``) and the checked slots (``check``), as
for ``async_engine``; the phase programs are the sharded slot's
(``wake_sample``, ``halo_publish``, ``halo_collective``, ``halo_scatter``,
``fused_row_update``, ``finalize``).

The check follows ``async_engine``'s, once the window has closed and
through the timed path: ``check.points`` times, after 0 to
``check.max_calls_between`` more timed calls, the live state S0 (the
models, the churn flags and the error-feedback residuals), the chunk tied
to the one-slot graph (``chunk_mismatch``), then one slot from S0 and one
from S0' (every agent's row moved by N(0, ``check.perturb``)) with the same
draws; a last checked slot from the run's start. The reference
(``reference/halo.py``, the ownership read from the engine's partition)
judges each: the moved rows against the Eq. 4 step over exact own-silo and
bf16 other-silo reads (``step_gap``), the halo rows that the exchange left
in the slab against its payloads bit for bit, with the border and halo
sets (``halo_mismatch``), and the residuals after the slot against its
own (``ef_gap``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import harness
from perfbench.data import agents
from perfbench.data.rgg import relabel_csr
from perfbench.reference.control import ControlSlot, wake_probability
from perfbench.reference.halo import HaloReference

AE = harness.module("loops", "async_engine")  # the shared helpers and the phase timing


@dataclasses.dataclass
class Snapshot(AE.Snapshot):
    """``async_engine``'s snapshot, in agent order, with the slot's halo
    rows (one a real halo slot, the layout's order) and the residuals (one
    a border agent)."""

    halo: torch.Tensor | None = None
    ef: torch.Tensor | None = None


def base_names(cfg: dict, seeds: dict) -> np.ndarray:
    """The run's name of each agent of the configuration's base graph:
    ``data/problem.py`` renames base agent i ``names[i]``."""
    return np.random.default_rng(seeds["graph_relabel"]).permutation(int(cfg["n"]))


class Layout:
    """Where the engine keeps each agent's row, residual and halo copies
    (host tables of its partition, as device indices); agents by the run's
    names, ``names`` the run's name of each of the engine's agents."""

    def __init__(self, engine, device, names: np.ndarray):
        part, S, R = engine.part, engine.num_shards, engine.rows_per_shard
        H, n = engine.smix.halo_width, engine.n
        dev = device
        named = np.append(np.asarray(names, np.int64), n)  # the padding sentinel n stays n
        owned = named[np.asarray(part.owned, np.int64)]
        self.blocks = owned
        rows = np.asarray(part.shard_of, np.int64) * R + part.local_of
        self.agent_rows = torch.as_tensor(rows[np.argsort(names)], device=dev)
        s_b, b = np.nonzero(np.arange(part.border.shape[1])[None] <
                            np.asarray(part.border_sizes)[:, None])
        agent = owned[s_b, np.asarray(part.border, np.int64)[s_b, b]]
        self.ef_rows = torch.as_tensor(s_b * part.border.shape[1] + b, device=dev)
        self.border_agents = torch.as_tensor(agent, device=dev)
        self.border_keys = torch.as_tensor(s_b * n + agent, device=dev)
        s_h, h = np.nonzero(np.arange(H)[None] < np.asarray(part.halo_sizes)[:, None])
        agent = named[np.asarray(part.halo, np.int64)[s_h, h]]
        self.halo_rows = torch.as_tensor(S * R + s_h * H + h, device=dev)
        self.halo_agents = torch.as_tensor(agent, device=dev)
        self.halo_keys = torch.as_tensor(s_h * n + agent, device=dev)

    def snapshot(self, state, p: int) -> Snapshot:
        """A program state as the comparison reads it; counters from the state."""
        ef = (torch.zeros((self.ef_rows.numel(), p), device=state.slab.device)
              if state.ef is None else state.ef.reshape(-1, p)[self.ef_rows].float())
        return Snapshot(theta=state.slab[self.agent_rows].float(),
                        active=state.active.reshape(-1)[self.agent_rows].clone(), counts=None,
                        applied=int(state.applied.sum()), dropped=int(state.dropped.sum()),
                        messages=float(state.messages.sum()), ptr=int(state.ptr[0]),
                        halo=state.slab[self.halo_rows].float(), ef=ef)

    def residuals(self, snap: Snapshot, n: int) -> torch.Tensor:
        """The snapshot's residuals as (n, p) in agent order (0 off the border)."""
        e = torch.zeros((n, snap.ef.shape[1]), device=snap.ef.device)
        e[self.border_agents] = snap.ef
        return e


def reference(cfg: dict, prob, device) -> HaloReference:
    """The halo reference over the problem; ``check`` and ``controls`` give
    it the ownership (``HaloReference.own``)."""
    return HaloReference(prob.indptr, prob.indices, prob.weights, prob.X, prob.y, cfg["mu"],
                         device=device)


def _engine(cfg, update, seed, device, exchange, partition=None):
    """A ``ShardedAsyncEngine`` over the configuration with the wire
    ``exchange`` (an ``ExchangeSpec``), through the port's constructor."""
    from repro_torch.sim import ChurnConfig, Scenario, ShardedAsyncEngine

    sh, churn = cfg["shards"], cfg.get("churn")
    scenario = Scenario(churn=ChurnConfig(leave_prob=churn["leave"], rejoin_prob=churn["rejoin"])
                        if churn else None)
    return ShardedAsyncEngine(update, num_shards=int(sh["num_shards"]), relabel=sh["relabel"],
                              partition_mode=sh["partition_mode"], partition=partition,
                              exchange=exchange, fused=True, slot_wakes=float(cfg["slot_wakes"]),
                              scenario=scenario, seed=seed,
                              steps_per_chunk=int(cfg["steps_per_chunk"]), device=device)


def _step(engine, base, snap: Snapshot, layout: Layout, ef=True):
    """One slot of ``engine``'s timed path (``advance``) from the state
    ``base`` with ``snap``'s models and residuals (none where ``ef`` is
    False), counters from 0."""
    from repro_torch.sim.capture import clone_state

    st = clone_state(base)
    st.slab[layout.agent_rows] = snap.theta.to(st.slab.dtype)
    if ef:
        st.ef.view(-1, st.ef.shape[-1])[layout.ef_rows] = snap.ef.to(st.ef.dtype)
    z = torch.zeros_like
    st = st._replace(applied=z(st.applied), dropped=z(st.dropped), messages=z(st.messages),
                     ef=st.ef if ef else None)
    return engine.advance(st, 1)


class Program:
    """``ShardedAsyncEngine`` over the configuration, driven in timed calls
    of ``call_slots`` slots."""

    unit = "slot"
    phase_prefixes = AE.Program.phase_prefixes

    def __init__(self, cfg, traffic, prob, seeds, device, spans):
        from repro_torch.core import AgentData, make_objective
        from repro_torch.core.graph import CSRGraph
        from repro_torch.core.mixing import ExchangeSpec
        from repro_torch.sim import CDUpdate

        self.cfg, self.traffic, self.device, self.spans = cfg, traffic, device, spans
        n, m = int(cfg["n"]), int(cfg["m"])
        self.names = base_names(cfg, seeds)
        with spans.span("setup.objective"):
            # The base graph and the agents' data under the base names.
            indptr, indices, weights = relabel_csr(prob.indptr, prob.indices,
                                                   np.argsort(self.names), device)
            graph = CSRGraph(indptr=indptr, indices=indices, data=weights)
            data = AgentData(X=prob.X[self.names], y=prob.y[self.names],
                             mask=np.ones((n, m), dtype=np.float32))
            obj = make_objective(graph, data, cfg["loss"], mu=cfg["mu"], mix_mode="sparse")
        with spans.span("setup.engine"):
            ex = cfg["exchange"]
            self.engine = _engine(cfg, CDUpdate(obj), seeds["engine"], device,
                                  ExchangeSpec(ex["method"], ex["dtype"],
                                               bool(ex["error_feedback"])))
            self.state = self.engine.init_state(np.zeros((n, int(cfg["p"])), np.float32))
        self.seed = seeds["engine"]
        self.steps = 0
        meta = self.engine.report_meta()
        harness.log("[run] sharded_engine " + " ".join(f"{k}={v}" for k, v in meta.items()))

    def warm(self) -> None:
        """One eager slot, then the captured chunk and the one-slot graph."""
        with self.spans.span("setup.warmup"):
            S = int(self.cfg["steps_per_chunk"])
            self.state = self.engine.advance(self.state, 2 + S)
            self.steps += 2 + S

    def call(self) -> None:
        """One timed call: ``call_slots`` slots."""
        k = int(self.traffic["call_slots"])
        with self.spans.span("window.advance"):
            self.state = self.engine.advance(self.state, k)
        self.steps += k

    def updates(self) -> int:
        """Updates applied since the start, over the shards (a host read)."""
        return int(self.state.applied.sum())

    def dropped(self) -> int:
        """Wakes lost to the shards' slot capacity since the start (a host read)."""
        return int(self.state.dropped.sum())

    def finish(self, window: dict) -> dict:
        """The window's own numbers once it has closed: the models finite,
        the applied updates against the clocks' expectation."""
        return {"nonfinite": int((~torch.isfinite(self.state.Theta)).sum()),
                "window_rate_gap": AE.window_rate_gap(self.cfg, window["updates"],
                                                      window["steps"])}

    # -- the comparison's states
    def layout(self) -> Layout:
        if not hasattr(self, "_layout"):
            self._layout = Layout(self.engine, self.device, self.names)
        return self._layout

    def snapshot(self, start: bool = False) -> Snapshot:
        """The live state (``start``: the run's start state, Theta = 0 and no
        residual) as the start of a checked slot: counters from 0."""
        from repro_torch.sim.capture import clone_state

        if start:
            n, p = int(self.cfg["n"]), int(self.cfg["p"])
            self.base = self.engine.init_state(np.zeros((n, p), np.float32))
        else:
            self.base = clone_state(self.state)
        snap = self.layout().snapshot(self.base, int(self.cfg["p"]))
        return dataclasses.replace(snap, applied=0, dropped=0, messages=0.0)

    def chunk_mismatch(self) -> int:
        """The timed chunk tied to the checked slot: one ``advance`` of
        ``steps_per_chunk`` slots from the base state against as many
        one-slot ``advance`` calls; the elements that differ."""
        from repro_torch.sim.capture import clone_state

        S = int(self.cfg["steps_per_chunk"])
        chunk = clone_state(self.engine.advance(clone_state(self.base), S))
        st = clone_state(self.base)
        for _ in range(S):
            st = self.engine.advance(st, 1)
        return AE.state_mismatch(chunk, st)

    def step(self, snap: Snapshot, seed: int) -> Snapshot:
        """One slot of the timed path from the base state with ``snap``'s
        models and residuals."""
        from repro_torch.sim.capture import clone_state

        out = _step(self.engine, self.base, snap, self.layout())
        self.last = clone_state(out)
        return self.layout().snapshot(out, int(self.cfg["p"]))

    def resume(self, state) -> None:
        """Go on from ``state`` (the trajectory's own slot)."""
        self.state = self.engine.advance(state, 0)


def _set_mismatch(got: torch.Tensor, want: torch.Tensor) -> int:
    """Keys of ``got`` not in ``want`` (unique keys), of ``want`` not in
    ``got``, and repeats in ``got``."""
    got = got.to(want.device)
    return (int(torch.isin(got, want, invert=True).sum())
            + int(torch.isin(want, got, invert=True).sum())
            + got.numel() - int(torch.unique(got).numel()))


class Check:
    """The numbers of the checked slots (see the module's docstring)."""

    def __init__(self, cfg, ref: HaloReference, layout: Layout, batch: int):
        self.ref, self.layout, self.batch = ref, layout, batch
        self.n = int(cfg["n"])
        self.prob = wake_probability(cfg["slot_wakes"], self.n)
        self.gap = self.ef_gap = 0.0
        self.moved = self.errors = self.observed = 0
        self.expected = 0.0
        # The program's border and halo sets against the reference's.
        self.halo = (_set_mismatch(layout.border_keys, ref.border_keys)
                     + _set_mismatch(layout.halo_keys, ref.halo_keys))

    def _exchange(self, s: Snapshot, got: Snapshot):
        """The reference's payloads of the slot from ``s``; adds the halo's
        and the residuals' differences from ``got``."""
        lay, dev = self.layout, self.ref.device
        q, e = self.ref.publish(s.theta.to(dev), lay.residuals(s, self.n).to(dev))
        self.halo += int((got.halo.to(dev) != q[lay.halo_agents]).sum())
        scale = float(q[lay.border_agents].abs().max()) if lay.border_agents.numel() else 0.0
        if got.ef.numel():
            diff = (got.ef.to(dev) - e[lay.border_agents]).abs().max()
            self.ef_gap = max(self.ef_gap, float(diff) / max(scale, 1e-30))
        return q

    def add(self, s0: Snapshot, s0p: Snapshot, a: Snapshot, b: Snapshot) -> None:
        ref, dev = self.ref, self.ref.device
        changed_b = (b.theta != s0p.theta).any(1)
        changed_a = (a.theta != s0.theta).any(1)
        A = torch.nonzero(changed_b).squeeze(1)
        Aa = torch.nonzero(changed_a).squeeze(1)
        self.moved += int((changed_a & ~changed_b).sum())
        self.observed += int(A.numel())
        self.expected += self.prob * float(b.active.sum())
        msgs = float(ref.eq4.counts[A.to(dev)].sum())
        per_silo = torch.bincount(ref.owner[A.to(dev)], minlength=len(self.layout.blocks))
        errs = [b.applied != A.numel(), a.applied != b.applied, a.dropped != b.dropped,
                a.ptr != s0.ptr + 1, b.ptr != s0.ptr + 1, b.messages != msgs,
                a.messages != b.messages, bool((a.active != b.active).any()),
                not bool(b.active[A].all()), A.numel() == 0,
                bool((per_silo > self.batch).any())]
        self.errors += sum(bool(e) for e in errs)
        q_a, q_b = self._exchange(s0, a), self._exchange(s0p, b)
        if A.numel() == 0:
            return
        det_b = ref.step(A, s0p.theta.to(dev), q_b)
        det_a = ref.step(Aa, s0.theta.to(dev), q_a) if Aa.numel() else None
        gap = float((b.theta[A].to(dev, torch.float64) - det_b).abs().max())
        scale = float(det_b.abs().max())
        if det_a is not None:
            gap = max(gap, float((a.theta[Aa].to(dev, torch.float64) - det_a).abs().max()))
            scale = max(scale, float(det_a.abs().max()))
        self.gap = max(self.gap, gap / max(scale, 1e-30))

    def numbers(self) -> dict:
        return {"step_gap": self.gap, "halo_mismatch": self.halo, "ef_gap": self.ef_gap,
                "wake_rate_gap": abs(self.observed / max(self.expected, 1e-30) - 1.0),
                "rows_moved_wrongly": self.moved, "counter_errors": self.errors}


def check(prog: Program, cfg, traffic, ref: HaloReference, seeds, controls=()) -> dict:
    """The checked slots (see the module's docstring). ``controls``:
    steppers run in the program's place from the same starts; their
    numbers come back under their names."""
    layout = prog.layout()
    ref.own(layout.blocks)
    steppers = {"program": prog.step, **dict(controls)}
    checks = {k: Check(cfg, ref, layout, prog.engine.batch_size) for k in steppers}
    rng = np.random.default_rng(seeds["check"])
    pert = agents.generator(seeds["perturb"], prog.device)
    spec = traffic["check"]
    points = int(spec["points"])
    n, p = int(cfg["n"]), int(cfg["p"])
    mismatch = 0
    for k in range(points + 1):
        start = k == points  # last, the run's own start: a slot from Theta = 0
        for _ in range(0 if start else int(rng.integers(0, int(spec["max_calls_between"]) + 1))):
            prog.call()
        s0 = prog.snapshot(start)
        mismatch += prog.chunk_mismatch()
        s0p = dataclasses.replace(s0, theta=s0.theta + torch.randn(
            (n, p), generator=pert, device=prog.device) * float(spec["perturb"]))
        seed = int(rng.integers(2**62))
        resume = None
        for name, step in steppers.items():
            a = step(s0, seed)
            if name == "program":
                resume = prog.last
            b = step(s0p, seed)
            checks[name].add(s0, s0p, a, b)
        prog.resume(resume)
    out = {k: c.numbers() for k, c in checks.items()}
    out["program"]["chunk_mismatch"] = mismatch
    return out


class WireControl:
    """The engine on another wire (an ``ExchangeSpec``) in the program's
    place: the same partition, update and draws, from the same starts."""

    def __init__(self, cfg, prog: Program, exchange):
        self.prog = prog
        self.engine = _engine(cfg, prog.engine.update, prog.seed, prog.device, exchange,
                              partition=prog.engine.part)
        self.ef = exchange.error_feedback

    def __call__(self, snap: Snapshot, seed: int) -> Snapshot:
        prog = self.prog
        out = _step(self.engine, prog.base, snap, prog.layout(), ef=self.ef)
        return prog.layout().snapshot(out, int(prog.cfg["p"]))


class Bf16Control:
    """The reference's sharded slot computed in bfloat16 (the engine takes
    float32 and float64 only): the payload v = theta + e added in bf16, so
    q = v and the residual is 0, then ``reference/control.py``'s slot over
    own-silo rows and q, every draw and operation in bfloat16."""

    def __init__(self, cfg, prog: Program, ref: HaloReference):
        self.prog, self.ref = prog, ref
        churn = cfg.get("churn")
        batch = prog.engine.batch_size * prog.engine.num_shards
        self.slot = ControlSlot(ref.eq4, wake_probability(cfg["slot_wakes"], int(cfg["n"])),
                                batch, churn=(churn["leave"], churn["rejoin"]) if churn else None)

    def __call__(self, snap: Snapshot, seed: int) -> Snapshot:
        lay, ref = self.prog.layout(), self.ref
        bf16 = torch.bfloat16
        v = snap.theta.to(ref.device, bf16) + lay.residuals(snap, ref.n).to(ref.device, bf16)
        q = torch.where(ref.border[:, None], v, snap.theta.to(ref.device, bf16))
        out = self.slot(snap, [snap.theta, q], seed)
        return dataclasses.replace(out, halo=q[lay.halo_agents].float().to(snap.theta.device),
                                   ef=torch.zeros_like(snap.ef))


def controls(cfg, prog: Program, ref: HaloReference, device) -> list:
    """The controls in the program's place: the slot in bfloat16 (``control``),
    the f32 wire, and the bf16 wire without error feedback."""
    from repro_torch.core.mixing import ExchangeSpec

    ref.own(prog.layout().blocks)
    method = cfg["exchange"]["method"]
    return [("control", Bf16Control(cfg, prog, ref)),
            ("f32_wire", WireControl(cfg, prog, ExchangeSpec(method, "f32"))),
            ("bf16_wire_no_ef", WireControl(cfg, prog, ExchangeSpec(method, "bf16")))]
