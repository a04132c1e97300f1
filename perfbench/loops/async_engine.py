"""The loop ``async_engine``: ``AsyncEngine.advance`` over the configuration.

A mix that names this loop (``traffic/<mix>.json``) sets the timed call's
slots (``call_slots``), back-to-back episodes from Theta = 0
(``episode_slots``, 0 for none), per-edge delays (``delay``), the
traced stretch's calls (``trace_calls``) and the checked slots
(``check``). The harness finds this file by the mix's ``loop`` key.

Once the window has closed the run goes on through the timed path:
``check.points`` times, after 0 to ``check.max_calls_between`` more timed
calls drawn from the seed, it takes the live state S0, ties the timed
chunk graph to the checked slot (one replay of the ``steps_per_chunk``
graph from S0 must equal as many one-slot replays from S0, bit for bit),
and runs one slot from S0 and one from S0' (every row moved by
N(0, ``check.perturb``)) with the same draws; the reference judges both.
A last checked slot starts from the run's own start (Theta = 0).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from perfbench.data import agents
from perfbench.reference.control import ControlSlot, wake_probability
from perfbench.reference.eq4 import Eq4Reference
from perfbench.reference.privacy import laplace_scales


@dataclasses.dataclass
class Snapshot:
    """A state as the comparison reads it; the counters count from the
    snapshot the step started at."""

    theta: torch.Tensor
    active: torch.Tensor | None
    counts: torch.Tensor | None  # per-agent private updates
    applied: int = 0
    dropped: int = 0
    messages: float = 0.0
    ptr: int = 0

    def advanced(self, **kw) -> "Snapshot":
        return dataclasses.replace(self, ptr=self.ptr + 1, **kw)


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: x.clone() for k, x in v.items()}
    if isinstance(v, torch.Generator):
        g = torch.Generator(device=v.device)
        g.set_state(v.get_state())
        return g
    return v


def clone_state(state):
    """A program state of new tensors (and a generator at the same place)."""
    return type(state)(**{f: _clone(getattr(state, f)) for f in state._fields})


def _leaves(v) -> list:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, dict):
        return [v[k] for k in sorted(v)]
    if isinstance(v, torch.Generator):
        return [v.get_state()]
    return []


def state_mismatch(a, b) -> int:
    """Elements (and generator states) in which two program states differ."""
    out = 0
    for f in a._fields:
        la, lb = _leaves(getattr(a, f)), _leaves(getattr(b, f))
        if len(la) != len(lb):
            out += 1
            continue
        for x, y in zip(la, lb):
            out += int((x != y).sum()) if x.shape == y.shape else x.numel() + 1
    return out


def _scales(cfg, device):
    """Theorem 1's per-agent Laplace scales (None: no privacy)."""
    priv = cfg.get("private")
    if not priv:
        return None
    return torch.as_tensor(laplace_scales(priv["eps_bar"], priv["delta_bar"],
                                          int(priv["planned_Ti"]), priv["clip"],
                                          np.full(int(cfg["n"]), cfg["m"])), device=device)


def reference(cfg: dict, prob, device) -> Eq4Reference:
    clip = (cfg.get("private") or {}).get("clip")
    return Eq4Reference(prob.indptr, prob.indices, prob.weights, prob.X, prob.y, cfg["mu"],
                        clip=clip, delays=prob.delays, device=device)


class Program:
    """``AsyncEngine`` over the configuration, driven in timed calls of
    ``call_slots`` slots (episodes of ``episode_slots`` from Theta = 0
    when the mix asks for them)."""

    unit = "slot"

    def __init__(self, cfg, traffic, prob, seeds, device, spans):
        from repro_torch.core import AgentData, DPConfig, make_objective
        from repro_torch.core.graph import CSRGraph
        from repro_torch.sim import (AsyncEngine, CDUpdate, ChurnConfig, DelayConfig,
                                     DPCDUpdate, Scenario)

        self.cfg, self.traffic, self.device, self.spans = cfg, traffic, device, spans
        n, m = int(cfg["n"]), int(cfg["m"])
        priv = cfg.get("private")
        with spans.span("setup.objective"):
            graph = CSRGraph(indptr=prob.indptr, indices=prob.indices, data=prob.weights)
            data = AgentData(X=prob.X, y=prob.y, mask=np.ones((n, m), dtype=np.float32))
            obj = make_objective(graph, data, cfg["loss"], mu=cfg["mu"],
                                 clip=priv["clip"] if priv else None, mix_mode="sparse")
        with spans.span("setup.engine"):
            if priv:
                update = DPCDUpdate.plan(obj, DPConfig(eps_bar=priv["eps_bar"],
                                                       delta_bar=priv["delta_bar"]),
                                         int(priv["planned_Ti"]))
            else:
                update = CDUpdate(obj)
            churn = cfg.get("churn")
            delay = traffic.get("delay")
            scenario = Scenario(
                churn=ChurnConfig(leave_prob=churn["leave"], rejoin_prob=churn["rejoin"])
                if churn else None,
                delay=DelayConfig(max_delay=int(delay["max_delay"]),
                                  edge_delays=agents.padded_delays(prob.indptr, prob.delays))
                if delay else None)
            self.engine = AsyncEngine(update, slot_wakes=float(cfg["slot_wakes"]),
                                      scenario=scenario, seed=seeds["engine"],
                                      steps_per_chunk=int(cfg["steps_per_chunk"]),
                                      fused=traffic.get("fused", "auto"), device=device)
            zeros = torch.zeros((n, int(cfg["p"])), device=device)
            self.state = self.engine.init_state(zeros)
            # An episode's start state, made once on the card: a reset binds
            # it into the engine's buffers (device copies, no host read).
            self.start = self.engine.init_state(zeros)
        self.depth = int(delay["max_delay"]) + 1 if delay else 1
        self.episode = int(traffic.get("episode_slots") or 0)
        self.done = 0  # slots of the running episode
        self.steps = 0  # slots run
        self.ep_rng = np.random.default_rng(seeds["episodes"])
        # Budget violations of finished episodes, kept on the device (no host
        # read inside the window); the counters never restart.
        self.budget_errors = torch.zeros((), dtype=torch.int64, device=device)
        self.episode_applied = torch.zeros((), dtype=torch.int64, device=device)
        self.planned = int(priv["planned_Ti"]) if priv else None

    def warm(self) -> None:
        """One eager slot, then the captured chunk and the one-slot graph."""
        with self.spans.span("setup.warmup"):
            S = int(self.cfg["steps_per_chunk"])
            self.state = self.engine.advance(self.state, 2 + S)
            self.done += 2 + S
            self.steps += 2 + S

    def _budget_check(self) -> None:
        """Add the episode's violations: an agent past its T_i, or budgets that
        do not sum to the episode's applied updates."""
        if self.planned is not None:
            c = self.state.ustate
            spent = self.state.applied - self.episode_applied
            self.budget_errors.add_((c > self.planned).sum() + (c.sum() != spent).to(torch.int64))

    def call(self) -> None:
        """One timed call: ``call_slots`` slots, or what is left of the episode;
        at the episode's end a fresh start state goes into the engine."""
        k = int(self.traffic["call_slots"])
        if self.episode:
            k = min(k, self.episode - self.done)
        with self.spans.span("window.advance"):
            self.state = self.engine.advance(self.state, k)
        self.done += k
        self.steps += k
        if self.episode and self.done >= self.episode:
            with self.spans.span("window.episode_reset"):
                self._budget_check()
                self.episode_applied.copy_(self.state.applied)
                start = self.start if self.device.type == "cuda" else clone_state(self.start)
                gen = agents.generator(int(self.ep_rng.integers(2**62)), self.device)
                fresh = self.state._replace(Theta=start.Theta, ustate=start.ustate,
                                            active=start.active, generator=gen)
                self.state = self.engine.advance(fresh, 0)
            self.done = 0

    def updates(self) -> int:
        """Updates applied since the start (a host read)."""
        return int(self.state.applied)

    def dropped(self) -> int:
        """Wakes lost to the slot capacity since the start (a host read)."""
        return int(self.state.dropped)

    def finish(self, window: dict) -> dict:
        """The window's own numbers once it has closed: Theta finite, every
        episode's budgets, and (without episodes) the applied updates
        against the clocks' expectation."""
        self._budget_check()
        out = {"nonfinite": int((~torch.isfinite(self.state.Theta)).sum())}
        if self.planned is not None:
            out["budget_errors"] = int(self.budget_errors)
        if not self.episode:
            out["window_rate_gap"] = window_rate_gap(self.cfg, window["updates"],
                                                     window["steps"])
        return out

    # -- the comparison's states
    def pre_slots(self) -> list:
        """Run depth - 1 slots through the timed path, keeping the model
        matrix before each: the delayed reads of the slot that follows
        (most recent first)."""
        prior = []
        for _ in range(self.depth - 1):
            prior.insert(0, self.state.Theta.clone())
            self.state = self.engine.advance(self.state, 1)
            self.steps += 1
        return prior

    def snapshot(self, start: bool = False) -> Snapshot:
        """The live state (``start``: the run's start state, Theta = 0) as the
        start of a checked slot: counters from 0."""
        self.base = clone_state(self.start if start else self.state)
        s = self.base
        return Snapshot(theta=s.Theta.clone(), active=s.active.clone(),
                        counts=s.ustate.clone() if isinstance(s.ustate, torch.Tensor) else None,
                        ptr=int(s.ptr))

    def chunk_mismatch(self) -> int:
        """The timed chunk tied to the checked slot: one ``advance`` of
        ``steps_per_chunk`` slots (a replay of the chunk graph on the card)
        from the base state against as many one-slot ``advance`` calls (the
        graph the checked slots replay) from it; the elements that differ."""
        S = int(self.cfg["steps_per_chunk"])
        chunk = clone_state(self.engine.advance(clone_state(self.base), S))
        st = clone_state(self.base)
        for _ in range(S):
            st = self.engine.advance(st, 1)
        return state_mismatch(chunk, st)

    def step(self, snap: Snapshot, thetas, seed) -> Snapshot:
        """One slot of the timed path (``AsyncEngine.advance``) from the base
        state with ``snap``'s model matrix."""
        st = clone_state(self.base)
        z = torch.zeros_like
        st = st._replace(Theta=snap.theta.clone(), applied=z(st.applied), dropped=z(st.dropped),
                         messages=z(st.messages))
        out = self.engine.advance(st, 1)
        self.last = clone_state(out)
        return Snapshot(theta=out.Theta.clone(), active=out.active.clone(),
                        counts=out.ustate.clone() if isinstance(out.ustate, torch.Tensor) else None,
                        applied=int(out.applied), dropped=int(out.dropped),
                        messages=float(out.messages), ptr=int(out.ptr))

    def resume(self, state) -> None:
        """Go on from ``state`` (the trajectory's own slot)."""
        self.state = self.engine.advance(state, 0)

    def phase_prefixes(self, inner: int = 32, repeats: int = 3) -> dict:
        """Seconds a slot of each phase prefix (``engine.phase_program``) and
        of the whole slot (key None): the best of ``repeats`` loops of
        ``inner`` replays on the engine's scratch state, timed by CUDA
        events (the host clock off the card)."""
        cuda = self.device.type == "cuda"
        out = {}
        for name in list(self.engine.phase_names) + [None]:
            prog = self.engine.phase_program(name)
            prog.load(self.state)
            prog.run()
            best = math.inf
            for _ in range(repeats):
                if cuda:
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(inner):
                        prog.run()
                    b.record()
                    b.synchronize()
                    best = min(best, a.elapsed_time(b) / 1e3 / inner)
                else:
                    t0 = time.perf_counter()
                    for _ in range(inner):
                        prog.run()
                    best = min(best, (time.perf_counter() - t0) / inner)
            out[name] = best
        return out


def window_rate_gap(cfg, updates: int, slots: int) -> float:
    """The window's applied updates against the clocks' expectation: every
    agent wakes with the slot's probability while active, and churn keeps
    rejoin / (leave + rejoin) of them active."""
    n = int(cfg["n"])
    churn = cfg.get("churn")
    share = churn["rejoin"] / (churn["leave"] + churn["rejoin"]) if churn else 1.0
    want = slots * n * wake_probability(cfg["slot_wakes"], n) * share
    return abs(updates / max(want, 1e-30) - 1.0)


class Check:
    """The numbers of the checked slots: each slot run twice from one start
    (the trajectory's state, and that state with a random change of every
    model row), with the same draws."""

    def __init__(self, cfg, ref: Eq4Reference, scales):
        self.ref, self.cfg = ref, cfg
        self.n = int(cfg["n"])
        self.prob = wake_probability(cfg["slot_wakes"], self.n)
        priv = cfg.get("private")
        self.planned = int(priv["planned_Ti"]) if priv else None
        self.scales = scales
        self.gap = 0.0
        self.moved = self.errors = self.observed = 0
        self.expected = self.zsum = 0.0
        self.zn = 0

    def add(self, s0: Snapshot, s0p: Snapshot, a: Snapshot, b: Snapshot, prior) -> None:
        ref, dev = self.ref, self.ref.device
        changed_b = (b.theta != s0p.theta).any(1)
        changed_a = (a.theta != s0.theta).any(1)
        A = torch.nonzero(changed_b).squeeze(1)
        self.moved += int((changed_a & ~changed_b).sum())
        eligible = b.active.clone()
        if self.planned is not None:
            stopped = s0.counts >= self.planned
            self.moved += int((changed_b & stopped).sum())
            eligible &= ~stopped
        self.observed += int(A.numel())
        self.expected += self.prob * float(eligible.sum())
        msgs = float(ref.counts[A.to(dev)].sum())
        errs = [b.applied != A.numel(), a.applied != b.applied, a.dropped != b.dropped,
                a.ptr != s0.ptr + 1, b.ptr != s0.ptr + 1, b.messages != msgs,
                a.messages != b.messages, bool((a.active != b.active).any()),
                not bool(b.active[A].all()), A.numel() == 0]
        if self.planned is not None:
            inc = torch.zeros_like(s0.counts)
            inc[A] = 1
            errs += [bool((b.counts - s0.counts != inc).any()), bool((a.counts != b.counts).any()),
                     int(b.counts.max()) > self.planned]
        self.errors += sum(bool(e) for e in errs)
        if A.numel() == 0:
            return
        det_b = ref.step(A, [s0p.theta] + prior)
        if self.planned is None:
            Aa = torch.nonzero(changed_a).squeeze(1)
            det_a = ref.step(Aa, [s0.theta] + prior)
            got_b = b.theta[A].to(dev, torch.float64)
            got_a = a.theta[Aa].to(dev, torch.float64)
            gap = max(float((got_b - det_b).abs().max()),
                      float((got_a - det_a).abs().max()) if Aa.numel() else 0.0)
            scale = max(float(det_b.abs().max()), float(det_a.abs().max()) if Aa.numel() else 0.0)
        else:
            det_a = ref.step(A, [s0.theta] + prior)
            got_a = a.theta[A].to(dev, torch.float64)
            d_prog = b.theta[A].to(dev, torch.float64) - got_a
            d_ref = det_b - det_a
            gap = float((d_prog - d_ref).abs().max())
            scale = float(d_ref.abs().max())
            coef = ref.noise_coefficient(A) * self.scales[A.to(dev)]
            z = (det_a - got_a) / coef[:, None]
            self.zsum += float(z.abs().sum())
            self.zn += z.numel()
        self.gap = max(self.gap, gap / max(scale, 1e-30))

    def numbers(self) -> dict:
        out = {"step_gap": self.gap,
               "wake_rate_gap": abs(self.observed / max(self.expected, 1e-30) - 1.0),
               "rows_moved_wrongly": self.moved, "counter_errors": self.errors}
        if self.planned is not None:
            out["noise_scale_gap"] = abs(self.zsum / max(self.zn, 1) - 1.0)
        return out


def check(prog: Program, cfg, traffic, ref, seeds, controls=()) -> dict:
    """The checked slots (see the module's docstring). ``controls``:
    steppers run in the program's place from the same starts; their
    numbers come back under their names."""
    n, p = int(cfg["n"]), int(cfg["p"])
    scales = _scales(cfg, ref.device)
    steppers = {"program": prog.step, **dict(controls)}
    checks = {k: Check(cfg, ref, scales) for k in steppers}
    rng = np.random.default_rng(seeds["check"])
    pert = agents.generator(seeds["perturb"], prog.device)
    spec = traffic["check"]
    points = int(spec["points"])
    mismatch = 0
    for k in range(points + 1):
        start = k == points  # last, the run's own start: a slot from Theta = 0
        for _ in range(0 if start else int(rng.integers(0, int(spec["max_calls_between"]) + 1))):
            prog.call()
        prior = [torch.zeros_like(prog.state.Theta)] * (prog.depth - 1) if start else \
            prog.pre_slots()
        s0 = prog.snapshot(start)
        mismatch += prog.chunk_mismatch()
        s0p = dataclasses.replace(s0, theta=s0.theta + torch.randn(
            (n, p), generator=pert, device=prog.device) * float(spec["perturb"]))
        seed = int(rng.integers(2**62))
        resume = None
        for name, step in steppers.items():
            a = step(s0, [s0.theta] + prior, seed)
            if name == "program":
                resume = prog.last
            b = step(s0p, [s0p.theta] + prior, seed)
            checks[name].add(s0, s0p, a, b, prior)
        prog.resume(resume)
    out = {k: c.numbers() for k, c in checks.items()}
    out["program"]["chunk_mismatch"] = mismatch
    return out


def controls(cfg, prog: Program, ref, device) -> list:
    """The control in the program's place: the slot in bfloat16."""
    priv = cfg.get("private")
    churn = cfg.get("churn")
    slot = ControlSlot(ref, wake_probability(cfg["slot_wakes"], int(cfg["n"])),
                       prog.engine.batch_size,
                       churn=(churn["leave"], churn["rejoin"]) if churn else None,
                       planned=int(priv["planned_Ti"]) if priv else None,
                       scales=_scales(cfg, device))
    return [("control", slot)]
