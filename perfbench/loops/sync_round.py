"""The loop ``sync_round``: ``synchronous_round`` over the configuration's
objective, one round a timed call, from Theta = 0.

A mix that names this loop sets the traced stretch's rounds
(``trace_calls``) and the change of the perturbed start (``check.perturb``).
Once the window has closed the round is compared whole with the
reference's, from the window's last state, from that state with every row
moved, and from Theta = 0.
"""

from __future__ import annotations

import torch

from perfbench.data import agents
from perfbench.reference.control import control_round
from perfbench.reference.eq4 import Eq4Reference


def reference(cfg: dict, prob, device) -> Eq4Reference:
    return Eq4Reference(prob.indptr, prob.indices, prob.weights, prob.X, prob.y, cfg["mu"],
                        device=device)


def _round(obj, theta):
    from repro_torch.core import coordinate_descent

    return coordinate_descent.synchronous_round(obj, theta)


class Program:
    """``synchronous_round`` from Theta = 0, one round a timed call."""

    unit = "round"

    def __init__(self, cfg, traffic, prob, seeds, device, spans):
        import numpy as np

        from repro_torch.core import AgentData, make_objective
        from repro_torch.core.graph import CSRGraph

        self.cfg, self.traffic, self.device, self.spans = cfg, traffic, device, spans
        n, m = int(cfg["n"]), int(cfg["m"])
        with spans.span("setup.objective"):
            graph = CSRGraph(indptr=prob.indptr, indices=prob.indices, data=prob.weights)
            data = AgentData(X=prob.X, y=prob.y, mask=np.ones((n, m), dtype=np.float32))
            self.obj = make_objective(graph, data, cfg["loss"], mu=cfg["mu"], mix_mode="sparse")
        self.theta = torch.zeros((n, int(cfg["p"])), device=device)
        self.steps = 0  # rounds run

    def warm(self) -> None:
        with self.spans.span("setup.warmup"):
            for _ in range(2):
                self.theta = _round(self.obj, self.theta)
                self.steps += 1

    def call(self) -> None:
        with self.spans.span("window.round"):
            self.theta = _round(self.obj, self.theta)
        self.steps += 1

    def updates(self) -> int:
        return self.steps * int(self.cfg["n"])

    def dropped(self) -> int:
        return 0

    def finish(self, window: dict) -> dict:
        return {"nonfinite": int((~torch.isfinite(self.theta)).sum())}


def check(prog: Program, cfg, traffic, ref, seeds, controls=()) -> dict:
    """Rounds from the window's last state, from that state with a random
    change of every row, and from Theta = 0, each against the reference's."""
    n, p = int(cfg["n"]), int(cfg["p"])
    pert = agents.generator(seeds["perturb"], prog.device)
    starts = [prog.theta, prog.theta + torch.randn((n, p), generator=pert, device=prog.device)
              * float(traffic["check"]["perturb"]), torch.zeros_like(prog.theta)]
    rounds = {"program": lambda th: _round(prog.obj, th), **dict(controls)}
    out = {}
    for name, fn in rounds.items():
        gap = 0.0
        for th in starts:
            want = ref.round(th)
            got = fn(th).to(ref.device, torch.float64)
            gap = max(gap, float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30))
        out[name] = {"round_gap": gap}
    return out


def controls(cfg, prog: Program, ref, device) -> list:
    """The control in the program's place: the round in bfloat16."""
    return [("control", lambda th: control_round(ref, th))]
