"""Batched asynchronous simulation engine (port of ``repro.sim``).

Poisson-thinned super-ticks with churn / delay / straggler scenarios,
driving the Eq. 4, private Eq. 6 and model-propagation Eq. 16 updates
through the ``LocalUpdate`` protocol on one device: the static-topology,
single-device ``AsyncEngine``. The reference's sharded engine, arrivals
and dynamic topology are queued in ``ROADMAP.md``.
"""

from repro_torch.sim.clocks import (
    default_batch_size,
    expected_wakes,
    normalize_rates,
    slot_duration,
    wake_probs,
)
from repro_torch.sim.config import EngineConfig, make_engine
from repro_torch.sim.engine import AsyncEngine, SimResult, SimState
from repro_torch.sim.scenarios import ChurnConfig, DelayConfig, Scenario, StragglerConfig
from repro_torch.sim.updates import CDUpdate, DPCDUpdate, LocalUpdate, PropagationUpdate

__all__ = [
    # engine and configuration
    "AsyncEngine",
    "EngineConfig",
    "SimResult",
    "SimState",
    "make_engine",
    # update rules
    "CDUpdate",
    "DPCDUpdate",
    "LocalUpdate",
    "PropagationUpdate",
    # scenarios
    "ChurnConfig",
    "DelayConfig",
    "Scenario",
    "StragglerConfig",
    # clock helpers
    "default_batch_size",
    "expected_wakes",
    "normalize_rates",
    "slot_duration",
    "wake_probs",
]
