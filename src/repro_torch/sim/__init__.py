"""Batched asynchronous simulation engine (port of ``repro.sim``).

Poisson-thinned super-ticks with churn / delay / straggler scenarios,
driving the Eq. 4, private Eq. 6 and model-propagation Eq. 16 updates
through the ``LocalUpdate`` protocol: the single-device ``AsyncEngine``
and the sharded ``ShardedAsyncEngine`` (agent blocks with a halo
exchange, its S shards stacked on one device), whose chunks of slots
replay as captured CUDA graphs on the card (:mod:`repro_torch.sim.capture`),
and the agent-block partitioner (:mod:`repro_torch.sim.partition`).
Both engines take dynamic topology: the Dada edge refresh
(:class:`GraphUpdate`) and agent arrivals (:class:`ArrivalConfig`).
"""

from repro_torch.sim.clocks import (
    default_batch_size,
    expected_wakes,
    normalize_rates,
    slot_duration,
    wake_probs,
)
from repro_torch.core.mixing import ExchangeSpec
from repro_torch.sim.config import EngineConfig, make_engine
from repro_torch.sim.engine import (
    AsyncEngine,
    ShardedAsyncEngine,
    ShardedSimState,
    SimResult,
    SimState,
)
from repro_torch.sim.partition import (
    GraphPartition,
    hilbert_order,
    partition_graph,
    point_to_point_plan,
    rcm_order,
    sfc_order,
)
from repro_torch.sim.scenarios import (
    ArrivalConfig,
    ChurnConfig,
    DelayConfig,
    Scenario,
    StragglerConfig,
)
from repro_torch.sim.updates import (
    CDUpdate,
    DPCDUpdate,
    GraphUpdate,
    LocalUpdate,
    PropagationUpdate,
)

__all__ = [
    # engine and configuration
    "AsyncEngine",
    "EngineConfig",
    "ExchangeSpec",
    "ShardedAsyncEngine",
    "ShardedSimState",
    "SimResult",
    "SimState",
    "make_engine",
    # update rules
    "CDUpdate",
    "DPCDUpdate",
    "GraphUpdate",
    "LocalUpdate",
    "PropagationUpdate",
    # scenarios
    "ArrivalConfig",
    "ChurnConfig",
    "DelayConfig",
    "Scenario",
    "StragglerConfig",
    # partitioning and relabels
    "GraphPartition",
    "hilbert_order",
    "partition_graph",
    "point_to_point_plan",
    "rcm_order",
    "sfc_order",
    # clock helpers
    "default_batch_size",
    "expected_wakes",
    "normalize_rates",
    "slot_duration",
    "wake_probs",
]
