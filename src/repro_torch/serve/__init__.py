"""``repro_torch.serve``: the online personalized serving tier (port of
``repro.serve``).

Versioned snapshot publication plus batched personalized inference over
the training swarm: a :class:`ServeHandle` answers ``predict(agent_ids,
X)`` against the latest published Theta version, live
(``engine.run(..., snapshot_every=, serve=handle)``) or offline from a
``repro_torch.checkpoint`` entry (:func:`serve_from_checkpoint`), with an
Eq. 16 neighbour-average cold-start tier for ids not yet in the swarm.
``python -m repro_torch.serve`` fronts both modes from the command line.
"""

from repro_torch.serve.checkpoint_io import serve_from_checkpoint
from repro_torch.serve.handle import (
    ServeHandle,
    ServeResult,
    ServeSpec,
    SnapshotStore,
    ThetaSnapshot,
)

__all__ = [
    "ServeHandle",
    "ServeResult",
    "ServeSpec",
    "SnapshotStore",
    "ThetaSnapshot",
    "serve_from_checkpoint",
]
