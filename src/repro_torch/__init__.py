"""PyTorch/CUDA port of the ``repro`` package (Bellet et al., 2017).

Personalized peer-to-peer learning by asynchronous block coordinate
descent over an agent graph, ported module by module from the JAX
package ``repro``, which stays the reference every part of this package
is tested against (``tests/test_torch_*.py``). The layout and public
names follow ``repro``'s, so each counterpart sits at the same path:
``repro_torch.core.mixing.MixOp``, ``repro_torch.sim.engine.AsyncEngine``
and so on.

This package imports ``torch`` and numpy, never ``jax`` and never
anything of ``repro``. Entry points run on the CUDA card unless the
caller passes ``device="cpu"`` (:mod:`repro_torch.device`). The Pallas
kernels of the reference are hand-written CUDA kernels here
(:mod:`repro_torch.kernels`), built from ``csrc/`` at first use.

Ported so far: graphs, the Eq. 2 objective, the neighbour-sum operator,
sequential coordinate descent, the private algorithm (Eq. 6) with its
accounting, model propagation and the private warm start, and the
static-topology single-device batched engine driving the Eq. 4, Eq. 6
and Eq. 16 updates (unfused and fused). Sharding, telemetry, dynamic
topology, checkpoints and serving are queued in ``ROADMAP.md``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
