"""The compiled decode: one program for every position.

The port's counterpart of the reference's ``jax.jit(bundle.decode)`` with
the position a traced ``int32`` scalar (``tests/test_arch_smoke.py``,
``launch/dryrun.py``'s decode row). :class:`DecodeGraph` runs a family's
decode step (:class:`~repro_torch.models.registry.ModelBundle`'s
``decode``) over static buffers with the position as a 0-d tensor on the
device, so one program serves every position: on a CUDA device the step
is captured once as a CUDA graph and replayed at each call, one launch
from the host for the step's thousands of kernels; on the CPU the same
static-buffer step runs eagerly. There is no switch between the two: the
device decides, as in :mod:`repro_torch.sim.capture`.

* **Static buffers.** The caches it is given become its buffers: the KV
  caches are written in place by the step itself; each recurrent state
  the step returns as a new tensor (the Mamba2 ``state`` and
  ``conv_buf``, the mLSTM and sLSTM states) is copied back into the
  buffer it came from, inside the step. A static 0-d position, and a
  static token (B, 1) and static logits made at the first call's shapes,
  complete them. A call returns the
  logits and caches buffers themselves: the next call overwrites them,
  so the caller clones what it keeps.
* **The position.** ``__call__(token, pos)`` takes an int. It is
  range-checked on the host against a full (not windowed) KV cache, with
  the eager step's ``ValueError``, before anything is written; then
  written into the static position with ``fill_``. The step never reads
  it on the host (``attention.decode_attention``'s tensor path).
* **Capture.** The first call on the card runs one eager step on the
  capture stream (it counts: it is that call's step), which loads the
  libraries and fills the caches a capture may not; then the step is
  captured through :func:`repro_torch.sim.capture.capture`. Every later
  call replays that graph. A capture that fails raises; nothing carries
  on eagerly.
"""

from __future__ import annotations

import operator
import time

import torch

from repro_torch.kernels import _build
from repro_torch.sim.capture import _copy_leaf, capture
from repro_torch.utils.tree import tree_flatten_with_path, tree_map


class DecodeGraph:
    """``bundle``'s decode step over ``params`` and the static buffers
    ``caches`` (adopted, not copied), one program for every position (see
    the module docstring). ``captures`` counts the graphs captured: one
    serves every position."""

    def __init__(self, bundle, params, caches):
        self.bundle, self.params, self.caches = bundle, params, caches
        self.device = bundle.device
        # The positions a full KV cache holds (None: no KV cache, as xLSTM's).
        self.size = min((t.shape[0] for name, t in tree_flatten_with_path(caches)
                         if name.endswith("slot_pos")), default=None)
        with torch.inference_mode():
            self.pos = torch.zeros((), dtype=torch.long, device=self.device)
        self.token = None  # made by the first call, at its token's shape
        self.logits = None  # made by the first step, at the step's shape and type
        self.graph = None
        self.launches = {}  # our kernels' launches a replay
        self.captures = 0
        self.capture_s = 0.0  # the warm-up step and the capture, host seconds

    def __call__(self, token, pos: int):
        """The step of ``token`` (B, 1) at position ``pos``: returns the
        static ``(logits (B, 1, vocab), caches)``."""
        pos = operator.index(pos)
        if not self.bundle.cfg.sliding_window and self.size is not None \
                and not 0 <= pos < self.size:
            raise ValueError(f"pos={pos} is outside the cache of {self.size} positions")
        with torch.inference_mode():
            token = torch.as_tensor(token, device=self.device)
            if self.token is None:
                self.token = torch.empty(token.shape, dtype=torch.long, device=self.device)
            self.token.copy_(token)
            self.pos.fill_(pos)
            if self.device.type != "cuda":
                self._step()
            elif self.graph is None:
                self._capture()
            else:
                self.graph.replay()
                _build.add_launches(self.launches)
        return self.logits, self.caches

    def _step(self) -> None:
        logits, new = self.bundle.decode(self.params, self.token, self.caches, self.pos)
        tree_map(_copy_leaf, new, self.caches)
        if self.logits is None:
            self.logits = torch.empty_like(logits)
        self.logits.copy_(logits)

    def _capture(self) -> None:
        """The eager warm-up step on the capture stream (this call's step),
        then the capture of the step; a failure raises."""
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self._step()
        current.wait_stream(stream)
        try:
            self.graph, _, self.launches = capture(self._step, None, stream)
        except Exception as e:
            raise RuntimeError(f"capturing the decode step as a CUDA graph failed: {e}") from e
        self.captures += 1
        self.capture_s = time.perf_counter() - t0
