"""The engine's compiled chunk: super-ticks captured as CUDA graphs.

The port's counterpart of the reference's jitted ``lax.scan`` chunk
(``repro.sim.engine.AsyncEngine._chunk`` and
``ShardedAsyncEngine._chunk``). On a CUDA device ``advance`` of either
engine (:class:`AsyncEngine`, :class:`ShardedAsyncEngine`, whose one slot
serves all its stacked shards) replays one graph of ``steps_per_chunk``
slots ``slots // steps_per_chunk`` times and one graph of a single slot
for the remainder: two graphs an engine, as the reference compiles two
scan lengths. A replay is one launch from the host for a chunk's several
hundred kernels, where the eager slot spends 14–30 us of host time on
each of its 55–99 operations. On the CPU the slots run eagerly, one by
one; there is no switch between the two.

What a graph needs, and how the engine gives it:

* **Fixed addresses.** A graph replays the addresses it captured. The
  slot writes every state tensor in place (``copy_``/``add_``/
  ``index_copy_``/``index_add_``), so the state it returns holds the
  tensors it was given. The first state an engine advances on the card
  becomes its live buffers; a state whose tensors are other ones (a
  second ``init_state``, another engine's ``SimResult.state``) is copied
  into them, never captured anew. A state the engine returned aliases the
  buffers, so advancing another state overwrites it: a state passed to
  ``advance`` is consumed, as it always was.
* **The random stream.** A graph serves only the generator registered
  with it. The live state's generator is registered with both graphs; a
  replay reads its seed and offset when it is launched and advances the
  offset by the graph's draws, so a replayed chunk draws what the same
  slots run eagerly draw. An incoming state's generator is loaded into
  it (seed and offset), as its tensors are copied.
* **Warm-up.** The first slot of the first ``advance`` runs eagerly, on
  the real state (it counts), on the capture stream: it fills the tables
  and caches the slot reads (``MixOp.table``, ``Objective.tensors``,
  ``DPCDUpdate._scales``) and loads the kernel libraries, none of which a
  capture may do. A graph is captured when it is first needed.
* **Launch counts.** A capture records launches and makes none; the
  counts it added are taken back out and added once per replay, so
  ``ops.launch_counts()`` keeps counting the launches that reached the
  card.
* **Topology swaps.** A dynamic engine's slot reads device tiles of the
  live topology. A swap that keeps their shapes copies into them, and the
  graphs replay on. One that reallocates what the slot reads (a larger
  neighbour-slot capacity; any swap of the sharded engine, whose state
  may change shape with it) calls :meth:`ChunkGraphs.reset`: the graphs
  and the live buffers are dropped, never replayed over freed tensors,
  and the next ``advance`` adopts the state it is given, runs an eager
  warm-up slot (it counts) and captures again.

* **Other threads.** A capture is ``thread_local``: it checks only the
  capturing thread's CUDA calls, so a serving thread (``repro_torch.serve``)
  may gather from its snapshots on its own stream while the trainer
  captures; the snapshots are copies, never the live buffers.

A capture that fails raises; nothing carries on eagerly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

def _copy_leaf(src, dst) -> None:
    """Copy a state leaf (a tensor, a dict of tensors, or an empty ``()`` /
    None) into the live one, tensor by tensor, where they differ."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k, leaf in dst.items():
            if src[k] is not leaf:
                leaf.copy_(src[k])


def _same_tensors(a, b) -> bool:
    """Whether the state leaves ``a`` and ``b`` are the very same tensors."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(a[k] is b[k] for k in a)
    return a == b  # the stateless updates' ()


class ChunkGraphs:
    """The captured chunks of one engine on a CUDA device and the live
    buffers they update (see the module docstring)."""

    def __init__(self, engine):
        self.engine = engine
        self.live = None  # the SimState whose tensors the graphs update
        self.graphs: dict = {}  # slots -> (CUDAGraph, launches per replay)
        self.stream = None  # the capture stream, made with the first warm-up
        self.warm = False
        self.warmups = 0  # the first capture, then one more per recapture after a reset

    @property
    def recaptures(self) -> int:
        """Captures made again after a :meth:`reset` (warm-ups past the first)."""
        return max(self.warmups - 1, 0)

    def reset(self) -> None:
        """Drop the captured graphs and the live buffers: the next ``advance``
        adopts the state it is given, warms up eagerly and captures anew."""
        self.graphs = {}
        self.live = None
        self.warm = False

    def bind(self, state):
        """``state`` in the live buffers: adopted as them the first time,
        copied into them (every tensor field the state has — a
        ``SimState``'s or a ``ShardedSimState``'s, ``ef`` included — then
        the generator's seed and offset) where its tensors are other ones.
        Returns the live state."""
        if self.live is None:
            self.live = state
            return state
        live = self.live
        for name in state._fields:
            if name != "generator":
                _copy_leaf(getattr(state, name), getattr(live, name))
        if state.generator is not live.generator:
            live.generator.set_state(state.generator.get_state())
        return live

    def advance(self, state, slots: int):
        """Run ``slots`` sampled super-ticks through the captured graphs."""
        state = self.bind(state)
        eng = self.engine
        if slots > 0 and not self.warm:
            self.stream = torch.cuda.Stream(eng.device)
            current = torch.cuda.current_stream(eng.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                state = eng._slot(state, None)
            current.wait_stream(self.stream)
            self.warm = True
            self.warmups += 1
            slots -= 1
        S = eng.steps_per_chunk
        for steps, replays in ((S, slots // S), (1, slots % S)):
            if replays:
                graph, launches = self._graph(steps)
                for _ in range(replays):
                    graph.replay()
                    _build.add_launches(launches)
        return state

    def _graph(self, steps: int):
        """The graph of ``steps`` slots and its launches a replay, captured
        on first need."""
        if steps in self.graphs:
            return self.graphs[steps]
        live, eng = self.live, self.engine
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(live.generator)
        pool = next(iter(self.graphs.values()))[0].pool() if self.graphs else None
        before = _build.launch_counts()
        current = torch.cuda.current_stream(eng.device)
        try:
            # thread_local: a capture checks only this thread's CUDA calls, so
            # a serving thread reading snapshots meanwhile breaks nothing.
            with torch.cuda.graph(graph, pool=pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = live
                for _ in range(steps):
                    out = eng._slot(out, None)
        except Exception as e:
            raise RuntimeError(
                f"capturing {steps} engine slot(s) as a CUDA graph failed: {e}") from e
        finally:
            launches = {k: v - before[k] for k, v in _build.launch_counts().items()}
            _build.add_launches({k: -v for k, v in launches.items()})
            torch.cuda.set_stream(current)  # a failed capture_end skips the stream's exit
        moved = [f for f in live._fields if not _same_tensors(getattr(out, f), getattr(live, f))]
        if moved:
            raise RuntimeError(f"the captured slot replaced the state's {moved}: a graph "
                               "needs the slot to update the state in place")
        self.graphs[steps] = (graph, launches)
        return self.graphs[steps]
