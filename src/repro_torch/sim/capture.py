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
* **The garbage collector.** An engine holds its graphs in a reference
  cycle, so only the collector frees a dropped engine's graphs, and
  destroying a graph while another stream captures invalidates that
  capture. The collector is off while a capture runs; what it would have
  freed waits for the next collection.

The engines' phase programs (:class:`PhaseProgram`, the reference's
jitted slot prefixes ``phase_program(upto)``) follow the same rules on a
scratch state of their own: each prefix is a graph of its own, captured
on a clone of the state it is first given and kept out of the chunk's
graphs, with the clone's own generator registered; ``load`` copies a
state (its generator's seed and offset included) into the clone. A
prefix never touches the state it was given or that state's generator.
On the CPU, and on a rank of a sharded engine whose gloo group stages
the exchange through the host (``capture_mode``), a prefix runs eagerly
on the clone.

A capture that fails raises; nothing carries on eagerly.
"""

from __future__ import annotations

import gc

import torch

from repro_torch.kernels import _build
from repro_torch.obs.trace import span


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


def _clone_leaf(leaf):
    """A copy of a state leaf: tensors cloned, dicts leaf by leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf.clone()
    if isinstance(leaf, dict):
        return {k: v.clone() for k, v in leaf.items()}
    return leaf


def clone_state(state):
    """A state of new tensors equal to ``state``, with a generator of its
    own at the same seed and offset (a sharded state's ``Theta`` stays a
    view of its new slab)."""
    fields = {f: _clone_leaf(getattr(state, f)) for f in state._fields if f != "generator"}
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    fields["generator"] = gen
    if "slab" in fields:
        S, R, p = state.Theta.shape
        fields["Theta"] = fields["slab"][: S * R].view(S, R, p)
    return type(state)(**fields)


def load_state(src, dst) -> None:
    """Copy every tensor leaf of ``src`` into ``dst`` where they are other
    tensors, then the generator's seed and offset."""
    for name in dst._fields:
        if name != "generator":
            _copy_leaf(getattr(src, name), getattr(dst, name))
    if src.generator is not dst.generator:
        dst.generator.set_state(src.generator.get_state())


def capture(fn, generator, stream, pool=None, **args):
    """Capture ``fn()`` as a CUDA graph on ``stream`` with ``generator``
    registered (None: ``fn`` draws nothing); returns ``(graph, output,
    launches a replay)``. The launches counted while capturing are taken
    back out (a capture launches nothing). The garbage collector is off
    meanwhile: a graph it destroyed would invalidate the capture. The
    capture is the span ``capture.graph`` (``args``: what the graph holds),
    around the graph's context and never inside it."""
    with span("capture.graph", sync=stream.device, **args):
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = _build.launch_counts()
        current = torch.cuda.current_stream(stream.device)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: a capture checks only this thread's CUDA calls, so
            # a serving thread reading snapshots meanwhile breaks nothing.
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            launches = {k: v - before[k] for k, v in _build.launch_counts().items()}
            _build.add_launches({k: -v for k, v in launches.items()})
            torch.cuda.set_stream(current)  # a failed capture_end skips the stream's exit
            if collecting:
                gc.enable()
    return graph, out, launches


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
        if state is not self.live:
            with span("capture.bind"):
                load_state(state, self.live)
        return self.live

    def advance(self, state, slots: int):
        """Run ``slots`` sampled super-ticks through the captured graphs."""
        state = self.bind(state)
        eng = self.engine
        if slots > 0 and not self.warm:
            self.stream = torch.cuda.Stream(eng.device)
            current = torch.cuda.current_stream(eng.device)
            self.stream.wait_stream(current)
            with span("engine.warm_slot", sync=eng.device), torch.cuda.stream(self.stream):
                state = eng._slot(state, None)
            current.wait_stream(self.stream)
            self.warm = True
            self.warmups += 1
            slots -= 1
        S = eng.steps_per_chunk
        for steps, replays in ((S, slots // S), (1, slots % S)):
            if replays:
                graph, launches = self._graph(steps)
                with span("capture.replay"):
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
        pool = next(iter(self.graphs.values()))[0].pool() if self.graphs else None

        def slots():
            out = live
            for _ in range(steps):
                out = eng._slot(out, None)
            return out

        try:
            graph, out, launches = capture(slots, live.generator, self.stream, pool,
                                           slots=steps)
        except Exception as e:
            raise RuntimeError(
                f"capturing {steps} engine slot(s) as a CUDA graph failed: {e}") from e
        moved = [f for f in live._fields if not _same_tensors(getattr(out, f), getattr(live, f))]
        if moved:
            raise RuntimeError(f"the captured slot replaced the state's {moved}: a graph "
                               "needs the slot to update the state in place")
        self.graphs[steps] = (graph, launches)
        return self.graphs[steps]


class PhaseProgram:
    """One phase prefix of an engine's sampled slot (the reference's
    ``phase_program(upto)``) on the engine's scratch state: ``load`` a
    state into the scratch, then ``run`` the prefix there, or call the
    program with a state for both. Returns the cut phase's intermediates
    (the scratch state itself for ``upto`` None or ``"finalize"``). On a
    CUDA device the prefix is a graph of its own, captured at the first
    ``load`` after an eager warm-up on the scratch; each replay adds its
    launches to ``ops.launch_counts()``, as a chunk's replay does."""

    def __init__(self, engine, upto):
        self.engine = engine
        self.upto = upto
        self.graph = None
        self.out = None
        self.launches = None

    def __call__(self, state):
        self.load(state)
        return self.run()

    def load(self, state) -> None:
        """Copy ``state`` (tensors and the generator's position) into the
        engine's scratch state, capturing this prefix first if it is not
        yet; ``state`` itself is only read."""
        eng = self.engine
        scratch = eng._phase_scratch
        if scratch is None:
            eng._phase_scratch = scratch = clone_state(state)
        if self.graph is None and _captures(eng):
            self._capture(scratch)
        load_state(state, scratch)

    def run(self):
        """The prefix on the scratch state as it stands (it updates it)."""
        eng = self.engine
        if eng._phase_scratch is None:
            raise ValueError("load a state into the phase program before running it")
        if self.graph is None:
            return eng._slot(eng._phase_scratch, None, upto=self.upto)
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.out

    def _capture(self, scratch) -> None:
        eng = self.engine
        stream = getattr(eng, "_phase_stream", None)
        if stream is None:
            stream = eng._phase_stream = torch.cuda.Stream(eng.device)
        current = torch.cuda.current_stream(eng.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):  # the warm-up fills the caches a capture may not
            eng._slot(scratch, None, upto=self.upto)
        current.wait_stream(stream)
        pools = [p.graph for p in eng._phase_cache.values() if p.graph is not None]
        try:
            self.graph, self.out, self.launches = capture(
                lambda: eng._slot(scratch, None, upto=self.upto), scratch.generator, stream,
                pools[0].pool() if pools else None, upto=self.upto)
        except Exception as e:
            raise RuntimeError(
                f"capturing the slot prefix up to {self.upto!r} as a CUDA graph failed: {e}"
            ) from e


def _captures(engine) -> bool:
    """Whether ``engine``'s slots are captured: on a CUDA device, unless
    its ``capture_mode`` says eager (a rank of a gloo group)."""
    return engine.device.type == "cuda" and \
        getattr(engine, "capture_mode", "captured") == "captured"


def phase_program(engine, upto) -> PhaseProgram:
    """The engine's cached :class:`PhaseProgram` for ``upto`` (None: the
    full slot); an unknown phase raises the reference's ``ValueError``."""
    if upto is not None and upto not in engine._phases:
        raise ValueError(f"unknown phase {upto!r} (have {engine._phases})")
    if upto not in engine._phase_cache:
        engine._phase_cache[upto] = PhaseProgram(engine, upto)
    return engine._phase_cache[upto]


def prefix_shards(engine, upto: str | None, out) -> list:
    """A sharded engine's phase prefix output as ``(tensor, per_shard)``
    pairs, for comparisons: a per-shard tensor has a leading axis over
    the L shards this process holds (flat (L * B, ...) rows, the slab's
    owned and halo parts and a p2p buffer's offset segments cut so), and
    one that is not is the all-gather's pool, which every shard holds
    whole. So a rank's prefix compares leaf by leaf with the stacked
    engine's: its per-shard leaves with the stacked leaves' row
    ``rank``, its pool with the whole pool."""
    L, R = engine.local_shards, engine.rows_per_shard
    smix = engine.smix

    def cut(t):  # flat (L * X, ...) rows -> (L, X, ...)
        return t.reshape((L, -1) + tuple(t.shape[1:]))

    def segments(t):  # a p2p buffer: offset by offset, (L * P_d, ...) each
        sizes = [L * int(dst.shape[1]) for dst in smix.p2p_dst]
        if not sizes:
            return t.reshape((L, 0) + tuple(t.shape[1:]))
        return torch.cat([cut(x) for x in torch.split(t, sizes)], dim=1)

    if upto in ("halo_publish", "halo_collective"):
        live = [t for t in out if t is not None]
        if smix.method == "p2p":
            return [(segments(t), True) for t in live]
        if upto == "halo_publish":
            return [(t, True) for t in live]
        # the pool, (S, Bmax, ...) in either form
        return [(t.reshape((engine.num_shards, -1) + tuple(t.shape[-1:])), False) for t in live]
    if upto == "halo_scatter":
        return [(out[: L * R].view(L, R, -1), True),
                (out[L * R:].view(L, smix.halo_width, -1), True)]
    if upto in (None, "finalize"):
        leaves = [out.Theta, out.active, out.applied, out.dropped, out.messages, out.ptr]
        leaves += [t for t in (out.ef, out.ustate) if isinstance(t, torch.Tensor)]
        return [(t, True) for t in leaves]
    flat = L * engine.batch_size  # the woken rows' leaves, (L * B, ...)
    outs = out if isinstance(out, tuple) else (out,)
    return [(cut(t) if t.dim() and t.shape[0] == flat != L else t, True) for t in outs]
