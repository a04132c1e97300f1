"""Per-device counts of a traced torch program: the port's ``hlo_parse``.

The reference parses the partitioned HLO of a compiled step. The port runs
the step eagerly, its parameters DTensors on a ``DeviceMesh`` over a fake
process group and every tensor a FakeTensor, and :class:`OpCounter`, a
``TorchDispatchMode``, sees each local operation below DTensor (it
declines DTensor-level calls, so DTensor desugars them into the local
operations and the collectives it needs, which the mode sees next; the
global-shape operations DTensor runs to propagate metadata are skipped):

* flops: twice the multiply-adds of every local matrix product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, which ``matmul``, ``einsum`` and the
  linear layers reach), the reference's dot convention. Under
  ``torch.inference_mode()`` the mode sees composite operations whole
  (``einsum``, ``matmul``, ``linear``: their ``CompositeImplicitAutograd``
  kernel runs below the autograd keys that inference mode skips); it runs
  their decomposition instead (on DTensors: of those DTensor has no
  sharding strategy for, and of every composite inside those), so it
  counts the same products, once, as under ``torch.no_grad()``;
* bytes: each local operation's tensor inputs and outputs (views, aliases
  and uninitialised allocations move nothing). Eager torch fuses nothing,
  but it also keeps no copies XLA makes (layout changes, remat's
  recomputations, scan carries): this is not a bound on the reference's
  fused count either way (``DEVIATIONS.md``);
* collectives: one record per collective, ``(kind, operand bytes, result
  bytes)``, from the functional collectives DTensor issues and the
  ``torch.distributed`` calls of the gossip (sends, all-gathers);
* memory: the bytes of the storages allocated inside the mode and still
  alive (meta tensors hold none), and their peak; ``peak_sites`` attributes the live bytes at the
  peak to the frames that allocated them (:meth:`OpCounter.top_sites`).

Loops: a Python loop runs every iteration, except where the model
weights one. The xLSTM's recurrences (``models/xlstm.py``: the sLSTM time
scan ``SLSTMScan`` and the mLSTM's inter-chunk ``MLSTMChunkScan``), under
a counter with ``weight_loops``, trace their distinct steps once each,
forward and backward, inside :meth:`OpCounter.weighted`, which scales the
flops, bytes, operations and collective records (``Collective.count``)
counted inside it by the steps each stands for: the counterpart of
``hlo_parse``'s ``known_trip_count`` weighting of a ``while`` body. Their
stacked outputs and residuals are still made at full shape, so their
bytes and storage count as the reference's stacked scan outputs do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_MATMULS = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}

# Collective ops by the reference's kinds (``_c10d_functional``: DTensor's
# redistributions; ``c10d``: the process-group calls of the gossip).
COLLECTIVE_KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
}
# Operations that move no bytes: allocation without a write, metadata.
_NO_BYTES = {"aten.empty", "aten.empty_like", "aten.empty_strided", "aten.detach",
             "aten.lift_fresh", "aten._unsafe_view", "aten.alias", "aten.t",
             "_c10d_functional.wait_tensor", "c10d.recv_"}
# DTensor's metadata propagation runs the op once on global-shape fake
# tensors; those frames' operations are not the program's.
_PROPAGATION_FRAMES = ("_propagate_tensor_meta", "gen_fake_args")
# DTensor's placement bookkeeping computes shard offsets from small index
# tensors it makes and reads back (``.tolist()``): those run as real
# tensors, outside the fake mode, and are not the program's either.
_PLACEMENT_FILE = "placement_types.py"


def _composite(func) -> bool:
    """Whether ``func`` has a ``CompositeImplicitAutograd`` kernel (a
    decomposition into other aten operations)."""
    key = torch._C.DispatchKey.CompositeImplicitAutograd
    return func.namespace != "prim" and func.has_kernel_for_dispatch_key(key)


def _dtensor_rule(func) -> bool:
    """Whether DTensor propagates ``func`` itself (a composite it has a
    sharding strategy for, such as ``reshape``, is left to it whole)."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    return (func in prop.op_strategy_funcs or func in prop.op_to_rules
            or func in getattr(prop, "op_single_dim_strategy_funcs", {}))


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def matmul_flops(func, args) -> float:
    """2 x the multiply-adds of a local ``mm``/``addmm``/``bmm``/``baddbmm``."""
    if func in (aten.addmm.default, aten.baddbmm.default):
        args = args[1:]
    a, b = args[0], args[1]
    batch = a.shape[0] if a.ndim == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


@dataclasses.dataclass
class Collective:
    kind: str
    operand_bytes: int
    result_bytes: int
    count: int = 1  # the collectives this record stands for (a weighted loop's)


def active_counter():
    """The innermost :class:`OpCounter` on the dispatch-mode stack, or None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


def _caller() -> str:
    """"propagation" inside DTensor's metadata propagation, "placement"
    inside its placement bookkeeping, else ""."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith(_PROPAGATION_FRAMES):
            return "propagation"
        if f.f_code.co_filename.endswith(_PLACEMENT_FILE):
            return "placement"
        f = f.f_back
    return ""


def _site() -> str:
    """``file:function:line`` of the innermost frame of the program (a
    ``repro_torch`` module other than this one and the layout hooks of
    ``models/sharding.py``) that is running the current operation."""
    f = sys._getframe(3)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(("counter.py", "sharding.py")):
            short = name[name.rindex("repro_torch") + len("repro_torch") + 1:]
            return f"{short}:{f.f_code.co_name}:{f.f_lineno}"
        f = f.f_back
    return "?"


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes, collectives and live storage bytes of the local
    operations run inside it (see the module docstring). With
    ``sites=True`` it also keeps the live bytes by allocation site and, at
    each new peak, a copy of them: ``peak_sites``. ``weight_loops``: a
    loop that can be weighted (the xLSTM's recurrences) traces its
    distinct steps once each inside :meth:`weighted`; False runs every
    step (the yardstick of the weighting)."""

    def __init__(self, sites: bool = False, weight_loops: bool = True):
        super().__init__()
        self.weight_loops = weight_loops
        self.weight = 1
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self.sites = sites
        self.live_sites: dict = {}
        self.peak_sites: dict = {}
        self._seen: set = set()
        self._declined = None
        self._nested = 0
        self._gathering = False

    def _free(self, key, nbytes, site):
        self._seen.discard(key)
        self.live -= nbytes
        if site is not None:
            self.live_sites[site] -= nbytes

    def _track(self, out):
        for t in _tensors(out):
            if t.device.type == "meta":  # no memory
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen.add(key)
            self.live += nbytes
            site = None
            if self.sites:
                site = _site()
                self.live_sites[site] = self.live_sites.get(site, 0) + nbytes
            if self.live > self.peak:
                self.peak = self.live
                if self.sites:
                    self.peak_sites = {k: v for k, v in self.live_sites.items() if v}
            weakref.finalize(st, self._free, key, nbytes, site)

    @contextlib.contextmanager
    def weighted(self, n: int):
        """Count what runs inside ``n`` times over: flops, bytes, operations
        and collectives (live storage is counted once)."""
        outer = self.weight
        self.weight = outer * int(n)
        try:
            yield self
        finally:
            self.weight = outer

    def top_sites(self, k: int = 10) -> list:
        """The ``k`` sites holding the most live bytes at the peak, as
        ``(site, bytes)``, largest first (needs ``sites=True``)."""
        return sorted(self.peak_sites.items(), key=lambda kv: -kv[1])[:k]

    def _dtensor_call(self, func, args, kwargs):
        """A DTensor-level call, run by DTensor with this mode active (so its
        local operations and collectives are counted). One that DTensor
        fails on (a view splitting a dim its mesh split does not divide, an
        einsum its decomposition cannot shard: layouts GSPMD reshards) runs
        again on its DTensor inputs gathered to replicas, the gathers
        counted."""
        from torch.distributed.tensor import DTensor, Replicate

        try:
            self._declined = func
            with self:
                return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError):
            self._declined = None
            if self._gathering:  # the gather itself failed: no second rerun
                raise
            self._gathering = True
            try:
                with self:
                    args = [a.redistribute(a.device_mesh, [Replicate()] * a.device_mesh.ndim)
                            if isinstance(a, DTensor) else a for a in args]
            finally:
                self._gathering = False
            self._declined = func
            with self:
                return func(*args, **kwargs)
        finally:
            self._declined = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

        kwargs = kwargs or {}
        dtensor = any(issubclass(t, DTensor) for t in types)
        if _composite(func) and (not dtensor or self._nested or not _dtensor_rule(func)):
            # Whole under inference mode: counted as its parts, all the way
            # down inside a composite DTensor has no rule for (as no_grad).
            self._nested += 1
            try:
                with self:
                    out = func.decompose(*args, **kwargs)
            finally:
                self._nested -= 1
            if out is not NotImplemented:
                return out
        if dtensor:
            if self._declined is func:  # the call _dtensor_call made: DTensor's
                self._declined = None
                return NotImplemented
            return self._dtensor_call(func, args, kwargs)
        caller = _caller()
        if caller == "placement" and not any(isinstance(t, FakeTensor)
                                             for t in _tensors((args, kwargs))):
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, ValueError):
            if func is not aten.view.default:
                raise
            # DTensor views a permuted local shard its global view allows
            # (an MoE einsum's backward): the values of a reshape.
            out = aten.reshape.default(*args, **kwargs)
        name = func._schema.name.replace("::", ".")
        if name.startswith("prim.") or caller == "propagation":
            return out
        w = self.weight
        self.ops += w
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None:
            if name == "c10d._allgather_base_":
                operand, result = _nbytes(args[1]), _nbytes(args[0])
            elif name.startswith("c10d."):
                operand = result = _nbytes(args[0])
            else:
                operand, result = _nbytes(args[0]), _nbytes(out)
            self.collectives.append(Collective(kind, operand, result, w))
            self.bytes += w * (operand + result)
        elif func in _MATMULS:
            self.flops += w * matmul_flops(func, args)
            self.bytes += w * (_nbytes(args) + _nbytes(out))
        elif not func.is_view and name not in _NO_BYTES:
            self.bytes += w * (_nbytes(args) + _nbytes(kwargs) + _nbytes(out))
        if not func.is_view:
            self._track(out)
        return out
