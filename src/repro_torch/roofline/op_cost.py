"""Per-device cost of one eager call, counted op by op.

Counterpart of ``repro/roofline/hlo_cost.py``. The reference walks the
optimized HLO text of a compiled step; the port has no compiled program, so
``analyze(fn, *args, **kw)`` runs ``fn`` once under a ``TorchDispatchMode``
and counts every aten op as it runs, on this rank's tensors:

* flops        — the matmul-class ops (``mm``, ``addmm``, ``bmm``,
                 ``baddbmm``, the SDPA ops: ``torch.utils.flop_counter``'s
                 formulas, 2 * prod(out) * K as ``hlo_cost._dot_flops``
                 counts a dot; ``mv`` and ``dot`` likewise);
* bytes        — operand plus output bytes of every op that moves data;
                 views and the ops ``hlo_cost._ZERO_BYTE_OPS`` stands for
                 (``detach``, ``alias``, ``empty*``, ``t``, ``expand``: every
                 op whose outputs alias its inputs without writing them,
                 and the allocators) are skipped;
* collectives  — operand bytes of the ``_c10d_functional`` (and ``c10d``)
                 collectives, keyed by the reference's kind names
                 (``all-gather``, ``all-reduce``, ``reduce-scatter``,
                 ``all-to-all``, ``collective-permute``); ``wait_tensor`` is
                 not counted, as ``-done`` is not in the reference. They
                 count in ``bytes`` too, as the reference's do;
* memory       — the bytes of the storages alive on this rank: the
                 arguments', the peak over the call, the outputs' and those
                 outputs that are arguments updated in place (``Memory``).

**Every count is one rank's.** On DTensor operands the mode returns
``NotImplemented``, so DTensor runs the op and the mode sees what it runs on
this rank: the redistributions' collectives and the local op on the local
shards, after sharding propagation. (A mode that ran the DTensor op itself,
as ``FlopCounterMode`` does, would count the global op.) DTensor's own
bookkeeping, which runs ops on stand-in tensors of the global shapes to
propagate shapes, is not counted; its strategy search is steered off
strided shards (``_dtensor_bookkeeping_uncounted``).

There are no trip counts to correct: eager ops are counted as they run, so
a loop of 7 matmuls counts 7, and ``unbounded_whiles`` is always 0.

On ``meta`` tensors (the dry run: shapes and no data) nothing is allocated
and the counts are the same; a functional op's outputs are then made from
the metadata of its last call with the same argument shapes. An op that
needs a tensor's value on the host (``.item()``, ``bool(t)``) cannot run
there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: collective op name (its overload packet's) -> the reference's kind
_COLLECTIVE_KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
    "c10d.broadcast_": "broadcast",
}

#: waits and bookkeeping of the collectives: no bytes of their own
_COLLECTIVE_FREE = ("_c10d_functional.wait_tensor", "_c10d_functional_autograd.wait_tensor",
                    "c10d.barrier", "c10d.monitored_barrier_")

#: the allocators: they write nothing (``hlo_cost._ZERO_BYTE_OPS``'s ``empty``)
_ALLOCATORS = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default}


def _matmul_flops() -> dict:
    """The matmul-class entries of ``torch.utils.flop_counter``'s table, and
    ``mv`` / ``dot`` (a dot in HLO, which the reference counts)."""
    from torch.utils.flop_counter import flop_registry
    table = {}
    for name in ("mm", "addmm", "bmm", "baddbmm", "_scaled_dot_product_efficient_attention",
                 "_scaled_dot_product_flash_attention",
                 "_scaled_dot_product_cudnn_attention",
                 "_scaled_dot_product_efficient_attention_backward",
                 "_scaled_dot_product_flash_attention_backward",
                 "_scaled_dot_product_cudnn_attention_backward"):
        packet = getattr(aten, name, None)
        if packet is not None and packet in flop_registry:
            table[packet] = flop_registry[packet]
    table[aten.mv] = lambda a, b, *_, out_val=None, **__: 2 * a.shape[0] * a.shape[1]
    table[aten.dot] = lambda a, b, *_, out_val=None, **__: 2 * a.shape[0]
    return table


@dataclasses.dataclass
class Memory:
    """Bytes of the storages alive on this rank during one call.

    ``arguments``: the call's inputs (parameters, optimizer state, batch,
    cache) before it starts; ``peak``: the most alive at once, arguments
    included; ``outputs``: the returned tensors' storages; ``aliased``: the
    outputs that are arguments (updated in place, the reference's donated
    buffers). A storage counts once however many tensors view it."""
    arguments: int = 0
    peak: int = 0
    outputs: int = 0
    aliased: int = 0

    @property
    def temp(self) -> int:
        """The peak above the arguments and the fresh outputs."""
        return max(0, self.peak - self.arguments - (self.outputs - self.aliased))


@dataclasses.dataclass
class OpCost:
    """``hlo_cost.HloCost``'s fields, per device, and the call's memory."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    unbounded_whiles: int = 0
    memory: Memory = dataclasses.field(default_factory=Memory)
    ops: int = 0

    @property
    def collective_total(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": {k: float(v) for k, v in self.collective_bytes.items()},
                "unbounded_whiles": self.unbounded_whiles}


def _local(t):
    """A DTensor's local shard; anything else as it is."""
    return getattr(t, "_local_tensor", t)


def _tensors_of(obj) -> list[torch.Tensor]:
    """Every tensor held by ``obj``: a tensor (a DTensor's local shard), the
    parameters and buffers of a module, the members of a ``LeafGroup`` and
    of dicts, lists, tuples and named tuples, nested."""
    out: list[torch.Tensor] = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append(_local(o))
        elif isinstance(o, torch.nn.Module):
            for t in o.parameters():
                walk(t)
            for t in o.buffers():
                walk(t)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif hasattr(o, "tensors"):              # a LeafGroup
            walk(o.tensors)

    walk(obj)
    return out


class _Live:
    """The bytes of the storages this rank holds, each once, freed when its
    storage dies (a weak reference's callback)."""

    def __init__(self):
        self.refs: dict[int, weakref.ref] = {}
        self.now = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.refs:
            return
        nbytes = st.nbytes()

        def free(_, key=key, nbytes=nbytes):
            if self.refs.pop(key, None) is not None:
                self.now -= nbytes

        self.refs[key] = weakref.ref(st, free)
        self.now += nbytes
        self.peak = max(self.peak, self.now)

    def bytes_of(self, tensors) -> int:
        seen: dict[int, int] = {}
        for t in tensors:
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
        return sum(seen.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


class CostMode(TorchDispatchMode):
    """Counts flops, bytes, collective bytes and live storages of the ops
    it sees (``analyze`` enters it; see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.coll: dict[str, float] = defaultdict(float)
        self.live = _Live()
        self.paused = 0
        self._flops = _matmul_flops()
        self._kinds: dict = {}   # op -> (role, flops formula); role: a collective kind,
        #                          "free", "view", "functional" or None
        self._memo: dict = {}    # (op, argument metadata) -> (outputs' metadata, flops, bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented                # DTensor runs it; we see its local ops
        if self.paused:
            return func(*args, **kwargs)
        self.cost.ops += 1
        role, flops = self._kind(func)
        if role != "functional":
            out = func(*args, **kwargs)
            self._count(role, flops, args, kwargs, out)
            return out
        # a functional op on meta tensors: its outputs are made from the
        # metadata of its last call with the same arguments' shapes, strides
        # and dtypes, and its bytes and flops are that call's (a meta
        # kernel's shape logic runs in Python, at a few hundred microseconds
        # an op: the dry run's time)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs) if kwargs else None)
        except _NotMeta:
            key = None
        memo = None if key is None else self._memo.get(key)
        if memo is not None:
            template, fl, by = memo
            out = _rebuild(template)
            self.cost.flops += fl
            self.cost.bytes += by
            for t in _flat(out, []):
                self.live.add(t)
            return out
        out = func(*args, **kwargs)
        fl, by = self._count(role, flops, args, kwargs, out)
        if key is not None:
            try:
                self._memo[key] = (_template(out), fl, by)
            except _NotMeta:
                pass
        return out

    def _kind(self, func):
        kind = self._kinds.get(func)
        if kind is None:
            name = func._schema.name.replace("::", ".")
            role = ("free" if name in _COLLECTIVE_FREE else _COLLECTIVE_KINDS.get(name)
                    or ("view" if func in _ALLOCATORS or _is_view(func) else
                        "functional" if _functional(func) else None))
            kind = self._kinds[func] = (role, self._flops.get(func._overloadpacket))
        return kind

    def _count(self, role, flops, args, kwargs, out) -> tuple[float, float]:
        """Add one op's flops and bytes (returned) and track its outputs."""
        outs = _flat(out, [])
        for t in outs:
            self.live.add(t)
        if role == "free" or role == "view":
            return 0.0, 0.0
        b_in = sum(_nbytes(t) for t in _flat(kwargs, _flat(args, [])))
        by = float(b_in + sum(_nbytes(t) for t in outs))
        fl = 0.0
        if role is not None and role != "functional":   # a collective
            self.coll[role] += b_in
        elif flops is not None:
            fl = float(flops(*args, **kwargs, out_val=out))
        self.cost.bytes += by
        self.cost.flops += fl
        return fl, by


class _NotMeta(Exception):
    """An argument or output that the meta-output cache does not handle."""


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def _meta_key(x):
    """A hashable key of an op's arguments: each tensor by shape, stride and
    dtype (``meta`` tensors only), each scalar by type and value."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _NotMeta
        return (x.size(), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in x.items())
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise _NotMeta


def _template(out):
    if isinstance(out, torch.Tensor):
        if not out.is_meta or out.storage_offset() != 0:
            raise _NotMeta
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), [_template(v) for v in out])
    if isinstance(out, _SCALARS):
        return ("S", out)
    raise _NotMeta


def _rebuild(template):
    tag = template[0]
    if tag == "T":
        return torch.empty_strided(template[1], template[2], dtype=template[3], device="meta")
    if tag == "S":
        return template[1]
    return tag(_rebuild(v) for v in template[1])


def _functional(func) -> bool:
    """No output aliases or writes an input (no views, in-place or out=)."""
    return all(r.alias_info is None for r in func._schema.returns) and not any(
        a.alias_info is not None and a.alias_info.is_write for a in func._schema.arguments)


def _is_dtensor_type(cls) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(cls, type) and issubclass(cls, DTensor)


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them (views,
    ``detach``, ``alias``, ``t``, ``expand``): no bytes move."""
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


@contextlib.contextmanager
def _dtensor_bookkeeping_uncounted(mode: CostMode):
    """DTensor's sharding propagation and redistribution planning run with
    the mode paused: they run ops on stand-in tensors of global shapes and
    on index tensors. And the strategy search prices a
    candidate redistribution from or to a strided shard (two sharded
    dimensions folded into one) as infinite: DTensor plans such a
    redistribution by a search over the mesh's placement states whose cost
    grows steeply with the mesh's rank (minutes per op on a 3-D mesh), so
    a strategy without one is taken wherever there is one, and where every
    candidate has one, DTensor's first. The redistribution it then runs is
    planned as DTensor plans it."""
    patched = []

    def strided(spec) -> bool:
        return any(type(p).__name__ == "_StridedShard" for p in spec.placements)

    def price(owner, name="redistribute_cost"):
        fn = getattr(owner, name, None)
        if fn is None:
            return

        def cost(current, target, *a, **k):
            if strided(current) or strided(target):
                return float("inf")
            return fn(current, target, *a, **k)

        setattr(owner, name, cost)
        patched.append((owner, name, fn))

    def wrap(owner, name):
        fn = owner.__dict__.get(name) if isinstance(owner, type) else getattr(owner, name, None)
        if fn is None:
            return
        raw = fn.__func__ if isinstance(fn, staticmethod) else fn

        def quiet(*a, **k):
            mode.paused += 1
            try:
                return raw(*a, **k)
            finally:
                mode.paused -= 1

        quiet.__wrapped__ = raw
        setattr(owner, name, staticmethod(quiet) if isinstance(fn, staticmethod) else quiet)
        patched.append((owner, name, fn))

    try:
        from torch.distributed.tensor import _redistribute, _sharding_prop
        from torch.distributed.tensor import placement_types
    except ImportError:       # no torch.distributed: no DTensor to count
        yield
        return
    for name in ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached",
                 "propagate_tensor_meta"):
        wrap(_sharding_prop.ShardingPropagator, name)
    for name in ("_gen_transform_infos_non_cached",):
        wrap(_redistribute, name)
    strided_cls = getattr(placement_types, "_StridedShard", None)
    if strided_cls is not None:
        wrap(strided_cls, "local_shard_size_and_offset")
    for module in ("torch.distributed.tensor._ops.utils", "torch.distributed.tensor._utils"):
        try:
            price(importlib.import_module(module))
        except ImportError:
            pass
    try:
        yield
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)


def analyze(fn: Callable, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once and count its ops on this rank
    (module docstring). The arguments' tensors are this rank's before the
    call; the returned ``OpCost.memory`` has their bytes, the peak, the
    outputs' and the outputs updated in place."""
    cost, _ = analyze_with_result(fn, *args, **kwargs)
    return cost


def analyze_with_result(fn: Callable, *args, **kwargs) -> tuple[OpCost, Any]:
    """``analyze``, and ``fn``'s result."""
    mode = CostMode()
    inputs = _tensors_of((args, kwargs))
    for t in inputs:
        mode.live.add(t)
    arg_keys = {id(t.untyped_storage()) for t in inputs}
    arguments = mode.live.now
    mode.live.peak = arguments
    with _dtensor_bookkeeping_uncounted(mode), mode:
        result = fn(*args, **kwargs)
    outs = _tensors_of(result)
    cost = mode.cost
    cost.collective_bytes = dict(mode.coll)
    cost.memory = Memory(arguments=arguments, peak=mode.live.peak,
                         outputs=mode.live.bytes_of(outs),
                         aliased=mode.live.bytes_of(
                             t for t in outs if id(t.untyped_storage()) in arg_keys))
    return cost, result
