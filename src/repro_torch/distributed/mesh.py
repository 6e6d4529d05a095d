"""Logical-axis sharding rules, and what the data-parallel FALKON fit needs
of a device mesh.

Counterpart of ``repro/distributed/mesh.py``. The reference runs one
process over a ``jax.sharding.Mesh``; torch.distributed runs one process a
rank, and the port's mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with ``mesh_dim_names`` (``repro_torch.launch.mesh.make_mesh``).

The LM substrate's rules. Model code annotates tensors with *logical* axis
names ("batch", "heads", "ff", ...). ``AxisRules`` maps each logical axis
to mesh axes, checking the divisibility of the actual dimension against
the mesh axes' size and *degrading to replication* when it does not divide
(e.g. gemma3-1b's 4 query heads on a 16-way model axis). ``spec_for``
gives the reference's ``PartitionSpec`` (the port's own tuple type, equal
to the reference's through ``tuple(spec)``); it reads only the mesh's
named sizes, so it resolves a ``DeviceMesh`` and any object with the
reference's ``.shape`` mapping (a production mesh described without its
ranks). ``sharding_for`` gives the torch form of a ``NamedSharding``: the
mesh and its DTensor placements. The torch form of GSPMD is DTensor:
``lshard`` redistributes a DTensor activation to the placements the active
rules give, and does nothing without active rules (``use_rules``) or on a
plain tensor, so every single-device path runs as before.

The FALKON fit's helpers (``mesh_shape``, ``data_axes``, ``data_shard``,
``data_group``, ``device_of``): the rows of X shard over the
``data_axes`` dimensions in the reference's ``P(data_axes)`` order:
row-major over those dimensions in the order given, so for ``("pod",
"data")`` a rank's shard is ``pod_index * data_size + data_index``. Ranks
that differ only along another dimension (the reference's ``"model"``)
hold the same shard and reduce in separate groups.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from typing import Sequence

import torch
import torch.distributed as dist

#: one process group per (mesh, data axes), made on first use
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

# logical axis -> candidate mesh axes, tried in order; tuple entries mean
# "shard over the product of these axes" (e.g. batch over pod+data).
DEFAULT_RULES: dict[str, tuple] = {
    "batch":    (("pod", "data"), ("data",)),
    "fsdp":     (("pod", "data"), ("data",)),  # param dims when cfg.fsdp
    "heads":    (("model",),),
    "kv_heads": (("model",),),
    "ff":       (("model",),),
    "experts":  (("model",),),
    "vocab":    (("model",),),
    "embed":    (),                      # replicated (FSDP overrides below)
    "seq":      (),                      # replicated in training activations
    "kv_seq":   (("model",),),           # decode cache seq (flash-decoding)
    "cache_seq": (("data", "model"), ("model",),),  # long-context cache
    # capacity dim: when the expert dim itself can't shard (e.g. 40 experts
    # on a 16-way model axis) the capacity dim absorbs the model axis too.
    "expert_cap": (("pod", "data", "model"), ("data", "model"),
                   ("pod", "data"), ("data",)),
    "conv":     (),
    "state":    (),
}

# FSDP mode additionally shards "embed"-tagged *parameter* dims over data
# (activations never get it: their batch dim claims the data axes first).
FSDP_EXTRA: dict[str, tuple] = {
    "embed": (("pod", "data"), ("data",)),
}

# Resolution priority: lower resolves first (greedy mesh-axis allocation).
_PRIORITY = {
    "batch": 0,
    "heads": 1,
    "kv_heads": 1,
    "ff": 1,
    "experts": 1,
    "vocab": 1,
    "kv_seq": 2,
    "cache_seq": 2,
    "expert_cap": 2,
    "fsdp": 3,
    "embed": 4,
}


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (replicated), a mesh axis name, or
    a tuple of names (sharded over their product, row-major). Trailing
    None entries are dropped, as the reference's specs drop them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def named_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> size, of a ``DeviceMesh`` or of an object whose
    ``.shape`` is that mapping (the reference's ``Mesh.shape``)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh_shape(mesh)
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The torch form of ``jax.sharding.NamedSharding``: the mesh, the
    DTensor placements of a tensor on it (one a mesh dimension) and the
    spec they came from (None where they were derived from a tensor's).
    A leaf of any tree."""
    mesh: object
    placements: tuple
    spec: PartitionSpec | None = None

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the mesh at these placements: a DTensor redistributed,
        a full tensor (the same on every rank) distributed."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        if isinstance(t, DTensor):
            if tuple(t.placements) == self.placements:
                return t
            return t.redistribute(self.mesh, self.placements)
        return distribute_tensor(t, self.mesh, list(self.placements))


def placements_for(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dimension that entry ``i`` names, ``Replicate()`` on the others. A
    tuple entry names mesh dimensions in the mesh's order, which DTensor
    shards row-major, as the reference's ``P(("pod", "data"))``. A mesh
    dimension of size 1 replicates: the same layout, and DTensor refuses
    to view a tensor whose sharded dimension it would fold (a size-1
    dimension "sharded" over a size-1 mesh dimension)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = named_sizes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {tuple(names)}")
        for d in dims:
            if sizes[names[d]] > 1:
                out[d] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    mesh: object | None
    rules: dict[str, tuple] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )
    fsdp: bool = False

    def axis_size(self, names: Sequence[str]) -> int:
        sizes = named_sizes(self.mesh)
        s = 1
        for nm in names:
            s *= sizes[nm]
        return s

    def spec_for(self, dims: Sequence[int], axes: Sequence[str | None]) -> PartitionSpec:
        """Resolve logical axes to a PartitionSpec.

        Dims resolve in priority order (model-parallel dims before fallback
        dims) with greedy mesh-axis allocation; a dim that does not divide the
        mesh extent is replicated — the divisibility fallback."""
        if self.mesh is None:
            return P()
        if len(dims) != len(axes):
            raise ValueError(f"dims {tuple(dims)} and axes {tuple(axes)} differ in length")
        sizes = named_sizes(self.mesh)
        rules = dict(self.rules)
        if self.fsdp:
            for k, v in FSDP_EXTRA.items():
                rules[k] = v + rules.get(k, ())
        order = sorted(range(len(dims)), key=lambda i: _PRIORITY.get(axes[i] or "", 9))
        used: set[str] = set()
        out: list = [None] * len(dims)
        for i in order:
            dim, name = dims[i], axes[i]
            if name is None:
                continue
            if name in ("fsdp",) and not self.fsdp:
                continue
            for cand in rules.get(name, ()):
                cand = tuple(a for a in cand if a in sizes)
                if not cand or any(a in used for a in cand):
                    continue
                if dim % self.axis_size(cand) == 0:
                    used.update(cand)
                    out[i] = cand if len(cand) > 1 else cand[0]
                    break
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def sharding_for(self, dims, axes) -> NamedSharding:
        spec = self.spec_for(dims, axes)
        return NamedSharding(self.mesh, placements_for(self.mesh, spec), spec)


_local = threading.local()


def current_rules() -> AxisRules:
    return getattr(_local, "rules", AxisRules(mesh=None))


@contextlib.contextmanager
def use_rules(rules: AxisRules):
    """Make ``rules`` the active rules of this thread. Inside, a plain tensor
    that meets a DTensor in an op counts as replicated (DTensor's implicit
    replication, restored to what it was on exit): the masks, positions
    and constants the model builds are the same on every rank. The switch
    is set here and not through ``experimental.implicit_replication()``,
    which turns it off on exit: the backward's recomputation enters
    ``use_rules`` of its own (``recompute_contexts``), nested on the CPU and
    in autograd's threads on the card, and its exit would end the implicit
    replication of the ``use_rules`` around it."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prev = getattr(_local, "rules", None)
    prev_implicit = dispatcher._allow_implicit_replication
    _local.rules = rules
    dispatcher._allow_implicit_replication = True
    try:
        yield rules
    finally:
        dispatcher._allow_implicit_replication = prev_implicit
        if prev is None:
            del _local.rules
        else:
            _local.rules = prev


def recompute_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for code under the rules:
    the recomputation in the backward pass runs under the rules active at
    the forward. On the card autograd runs the backward pass in threads of
    its own, which do not see this thread's rules."""
    rules = current_rules()
    if rules.mesh is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return contextlib.nullcontext(), use_rules(rules)


def lshard(x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
    """Annotate x with logical axes: under active rules a DTensor is
    redistributed to the placements they give, and so is its gradient in
    the backward pass (the reference's ``with_sharding_constraint``
    constrains the cotangent too: without it, DTensor's backward picks its
    own placements, e.g. folding batch and sequence shards into a strided
    shard that it plans slowly on a 3-D mesh); otherwise x is returned."""
    from torch.distributed.tensor import DTensor
    rules = current_rules()
    if rules.mesh is None or not isinstance(x, DTensor):
        return x
    sh = rules.sharding_for(x.shape, axes)
    y = x if tuple(x.placements) == sh.placements else x.redistribute(sh.mesh, sh.placements)
    if y.requires_grad and torch.is_grad_enabled():
        y.register_hook(lambda g: g.redistribute(sh.mesh, sh.placements)
                        if isinstance(g, DTensor) and tuple(g.placements) != sh.placements
                        else g)
    return y


def replicated(x: torch.Tensor) -> torch.Tensor:
    """x whole on every rank: a DTensor redistributed to ``Replicate()`` on
    every mesh dimension; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or all(isinstance(p, Replicate) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def local_apply(fn, args: Sequence, axes: Sequence, out_axes: Sequence):
    """``fn(*args)`` on this rank's shards, under active rules when an
    argument is a DTensor: each tensor argument comes to the placements the
    rules give its logical ``axes`` (an entry of ``axes`` is None for a
    non-tensor argument; a plain tensor counts as replicated) and ``fn``
    runs on the local shards; each output (``fn`` returns a tuple when
    ``out_axes`` is a list of axes tuples) is wrapped back as a DTensor,
    sharded where its logical axes name the mesh dimensions the inputs'
    axes of the same name resolved to. For computations independent along
    the sharded axes (attention over batch rows and heads, the SSD scan
    over batch rows and heads), each rank computes its block of the
    unsharded result with the same ops, and DTensor's propagation, which
    folds two sharded dimensions into a strided shard in einsums, is not
    asked. An argument whole along a mesh dimension that splits another
    (the scan's B and C, whole over the heads) gets its gradient as the sum
    over that dimension's ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    rules = current_rules()
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if rules.mesh is None or mesh is None:
        return fn(*args)
    where: dict[str, set] = {}
    placed = []
    for a, ax in zip(args, axes):
        if ax is None:
            placed.append((a, None))
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        placements = rules.sharding_for(a.shape, ax).placements
        for d, p in enumerate(placements):
            if isinstance(p, Shard):
                where.setdefault(ax[p.dim], set()).add(d)
        placed.append((a.redistribute(mesh, placements), placements))
    split = set().union(*where.values()) if where else set()
    local = []
    for a, placements in placed:
        if placements is None:
            local.append(a)
            continue
        # an argument whole along a mesh dimension that splits the others
        # meets only this rank's block there: its local gradient is a
        # partial sum over that dimension's ranks
        grad = [Partial() if d in split and isinstance(p, Replicate) else p
                for d, p in enumerate(placements)]
        local.append(a.to_local(grad_placements=grad))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs, oaxes = ((out,), (out_axes,)) if single else (out, out_axes)
    wrapped = []
    for t, ax in zip(outs, oaxes):
        placements = [Replicate()] * mesh.ndim
        for i, name in enumerate(ax):
            for d in where.get(name, ()) if name is not None else ():
                placements[d] = Shard(i)
        wrapped.append(DTensor.from_local(t, mesh, placements, run_check=False))
    return wrapped[0] if single else tuple(wrapped)


def leaf_sharding(leaf) -> NamedSharding | None:
    """The sharding of a parameter leaf on its mesh: a DTensor's own; of a
    ``LeafGroup`` of DTensors (its ``tensors``), that of their stack, the
    leading dimension replicated and the others sharded as the tensors
    are. None for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    tensors = getattr(leaf, "tensors", None)
    t = leaf if tensors is None else tensors[0]
    if not isinstance(t, DTensor):
        return None
    placements = tuple(t.placements)
    if tensors is not None:
        placements = tuple(Shard(p.dim % t.ndim + 1) if isinstance(p, Shard) else p
                           for p in placements)
    return NamedSharding(t.device_mesh, placements)


def drop_dim(sharding: NamedSharding, dim: int, ndim: int) -> NamedSharding:
    """The sharding of a reduction of an ``ndim``-dimensional tensor over
    ``dim``: that dimension's mesh dimensions replicate, later ones shift."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= ndim
    out = []
    for p in sharding.placements:
        if isinstance(p, Shard):
            d = p.dim % ndim
            p = Replicate() if d == dim else Shard(d - 1) if d > dim else Shard(d)
        out.append(p)
    return NamedSharding(sharding.mesh, tuple(out))


def zeros_for(leaf, shape, dtype: torch.dtype, sharding: NamedSharding | None = None):
    """Zeros of ``shape`` beside a parameter leaf: on its device, or, for a
    leaf on a mesh, a DTensor at ``sharding`` (default the leaf's own), its
    shard on the leaf's device (``meta`` for a dry run's state)."""
    sharding = sharding or leaf_sharding(leaf)
    if sharding is None:
        return torch.zeros(shape, dtype=dtype, device=leaf.device)
    return sharded_zeros(shape, dtype, sharding, leaf.device)


def sharded_zeros(shape, dtype: torch.dtype, sharding: NamedSharding,
                  device: str | torch.device) -> torch.Tensor:
    """Zeros of the global ``shape`` as a DTensor at ``sharding``, only this
    rank's shard allocated, on ``device`` (``meta`` allocates nothing).
    The sharded dimensions divide their mesh dimensions (``spec_for``'s
    rule)."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for size, p in zip(sharding.mesh.shape, sharding.placements):
        if isinstance(p, Shard):
            local[p.dim] //= size
    t = torch.zeros(local, dtype=dtype, device=device)
    return DTensor.from_local(t, sharding.mesh, list(sharding.placements), run_check=False,
                              shape=torch.Size(shape), stride=torch.empty(shape,
                                                                          device="meta").stride())


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x with dimension ``dim`` whole on every rank: a DTensor sharded there
    is redistributed to ``Replicate()`` on those mesh dimensions; anything
    else is returned as it is. Marks the ops DTensor cannot run sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    placements = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                       for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def mesh_shape(mesh) -> dict[str, int]:
    """Dimension name -> size, as ``jax.sharding.Mesh.shape`` gives them."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(
            f"a mesh must be a torch.distributed DeviceMesh with mesh_dim_names, got "
            f"{type(mesh).__name__}; build one with repro_torch.launch.mesh.make_mesh")
    return dict(zip(names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """The batch axes of the LM substrate's rules: ``"pod"`` and ``"data"``,
    those the mesh has."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def data_shard(mesh, axes) -> tuple[int, int]:
    """(this rank's row-shard index, the shard count) over ``axes``."""
    shape = mesh_shape(mesh)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    names = list(shape)
    index = 0
    for a in axes:
        index = index * shape[a] + coord[names.index(a)]
    return index, math.prod(shape[a] for a in axes)


def data_group(mesh, axes) -> dist.ProcessGroup:
    """The process group of the ranks that share this rank's coordinates off
    ``axes``, its ranks in shard order. Every rank of the world makes every
    such group once per mesh, in the same order (``dist.new_group`` is
    collective), on first use."""
    axes = tuple(axes)
    groups = _GROUPS.setdefault(mesh, {})
    if axes not in groups:
        names = list(mesh_shape(mesh))
        keep = [names.index(a) for a in axes]
        other = [i for i in range(len(names)) if i not in keep]
        rows = mesh.mesh.permute(other + keep).reshape(-1, math.prod(
            mesh.mesh.shape[i] for i in keep))
        me = dist.get_rank()
        for ranks in rows.tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                groups[axes] = group
    return groups[axes]


def device_of(mesh) -> torch.device:
    """The device this rank's tensors live on: the mesh's device type, at
    the current CUDA device for ``"cuda"``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
