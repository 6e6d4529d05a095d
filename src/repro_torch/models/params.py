"""Parameter descriptors, and the modules built from them.

Counterpart of ``repro/models/params.py``. Layers declare their parameters
as ``PD(shape, logical_axes, init)`` trees (nested dicts and lists); from
one descriptor tree come (a) initialized tensors (``init_params``), (b)
``meta`` tensors of the same shapes (``param_shape_structs``: no
allocation) and (c) a ``ParamModule`` whose parameters carry the tree's
leaf names, so that a reference parameter tree maps onto it one to one.
(d) ``param_pspecs`` resolves a tree's logical axes to PartitionSpecs by
the sharding rules, and ``place_module`` puts a module's parameters on a
mesh as DTensors, each at the sharding of its own descriptor.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn


class PD(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | embed | ssm_A
    scale: float | None = None    # stddev; default 1/sqrt(fan_in)


def _is_pd(x) -> bool:
    return isinstance(x, PD)


def tree_map(fn, tree):
    """Apply ``fn`` to every PD leaf of a tree of dicts and lists."""
    if _is_pd(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    raise TypeError(f"not a descriptor tree: {type(tree).__name__}")


def _init_leaf(pd: PD, generator: torch.Generator | None, dtype, device,
               stack: int | None = None) -> torch.Tensor:
    """One leaf's initial value. ``stack``: the leaf is one repeat of a
    leaf the reference stacks ``stack`` times, and the default scale is the
    stacked leaf's (its fan-in counts the repeats), as the reference draws
    it."""
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=device)
    if pd.init == "ssm_A":           # A_log in [log 1, log 16]
        u = torch.rand(pd.shape, generator=generator, device=device, dtype=torch.float32)
        return torch.log(1.0 + 15.0 * u).to(dtype)
    shape = pd.shape if stack is None else (stack,) + tuple(pd.shape)
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    scale = pd.scale if pd.scale is not None else fan_in ** -0.5
    if pd.init == "embed":
        scale = 1.0 if pd.scale is None else pd.scale
    z = torch.randn(pd.shape, generator=generator, device=device, dtype=torch.float32)
    return (z * scale).to(dtype)


def init_params(generator: torch.Generator | None, tree, dtype: torch.dtype,
                device: str | torch.device | None = None):
    """Initialized tensors for a descriptor tree, drawn from ``generator`` on
    its device (or ``device``): the reference's init kinds and scales. The
    draws are torch's, so the values differ from the reference's. A tree of
    "zeros" and "ones" only (a cache) needs no generator."""
    device = generator.device if device is None else torch.device(device)
    return tree_map(lambda pd: _init_leaf(pd, generator, dtype, device), tree)


def param_shape_structs(tree, dtype: torch.dtype) -> dict:
    """``meta`` tensors of the tree's shapes at ``dtype``: no allocation."""
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=dtype, device="meta"), tree)


def param_pspecs(tree, rules):
    """The PartitionSpec of each descriptor under ``rules`` (an ``AxisRules``)."""
    return tree_map(lambda pd: rules.spec_for(pd.shape, pd.axes), tree)


def stack_pds(tree, n: int, axis_name: str | None = "fsdp") -> dict:
    """Stack descriptors along a new leading axis (the reference's period
    stacking; the port keeps its layers unstacked, so only the shapes of
    the reference's trees use this)."""
    return tree_map(lambda pd: PD((n,) + pd.shape, (axis_name,) + pd.axes, pd.init, pd.scale),
                    tree)


class LeafGroup:
    """One stacked leaf of the reference's trees, kept as separate tensors.

    The reference stacks the parameters of all repeats of one period slot
    into a leaf of shape (repeats, ...); the port keeps one tensor a layer.
    A ``LeafGroup`` holds those tensors in repeat order and stands for the
    stacked leaf wherever the reference's leaf shape matters (an optimizer's
    moments, a checkpoint's leaf): ``shape`` is the stacked shape,
    ``stack()`` the stacked value and ``copy_(stacked)`` writes each slice
    back into its tensor. It is a leaf of any tree (not a tuple)."""

    def __init__(self, tensors):
        self.tensors = tuple(tensors)
        first = self.tensors[0]
        if any(t.shape != first.shape or t.dtype != first.dtype for t in self.tensors):
            raise ValueError("a LeafGroup's tensors must share shape and dtype")

    def __iter__(self):
        return iter(self.tensors)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self.tensors),) + tuple(self.tensors[0].shape))

    @property
    def dtype(self) -> torch.dtype:
        return self.tensors[0].dtype

    @property
    def device(self) -> torch.device:
        return self.tensors[0].device

    def stack(self) -> torch.Tensor:
        """The stacked value; of DTensors, a DTensor whose leading dimension
        is replicated and whose others keep the tensors' shards."""
        return torch.stack([t.detach() for t in self.tensors])

    @torch.no_grad()
    def copy_(self, stacked: torch.Tensor) -> "LeafGroup":
        if tuple(stacked.shape) != tuple(self.shape):
            raise ValueError(f"stacked value {tuple(stacked.shape)} for a group of "
                             f"{tuple(self.shape)}")
        for t, s in zip(self.tensors, stacked):
            t.copy_(s)
        return self


def tree_flatten(tree) -> list:
    """The leaves of nested dicts, lists and tuples in the reference's
    flattening order (dict keys sorted, sequences in order, a
    ``NamedTuple``'s fields in order); a ``LeafGroup`` is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


class ParamModule(nn.Module):
    """A module whose parameters are a descriptor tree's leaves, under the
    tree's names: a PD leaf becomes an ``nn.Parameter`` (uninitialized until
    :func:`init_module`), a nested dict a ``ParamModule``. Subclasses that
    hold submodules of their own pass the remaining leaves here."""

    def __init__(self, tree: dict, *, dtype: torch.dtype, device=None):
        super().__init__()
        self._pds: dict[str, PD] = {}
        self._stack: int | None = None     # repeats of the reference's stacked leaves
        for name, leaf in tree.items():
            if _is_pd(leaf):
                self._pds[name] = leaf
                self.register_parameter(
                    name, nn.Parameter(torch.empty(leaf.shape, dtype=dtype, device=device)))
            else:
                self.add_module(name, ParamModule(leaf, dtype=dtype, device=device))


@torch.no_grad()
def place_module(module: nn.Module, rules) -> nn.Module:
    """Put every ``ParamModule`` parameter of ``module`` on ``rules.mesh``, in
    place: a DTensor ``Parameter`` at ``rules.sharding_for`` of its own
    descriptor's shape and axes. Every rank holds the same full values
    before (the same seed, or the same checkpoint); a parameter already on
    the mesh is redistributed."""
    for sub in module.modules():
        if isinstance(sub, ParamModule):
            for name, pd in sub._pds.items():
                p = getattr(sub, name)
                placed = rules.sharding_for(pd.shape, pd.axes).place(p.detach())
                setattr(sub, name, nn.Parameter(placed, requires_grad=p.requires_grad))
    return module


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every ``ParamModule`` parameter from its descriptor, drawing from
    ``generator`` in the order of ``module.named_modules()`` (at the scale
    of the reference's stacked leaf where the module's ``_stack`` is set)."""
    for sub in module.modules():
        if isinstance(sub, ParamModule):
            for name, pd in sub._pds.items():
                p = getattr(sub, name)
                p.copy_(_init_leaf(pd, generator, p.dtype, p.device, sub._stack))
    return module
