"""What the data-parallel FALKON fit needs of a device mesh.

Counterpart of the FALKON part of ``repro/distributed/mesh.py``. The
reference runs one process over a ``jax.sharding.Mesh``; torch.distributed
runs one process a rank, and the port's mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
(``repro_torch.launch.mesh.make_mesh``). The rows of X shard over the
``data_axes`` dimensions in the reference's ``P(data_axes)`` order:
row-major over those dimensions in the order given, so for
``("pod", "data")`` a rank's shard is ``pod_index * data_size +
data_index``. Ranks that differ only along another dimension (the
reference's ``"model"``) hold the same shard and reduce in separate groups.

Not here: the LM substrate's logical-axis rules (``AxisRules``, ``lshard``,
``use_rules``), which are ported with the LM models (ROADMAP A15).
"""
from __future__ import annotations

import math
import weakref

import torch
import torch.distributed as dist

#: one process group per (mesh, data axes), made on first use
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


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
