"""Device meshes for the data-parallel fit.

Counterpart of ``repro/launch/mesh.py``'s ``make_mesh``. A function, so
that importing this module starts no process group. ``make_production_mesh``
serves the LM substrate and is ported with it (ROADMAP A15).
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    ranks of the default process group (which ``init_device_mesh`` starts
    from the environment, as ``torchrun`` sets it, when none is running).
    On cards, select each rank's card (``torch.cuda.set_device``) first."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
