"""Device meshes: the data-parallel fit's and the LM substrate's.

Counterpart of ``repro/launch/mesh.py``. Functions, so that importing this
module starts no process group.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``: a world of
    256 or 512 ranks, one a card. The dry run passes ``"cpu"``, on a fake
    world of that many ranks in one process (``launch.dryrun``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    ranks of the default process group (which ``init_device_mesh`` starts
    from the environment, as ``torchrun`` sets it, when none is running).
    On cards, select each rank's card (``torch.cuda.set_device``) first."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
