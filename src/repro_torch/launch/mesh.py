"""Production meshes over ``torch.distributed`` ranks (the reference's
``launch/mesh.py``), and the card's figures the dry run's roofline divides
by.

Defined as FUNCTIONS so importing this module touches no process group.  A
mesh is a :class:`repro_torch.core.mesh.Mesh` over the default process
group, one rank a device: ``torchrun`` with 256 (or 512) ranks on a real
pod, or, with no card, the dry run's fake group of that world in one
process (``launch.dryrun.fake_world``), where the reference forces 512 host
devices.

``LINK_BW`` is one figure for every axis, as the reference's single
``ICI_BW`` is: the network between nodes (the reference's DCN, here
InfiniBand between NVLink domains) is not modelled.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.core.mesh import Mesh, make_mesh

SINGLE_POD = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")

# NVIDIA H100 SXM5 80GB, the card the port runs on (NVIDIA H100 80GB HBM3 at
# its 700 W limit): the NVIDIA data sheet's figures, not measurements
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12              # HBM3 bytes/s per GPU
LINK_BW = 450e9               # NVLink 4 bytes/s per GPU, each direction
HBM_BYTES = 80e9              # HBM3 capacity per GPU


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the default process group, whose
    world must be 256 (or 512).  ``device`` as in ``core.mesh.make_mesh``
    (``cuda`` by default; ``"meta"`` in the dry run's fake world)."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    n = math.prod(shape)
    if _world() != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {_world()}; launch {n} "
            f"ranks with torchrun, or run in a fake group of {n} ranks "
            f"(repro_torch.launch.dryrun.fake_world({n}))")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A small (data, model) mesh for tests and examples over the first
    ``data * model`` ranks of the default process group.  Every rank calls
    it (a mesh over fewer ranks than the world makes a process group,
    which every rank joins); a rank outside the mesh gets None."""
    n = data * model
    if n > _world():
        raise RuntimeError(f"need {n} ranks for mesh ({data}, {model}), have "
                           f"{_world()}")
    if n == _world():
        return make_mesh((data, model), SINGLE_POD_AXES, device=device)
    group = dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return make_mesh((data, model), SINGLE_POD_AXES, group=group,
                     device=device)
