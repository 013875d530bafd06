"""Production mesh builder (counterpart of ``repro/launch/mesh.py``) and
the card's roofline constants.

The reference's production mesh is a TPU pod, ``(16, 16)`` over ``(data,
model)``; the port's is a ``DeviceMesh`` over the ranks of the initialized
process group, ``(world // model, model)`` over ``(data, model)``. A
function, so that importing never touches the process group.
"""
from __future__ import annotations

import torch

# the NVIDIA H100 SXM data sheet's figures, per card
PEAK_FLOPS_BF16 = 989.4e12     # dense BF16 Tensor Core (1,979 with sparsity)
HBM_BW = 3.35e12               # HBM3 bytes/s
NVLINK_BW = 900e9              # NVLink bytes/s, both directions together


def make_production_mesh(*, model: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the default process group, rank
    ``r`` at position ``r`` of the grid. Every rank must call it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"{world} ranks do not factor into a model axis "
                         f"of {model}")
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(world // model, model),
                      mesh_dim_names=("data", "model"))
