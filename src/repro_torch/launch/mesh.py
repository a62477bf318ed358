"""Production mesh construction.

Port of `repro/launch/mesh.py`. The meshes are `DeviceMesh`es over a
`torch.distributed` process group; every function builds on call, and
importing the module touches no `torch.distributed` state. Single pod:
256 ranks as (data=16, model=16). Multi-pod: 512 ranks as (pod=2,
data=16, model=16); the 'pod' axis extends data parallelism across the
inter-pod links. The group comes from the caller: `torchrun` on a
cluster, or the fake group of an abstract pass (`launch/dryrun.py`).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" first, over
    the ranks of the default process group (which must hold at least 256
    or 512)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cpu"):
    """A 1 x 1 ("data", "model") mesh over this process, for smoke runs.
    Without a process group it first makes a single-rank one (gloo over
    an in-process store)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
