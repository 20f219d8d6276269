"""Production mesh construction (counterpart of ``repro/launch/mesh.py``)
over ``torch.distributed.device_mesh.init_device_mesh``.

Functions only: importing this module touches no device and no process
group. A mesh spans the ranks of the default process group, one device a
rank, so building one needs a group of exactly its size (the caller
starts it, as ``init_device_mesh`` would from the environment otherwise).

Mesh layout (JAX's axis names and shapes):
  single-pod: (data=16, model=16)              = 256 devices (one pod)
  multi-pod:  (pod=2, data=16, model=16)       = 512 devices (two pods)

The 'model' axis carries TP/EP/SP (intra-pod: NVLink on a GPU pod);
'data' (+'pod') carry DP and the FSDP parameter sharding, so traffic
between pods is only the data-parallel gradient reduction. A mesh is built
on the card ("cuda") unless the caller asks for the CPU.
"""
from __future__ import annotations

from ..configs.base import MeshConfig


def mesh_layout(cfg: MeshConfig) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of ``cfg``'s mesh."""
    if cfg.multi_pod:
        return (cfg.pods, cfg.data, cfg.model), ("pod", "data", "model")
    return (cfg.data, cfg.model), ("data", "model")


def _init(shape: tuple[int, ...], names: tuple[str, ...], device: str):
    from torch.distributed.device_mesh import init_device_mesh

    if device not in ("cuda", "cpu"):
        raise ValueError(f"a mesh is built on cuda or cpu, not {device!r}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    return make_mesh(MeshConfig(multi_pod=multi_pod), device=device)


def make_mesh(cfg: MeshConfig, *, device: str = "cuda"):
    return _init(*mesh_layout(cfg), device)


def make_host_mesh(model_axis: int = 1, *, device: str = "cuda"):
    """A small (data, model) mesh over the default group's ranks
    (tests/examples): data = world size // model_axis."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    data = max(1, n // model_axis)
    return _init((data, model_axis), ("data", "model"), device)
