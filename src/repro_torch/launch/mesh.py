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

``process_mesh`` is what the launchers' ``--mesh DATA,MODEL`` runs on:
the sharded route's ``collectives.Mesh`` over the default process group
the caller started (``torchrun`` sets its environment), NCCL on the card
and gloo on the CPU; without one, a one-rank group.
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


def parse_mesh(spec: str) -> tuple[int, int]:
    """'DATA,MODEL' -> (data, model)."""
    try:
        data, model = (int(x) for x in spec.split(","))
    except ValueError:
        raise ValueError(f"--mesh takes DATA,MODEL, got {spec!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh sizes must be positive, got {spec!r}")
    return data, model


def process_mesh(data: int, model: int, device):
    """The (data, model) ``collectives.Mesh`` over the default process
    group, started here if the caller has not: from ``torchrun``'s
    environment (RANK, WORLD_SIZE, MASTER_ADDR, ...) where it is set, else
    as one rank on an in-process store. The card takes NCCL (each rank on
    cuda:LOCAL_RANK), the CPU gloo; a default group of the other backend
    raises."""
    import os

    import torch
    import torch.distributed as dist

    from ..distributed.collectives import Mesh

    backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        kw = {}
        if device.type == "cuda":
            index = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(index)
            kw["device_id"] = torch.device("cuda", index)
        if "RANK" in os.environ:
            dist.init_process_group(backend, **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    have = str(dist.get_backend())
    if have != backend:
        raise RuntimeError(f"the default process group runs {have!r}; a {device.type} mesh "
                           f"needs {backend!r}")
    return Mesh.build(data, model)
