"""Collectives over the named axes of a (data, model) mesh: the
counterpart of the ``psum``, ``all_gather`` and reduce-scatter calls that
JAX's ``shard_map`` bodies make and that GSPMD inserts around sharded
products.

A :class:`Mesh` lays the ranks of a ``torch.distributed`` process group
out as JAX's ``make_host_mesh`` does, row-major over ('data', 'model'):
rank = d * model + m. It holds one process group for each axis slice the
rank belongs to ('model', 'data', and both together) and the rank's
coordinates. ``all_reduce``, ``all_gather`` and ``reduce_scatter`` run
over a named axis (or a tuple of names, the entries of a spec); a tuple
concatenates in the spec's order, the first name outermost.

Two forms, chosen from ``dist.get_backend(group)``, never on failure:

* **NCCL**: a group of one rank per card; the native collectives.
* **gloo**: the CPU tests and the card's two-process check. Gloo takes
  CUDA tensors only in ``all_reduce`` and ``broadcast``, so this form
  builds ``all_gather`` and ``reduce_scatter`` from ``all_reduce`` on any
  device: a zero-filled buffer with the rank's own slot written, summed,
  for a gather; the whole tensor summed and the rank's slot sliced, for a
  reduce-scatter. Adding exact zeros changes no value.

A collective that fails raises; nothing gives way to a dense route.

The autograd pairs of Megatron-style tensor parallelism, each a
``torch.autograd.Function`` over one axis:

  ``copy_to``      identity forward, all-reduce backward (Megatron's f:
                   before a column-parallel product of a replicated input)
  ``reduce_from``  all-reduce forward, identity backward (g: after a
                   row-parallel product)
  ``gather_sum``   all-gather forward, reduce-scatter backward (FSDP's
                   gather; each rank's gradient is a partial sum)
  ``gather_from``  all-gather forward, the rank's slice backward (the
                   result feeds replicated compute: every rank's gradient
                   is the whole one)
  ``scatter_to``   the rank's slice forward, all-gather backward

Every collective adds one to :data:`CALLS` under (kind, axis), the way the
kernel wrappers count launches and ``server_axis.CALLS`` counts the
server axis's collectives.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

#: collectives issued, by (kind, axis): kind in all_reduce, all_gather,
#: reduce_scatter; axis the names joined by '+'
CALLS: collections.Counter = collections.Counter()

#: the mesh axes the port lays ranks over, outermost first
AXES = ("data", "model")


def reset_calls() -> None:
    CALLS.clear()


def _names(axes) -> tuple[str, ...]:
    """A spec entry (a name or a tuple of names) as a tuple of names."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) mesh over a process group's ranks.

    sizes     axis name -> size
    coords    axis name -> this rank's index along it
    groups    axis-name tuple -> the process group of this rank's slice
              along those axes (('data',), ('model',), ('data', 'model'))
    backend   the groups' backend, 'nccl' or 'gloo'
    """

    sizes: dict
    coords: dict
    groups: dict
    backend: str

    @classmethod
    def build(cls, data: int, model: int, group: Any = None) -> "Mesh":
        """The mesh of ``data`` x ``model`` over ``group``'s ranks (the
        default group when None), which must number data * model. Every
        rank of ``group`` calls this with the same shape: it makes one
        process group per slice of each axis, in the same order on every
        rank, with ``group``'s backend."""
        group = dist.group.WORLD if group is None else group
        ranks = dist.get_process_group_ranks(group)
        if len(ranks) != data * model:
            raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, the group "
                             f"has {len(ranks)}")
        me = ranks.index(dist.get_rank())
        backend = str(dist.get_backend(group))
        d, m = divmod(me, model)
        groups = {("data", "model"): group}
        for i in range(data):
            g = dist.new_group([ranks[i * model + j] for j in range(model)], backend=backend)
            if i == d:
                groups[("model",)] = g
        for j in range(model):
            g = dist.new_group([ranks[i * model + j] for i in range(data)], backend=backend)
            if j == m:
                groups[("data",)] = g
        return cls(sizes={"data": data, "model": model}, coords={"data": d, "model": m},
                   groups=groups, backend=backend)

    # -- queries -----------------------------------------------------------
    def size(self, axes) -> int:
        n = 1
        for a in _names(axes):
            n *= self.sizes[a]
        return n

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major, the first name
        outermost): the slot its shard takes in a concatenation."""
        i = 0
        for a in _names(axes):
            i = i * self.sizes[a] + self.coords[a]
        return i

    def group(self, axes):
        names = tuple(a for a in AXES if a in _names(axes))
        if names != _names(axes):
            raise ValueError(f"axes {axes!r} are not in the mesh's order {AXES}")
        return self.groups[names]

    @property
    def nccl(self) -> bool:
        return self.backend == "nccl"

    # -- collectives ---------------------------------------------------------
    # The direct collectives carry no gradient (the autograd pairs below do).
    @torch.no_grad()
    def all_reduce(self, x: torch.Tensor, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A new tensor: ``x`` reduced over ``axes`` (sum unless ``op``)."""
        y = x.contiguous().clone()
        dist.all_reduce(y, op=op, group=self.group(axes))
        CALLS[("all_reduce", "+".join(_names(axes)))] += 1
        return y

    @torch.no_grad()
    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in ``axes``' order."""
        n = self.size(axes)
        x = x.contiguous()
        if self.nccl:
            out = x.new_empty((n, *x.shape))
            dist.all_gather_into_tensor(out, x, group=self.group(axes))
        else:
            out = x.new_zeros((n, *x.shape))
            out[self.index(axes)] = x
            dist.all_reduce(out, group=self.group(axes))
        CALLS[("all_gather", "+".join(_names(axes)))] += 1
        return torch.cat(out.unbind(0), dim=dim)

    @torch.no_grad()
    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """``x`` summed over ``axes``, then this rank's slot of ``dim``
        (which the axes' size divides)."""
        n = self.size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
        chunk = x.shape[dim] // n
        if self.nccl:
            parts = x.movedim(dim, 0).contiguous()
            out = parts.new_empty((chunk, *parts.shape[1:]))
            dist.reduce_scatter_tensor(out, parts, group=self.group(axes))
            out = out.movedim(0, dim)
        else:
            y = x.contiguous().clone()
            dist.all_reduce(y, group=self.group(axes))
            out = y.narrow(dim, self.index(axes) * chunk, chunk)
        CALLS[("reduce_scatter", "+".join(_names(axes)))] += 1
        return out.contiguous()

    def local_slice(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """This rank's slot of ``dim`` split over ``axes`` (no collective)."""
        n = self.size(axes)
        chunk = x.shape[dim] // n
        return x.narrow(dim, self.index(axes) * chunk, chunk)


# --- the autograd pairs ---------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_reduce(dy, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.reduce_scatter(dy, ctx.axes, ctx.dim), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.local_slice(dy, ctx.axes, ctx.dim).contiguous(), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.local_slice(x, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_gather(dy, ctx.axes, ctx.dim), None, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, axes)


def gather_sum(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    return _GatherSum.apply(x, mesh, axes, dim)


def gather_from(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, mesh, axes, dim)


def scatter_to(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    return _ScatterTo.apply(x, mesh, axes, dim)
