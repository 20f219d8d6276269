"""ServerAxis: one switch for dense-replicated vs rank-sharded server state.

Counterpart of ``repro/distributed/server_axis.py``. Every layer of the
consolidation plane owns at least one ``[m, ...]`` tensor (the pairwise-D
tables of :class:`~repro_torch.core.binpack_torch.PackedCluster`, the stacked
estimator bank rows, CUSUM state, per-server metric columns). At rack width
those live replicated on one card; at fleet width the D stack and the Q x m
scorer can be spread over several. :class:`ServerAxis` names the layout once
so each layer is written a single time:

``ServerAxis()`` (dense, :data:`DENSE`)
    ``group is None``. Every helper is the identity when the code runs -- no
    ``- 0`` offset, no size-1 collective -- so a program threaded through a
    dense axis dispatches exactly the operators of the unthreaded code.

``ServerAxis(group=...)`` (sharded)
    SPMD over a ``torch.distributed`` process group, where JAX's wraps a
    ``shard_map`` over a mesh. Every rank calls the same entry point with the
    same global arguments, takes its own leading slice of each ``[m, ...]``
    tensor (:meth:`local`, a view), runs the per-shard body with each
    collective at the site where JAX calls it, and gathers each ``[m, ...]``
    output once on exit (:meth:`gather`). The decision plane (placements,
    queue flags, rings, counters) comes out replicated on every rank. The
    contract for exactness (DESIGN.md section 15): per-server arithmetic is
    shard-local and equal to the dense rows, and only order-insensitive
    scalars (min / max / single-owner sums) cross ranks.

A one-rank group is *not* dense: its collectives are called, as JAX's
``over_host_devices(1)`` still runs the full ``shard_map`` path. No helper
falls back to the dense path: a collective that fails raises.

Every collective adds one to :data:`CALLS` under its kind, the way the
kernel wrappers count launches; the event loop moves the counts a captured
block makes into a per-replay tally.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..device import resolve_device

#: collectives issued, by kind ("pmin", "pmax", "psum", "any", "all_gather")
CALLS: collections.Counter = collections.Counter()


def reset_calls() -> None:
    CALLS.clear()


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """One all-gather of ``x`` into ``out`` (ranks concatenated on dim 0).
    ``all_gather_single`` where the running torch has it (2.13 deprecates
    the older name), else ``all_gather_into_tensor``."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


@dataclasses.dataclass(frozen=True)
class ServerAxis:
    """How the server dimension ``m`` is laid out across ranks.

    group
        ``None`` for the dense-replicated layout; otherwise the
        ``torch.distributed`` process group whose ranks each own one
        contiguous slice of the servers (rank r owns ``[r m_l, (r+1) m_l)``).
    pods
        Scheduler pods for the hierarchical greedy (independent of the
        group: one card may still schedule hierarchically, and each rank owns
        ``pods // shards`` whole pods). ``1`` disables the hierarchy.
    """

    group: Any = None
    pods: int = 1

    # -- layout queries ----------------------------------------------------
    @property
    def is_sharded(self) -> bool:
        return self.group is not None

    @property
    def shards(self) -> int:
        return 1 if self.group is None else self.group.size()

    def local_m(self, m: int) -> int:
        return m // self.shards

    def validate(self, m: int) -> "ServerAxis":
        """Divisibility contract: shards | pods | m (each pod whole within
        one rank, each rank an integer number of servers)."""
        if m % max(self.pods, 1):
            raise ValueError(f"m={m} not divisible by pods={self.pods}")
        if self.is_sharded:
            if m % self.shards:
                raise ValueError(f"m={m} not divisible by shards={self.shards}")
            if self.pods > 1 and self.pods % self.shards:
                raise ValueError(f"pods={self.pods} not divisible by shards={self.shards}")
        return self

    def index(self) -> int:
        """This rank's shard index (0 when dense)."""
        return 0 if self.group is None else self.group.rank()

    def offset(self, m_local: int) -> int:
        """Global index of this rank's first server (0 when dense). A host
        int: the rank is known on the host, so the offset costs no device
        operation (JAX's is traced)."""
        return self.index() * m_local

    # -- collectives (identity when dense) ---------------------------------
    def _reduce(self, x: torch.Tensor, op, kind: str) -> torch.Tensor:
        y = x.clone()  # contiguous, and the caller's tensor is left as it was
        dist.all_reduce(y, op=op, group=self.group)
        CALLS[kind] += 1
        return y

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.group is None else self._reduce(x, dist.ReduceOp.MIN, "pmin")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.group is None else self._reduce(x, dist.ReduceOp.MAX, "pmax")

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.group is None else self._reduce(x, dist.ReduceOp.SUM, "psum")

    def any(self, x: torch.Tensor) -> torch.Tensor:
        """Global boolean any over the ranks (bools sum as int32, as JAX)."""
        if self.group is None:
            return x
        return self._reduce(x.to(torch.int32), dist.ReduceOp.SUM, "any") > 0

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along dim 0 (JAX's ``tiled``)."""
        if self.group is None:
            return x
        out = x.new_empty((x.shape[0] * self.shards, *x.shape[1:]))
        _gather_into(out, x.contiguous(), self.group)
        CALLS["all_gather"] += 1
        return out

    # -- the one layout rule of DESIGN.md section 15 -------------------------
    def local(self, tree, m: int):
        """``tree`` with every tensor whose leading dim is ``m`` narrowed to
        this rank's rows (a view); everything else is replicated and kept.
        The dense axis returns ``tree`` itself."""
        if self.group is None:
            return tree
        m_l = self.local_m(m)
        lo = self.offset(m_l)
        return _map(lambda x: x.narrow(0, lo, m_l) if _leads(x, m) else x, tree)

    def gather(self, tree, m_local: int):
        """The exit gather: every tensor whose leading dim is ``m_local``
        all-gathered to the global ``[m, ...]`` (one collective per field).
        The dense axis returns ``tree`` itself."""
        if self.group is None:
            return tree
        return _map(lambda x: self.all_gather(x) if _leads(x, m_local) else x, tree)

    # -- constructors ------------------------------------------------------
    @classmethod
    def over_process_group(cls, pods: int = 1,
                           device: str | torch.device | None = None) -> "ServerAxis":
        """The axis over the default process group (counterpart of JAX's
        ``over_host_devices``): the group ``torch.distributed`` already has,
        or else a one-rank group on an in-process ``HashStore`` (no TCP).
        ``device`` names where the collectives run, as every entry point
        resolves it: ``None`` is the card (NCCL; raises without one), the CPU
        gets gloo. A default group of the other backend raises: nothing gives
        way to gloo on the card."""
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if not dist.is_initialized():
            kw = {}
            if dev.type == "cuda":
                index = torch.cuda.current_device() if dev.index is None else dev.index
                torch.cuda.set_device(index)
                kw["device_id"] = torch.device("cuda", index)
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    **kw)
        group = dist.group.WORLD
        have = str(dist.get_backend(group))
        if backend not in have:
            raise RuntimeError(f"the default process group runs {have!r}; a {dev.type} axis "
                               f"needs {backend!r}")
        return cls(group=group, pods=pods)


#: the dense-replicated axis: the default everywhere, the unthreaded program
DENSE = ServerAxis()


def check_axis(axis) -> "ServerAxis | None":
    """``axis`` when it is None or a :class:`ServerAxis`; raises TypeError
    for anything else (an entry point never guesses a layout)."""
    if axis is not None and not isinstance(axis, ServerAxis):
        raise TypeError(f"axis must be a ServerAxis or None, not {type(axis).__name__}")
    return axis


def is_sharded(axis) -> bool:
    return check_axis(axis) is not None and axis.is_sharded


def _leads(x, m: int) -> bool:
    return torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == m


def _map(fn, tree):
    """``fn`` on every tensor of a dataclass / NamedTuple / tuple / list /
    dict tree; other leaves are kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree
