"""Consolidation-aware input-pipeline placement: the paper's algorithm
applied to its *original* domain inside this framework -- deciding which
input hosts run which data-loading workers.

Each TokenPipeline rank is a data-intensive workload characterized exactly
as the paper prescribes (FS = chunk size, RS = request size, op = read);
input hosts are ServerSpec bins. The same greedy that packs TestDFSIO tasks
admits loader ranks so that no host's loaders degrade past 50% -- which is
precisely the condition under which the training job's input pipeline stops
being able to hide behind compute.

Copied from ``repro/data/placement.py``. The JAX module takes
``greedy_sequence`` from ``repro.core``, which is the float64 oracle's; the
port's ``repro_torch.core.greedy_sequence`` is the device greedy, with
another signature, so the oracle's copy is imported from ``core.binpack``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.binpack import ClusterState, greedy_sequence  # the float64 oracle's
from ..core.contention import profile_pairwise_fast
from ..core.server import ServerSpec
from ..core.workload import Workload, snap_to_grid
from .chunkstore import ChunkStore


@dataclasses.dataclass(frozen=True)
class LoaderPlacement:
    rank: int
    host: int | None  # None = queued (input fleet saturated)


def place_loaders(
    store: ChunkStore,
    n_ranks: int,
    hosts: list[ServerSpec],
    request_bytes: int = 256 * 1024,
    alpha: float = 1.3,
) -> tuple[list[LoaderPlacement], ClusterState]:
    """Pack ``n_ranks`` loader workers onto input hosts with the Fig-8 greedy."""
    D = [profile_pairwise_fast(h) for h in hosts]
    state = ClusterState.empty(hosts, D, alpha=alpha)
    w = snap_to_grid(store.as_workload(request_bytes))
    placements, _ = greedy_sequence(state, [w] * n_ranks)
    return [LoaderPlacement(r, p) for r, p in enumerate(placements)], state


def max_safe_ranks_per_host(
    store: ChunkStore, host: ServerSpec, request_bytes: int = 256 * 1024,
    alpha: float = 1.3,
) -> int:
    """Criterion-1 capacity: how many loader ranks one host sustains <50%."""
    D = [profile_pairwise_fast(host)]
    state = ClusterState.empty([host], D, alpha=alpha)
    w = snap_to_grid(store.as_workload(request_bytes))
    placements, _ = greedy_sequence(state, [w] * 64)
    return sum(1 for p in placements if p is not None)
