"""Pooled estimation: same-spec servers share one estimator row.

Counterpart of ``repro/fleet/pool.py``. Per-server estimators are correct
under drift but slow to warm up: every server re-learns the same D-matrix
from only its own completions. :class:`PooledEstimatorBank` makes pooling a
*routing* decision: the underlying :class:`~repro_torch.telemetry.
EstimatorBank` keeps one row per server (its stacked [m, ...] device state
never changes shape), and a server -> row map, applied on the device by the
bank's ``row_map`` hook, decides which row each server's observations
update:

  pooled   every member of a pool maps to the pool's *leader row* (the
           lowest member index); one banked update still consumes the whole
           fleet's telemetry in one pass.
  split    a diverging server is re-routed to its own row, seeded with the
           pool's full posterior (``EstimatorBank.copy_row``). When the
           *leader* splits, the pool migrates to the next member's row
           (seeded the same way) and the leader keeps its own.
  dropped  an evicted server maps to -1: its rows fall into the update's
           dump mask. Reads keep returning its last estimator.

Reads (``estimator_for`` / ``estimate_D``) resolve through the same map.
The JAX package's server-axis helpers (``shard_local_pools``,
``resolve_leaders_device``) wait for the server axis (ROADMAP item 8).
"""
from __future__ import annotations

from typing import Hashable, Sequence

import numpy as np
import torch

from ..telemetry.estimator import EstimatorBank, StreamingEstimator
from ..telemetry.log import RingBlock


class PooledEstimatorBank:
    """An :class:`EstimatorBank` routed through a mutable server -> row map.

    ``pools`` labels each server with a hashable pool id (servers sharing a
    label share a row); ``None`` puts every server in its own pool.
    """

    def __init__(
        self,
        estimators: Sequence[StreamingEstimator],
        pools: Sequence[Hashable] | None = None,
    ):
        self.bank = EstimatorBank(list(estimators))
        m = len(self.bank.estimators)
        if pools is None:
            pools = list(range(m))
        if len(pools) != m:
            raise ValueError(f"{len(pools)} pool labels for {m} estimators")
        leader: dict[Hashable, int] = {}
        self.row_of = np.empty(m, np.int32)  # -1 once dropped
        for s, lab in enumerate(pools):
            self.row_of[s] = leader.setdefault(lab, s)
        self._read_row = self.row_of.copy()  # survives drop() for reads
        self._row_map = self._on_device(self.row_of)
        #: (src_row, dst_row) when the last split()/drop() migrated a pool to
        #: a new leader row, else None -- consumers holding per-row state
        #: keyed on pool rows (the drift detector's centering EWMA) move the
        #: same rows to stay aligned
        self.last_migration: tuple[int, int] | None = None

    def _on_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(rows, np.int32)).to(self.device)

    # -- introspection -----------------------------------------------------
    @property
    def m(self) -> int:
        return len(self.bank.estimators)

    @property
    def device(self) -> torch.device:
        return self.bank.estimators[0].device

    @property
    def estimators(self) -> list[StreamingEstimator]:
        return self.bank.estimators

    def members(self, server: int) -> tuple[int, ...]:
        """Servers currently sharing ``server``'s row (itself included)."""
        row = self.row_of[server]
        if row < 0:
            return ()
        return tuple(int(s) for s in np.flatnonzero(self.row_of == row))

    def pool_size(self, server: int) -> int:
        return len(self.members(server))

    # -- the fused update --------------------------------------------------
    def update_device(self, block: RingBlock, sync: bool = True):
        """One fused observe -> estimate step through the pool map: a pooled
        row consumes every member's rows in the same pass, dropped servers
        contribute nothing. Takes the bank's indexed table update (the
        dense form's values), as the fused closed loop does."""
        return self.bank.update_device(block, sync=sync, row_map=self._row_map,
                                       sparse_tables=True)

    # -- reads -------------------------------------------------------------
    def estimator_for(self, server: int) -> StreamingEstimator:
        """The estimator whose state backs ``server`` (shared when pooled);
        evicted servers keep resolving to their last row."""
        return self.bank.estimators[int(self._read_row[server])]

    def estimate_D(self) -> list[torch.Tensor]:
        """Per-server D estimates, computed once per live row."""
        cache: dict[int, torch.Tensor] = {}
        out = []
        for s in range(self.m):
            row = int(self._read_row[s])
            if row not in cache:
                cache[row] = self.bank.estimators[row].estimate_D()
            out.append(cache[row])
        return out

    def refs(self):
        """(log_b [rows, T], L_t [rows, T, T] target-major, row_map [m]) --
        the pooled model as device tensors, for the drift detector. Reads
        the bank's live stacked state (no member flush, no host read)."""
        st = self.bank.stacked_state()
        return st.log_b, st.L_t, self._row_map

    # -- topology changes (the controller's actions) -----------------------
    def split(self, server: int) -> bool:
        """Split ``server`` out of its pool onto its own row, seeded with
        the pool posterior. Returns False (no-op) when the server is already
        solo or dropped. A leader split records the pool's row move in
        ``last_migration``."""
        self.last_migration = None
        src = int(self.row_of[server])
        if src < 0:
            return False
        group = [s for s in range(self.m) if self.row_of[s] == src]
        if len(group) <= 1:
            return False
        if src == server:
            # the leader is leaving: the pool migrates to a new leader row
            # (seeded from the shared posterior) and the leader keeps src
            rest = [s for s in group if s != server]
            new = min(rest)
            self.bank.copy_row(src, new)
            for s in rest:
                self.row_of[s] = new
                self._read_row[s] = new
            self.last_migration = (src, new)
        else:
            self.bank.copy_row(src, server)
            self.row_of[server] = server
            self._read_row[server] = server
        self._row_map = self._on_device(self.row_of)
        return True

    def adopt_rows(self, row_of, read_row) -> None:
        """Adopt routing computed on the device (the fused closed loop):
        the final maps replace the host mirror whole. Any pending
        ``last_migration`` is cleared: per-row consumer state was already
        moved on the device."""
        self.last_migration = None
        self.row_of = np.asarray(row_of, np.int32).copy()
        self._read_row = np.asarray(read_row, np.int32).copy()
        self._row_map = self._on_device(self.row_of)

    def drop(self, server: int) -> None:
        """Stop routing ``server``'s observations anywhere (eviction). A
        leader with other members hands its pool on first (:meth:`split`,
        recorded in ``last_migration``); reads keep resolving to the last
        live row."""
        self.last_migration = None
        if self.row_of[server] == server and self.pool_size(server) > 1:
            self.split(server)  # leader: detach the survivors first
        self.row_of[server] = -1
        self._row_map = self._on_device(self.row_of)
