"""CUSUM drift detection on per-server residual streams.

Counterpart of ``repro/fleet/detect.py``. The pooling bet (``fleet.pool``)
is that same-spec servers share one world; this module watches for the
moment that stops being true. Every completion observation yields a *solo
residual* -- the server's own log-rate minus what its pool's model predicts
for that run::

    r = y - (log_b_pool[t] + cbar @ L_pool[:, t])

For a healthy pool member r is zero-mean noise; a diverging server pushes it
persistently to one side. Two statistics per server, folded strictly in
stream order, so that splitting a batch anywhere leaves the state bitwise
identical:

  CUSUM [m, 2]  the one-sided pair S+ = max(0, S+ + (x - k)), S- = max(0,
                S- - (x + k)) on the **pool-centered** residual x = r -
                pool_level_hat, where pool_level_hat is an EWMA of the pool
                row's own residual, kept in the same fold (it cancels model
                error every member shares). Crossing ``h`` is the split
                signal.
  level [m]     an exposure-weighted EWMA of the **raw** residual with its
                exact bias correction ``level / ((1 - decay) n)``: a level at
                or below ``log(fail_floor)`` means the server runs at a
                fraction ``fail_floor`` of its model -- the failure signal,
                whose default floor is ``criteria.eviction_rate_floor()``.

The residuals are computed per row in PyTorch; the fold is the hand-written
CUDA kernel ``kernels.cusum.cusum_scan`` on the card and its plain version
on the CPU. The detector holds no estimator state: the pooled model enters
each update as explicit references (``PooledEstimatorBank.refs``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.criteria import eviction_rate_floor
from ..device import resolve_device
from ..kernels.cusum import CusumState, cusum_scan
from ..telemetry.estimator import _localize_block
from ..telemetry.log import RingBlock


def _cusum_update(
    state: CusumState,
    block: RingBlock,
    log_b: torch.Tensor,  # f32[p, T] pooled base estimates (bank rows)
    L_t: torch.Tensor,  # f32[p, T, T] pooled pair estimates, target-major [t, u]
    row_map: torch.Tensor,  # i32[m] server -> bank row (-1 drops the server)
    *,
    k: float,
    level_decay: float,
    max_lost_frac: float,
) -> tuple[CusumState, torch.Tensor]:
    """Fold one block of observation rows into the detector state.

    Residuals are computed per row (each is independent); the accumulation
    is the scan kernel, in stream order. Rows outside [0, m), unmapped,
    voided or past the lost-frac filter change nothing. Returns the new
    state and the rows consumed (a device scalar); nothing is read back."""
    m = state.level.shape[0]
    p, T = log_b.shape
    srv = block.server
    valid = block.valid & (block.lost_frac <= max_lost_frac)
    valid = valid & (srv >= 0) & (srv < m)
    s_clip = torch.clamp(srv, 0, m - 1)
    row = row_map[s_clip.long()]
    valid = valid & (row >= 0) & (row < p)
    r_clip = torch.clamp(row, 0, p - 1).long()
    t_clip = torch.clamp(block.wtype, 0, T - 1).long()
    pred = log_b[r_clip, t_clip] + (block.co * L_t[r_clip, t_clip]).sum(dim=1)
    resid = block.y - pred  # [B]
    rows_n = state.pool_level.shape[0]
    r_idx = torch.clamp(r_clip, 0, rows_n - 1).to(torch.int32)
    new = cusum_scan(state, s_clip.to(torch.int32).contiguous(), r_idx.contiguous(),
                     resid.contiguous(), valid.contiguous(), k=k, level_decay=level_decay)
    return new, valid.sum()


def cusum_update_sharded(axis, state: CusumState, block: RingBlock, log_b, L_t, row_map, *,
                         k: float, level_decay: float, max_lost_frac: float):
    """``_cusum_update`` with the detector rows and the pooled tables
    sharded over a ``ServerAxis``.

    Global in, global out. Requires pool locality (DESIGN.md section 15):
    every pool lies whole inside one rank, so ``row_map[s]`` points into the
    rank owning server ``s``. Each rank folds the whole replicated block in
    stream order through the ``cusum_scan`` kernel on its own rows, with
    ``row_map`` sliced and rebased and the off-rank rows masked by the
    range check: every (server, pool row) state sees exactly the dense
    sequence of updates. One ``psum`` counts the rows consumed; the state
    is gathered on exit. A dense axis is ``_cusum_update`` itself."""
    if not axis.is_sharded:
        return _cusum_update(state, block, log_b, L_t, row_map, k=k, level_decay=level_decay,
                             max_lost_frac=max_lost_frac)
    m = row_map.shape[0]
    axis.validate(m)
    m_local = axis.local_m(m)
    lo = axis.offset(m_local)
    new, used = _cusum_update(axis.local(state, m), _localize_block(block, lo),
                              axis.local(log_b, m), axis.local(L_t, m),
                              row_map.narrow(0, lo, m_local) - lo,
                              k=k, level_decay=level_decay, max_lost_frac=max_lost_frac)
    return axis.gather(new, m_local), axis.psum(used)


def _reset_rows(state: CusumState, servers: torch.Tensor) -> CusumState:
    # per-server state only: pool_level rows are shared (a split or evicted
    # server's *new* row starts zeroed anyway; its old pool keeps its own)
    stat, level, n = state.stat.clone(), state.level.clone(), state.n.clone()
    stat[servers] = 0.0
    level[servers] = 0.0
    n[servers] = 0.0
    return state._replace(stat=stat, level=level, n=n)


def _reset_stat_rows(state: CusumState, servers: torch.Tensor) -> CusumState:
    stat = state.stat.clone()
    stat[servers] = 0.0
    return state._replace(stat=stat)


def _move_pool_row(state: CusumState, src: int, dst: int) -> CusumState:
    lvl, n = state.pool_level.clone(), state.pool_n.clone()
    lvl[dst], n[dst] = state.pool_level[src], state.pool_n[src]
    lvl[src], n[src] = 0.0, 0.0
    return state._replace(pool_level=lvl, pool_n=n)


@dataclasses.dataclass
class DriftDetector:
    """Per-server CUSUM + residual-level detector (see module docstring).

    Parameters are the JAX detector's: ``m`` fleet size; ``k`` the CUSUM
    allowance and ``h`` its split threshold, in log-slowdown units;
    ``level_decay`` the per-observation EWMA decay of the failure level;
    ``fail_floor`` the observed/predicted rate ratio at or below which a
    server is failing (default ``criteria.eviction_rate_floor()``);
    ``min_exposure`` the decayed observations required before the failure
    signal may fire; ``max_lost_frac`` the estimator's TDP-overflow filter.
    ``device`` holds the state (``None``: the card).
    """

    m: int
    k: float = 0.25
    h: float = 2.0
    level_decay: float = 0.9
    fail_floor: float | None = None
    min_exposure: float = 4.0
    max_lost_frac: float = 0.5
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.fail_floor is None:
            self.fail_floor = eviction_rate_floor()
        if not 0.0 < self.fail_floor < 1.0:
            raise ValueError(f"fail_floor must be in (0, 1), got {self.fail_floor}")
        self.device = resolve_device(self.device)
        self.state = CusumState.zeros(self.m, device=self.device)

    # -- updates -----------------------------------------------------------
    def update(self, block: RingBlock, log_b, L_t, row_map, sync: bool = True):
        """Consume one observation block against the pooled model refs
        (``PooledEstimatorBank.refs``). Returns rows consumed: a Python int
        when ``sync``, else the device scalar."""
        row_map = torch.as_tensor(row_map, dtype=torch.int32).to(self.device)
        self.state, used = _cusum_update(
            self.state, block, log_b, L_t, row_map, k=float(self.k),
            level_decay=float(self.level_decay), max_lost_frac=float(self.max_lost_frac))
        return int(used) if sync else used

    def _servers(self, server: "int | Sequence[int]") -> torch.Tensor:
        return torch.as_tensor(np.atleast_1d(np.asarray(server, np.int64)), device=self.device)

    def reset(self, server: "int | Sequence[int]") -> None:
        """Zero a server's detector rows (after a split or an eviction, so
        the acted-on evidence does not immediately re-fire)."""
        self.state = _reset_rows(self.state, self._servers(server))

    def reset_all(self) -> None:
        """Zero the whole detector (end of the controller's warm-up)."""
        self.state = CusumState(*(torch.zeros_like(a) for a in self.state))

    def move_pool_row(self, src: int, dst: int) -> None:
        """Move one pool's centering EWMA to a new row (leader split/drop)."""
        self.state = _move_pool_row(self.state, int(src), int(dst))

    def reset_stat(self, server: "int | Sequence[int]") -> None:
        """Zero only the CUSUM pair, keeping the failure level."""
        self.state = _reset_stat_rows(self.state, self._servers(server))

    # -- host-side reads ---------------------------------------------------
    def stat_max(self) -> np.ndarray:
        """max(S+, S-) per server -- the split statistic [m]."""
        return self.state.stat.cpu().numpy().max(axis=1)

    def split_flags(self) -> np.ndarray:
        """Servers whose CUSUM crossed ``h`` (bool [m])."""
        return self.stat_max() >= self.h

    def exposure(self) -> np.ndarray:
        """Decayed observation count behind the failure level [m]."""
        return self.state.n.cpu().numpy().astype(np.float64)

    def level_hat(self) -> np.ndarray:
        """Bias-corrected running mean of the residual per server [m];
        servers with no exposure read 0."""
        n = self.exposure()
        denom = np.maximum((1.0 - self.level_decay) * n, 1e-12)
        out = self.state.level.cpu().numpy().astype(np.float64) / denom
        return np.where(n > 0, out, 0.0)

    def fail_flags(self, center: float | np.ndarray = 0.0) -> np.ndarray:
        """Servers running at or below ``fail_floor`` x reference (bool [m]),
        gated on ``min_exposure``; ``center`` shifts the reference (the fleet
        controller passes the fleet-median level)."""
        lvl = self.level_hat()
        return (self.exposure() >= self.min_exposure) & (
            lvl - center <= float(np.log(self.fail_floor)))
