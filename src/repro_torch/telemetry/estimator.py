"""Streaming recovery of the scheduler's D-matrix from completion telemetry.

Counterpart of ``repro/telemetry/estimator.py``. Two update paths
implement the same estimator, as in the JAX package:

  ``update``         float64, consuming an ``ObservationLog``; the reference
                     semantics, and the host-alternating loop's path.
  ``update_device``  the device-resident stream: one fused float32 step
                     (``_bank_core``) consuming a validity-masked
                     ``RingBlock``, with no read back to the host;
                     ``EstimatorBank`` runs it for m per-server estimators
                     at once, with one banked scatter over the combined
                     (server, type) key space. The state stays on the
                     device between calls, target-major
                     (``DeviceEstimatorState``), and the float64 fields
                     follow it lazily when an estimate is read.

Estimation happens in log-slowdown space, where the ground truth is linear:
a type-t run whose time-averaged co-resident counts were ``cbar`` satisfies
(keep-cache regime)

  y  :=  log(rate)  =  log b_t  +  sum_u cbar_u * L[u, t],      L = log(1 - d)

Solo runs -- the only unbiased base signal -- update ``log_b``; co-run
residuals against the freshly updated base take one damped, exposure-weighted
least-squares step on ``L`` alone. Per-pair confidence counts accumulate
alongside; below a confidence floor the estimate falls back to a prior, and
an exposure-based EWMA ``decay`` (``decay ** n`` per batch of n used
observations, with matching triangular weights inside the batch) lets fresh
evidence overturn stale estimates after a drift, independently of how
callers chunk the stream.

The canonical state (``L``, ``log_b``, ``n_pair``, ``n_base`` and the two
priors) lives as float64 tensors on the estimator's device. The batched
pair-statistic scatter -- the only O(B T) loop -- goes through one of three
backends:

  scatter='cuda'   the hand-written kernel, the default; it needs a CUDA
                   device. ``update`` launches its contract entry
                   (``kernels.telemetry.pair_scatter``), ``update_device``
                   its banked entry (``pair_scatter_banked``);
  scatter='torch'  their plain PyTorch versions (one-hot contractions);
  scatter='numpy'  the float64 reference (``kernels.ref.pair_scatter_ref``)
                   in ``update``; ``update_device`` maps it to the plain
                   banked version, as the JAX package maps it to its jnp
                   contraction.

The 'cuda' and 'torch' backends take their inputs in float32; ``update``
hands their outputs back in float64, as the JAX package's Pallas backend
does. Nothing switches backend silently: a CPU device needs 'torch' or
'numpy' named.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ref import pair_scatter_ref
from ..kernels.telemetry import (pair_scatter, pair_scatter_banked,
                                 pair_scatter_banked_torch, pair_scatter_torch)
from .log import ObservationLog, RingBlock

ScatterName = Literal["cuda", "torch", "numpy"]

#: scatter contract: (types i32[B], cbar f64[B, T], vals f64[K, B]) ->
#: (pair f64[K, T, T], base f64[K, T]), tensors on the inputs' device, with
#: pair[k, u, t] = sum_b cbar[b, u] vals[k, b] 1{t_b = t}
Scatter = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]


def _f32(types, cbar, vals):
    return (types.to(torch.int32).contiguous(), cbar.to(torch.float32).contiguous(),
            vals.to(torch.float32).contiguous())


def _scatter_cuda(types, cbar, vals):
    if cbar.device.type != "cuda":
        raise ValueError(f"scatter='cuda' needs CUDA tensors, got {cbar.device}")
    pair, base = pair_scatter(*_f32(types, cbar, vals))
    return pair.to(torch.float64), base.to(torch.float64)


def _scatter_torch(types, cbar, vals):
    pair, base = pair_scatter_torch(*_f32(types, cbar, vals))
    return pair.to(torch.float64), base.to(torch.float64)


def _scatter_numpy(types, cbar, vals):
    pair, base = pair_scatter_ref(types.cpu().numpy(), cbar.cpu().numpy(),
                                  vals.cpu().numpy())
    dev = cbar.device
    return torch.from_numpy(pair).to(dev), torch.from_numpy(base).to(dev)


_SCATTERS: dict[str, Scatter] = {
    "cuda": _scatter_cuda, "torch": _scatter_torch, "numpy": _scatter_numpy}


def make_scatter(backend: ScatterName = "cuda") -> Scatter:
    """Resolve a pair-statistic scatter backend to the shared contract."""
    if backend not in _SCATTERS:
        raise ValueError(f"unknown scatter backend {backend!r}")
    return _SCATTERS[backend]


class DeviceEstimatorState(NamedTuple):
    """The estimator's mutable state as float32 device tensors
    (``update_device``).

    The pair tables are **target-major** ([t, u], the transpose of the
    canonical [u, t]): the fused step reads each observation's coefficient
    row ``L_t[t_b]`` as one contiguous row, and the banked scatter's rows
    land without a transpose. ``device_state`` and ``_pull`` transpose at the
    boundary only. The step builds new tensors and never writes these in
    place, so a state can be shared (a bank row, an exported posterior).
    """

    L_t: torch.Tensor  # f32[T, T] log(1 - d) estimate, transposed ([t, u])
    log_b: torch.Tensor  # f32[T] log base-throughput estimate
    n_pair_t: torch.Tensor  # f32[T, T] decayed per-pair exposure, transposed
    n_base: torch.Tensor  # f32[T] decayed per-type solo counts
    n_obs: torch.Tensor  # i32 scalar observations consumed


def _blend_prior_t(L_t, n_pair_t, L_prior_t, confidence_floor):
    """``estimate_D``'s confidence blend, target-major: below the floor the
    pair estimate falls back linearly (in accumulated exposure) to the
    prior."""
    w = torch.clamp(n_pair_t / confidence_floor, max=1.0)
    return w * L_t + (1.0 - w) * L_prior_t


def _bank_core(
    state: DeviceEstimatorState,  # tensors carry a leading bank-row axis [m, ...]
    block: RingBlock,
    *,
    lr: float,
    decay: float,
    step_damp: float,
    solo_eps: float,
    max_lost_frac: float,
    scatter: ScatterName,
    sparse_tables: bool = False,
) -> tuple[DeviceEstimatorState, torch.Tensor]:
    """The fused observe -> estimate step: m per-row estimators, one pass.

    The float32 arithmetic of the JAX package's ``_bank_core``, which
    mirrors ``StreamingEstimator.update`` independently per row: the lost-
    frac filter, exposure-based decay with **per-row** triangular weights
    (a server's half-life counts its own observations), solo-then-co
    ordering (co residuals see the freshly updated base), on masked
    fixed-shape rows. Each row updates only the bank row its ``server``
    column names. The co-run statistics come from one banked scatter over
    the combined key space (row * T + type; ``scatter='cuda'`` launches the
    kernel, otherwise its plain version), which returns only the touched
    (row, type) rows.

    ``sparse_tables`` applies those rows to the [m, T, T] tables by index
    and decays only the rows present, O(B T) plus the touched servers'
    tables; the dense form forms the full [2, m, T, T] statistics first, as
    the JAX package's GPU lowering does. The two give the same values:
    untouched entries skip a ``* 1.0`` and a ``+ 0.0``. Returns
    (new_state, rows used) with the count as a device scalar.
    """
    L_t, log_b, n_pair_t, n_base, n_obs = state
    m, T = log_b.shape
    dev = log_b.device
    f32 = torch.float32
    server = block.server
    valid = block.valid & (block.lost_frac <= max_lost_frac)
    valid = valid & (server >= 0) & (server < m)
    s_clip = torch.clamp(server, 0, m - 1).long()
    onehot_s = (torch.arange(m, device=dev)[None, :] == s_clip[:, None]) & valid[:, None]
    n_used = onehot_s.sum(dim=0, dtype=torch.int32)  # [m] rows per bank row

    if decay < 1.0:
        # decay^(n_used[s] - rank within s): the host path's triangular
        # weights, so the confidence state does not depend on how the stream
        # is chunked
        rank = torch.cumsum(onehot_s.to(f32), dim=0)  # [B, m]
        dec = torch.full((), decay, dtype=f32, device=dev)  # a fill, not a host copy
        w_bm = torch.where(onehot_s, torch.pow(dec, n_used[None, :].to(f32) - rank),
                           torch.zeros((), dtype=f32, device=dev))
        w = w_bm.sum(dim=1)  # [B]: a row has at most one bank-row column
        sdecay = torch.pow(dec, n_used.to(f32))  # [m]
        if sparse_tables:
            # decay the tables of the rows present only: a fixed-size list of
            # min(m, B) rows, padded with copies of its first entry (which
            # write the same values again)
            first = (onehot_s & (rank == 1.0)).any(dim=1)
            present = torch.sort(torch.where(first, s_clip, m)).values[:min(m, len(s_clip))]
            fill = torch.where(present[:1] < m, present[:1], 0)  # no row: server 0, x 1.0
            present = torch.where(present < m, present, fill)
            n_pair_t = n_pair_t.index_copy(
                0, present, n_pair_t[present] * sdecay[present][:, None, None])
        else:
            n_pair_t = n_pair_t * sdecay[:, None, None]
        n_base = n_base * sdecay[:, None]
    else:
        w = valid.to(f32)

    wtype = block.wtype
    t_clip = torch.clamp(wtype, 0, T - 1).long()
    co_sum = block.co_sum  # materialized at row birth (RingBlock)
    solo = valid & (co_sum <= solo_eps)

    # solo runs anchor the base; other rows land in a dump slot (index T)
    # that is sliced away, both statistics in one scatter
    t_solo = torch.where(solo & (wtype >= 0) & (wtype < T), wtype.long(), T)
    r0 = block.y - log_b[s_clip, t_clip]
    ws = torch.where(solo, w, torch.zeros_like(w))
    acc0 = torch.zeros((m * (T + 1), 2), dtype=f32, device=dev).index_add(
        0, s_clip * (T + 1) + t_solo, torch.stack([ws * r0, ws], dim=1))
    acc0 = acc0.view(m, T + 1, 2)
    num0, cnt0 = acc0[:, :T, 0], acc0[:, :T, 1]
    log_b = log_b + lr * num0 / (cnt0 + step_damp)
    n_base = n_base + cnt0

    # co-run residuals against the *updated* base take the LMS step on L
    is_co = valid & (co_sum > solo_eps)
    co = block.co
    pred = log_b[s_clip, t_clip] + (co * L_t[s_clip, t_clip]).sum(dim=1)
    xnorm = torch.clamp(block.co_sq, min=solo_eps)
    h = (block.y - pred) / xnorm
    wc = torch.where(is_co, w, torch.zeros_like(w))
    keep = is_co & (wtype >= 0) & (wtype < T)
    keys = torch.where(keep, s_clip * T + wtype.long(), -1).to(torch.int32)
    stats = torch.stack([wc * h, wc])  # residual numerator + exposure weight
    scatter_fn = pair_scatter_banked if scatter == "cuda" else pair_scatter_banked_torch
    rows, slot_keys = scatter_fn(keys, co.contiguous(), stats.contiguous(), m * T)
    # slots past the last key hold zeros: aim them at the last row, which
    # their + 0.0 leaves as it is
    idx = torch.clamp(slot_keys.long(), max=m * T - 1)
    if sparse_tables:
        delta = lr * rows[0] / (rows[1] + step_damp)
        L_t = L_t.reshape(m * T, T).index_add(0, idx, delta).view(m, T, T)
        n_pair_t = n_pair_t.reshape(m * T, T).index_add(0, idx, rows[1]).view(m, T, T)
    else:
        pair_t = torch.zeros((2, m * T, T), dtype=f32, device=dev).index_add(1, idx, rows)
        pair_t = pair_t.view(2, m, T, T)
        L_t = L_t + lr * pair_t[0] / (pair_t[1] + step_damp)
        n_pair_t = n_pair_t + pair_t[1]

    new = DeviceEstimatorState(L_t, log_b, n_pair_t, n_base, n_obs + n_used)
    return new, n_used.sum()


def _update_device(state: DeviceEstimatorState, block: RingBlock, server: int,
                   **hypers) -> tuple[DeviceEstimatorState, torch.Tensor]:
    """Single-estimator fused update: ``_bank_core`` as a bank of one. Rows
    placed on ``server`` (every row when ``server < 0``) go to bank row 0;
    the rest drop inside the core's validity mask."""
    sel = block.server == server if server >= 0 else torch.ones_like(block.server, dtype=torch.bool)
    block = block._replace(ints=torch.stack(
        [block.wtype, torch.where(sel, 0, -1).to(torch.int32)], dim=1))
    lifted = DeviceEstimatorState(*(a[None] for a in state))
    new, used = _bank_core(lifted, block, **hypers)
    return DeviceEstimatorState(*(a[0] for a in new)), used


@dataclasses.dataclass
class StreamingEstimator:
    """Online (base-rate, D-matrix) estimator for one server.

    Parameters are those of the JAX package's estimator (see its docstring):
    ``T`` grid size; ``prior_D`` a [T, T] matrix or a scalar uniform prior;
    ``prior_solo`` per-type solo throughput prior [T] (``None``: 1 byte/s);
    ``lr`` damping of each batch's step; ``decay`` per-observation EWMA
    forgetting of the confidence; ``confidence_floor`` exposure below which
    ``estimate_D`` blends toward the prior; ``max_lost_frac`` observations
    past the TDP for longer than this fraction of their run are dropped.
    ``scatter`` names the pair-statistic backend, ``device`` where the state
    lives (``None``: the card, raising without one).
    """

    T: int
    prior_D: float | np.ndarray = 0.0
    prior_solo: np.ndarray | None = None
    lr: float = 0.5
    decay: float = 1.0
    confidence_floor: float = 4.0
    max_lost_frac: float = 0.5
    scatter: ScatterName = "cuda"
    #: exposure added to the step denominator: damps updates from batches
    #: whose total exposure to a pair is far below one full co-run
    step_damp: float = 0.5
    #: co-resident exposure below which a run counts as a *solo* observation
    solo_eps: float = 0.05
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._scatter = make_scatter(self.scatter)
        if self.scatter == "cuda" and self.device.type != "cuda":
            raise ValueError(f"scatter='cuda' runs on a CUDA device, not "
                             f"{self.device}; name scatter='torch' or 'numpy'")
        # priors in float64 numpy, as the JAX package computes them, then
        # one copy to the device
        prior = self.prior_D
        if np.isscalar(prior):
            prior = np.full((self.T, self.T), float(prior))
        prior = np.clip(np.asarray(prior, np.float64), 0.0, 1.0 - 1e-9)
        logb = (np.zeros(self.T) if self.prior_solo is None
                else np.log(np.asarray(self.prior_solo, np.float64)))
        dev = self.device
        self._L_prior = torch.from_numpy(np.log1p(-prior)).to(dev)  # log(1 - d) prior
        self._logb_prior = torch.from_numpy(logb).to(dev)
        # canonical float64 state; a float32 device mirror takes over between
        # update_device calls and the fields it is ahead of are pulled lazily
        self._L = self._L_prior.clone()
        self._log_b = self._logb_prior.clone()
        self._n_pair = torch.zeros((self.T, self.T), dtype=torch.float64, device=dev)
        self._n_base = torch.zeros(self.T, dtype=torch.float64, device=dev)
        self._n_obs = 0
        self._dev: DeviceEstimatorState | None = None
        self._stale: set[str] = set()  # canonical fields behind the mirror
        self._bank: EstimatorBank | None = None  # the bank holding this member
        self._hypers = dict(
            lr=float(self.lr), decay=float(self.decay), step_damp=float(self.step_damp),
            solo_eps=float(self.solo_eps), max_lost_frac=float(self.max_lost_frac),
            scatter="cuda" if self.scatter == "cuda" else "torch")

    # -- canonical <-> device state ---------------------------------------
    #: canonical field names, in device-state order
    _FIELDS = ("L", "log_b", "n_pair", "n_base", "n_obs")

    def _mutated(self) -> None:
        """This estimator's state moved ahead of any bank's stacked copy."""
        if self._bank is not None:
            self._bank._invalidate()

    def _pull(self, fields: tuple[str, ...] | None = None) -> None:
        """Bring canonical fields up to the device mirror where they are
        behind (``None``: all). Each property read passes only its own
        field, so reading ``log_b`` never converts the [T, T] tables."""
        if self._bank is not None:
            self._bank._flush()  # a banked update may hold the newest state
        want = self._stale if fields is None else (self._stale & set(fields))
        if not want:
            return
        dev = self._dev
        f64 = torch.float64
        if "L" in want:
            self._L = dev.L_t.T.to(f64)
        if "log_b" in want:
            self._log_b = dev.log_b.to(f64)
        if "n_pair" in want:
            self._n_pair = dev.n_pair_t.T.to(f64)
        if "n_base" in want:
            self._n_base = dev.n_base.to(f64)
        if "n_obs" in want:
            self._n_obs = int(dev.n_obs)
        self._stale = self._stale - want

    def _host_write(self, name: str, value) -> None:
        self._pull()
        self._dev = None  # the mirror no longer matches: rebuilt on next use
        self._mutated()
        setattr(self, "_" + name, value)

    # canonical views: a read pulls its own field from the device mirror; a
    # write pulls the rest and drops the mirror
    L = property(lambda s: (s._pull(("L",)), s._L)[1],
                 lambda s, v: s._host_write("L", v))
    log_b = property(lambda s: (s._pull(("log_b",)), s._log_b)[1],
                     lambda s, v: s._host_write("log_b", v))
    n_pair = property(lambda s: (s._pull(("n_pair",)), s._n_pair)[1],
                      lambda s, v: s._host_write("n_pair", v))
    n_base = property(lambda s: (s._pull(("n_base",)), s._n_base)[1],
                      lambda s, v: s._host_write("n_base", v))
    n_obs = property(lambda s: (s._pull(("n_obs",)), s._n_obs)[1],
                     lambda s, v: s._host_write("n_obs", v))

    def device_state(self) -> DeviceEstimatorState:
        """The state as float32 device tensors (built on first use)."""
        if self._bank is not None:
            self._bank._flush()
        if self._dev is None:
            f32 = torch.float32
            self._dev = DeviceEstimatorState(
                self._L.T.to(f32).contiguous(), self._log_b.to(f32),
                self._n_pair.T.to(f32).contiguous(), self._n_base.to(f32),
                torch.tensor(self._n_obs, dtype=torch.int32, device=self.device))
        return self._dev

    # -- updates ----------------------------------------------------------
    def _batch_weights(self, n: int) -> torch.Tensor:
        """Per-observation decay weights, newest last (see ``decay``)."""
        if self.decay >= 1.0:
            return torch.ones(n, dtype=torch.float64, device=self.device)
        exps = torch.arange(n - 1, -1, -1, dtype=torch.float64, device=self.device)
        return torch.pow(self.decay, exps)

    def update(self, obs: ObservationLog) -> int:
        """Consume one observation batch; returns how many records were used."""
        if len(obs) == 0:
            return 0
        obs = obs.select(obs.lost_frac <= self.max_lost_frac)
        n = len(obs)
        if n == 0:
            return 0
        self._pull()
        self._dev = None
        self._mutated()
        t = obs.wtype.long()
        cbar = obs.co_counts.to(torch.float64)
        # geometric-mean rate: the log-linear model is exact in it per cache
        # regime
        y = torch.log(obs.geo_rate.to(torch.float64))

        # exposure-based forgetting: the state decays once per observation
        # consumed, and each observation's contribution carries the decay the
        # rest of the batch applies after it
        w = self._batch_weights(n)
        if self.decay < 1.0:
            self._n_pair *= self.decay ** n
            self._n_base *= self.decay ** n

        # solo runs update the base; co-run residuals against the updated
        # base update only L (the two trade off along an unidentifiable
        # direction, see the JAX package's estimator)
        solo = cbar.sum(dim=1) <= self.solo_eps
        if bool(solo.any()):
            ts, ws = t[solo], w[solo]
            r0 = y[solo] - self._log_b[ts]
            num0 = torch.zeros_like(self._log_b).index_add_(0, ts, ws * r0)
            cnt0 = torch.zeros_like(self._log_b).index_add_(0, ts, ws)
            self._log_b += self.lr * num0 / (cnt0 + self.step_damp)
            self._n_base += cnt0

        co = ~solo
        if bool(co.any()):
            tc, cc, yc, wc = t[co], cbar[co], y[co], w[co]
            pred = self._log_b[tc] + (cc * self._L.T[tc]).sum(dim=1)
            xnorm = torch.clamp((cc**2).sum(dim=1), min=self.solo_eps)
            h = (yc - pred) / xnorm  # normalized residual (LMS direction)

            # one stacked scatter carries both sufficient statistics: the
            # residual numerator and the exposure weight of the same step
            pair, _ = self._scatter(tc, cc, torch.stack([wc * h, wc]))
            num_pair, wgt_pair = pair[0], pair[1]
            # exposure-weighted average step: invariant to batch composition
            self._L += self.lr * num_pair / (wgt_pair + self.step_damp)
            self._n_pair += wgt_pair

        self._n_obs += n
        return n

    def update_device(self, block: RingBlock, server: int = -1, sync: bool = True):
        """Consume one device-resident block (the fused stream path).

        ``block`` is a ``RingBlock`` -- what ``ObservationRing.push``
        wrote, or a ring ``view()`` -- whose invalid rows drop inside the
        step. ``server`` restricts the update to rows placed on that server
        (< 0 takes every row). Returns the rows used: a Python int when
        ``sync`` (the one read back this path makes), else the device
        scalar. The state stays on the device until an estimate is read.
        """
        new, used = _update_device(self.device_state(), block, server, **self._hypers)
        self._dev = new
        self._stale = set(self._FIELDS)
        self._mutated()
        return int(used) if sync else used

    # -- bank interop and posterior export ---------------------------------
    def _absorb_device(self, state: DeviceEstimatorState) -> None:
        """Adopt device state updated elsewhere (``EstimatorBank``)."""
        self._dev = state
        self._stale = set(self._FIELDS)

    def export_posterior(self) -> DeviceEstimatorState:
        """Device snapshot of the full posterior: the point estimates and
        the accumulated exposure, so an estimator seeded from it starts as
        warm as this one."""
        return self.device_state()

    def seed_from(self, state: DeviceEstimatorState) -> None:
        """Adopt an exported posterior as this estimator's state. The prior
        and every hyperparameter stay this estimator's own. Safe on banked
        estimators (the bank's stacked copy is flushed first, then
        invalidated)."""
        self._pull()
        self._dev = DeviceEstimatorState(*state)
        self._stale = set(self._FIELDS)
        self._mutated()

    # -- estimates --------------------------------------------------------
    def pair_confidence(self) -> torch.Tensor:
        """Accumulated (decayed) exposure per pair, in co-run units [T, T]."""
        return self.n_pair.clone()

    def observed_mask(self, floor: float | None = None) -> torch.Tensor:
        """Pairs whose accumulated exposure reached the confidence floor."""
        return self.n_pair >= (self.confidence_floor if floor is None else floor)

    def estimate_D(self) -> torch.Tensor:
        """Current D-matrix estimate [T, T] (float64, on the estimator's
        device), prior-blended below the confidence floor."""
        w = torch.clamp(self.n_pair / self.confidence_floor, max=1.0)
        L_eff = w * self.L + (1.0 - w) * self._L_prior
        return torch.clamp(-torch.expm1(L_eff), 0.0, 0.999999)

    def estimate_solo(self) -> torch.Tensor:
        """Current per-type base-throughput estimate (bytes/s) [T]."""
        w = torch.clamp(self.n_base / self.confidence_floor, max=1.0)
        return torch.exp(w * self.log_b + (1.0 - w) * self._logb_prior)


# --- the bank: m per-server estimators, one fused update ---------------------

def _remap_rows(block: RingBlock, row_map: torch.Tensor) -> RingBlock:
    """Rewrite a block's server column through ``row_map`` (server -> bank
    row): several servers may share a row, and a ``-1`` entry (an evicted
    server) routes its rows to the step's dump mask, as do servers outside
    the map."""
    n = row_map.shape[0]
    s = block.server
    ok = (s >= 0) & (s < n)
    row = torch.where(ok, row_map[torch.clamp(s, 0, n - 1).long()], -1).to(torch.int32)
    return block._replace(ints=torch.stack([block.wtype, row], dim=1))


def _localize_block(block: RingBlock, lo: int) -> RingBlock:
    """Rebase a block's server column to a rank's slice of the fleet.

    Off-rank rows land outside ``[0, m_local)`` and drop in the core's own
    range mask (``-1`` voids stay negative on every rank), so each
    observation updates exactly one rank's rows and the sharded bank equals
    the dense one row by row."""
    return block._replace(ints=torch.stack([block.wtype, block.server - lo], dim=1))


def bank_update_sharded(axis, state: DeviceEstimatorState, block: RingBlock,
                        **hypers) -> tuple[DeviceEstimatorState, torch.Tensor]:
    """``_bank_core`` with the bank rows sharded over a ``ServerAxis``.

    Global in, global out: the block is replicated (B rows of O(T)), every
    rank runs the same fused core on its own rows with the server column
    rebased (per-row arithmetic, scatter order and decay weights are all
    rank-local, so each row's update is the dense one), one ``psum`` counts
    the rows used, and the new state is gathered on exit. ``hypers`` are
    ``_bank_core``'s keywords. A dense axis is ``_bank_core`` itself."""
    if not axis.is_sharded:
        return _bank_core(state, block, **hypers)
    m = state.log_b.shape[0]
    axis.validate(m)
    m_local = axis.local_m(m)
    new, used = _bank_core(axis.local(state, m), _localize_block(block, axis.offset(m_local)),
                           **hypers)
    return axis.gather(new, m_local), axis.psum(used)


class EstimatorBank:
    """m :class:`StreamingEstimator` s updated by one fused step.

    The stream's estimator refresh: a block folds into every server's
    estimator with one ``update_device`` call -- the batch streams once,
    through one banked scatter, instead of once per server. The members stay
    the source of truth for reads (``estimate_D`` etc.) and for the
    ``update`` path; the bank stacks their device states before its first
    fused step and, between steps, its stacked [m, ...] state is the live
    copy, flushed back into the members lazily, the first time a member's
    state is read or written outside the bank.

    Members must share hyperparameters: they are per-server states, not
    per-server policies.
    """

    def __init__(self, estimators: list[StreamingEstimator]):
        if not estimators:
            raise ValueError("EstimatorBank needs at least one estimator")
        e0 = estimators[0]
        for e in estimators[1:]:
            if e._hypers != e0._hypers or e.T != e0.T or e.device != e0.device:
                raise ValueError("banked estimators must share hyperparameters and device")
        self.estimators = list(estimators)
        self._stacked: DeviceEstimatorState | None = None
        self._dirty = False  # the stacked state is ahead of the members
        self._hypers = dict(e0._hypers)
        for e in self.estimators:
            e._bank = self

    def _invalidate(self) -> None:
        """A member moved ahead of the stacked copy: restack on next use."""
        self._stacked = None

    def _flush(self) -> None:
        """Split the stacked state back into the members (lazy, idempotent)."""
        if self._dirty:
            self._dirty = False  # first: _absorb_device re-enters via _pull
            for s, est in enumerate(self.estimators):
                est._absorb_device(DeviceEstimatorState(*(a[s] for a in self._stacked)))

    def stacked_state(self) -> DeviceEstimatorState:
        """The bank's live [m, ...] device state (stacking the members on
        first use). Between banked updates this is the newest state."""
        if self._stacked is None:
            self._stacked = DeviceEstimatorState(
                *(torch.stack(parts)
                  for parts in zip(*(e.device_state() for e in self.estimators))))
        return self._stacked

    def copy_row(self, src: int, dst: int) -> None:
        """Seed bank row ``dst`` from row ``src``'s posterior (estimates and
        confidence), on the device. Row ``dst``'s member keeps its own prior
        and hyperparameters."""
        m = len(self.estimators)
        if not (0 <= src < m and 0 <= dst < m):
            raise IndexError(f"copy_row({src}, {dst}) outside bank of {m}")
        if src == dst:
            return
        st = self.stacked_state()
        copied = []
        for a in st:
            a = a.clone()  # members may hold views of the old stacked tensors
            a[dst] = a[src]
            copied.append(a)
        self._stacked = DeviceEstimatorState(*copied)
        self._dirty = True

    def update_device(self, block: RingBlock, sync: bool = True, *,
                      row_map: torch.Tensor | np.ndarray | None = None,
                      sparse_tables: bool = False):
        """One fused observe -> estimate step for every member.

        Rows update the member their ``server`` column names; rows with a
        server outside [0, m) (voided rows included) drop. ``row_map``
        (i32[n_servers], entries in [0, m) or -1) first rewrites the server
        column into bank rows (estimator pooling). ``sparse_tables`` selects
        ``_bank_core``'s indexed table update (same values). Returns the
        rows used: a Python int when ``sync``, else the device scalar.
        """
        stacked = self.stacked_state()
        if row_map is not None:
            row_map = torch.as_tensor(row_map, dtype=torch.int32).to(stacked.log_b.device)
            block = _remap_rows(block, row_map)
        new, used = _bank_core(stacked, block, sparse_tables=sparse_tables, **self._hypers)
        self._stacked = new
        self._dirty = True
        return int(used) if sync else used
