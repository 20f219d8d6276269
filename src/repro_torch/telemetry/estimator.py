"""Streaming recovery of the scheduler's D-matrix from completion telemetry.

Counterpart of the host half of ``repro/telemetry/estimator.py``: the
``StreamingEstimator`` and its ``update`` (the JAX package's reference
semantics), with the same arithmetic in float64.

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

The state (``L``, ``log_b``, ``n_pair``, ``n_base`` and the two priors) lives
as float64 tensors on the estimator's device. The batched pair-statistic
scatter -- the only O(B T) loop -- goes through one of three backends:

  scatter='cuda'   the hand-written kernel (``kernels.telemetry.pair_scatter``),
                   the default; it needs a CUDA device;
  scatter='torch'  its plain PyTorch version (the one-hot contraction);
  scatter='numpy'  the float64 reference (``kernels.ref.pair_scatter_ref``).

The 'cuda' and 'torch' backends take their inputs in float32 and hand their
outputs back in float64, as the JAX package's Pallas backend does. Nothing
switches backend silently: a CPU device needs 'torch' or 'numpy' named.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ref import pair_scatter_ref
from ..kernels.telemetry import pair_scatter, pair_scatter_torch
from .log import ObservationLog

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
        self.L = self._L_prior.clone()
        self.log_b = self._logb_prior.clone()
        self.n_pair = torch.zeros((self.T, self.T), dtype=torch.float64, device=dev)
        self.n_base = torch.zeros(self.T, dtype=torch.float64, device=dev)
        self.n_obs = 0

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
            self.n_pair *= self.decay ** n
            self.n_base *= self.decay ** n

        # solo runs update the base; co-run residuals against the updated
        # base update only L (the two trade off along an unidentifiable
        # direction, see the JAX package's estimator)
        solo = cbar.sum(dim=1) <= self.solo_eps
        if bool(solo.any()):
            ts, ws = t[solo], w[solo]
            r0 = y[solo] - self.log_b[ts]
            num0 = torch.zeros_like(self.log_b).index_add_(0, ts, ws * r0)
            cnt0 = torch.zeros_like(self.log_b).index_add_(0, ts, ws)
            self.log_b += self.lr * num0 / (cnt0 + self.step_damp)
            self.n_base += cnt0

        co = ~solo
        if bool(co.any()):
            tc, cc, yc, wc = t[co], cbar[co], y[co], w[co]
            pred = self.log_b[tc] + (cc * self.L.T[tc]).sum(dim=1)
            xnorm = torch.clamp((cc**2).sum(dim=1), min=self.solo_eps)
            h = (yc - pred) / xnorm  # normalized residual (LMS direction)

            # one stacked scatter carries both sufficient statistics: the
            # residual numerator and the exposure weight of the same step
            pair, _ = self._scatter(tc, cc, torch.stack([wc * h, wc]))
            num_pair, wgt_pair = pair[0], pair[1]
            # exposure-weighted average step: invariant to batch composition
            self.L += self.lr * num_pair / (wgt_pair + self.step_damp)
            self.n_pair += wgt_pair

        self.n_obs += n
        return n

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
