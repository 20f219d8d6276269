"""Carry cluster, dynamics and estimator state across from the JAX package.

``cluster_from_numpy`` and ``dynamics_from_numpy`` take the fields of the
JAX ``PackedCluster`` / ``PackedDynamics`` as numpy arrays (a mapping from
field name to array; ``degradation_limit`` as a float) and return the
port's versions on ``device``, so both implementations can score the
identical tables. ``estimator_from_numpy`` does the same for a
``StreamingEstimator``'s state, so both compute the same next update.
Arrays keep their dtype; nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .core.binpack_torch import PackedCluster
from .core.engine_torch import PackedDynamics
from .device import resolve_device
from .telemetry.estimator import ScatterName, StreamingEstimator


def _from_numpy(cls, fields: Mapping[str, object], device):
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"{cls.__name__} field {f.name!r} missing")
            continue
        v = fields[f.name]
        out[f.name] = (torch.from_numpy(np.array(v)).to(device)
                       if isinstance(v, np.ndarray) else v)
    return cls(**out)


def cluster_from_numpy(fields: Mapping[str, object],
                       device: str | torch.device | None = None) -> PackedCluster:
    return _from_numpy(PackedCluster, fields, device)


def dynamics_from_numpy(fields: Mapping[str, object],
                        device: str | torch.device | None = None) -> PackedDynamics:
    return _from_numpy(PackedDynamics, fields, device)


#: a StreamingEstimator's state, by the JAX estimator's attribute names
ESTIMATOR_STATE = ("L", "log_b", "n_pair", "n_base", "_L_prior", "_logb_prior")
#: its hyperparameters; a missing one takes the estimator's default
ESTIMATOR_HYPERS = ("lr", "decay", "confidence_floor", "max_lost_frac", "step_damp",
                    "solo_eps")


def estimator_from_numpy(state: Mapping[str, object], *, scatter: ScatterName = "cuda",
                         device: str | torch.device | None = None) -> StreamingEstimator:
    """The port's estimator holding a JAX ``StreamingEstimator``'s state.

    ``state`` maps ``ESTIMATOR_STATE`` names to float64 numpy arrays,
    ``n_obs`` to an int and ``ESTIMATOR_HYPERS`` names to floats.
    """
    missing = [k for k in (*ESTIMATOR_STATE, "n_obs") if k not in state]
    if missing:
        raise KeyError(f"estimator state missing {missing}")
    L = np.asarray(state["L"], np.float64)
    est = StreamingEstimator(
        T=L.shape[0], scatter=scatter, device=device,
        **{k: float(state[k]) for k in ESTIMATOR_HYPERS if k in state})
    for k in ESTIMATOR_STATE:
        setattr(est, k, torch.from_numpy(np.array(state[k], np.float64)).to(est.device))
    est.n_obs = int(state["n_obs"])
    return est
