"""Carry cluster, dynamics and estimator state across from the JAX package.

``cluster_from_numpy`` and ``dynamics_from_numpy`` take the fields of the
JAX ``PackedCluster`` / ``PackedDynamics`` as numpy arrays (a mapping from
field name to array; ``degradation_limit`` as a float) and return the
port's versions on ``device``, so both implementations can score the
identical tables. ``estimator_from_numpy`` does the same for a
``StreamingEstimator``'s state, so both compute the same next update.
``lm_params_from_numpy`` carries a JAX LM's parameter tree across (any
family), and ``cache_from_numpy`` any family's JAX cache (the int8 KV
cache with its scales, the encoder-decoder's with its cross K/V
included), checked key by key, shape by shape and dtype by dtype against
the port's declaration. So both models run on the same weights and can
continue from the same state.
Arrays keep their dtype (bf16 arrives as numpy's ``bfloat16`` extension
type and leaves as ``torch.bfloat16``); nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .core.binpack_torch import PackedCluster
from .core.engine_torch import PackedDynamics
from .device import resolve_device
from .models.api import LM, build_model
from .models.params import ParamInfo
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


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on ``device``, bf16 included (through its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree_from_numpy(infos, tree, device, path="", what="parameter", exact_dtype=False):
    """The numpy tree as tensors in the declared dtypes, checked key by key
    and shape by shape against the declaration ``infos`` (and dtype by
    dtype with ``exact_dtype``)."""
    if isinstance(infos, ParamInfo):
        a = np.asarray(tree)
        if tuple(a.shape) != tuple(infos.shape):
            raise ValueError(f"{what} {path}: shape {tuple(a.shape)}, want {infos.shape}")
        t = tensor_from_numpy(a, device)
        if exact_dtype and t.dtype != infos.dtype:
            raise TypeError(f"{what} {path}: dtype {t.dtype}, want {infos.dtype}")
        return t.to(infos.dtype)
    if not isinstance(tree, Mapping):
        raise KeyError(f"{what} {path or '/'}: want a mapping of {sorted(infos)}")
    missing, extra = sorted(set(infos) - set(tree)), sorted(set(tree) - set(infos))
    if missing or extra:
        raise KeyError(f"{what}s under {path or '/'}: missing {missing}, extra {extra}")
    return {k: _tree_from_numpy(infos[k], tree[k], device, f"{path}/{k}", what, exact_dtype)
            for k in infos}


def lm_params_from_numpy(cfg, params: Mapping, *,
                         device: str | torch.device | None = None) -> LM:
    """The port's LM of ``cfg``'s family holding a JAX LM's parameters.

    ``params`` is the JAX parameter tree (``Model.param_infos``: stacked
    layers) with numpy leaves. Raises ``KeyError`` on a missing or extra
    key and ``ValueError`` on a wrong shape.
    """
    device = resolve_device(device)
    model = build_model(cfg)
    return model.build(_tree_from_numpy(model.param_infos(), params, device))


def cache_from_numpy(cfg, cache: Mapping, *, batch: int, max_len: int,
                     device: str | torch.device | None = None) -> dict:
    """The port's cache of ``cfg``'s family holding a JAX cache: ``cache``
    maps the JAX cache's names (``Model.cache_infos(batch, max_len)``, so
    ``max_len + CACHE_PAD`` rows) to numpy arrays, ``len`` included, which
    becomes a host int. An int8 KV cache brings ``k_scale`` and
    ``v_scale``, the encoder-decoder's ``xk`` and ``xv``. Raises
    ``KeyError`` on a missing or extra key, ``ValueError`` on a wrong shape
    and ``TypeError`` on a wrong dtype."""
    device = resolve_device(device)
    if "len" not in cache:
        raise KeyError("cache missing ['len']")
    infos = build_model(cfg).cache_infos(batch, max_len)
    state = {k: v for k, v in cache.items() if k != "len"}
    out = _tree_from_numpy(infos, state, device, what="cache array", exact_dtype=True)
    return dict(out, len=int(np.asarray(cache["len"])))
