"""Carry cluster, dynamics and estimator state across from the JAX package.

``cluster_from_numpy`` and ``dynamics_from_numpy`` take the fields of the
JAX ``PackedCluster`` / ``PackedDynamics`` as numpy arrays (a mapping from
field name to array; ``degradation_limit`` as a float) and return the
port's versions on ``device``, so both implementations can score the
identical tables. ``estimator_from_numpy`` does the same for a
``StreamingEstimator``'s state, so both compute the same next update.
``lm_params_from_numpy`` carries a JAX LM's parameter tree across (any
ported family), and ``kv_cache_from_numpy`` / ``rwkv_cache_from_numpy`` /
``hybrid_cache_from_numpy`` a JAX KV cache, RWKV state cache or hybrid
cache, so both models run on the same weights and can continue from the
same state.
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


def _tree_from_numpy(infos, tree, device, path=""):
    """The numpy tree as tensors, checked key by key and shape by shape
    against the declaration ``infos``."""
    if isinstance(infos, ParamInfo):
        a = np.asarray(tree)
        if tuple(a.shape) != tuple(infos.shape):
            raise ValueError(f"parameter {path}: shape {tuple(a.shape)}, want {infos.shape}")
        return tensor_from_numpy(a, device).to(infos.dtype)
    if not isinstance(tree, Mapping):
        raise KeyError(f"parameter {path or '/'}: want a mapping of {sorted(infos)}")
    missing, extra = sorted(set(infos) - set(tree)), sorted(set(tree) - set(infos))
    if missing or extra:
        raise KeyError(f"parameters under {path or '/'}: missing {missing}, extra {extra}")
    return {k: _tree_from_numpy(infos[k], tree[k], device, f"{path}/{k}") for k in infos}


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


def kv_cache_from_numpy(cache: Mapping, *, device: str | torch.device | None = None) -> dict:
    """A JAX KV cache ({'k', 'v': [L, B, T, Hkv, dh] bf16, 'len'}) as the
    port's, with ``len`` a host int."""
    device = resolve_device(device)
    missing = [k for k in ("k", "v", "len") if k not in cache]
    if missing:
        raise KeyError(f"KV cache missing {missing}")
    return {"k": tensor_from_numpy(cache["k"], device), "v": tensor_from_numpy(cache["v"], device),
            "len": int(np.asarray(cache["len"]))}


def rwkv_cache_from_numpy(cache: Mapping, *, device: str | torch.device | None = None) -> dict:
    """A JAX RWKV cache ({'wkv': [L, B, H, dh, dh] float32, 'shift_t',
    'shift_c': [L, B, D] bf16, 'len'}) as the port's, with ``len`` a host
    int."""
    device = resolve_device(device)
    missing = [k for k in ("wkv", "shift_t", "shift_c", "len") if k not in cache]
    if missing:
        raise KeyError(f"RWKV cache missing {missing}")
    out = {k: tensor_from_numpy(cache[k], device) for k in ("wkv", "shift_t", "shift_c")}
    return dict(out, len=int(np.asarray(cache["len"])))


def hybrid_cache_from_numpy(cache: Mapping, *,
                            device: str | torch.device | None = None) -> dict:
    """A JAX hybrid cache ({'k', 'v': [P, n_attn, B, T, Hkv, dh] bf16, 'h':
    [P, n_mamba, B, E, N] float32, 'conv': [P, n_mamba, B, K - 1, E] bf16,
    'len'}) as the port's, with ``len`` a host int."""
    device = resolve_device(device)
    missing = [k for k in ("k", "v", "h", "conv", "len") if k not in cache]
    if missing:
        raise KeyError(f"hybrid cache missing {missing}")
    out = {k: tensor_from_numpy(cache[k], device) for k in ("k", "v", "h", "conv")}
    return dict(out, len=int(np.asarray(cache["len"])))
