"""Carry cluster and dynamics tables across from the JAX package's layout.

``cluster_from_numpy`` and ``dynamics_from_numpy`` take the fields of the
JAX ``PackedCluster`` / ``PackedDynamics`` as numpy arrays (a mapping from
field name to array; ``degradation_limit`` as a float) and return the
port's versions on ``device``, so both implementations can score the
identical tables. Arrays keep their dtype; nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .core.binpack_torch import PackedCluster
from .core.engine_torch import PackedDynamics
from .device import resolve_device


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
