"""Uniform model API (counterpart of ``repro/models/api.py``) over the
dense family (``transformer``), the ssm family (``rwkv``) and the hybrid
family (``hybrid``).

``build_model(cfg)`` returns a :class:`Model` whose steps take the LM
module where the JAX ``Model`` takes its parameter tree:

  prefill(lm, batch, cache)       fill the cache from a prompt batch
  decode_step(lm, cache, tokens)  append one token per sequence

``init`` draws the weights (``lm_infos`` with the float32 master dtype)
from a ``torch.Generator`` on the target device, and ``init_cache`` makes
the zero cache: the KV cache, ``CACHE_PAD`` rows longer than asked, as in
JAX, or the recurrent state.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..configs.registry import not_ported
from ..device import resolve_device
from . import hybrid, rwkv, transformer
from .params import ParamInfo, map_infos, materialize

#: extra cache rows beyond the nominal context (decode writes at len)
CACHE_PAD = 128

#: each ported family's module (``lm_infos``, ``cache_infos``) and LM class
FAMILIES = {"dense": (transformer, transformer.TransformerLM), "ssm": (rwkv, rwkv.RWKVLM),
            "hybrid": (hybrid, hybrid.HybridLM)}
LM = transformer.TransformerLM | rwkv.RWKVLM | hybrid.HybridLM


def _apply_param_dtype(infos, cfg):
    """Big weight matrices in cfg.param_dtype; norms, biases and small
    vectors stay float32."""
    def cast(i: ParamInfo) -> ParamInfo:
        if i.init in ("normal", "embed") and len(i.shape) >= 2:
            return dataclasses.replace(i, dtype=cfg.param_dtype)
        return i

    return map_infos(cast, infos)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # --- declarations -------------------------------------------------------
    def param_infos(self):
        """The JAX parameter tree's declaration, big matrices in
        ``cfg.param_dtype``."""
        module, _ = FAMILIES[self.cfg.family]
        return _apply_param_dtype(module.lm_infos(self.cfg), self.cfg)

    def cache_infos(self, batch: int, max_len: int):
        module, _ = FAMILIES[self.cfg.family]
        return module.cache_infos(self.cfg, batch, max_len + CACHE_PAD)

    # --- state ----------------------------------------------------------------
    def build(self, params) -> LM:
        """The LM holding ``params``, the ``param_infos`` tree as tensors."""
        _, lm_class = FAMILIES[self.cfg.family]
        return lm_class(self.cfg, params)

    def init(self, generator: torch.Generator | None = None, *,
             device: str | torch.device | None = None) -> LM:
        """The LM with weights drawn from ``generator`` (default: a new one
        seeded with 0) on ``device``: the card unless the caller asks for
        the CPU."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        elif generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, weights asked on {device}")
        return self.build(materialize(self.param_infos(), generator))

    def init_cache(self, batch: int, max_len: int, *,
                   device: str | torch.device | None = None) -> dict:
        """Zero cache for ``batch`` sequences of up to ``max_len`` tokens."""
        device = resolve_device(device)
        infos = self.cache_infos(batch, max_len)
        cache = {k: torch.zeros(i.shape, dtype=i.dtype, device=device) for k, i in infos.items()}
        return dict(cache, len=0)

    # --- steps -------------------------------------------------------------
    def prefill(self, lm: LM, batch: dict, cache: dict):
        """(last-position logits [B, 1, Vp], cache) after the prompt."""
        return lm(batch["tokens"], cache=cache, last_only=True)

    def decode_step(self, lm: LM, cache: dict, tokens: torch.Tensor):
        """(logits [B, 1, Vp], cache) after appending tokens [B, 1]."""
        return lm(tokens, cache=cache, last_only=True)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(not_ported(cfg.family))
    return Model(cfg)
