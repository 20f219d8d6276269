"""Uniform model API (counterpart of ``repro/models/api.py``) over every
family of the JAX package: dense, moe and vlm (``transformer``), ssm
(``rwkv``), hybrid (``hybrid``) and encdec (``encdec``).

``build_model(cfg)`` returns a :class:`Model` whose steps take the LM
module where the JAX ``Model`` takes its parameter tree:

  prefill(lm, batch, cache)       fill the cache from a prompt batch
  decode_step(lm, cache, tokens)  append one token per sequence

and, as the JAX ``Model`` does, the training objective on the parameter
tree itself (the ``param_infos`` tree as tensors, float32 masters):

  loss(params, batch)             (loss, {"ce", "zloss"}) on tokens, labels

for every family, through the family module's ``forward`` on the tree.

A batch holds ``tokens`` [B, S] (and, to train, ``labels`` [B, S]) and,
for the vlm, ``vis_embeds`` [B, P, D] (patch embeddings put before the
tokens), for the encdec ``audio_embeds`` [B, enc_seq, D] (the encoder's
frame embeddings); ``prefill_extras`` gives their shapes.

``init`` draws the weights (``lm_infos`` with the float32 master dtype)
from a ``torch.Generator`` on the target device, and ``init_cache`` makes
the zero cache: the KV cache, ``CACHE_PAD`` rows longer than asked, as in
JAX, or the recurrent state.

On a mesh (the decoder LMs: dense, moe, vlm; ``mesh_context`` and
``layers.activation_sharding``) every step runs on this rank's rows of the
batch and its slices of the parameters: ``loss`` returns the mean over
the rank's rows, ``prefill`` and ``decode_step`` this rank's block of the
logits, and ``init_cache`` makes the rank's cache (its rows, its kv heads
where they divide TP). The other families' tensor parallelism is ROADMAP
10p-b.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import SHAPES, ModelConfig
from ..device import resolve_device
from . import encdec, hybrid, rwkv, transformer
from . import layers as L
from .params import ParamInfo, map_infos, materialize

#: extra cache rows beyond the nominal context (decode writes at len)
CACHE_PAD = 128

#: each family's module (``lm_infos``, ``cache_infos``) and LM class
FAMILIES = {"dense": (transformer, transformer.TransformerLM),
            "moe": (transformer, transformer.TransformerLM),
            "vlm": (transformer, transformer.TransformerLM),
            "ssm": (rwkv, rwkv.RWKVLM),
            "hybrid": (hybrid, hybrid.HybridLM),
            "encdec": (encdec, encdec.EncDecLM)}
#: the families whose LM takes patch embeddings before the tokens
PREFIX_FAMILIES = ("dense", "moe", "vlm")
LM = transformer.TransformerLM | rwkv.RWKVLM | hybrid.HybridLM | encdec.EncDecLM


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
        """Zero cache for ``batch`` sequences of up to ``max_len`` tokens
        (under a mesh context, ``batch`` is this rank's rows, and the cache
        holds the rank's kv heads where they divide TP)."""
        device = resolve_device(device)
        infos = self.cache_infos(batch, max_len)
        ctx = L.mesh_info()
        kv = self.cfg.n_kv_heads
        split = ctx is not None and ctx.tp > 1 and kv % ctx.tp == 0

        def shape(i: ParamInfo) -> tuple:
            if not split:
                return i.shape
            return (*i.shape[:3], kv // ctx.tp, *i.shape[4:])

        cache = {k: torch.zeros(shape(i), dtype=i.dtype, device=device) for k, i in infos.items()}
        return dict(cache, len=0)

    def mesh_context(self, mesh) -> L.MeshContext:
        """What the layers read on ``mesh`` (``distributed.collectives.Mesh``):
        install it with ``layers.activation_sharding``. The decoder LMs
        only: the other families' tensor parallelism is ROADMAP 10p-b."""
        if self.cfg.family not in PREFIX_FAMILIES:
            raise NotImplementedError(f"the {self.cfg.family} family has no sharded route yet "
                                      "(ROADMAP item 10p-b)")
        return L.MeshContext.build(mesh, self.cfg, self.param_infos())

    def prefill_extras(self, batch: int) -> dict[str, tuple[int, ...]]:
        """The shapes of the inputs a prefill batch of ``batch`` sequences
        takes besides its tokens (JAX's ``input_specs`` for a prefill)."""
        cfg = self.cfg
        if cfg.family == "vlm":
            return {"vis_embeds": (batch, cfg.vis_tokens, cfg.d_model)}
        if cfg.family == "encdec":
            return {"audio_embeds": (batch, cfg.enc_seq, cfg.d_model)}
        return {}

    def input_specs(self, shape: str | dict) -> dict:
        """Meta tensors standing for one input shape (a key of SHAPES or a
        dict of its keys), JAX's ``input_specs``: int32 tokens (and labels to
        train), the vlm's patch and the encdec's frame embeddings in the
        compute dtype; a decode step's one token per sequence."""
        info = SHAPES[shape] if isinstance(shape, str) else shape
        B, S, kind = info["global_batch"], info["seq_len"], info["kind"]
        cfg = self.cfg

        def spec(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if kind == "decode":
            return {"tokens": spec(B, 1)}
        if kind not in ("train", "prefill"):
            raise ValueError(kind)
        s_text = S - cfg.vis_tokens if cfg.family == "vlm" else S
        out = {name: spec(*dims, dtype=cfg.compute_dtype)
               for name, dims in self.prefill_extras(B).items()}
        out["tokens"] = spec(B, s_text)
        if kind == "train":
            out["labels"] = spec(B, s_text)
        return out

    def prefix_len(self, batch: dict) -> int:
        """Cache rows a prefill of ``batch`` writes before its tokens."""
        if self.cfg.family in PREFIX_FAMILIES and "vis_embeds" in batch:
            return batch["vis_embeds"].shape[1]
        return 0

    # --- steps -------------------------------------------------------------
    def head_matrix(self, params):
        """The unembedding [D, Vp] of a parameter tree (its masters)."""
        if self.cfg.family in PREFIX_FAMILIES and self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def loss(self, params, batch: dict, *, mode: str | None = None):
        """Training objective on the parameter tree: the family's final
        hidden states (the vlm's past its patches), then the
        sequence-chunked cross-entropy (``transformer.
        chunked_cross_entropy``), as the JAX ``Model.loss``, which adds no
        MoE auxiliary loss. The batch's ``vis_embeds`` go before the tokens
        of the transformer families, its ``audio_embeds`` (which the encdec
        needs) to the encoder. ``mode`` picks the kernels' route, as in
        ``layers.attention_apply``."""
        cfg, tokens = self.cfg, batch["tokens"]
        module, _ = FAMILIES[cfg.family]
        if cfg.family == "encdec":
            if "audio_embeds" not in batch:
                raise KeyError("the encdec family's loss needs the batch's audio_embeds "
                               "[B, enc_seq, D], the encoder's frame embeddings")
            kw = {"audio_embeds": batch["audio_embeds"]}
        elif cfg.family in PREFIX_FAMILIES:
            kw = {"prefix_embeds": batch.get("vis_embeds")}
        else:
            kw = {}
        hidden, _ = module.forward(params, cfg, tokens, return_hidden=True, mode=mode, **kw)
        if cfg.family == "vlm" and "vis_embeds" in batch:
            hidden = hidden[:, batch["vis_embeds"].shape[1]:, :]
        head = self.head_matrix(params)
        ctx = L.mesh_info()
        if ctx is not None and cfg.family in PREFIX_FAMILIES:
            name = "embed" if cfg.tie_embeddings else "lm_head"
            head = ctx.gather_leaf(params[name], ctx.specs[name], ctx.axes[name], name)
            head = head.T if cfg.tie_embeddings else head
        return transformer.chunked_cross_entropy(hidden, head, batch["labels"], cfg.vocab, cfg)

    def prefill(self, lm: LM, batch: dict, cache: dict):
        """(last-position logits [B, 1, Vp], cache) after the prompt and,
        in ``batch``, the vlm's patch embeddings or the encdec's frames."""
        tokens = batch["tokens"]
        if self.cfg.family == "encdec":
            return lm.prefill(tokens, batch["audio_embeds"], cache)
        if self.cfg.family in PREFIX_FAMILIES:
            return lm(tokens, prefix_embeds=batch.get("vis_embeds"), cache=cache,
                      last_only=True)
        return lm(tokens, cache=cache, last_only=True)

    def decode_step(self, lm: LM, cache: dict, tokens: torch.Tensor):
        """(logits [B, 1, Vp], cache) after appending tokens [B, 1]."""
        if self.cfg.family == "encdec":
            return lm.decode(tokens, cache=cache, last_only=True)
        return lm(tokens, cache=cache, last_only=True)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(cfg)
