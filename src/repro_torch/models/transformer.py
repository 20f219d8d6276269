"""Decoder-only transformer LM (counterpart of
``repro/models/transformer.py``): the dense family (llama, qwen,
starcoder, tinyllama), the MoE family (moonshot, kimi: the MLP replaced by
the top-k routed ``moe`` FFN on every layer) and the vlm family's backbone
(internvl: patch embeddings prepended to the token embeddings).

One function runs the LM: ``forward``, on a parameter tree in the JAX
layout (``embed`` [Vp, D], ``layers`` with every leaf stacked on a leading
layer axis, ``ln_f``, ``lm_head`` [D, Vp] unless the embeddings are tied),
its leaves cast to the compute dtype inside, as the JAX package does. Its
layers are a Python loop (the JAX package scans the stack). MoE dispatches
per sequence when a call brings several tokens and over the whole batch in
decode (``group``), as the JAX model does.

``TransformerLM`` is the serving ``nn.Module``: it holds the weights,
with per-layer modules whose weights are views of the stacked
tensors, and calls ``forward`` on their compute-dtype copies (made once),
where the cast inside is a no-op. Training calls ``forward`` on the
float32 masters themselves, so gradients reach them, and with
``cfg.remat == 'layer'`` recomputes each layer in the backward
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` per layer).
``chunked_cross_entropy`` is JAX's sequence-chunked loss.

The KV cache is the JAX one: ``k`` and ``v`` [L, B, max_len, Hkv, dh] in
bf16 whatever the compute dtype, or with ``kv_cache_dtype='int8'`` int8
codes with ``k_scale`` and ``v_scale`` [L, B, max_len, Hkv] in bf16; and
``len``, here a host ``int`` (the serving loop knows it). ``forward``
writes the new rows in place.
"""
from __future__ import annotations

from functools import partial
from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..tree import unstack
from . import layers as L
from .params import ParamInfo, stack_layers


def layer_infos(cfg) -> dict:
    d = {
        "ln1": L.norm_infos(cfg),
        "attn": L.attention_infos(cfg),
        "ln2": L.norm_infos(cfg),
    }
    if cfg.moe_experts:
        d["moe"] = L.moe_infos(cfg)
    else:
        d["mlp"] = L.mlp_infos(cfg)
    return d


def lm_infos(cfg) -> dict:
    vp = L.padded_vocab(cfg.vocab)
    d = {
        "embed": ParamInfo((vp, cfg.d_model), ("vocab", "dmodel"), "embed", scale=0.02),
        "layers": stack_layers(cfg.n_layers, layer_infos(cfg)),
        "ln_f": L.norm_infos(cfg),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamInfo((cfg.d_model, vp), ("dmodel", "vocab"))
    return d


def cache_infos(cfg, batch: int, max_len: int) -> dict:
    int8 = cfg.kv_cache_dtype == "int8"
    axes = ("layer", "batch", None, "kv_heads", None)
    kv = ParamInfo((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head), axes, "zeros",
                   dtype=torch.int8 if int8 else torch.bfloat16)
    d = {"k": kv, "v": kv}
    if int8:
        sc = ParamInfo((cfg.n_layers, batch, max_len, cfg.n_kv_heads), axes[:-1], "zeros",
                       dtype=torch.bfloat16)
        d.update(k_scale=sc, v_scale=sc)
    return d


def layer_apply(p: Mapping, x: torch.Tensor, cfg, *, positions, rope_cs, cache=None,
                mode=None, group: str = "seq") -> torch.Tensor:
    """One decoder layer on its parameters ``p`` (a layer's slice of the
    tree, cast to the compute dtype inside). ``cache`` is the layer's
    slice of the KV cache, written in place."""
    a, _ = L.attention_apply(p["attn"], L.norm_apply(p["ln1"], x, cfg), cfg,
                             positions=positions, cache=cache, window=cfg.sliding_window,
                             mode=mode, rope_cs=rope_cs)
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg)
    f = L.moe_apply(p["moe"], h, cfg, group=group) if "moe" in p else L.mlp_apply(p["mlp"], h, cfg)
    return x + f


class DecoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.Norm(cfg, p["ln1"])
        self.attn = L.Attention(cfg, p["attn"])
        self.ln2 = L.Norm(cfg, p["ln2"])
        if "moe" in p:
            self.moe = L.MoE(cfg, p["moe"])
        else:
            self.mlp = L.MLP(cfg, p["mlp"])

    def forward(self, x, **kw):
        return layer_apply({n: m.c for n, m in self.named_children()}, x, self.cfg, **kw)


def forward(params: Mapping, cfg, tokens: torch.Tensor, *, layers=None,
            prefix_embeds: torch.Tensor | None = None, cache: dict | None = None,
            last_only: bool = False, return_hidden: bool = False, mode: str | None = None):
    """The LM on a parameter tree (JAX ``forward``) on tokens [B, S]:
    (logits [B, P + S or 1, Vp], new_cache), or with ``return_hidden`` the
    final normed hidden states [B, P + S or 1, D] in their place, in the
    compute dtype.

    Leaves are cast to the compute dtype inside: a tree of float32 masters
    trains, the serving module's compute-dtype copies pass unchanged.
    ``layers`` are per-layer callables ``(x, **kw) -> x`` (the serving
    module's ``DecoderLayer``s); by default ``layer_apply`` on each layer's
    slice of ``params["layers"]``. ``prefix_embeds`` [B, P, D] (the vlm's
    patch embeddings) go before the token embeddings. With ``cache`` the
    call appends P + S positions at ``cache['len']``; decode is this with
    S == 1. Without a cache, where a gradient is asked for, self-attention
    is ``FlashAttention`` (``layers.attention_apply``), and where the
    embeddings carry one ``cfg.remat == 'layer'`` recomputes each layer in
    the backward.
    """
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.compute_dtype), x], dim=1)
    S = x.shape[1]
    offset = int(cache["len"]) if cache is not None else 0
    positions = offset + torch.arange(S, device=x.device)
    kw = dict(positions=positions, rope_cs=L.rope_tables(positions, cfg.d_head, cfg.rope_theta),
              mode=mode, group="batch" if S == 1 else "seq")
    if layers is None:
        layers = [partial(layer_apply, lp, cfg=cfg)
                  for lp in unstack(params["layers"], cfg.n_layers)]
    remat = cfg.remat == "layer" and cache is None and x.requires_grad
    for i, layer in enumerate(layers):
        if cache is not None:
            kw["cache"] = dict({n: t[i] for n, t in cache.items() if n != "len"}, len=offset)
        x = checkpoint(layer, x, use_reentrant=False, **kw) if remat else layer(x, **kw)
    new_cache = None if cache is None else dict(cache, len=offset + S)
    if last_only:  # the norm is per position: normalise only what is kept
        x = x[:, -1:, :]
    x = L.norm_apply(params["ln_f"], x, cfg)
    if return_hidden:
        return x, new_cache
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.mask_padded_logits(x @ head.to(cfg.compute_dtype), cfg.vocab), new_cache


class TransformerLM(L.Weights):
    """The dense LM on the device its weights lie on.

    ``params`` is the JAX parameter tree (``lm_infos``) as tensors. The
    attribute ``mode`` picks the attention route for every layer:
    ``None`` (the default) follows the tensors' device ('cuda' launches the
    kernel, 'torch' runs its plain version); setting it to 'torch' on the
    card replays the plain route.
    """

    mode: str | None = None

    def __init__(self, cfg, params: Mapping):
        top = {"embed": params["embed"]}
        if not cfg.tie_embeddings:
            top["lm_head"] = params["lm_head"]
        super().__init__(top, cfg.compute_dtype)
        self.cfg = cfg
        stacked = params["layers"]
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, {blk: {n: t[i] for n, t in stacked[blk].items()}
                               for blk in stacked})
            for i in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, params["ln_f"])

    def forward(self, tokens: torch.Tensor, *, prefix_embeds: torch.Tensor | None = None,
                cache: dict | None = None,
                last_only: bool = False) -> tuple[torch.Tensor, dict | None]:
        """The module-level ``forward`` on the compute-dtype copies."""
        return forward(dict(self.c, ln_f=self.ln_f.c), self.cfg, tokens, layers=self.layers,
                       prefix_embeds=prefix_embeds, cache=cache, last_only=last_only,
                       mode=self.mode)


# --- losses ------------------------------------------------------------------------

def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                          true_vocab: int, cfg, n_chunks: int = 8, z_weight: float = 1e-4):
    """Unembed + cross-entropy over sequence chunks, each recomputed in the
    backward (JAX ``chunked_cross_entropy``): x [B, S, D] final hidden
    states, head [D, Vp], labels [B, S]. The [B, S, Vp] logits never
    materialise whole; per-chunk sums in float32 (logits masked to the true
    vocab, lse in float32, z-loss weight ``z_weight``) are normalised once.
    Returns (loss, {"ce", "zloss"})."""
    B, S, D = x.shape
    if S % n_chunks != 0:
        n_chunks = 1
    c = S // n_chunks
    hd = head.to(cfg.compute_dtype)

    def body(xc, lc, hd):
        lg = L.mask_padded_logits(xc @ hd, true_vocab).float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, lc.long()[..., None])[..., 0]
        return torch.sum(lse - gold), z_weight * torch.sum(lse ** 2)

    ce_sum = z_sum = 0.0
    for i in range(n_chunks):
        ce, z = checkpoint(body, x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c], hd,
                           use_reentrant=False)
        ce_sum, z_sum = ce_sum + ce, z_sum + z
    n = B * S
    return ce_sum / n + z_sum / n, {"ce": ce_sum / n, "zloss": z_sum / n}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_weight: float = 1e-4):
    """Stable softmax cross-entropy in float32 with z-loss; mean over tokens."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels.long()[..., None])[..., 0]
    ce = lse - gold
    z = z_weight * (lse ** 2)
    return ce.mean() + z.mean(), {"ce": ce.mean(), "zloss": z.mean()}
