"""Whisper-style encoder-decoder (counterpart of ``repro/models/encdec.py``;
arXiv:2212.04356). Assigned arch: whisper-medium (24 encoder and 24 decoder
layers, d_model 1024).

The conv/mel frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings [B, enc_seq, D], adds learned positions
(``enc_pos``) and runs bidirectional self-attention (no RoPE) with a
layernorm and GELU MLP per layer. The decoder is a causal LM with RoPE
(the JAX package's documented deviation from Whisper's learned positions)
and cross-attention on the encoder's K/V, which the prefill computes once
per layer (``fill_cross_kv``) and the cache carries. Every attention runs
through the flash kernel on the card, its plain version on the CPU: the
encoder's and the cross-attention non-causal.

Three functions run the model on the JAX parameter tree (``embed``
[Vp, D], ``enc_pos`` [enc_seq, D], ``enc_layers`` and ``dec_layers`` with
leaves stacked on a leading layer axis, ``enc_ln_f``, ``ln_f``,
``lm_head`` [D, Vp]), its leaves cast to the compute dtype inside:
``encode``, ``decode`` and the teacher-forcing ``forward``. Their layers
are Python loops; with ``cfg.remat == 'layer'`` each layer is recomputed
in the backward (JAX's ``jax.checkpoint`` per layer), a decoder layer's
cross K/V projection included. Where a gradient is asked for, each
attention is ``layers.FlashAttention``. ``EncDecLM`` is the serving
``nn.Module``: per-layer modules whose weights are views of the stacked
tensors, and the same functions called on their compute-dtype copies.

The cache is the JAX one, whatever ``kv_cache_dtype`` says: the decoder's
self-attention ``k`` and ``v`` [L, B, max_len, Hkv, dh] and the
cross-attention ``xk`` and ``xv`` [L, B, enc_seq, Hkv, dh], all bf16, and
``len``, here a host ``int``. Calls write into it in place.
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
from .transformer import kv_cache_axes


def enc_layer_infos(cfg) -> dict:
    return {
        "ln1": L.norm_infos(cfg),
        "attn": L.attention_infos(cfg),
        "ln2": L.norm_infos(cfg),
        "mlp": L.mlp_infos(cfg),
    }


def dec_layer_infos(cfg) -> dict:
    return {
        "ln1": L.norm_infos(cfg),
        "self_attn": L.attention_infos(cfg),
        "ln_x": L.norm_infos(cfg),
        "cross_attn": L.attention_infos(cfg),
        "ln2": L.norm_infos(cfg),
        "mlp": L.mlp_infos(cfg),
    }


def lm_infos(cfg) -> dict:
    vp = L.padded_vocab(cfg.vocab)
    return {
        "embed": ParamInfo((vp, cfg.d_model), ("vocab", "dmodel"), "embed", scale=0.02),
        "enc_pos": ParamInfo((cfg.enc_seq, cfg.d_model), (None, "dmodel"), "small"),
        "enc_layers": stack_layers(cfg.enc_layers, enc_layer_infos(cfg)),
        "enc_ln_f": L.norm_infos(cfg),
        "dec_layers": stack_layers(cfg.n_layers, dec_layer_infos(cfg)),
        "ln_f": L.norm_infos(cfg),
        "lm_head": ParamInfo((cfg.d_model, vp), ("dmodel", "vocab")),
    }


def cache_infos(cfg, batch: int, max_len: int) -> dict:
    Hkv, dh = cfg.n_kv_heads, cfg.d_head
    kv = ParamInfo((cfg.n_layers, batch, max_len, Hkv, dh),
                   kv_cache_axes(cfg), "zeros", dtype=torch.bfloat16)
    xkv = ParamInfo((cfg.n_layers, batch, cfg.enc_seq, Hkv, dh),
                    ("layer", "batch", None, "kv_heads", None), "zeros", dtype=torch.bfloat16)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def enc_layer_apply(p: Mapping, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                    mode: str | None = None) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention without RoPE, then
    the MLP."""
    a, _ = L.attention_apply(p["attn"], L.norm_apply(p["ln1"], x, cfg), cfg,
                             positions=positions, causal=False, rope_on=False, mode=mode)
    x = x + a
    return x + L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], x, cfg), cfg)


def dec_layer_apply(p: Mapping, x: torch.Tensor, cfg, *, positions: torch.Tensor, rope_cs,
                    enc_kv=None, enc_out: torch.Tensor | None = None, cache: dict | None = None,
                    mode: str | None = None) -> torch.Tensor:
    """One decoder layer: causal self-attention (``cache``: the layer's
    slice, written in place), cross-attention on ``enc_kv`` or, without
    it, on the K/V projected here from ``enc_out``, then the MLP."""
    a, _ = L.attention_apply(p["self_attn"], L.norm_apply(p["ln1"], x, cfg), cfg,
                             positions=positions, cache=cache, mode=mode, rope_cs=rope_cs)
    x = x + a
    if enc_kv is None:
        enc_kv = L.encoder_kv(p["cross_attn"], enc_out, cfg)
    x = x + L.cross_attention_apply(p["cross_attn"], L.norm_apply(p["ln_x"], x, cfg), cfg,
                                    enc_kv, mode=mode)
    return x + L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], x, cfg), cfg)


def _run(layers, x: torch.Tensor, remat: bool, **kw) -> torch.Tensor:
    for layer in layers:
        x = checkpoint(layer, x, use_reentrant=False, **kw) if remat else layer(x, **kw)
    return x


def encode(params: Mapping, cfg, audio_embeds: torch.Tensor, *, layers=None,
           mode: str | None = None) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings [B, enc_seq, D]: its
    output [B, enc_seq, D] in the compute dtype. ``layers`` are per-layer
    callables ``(x, **kw) -> x`` (the serving module's); by default
    ``enc_layer_apply`` on each layer's slice of ``params["enc_layers"]``."""
    dt = cfg.compute_dtype
    x = audio_embeds.to(dt) + params["enc_pos"].to(dt)[None]
    if layers is None:
        layers = [partial(enc_layer_apply, lp, cfg=cfg)
                  for lp in unstack(params["enc_layers"], cfg.enc_layers)]
    remat = cfg.remat == "layer" and x.requires_grad
    x = _run(layers, x, remat, positions=torch.arange(x.shape[1], device=x.device), mode=mode)
    return L.norm_apply(params["enc_ln_f"], x, cfg)


def decode(params: Mapping, cfg, tokens: torch.Tensor, *, enc_out: torch.Tensor | None = None,
           cache: dict | None = None, layers=None, last_only: bool = False,
           return_hidden: bool = False, mode: str | None = None):
    """The decoder on tokens [B, S]: (logits [B, S or 1, Vp], new_cache), or
    with ``return_hidden`` the final normed hidden states in their place,
    in the compute dtype. Without a cache (training) the cross-attention
    K/V come from ``enc_out``, projected inside each (rematerialised)
    layer; with one, from its ``xk``/``xv``, and the call appends S tokens
    at ``cache['len']``. ``layers`` as in ``encode``, by default
    ``dec_layer_apply`` on the slices of ``params["dec_layers"]``."""
    if cache is None and enc_out is None:
        raise ValueError("decode without a cache needs the encoder output")
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    S = x.shape[1]
    offset = int(cache["len"]) if cache is not None else 0
    positions = offset + torch.arange(S, device=x.device)
    kw = dict(positions=positions, rope_cs=L.rope_tables(positions, cfg.d_head, cfg.rope_theta),
              mode=mode)
    if layers is None:
        layers = [partial(dec_layer_apply, lp, cfg=cfg)
                  for lp in unstack(params["dec_layers"], cfg.n_layers)]
    if cache is None:
        grads = x.requires_grad or enc_out.requires_grad
        x = _run(layers, x, cfg.remat == "layer" and grads, enc_out=enc_out, **kw)
    else:
        for i, layer in enumerate(layers):
            x = layer(x, enc_kv=(cache["xk"][i], cache["xv"][i]),
                      cache={"k": cache["k"][i], "v": cache["v"][i], "len": offset}, **kw)
    new_cache = None if cache is None else dict(cache, len=offset + S)
    if last_only:  # the norm is per position: normalise only what is kept
        x = x[:, -1:, :]
    x = L.norm_apply(params["ln_f"], x, cfg)
    if return_hidden:
        return x, new_cache
    return L.mask_padded_logits(x @ params["lm_head"].to(cfg.compute_dtype), cfg.vocab), new_cache


def forward(params: Mapping, cfg, tokens: torch.Tensor, *, audio_embeds: torch.Tensor,
            enc_layers=None, dec_layers=None, last_only: bool = False,
            return_hidden: bool = False, mode: str | None = None):
    """Teacher forcing (JAX ``forward``, the training path): encode, then
    decode ``tokens`` on the encoder's output in one call."""
    enc_out = encode(params, cfg, audio_embeds, layers=enc_layers, mode=mode)
    return decode(params, cfg, tokens, enc_out=enc_out, layers=dec_layers, last_only=last_only,
                  return_hidden=return_hidden, mode=mode)


class EncoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.Norm(cfg, p["ln1"])
        self.attn = L.Attention(cfg, p["attn"])
        self.ln2 = L.Norm(cfg, p["ln2"])
        self.mlp = L.MLP(cfg, p["mlp"])

    def forward(self, x, **kw):
        return enc_layer_apply({n: m.c for n, m in self.named_children()}, x, self.cfg, **kw)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.Norm(cfg, p["ln1"])
        self.self_attn = L.Attention(cfg, p["self_attn"])
        self.ln_x = L.Norm(cfg, p["ln_x"])
        self.cross_attn = L.CrossAttention(cfg, p["cross_attn"])
        self.ln2 = L.Norm(cfg, p["ln2"])
        self.mlp = L.MLP(cfg, p["mlp"])

    def forward(self, x, **kw):
        return dec_layer_apply({n: m.c for n, m in self.named_children()}, x, self.cfg, **kw)


class EncDecLM(L.Weights):
    """The encoder-decoder on the device its weights lie on.

    ``params`` is the JAX parameter tree (``lm_infos``) as tensors. The
    attribute ``mode`` picks the attention route of every layer, as in
    ``TransformerLM``.
    """

    mode: str | None = None

    def __init__(self, cfg, params: Mapping):
        super().__init__({n: params[n] for n in ("embed", "enc_pos", "lm_head")},
                         cfg.compute_dtype)
        self.cfg = cfg
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, lp) for lp in
                                        unstack(params["enc_layers"], cfg.enc_layers))
        self.enc_ln_f = L.Norm(cfg, params["enc_ln_f"])
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, lp) for lp in
                                        unstack(params["dec_layers"], cfg.n_layers))
        self.ln_f = L.Norm(cfg, params["ln_f"])

    def _params(self) -> dict:
        return dict(self.c, enc_ln_f=self.enc_ln_f.c, ln_f=self.ln_f.c)

    def encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The module-level ``encode`` on the compute-dtype copies."""
        return encode(self._params(), self.cfg, audio_embeds, layers=self.enc_layers,
                      mode=self.mode)

    def fill_cross_kv(self, cache: dict, enc_out: torch.Tensor) -> dict:
        """Write every decoder layer's cross-attention K/V of ``enc_out`` into
        the cache's ``xk`` and ``xv`` (bf16) in place; returns the cache."""
        for i, layer in enumerate(self.dec_layers):
            k, v = layer.cross_attn.kv(enc_out)
            cache["xk"][i].copy_(k)
            cache["xv"][i].copy_(v)
        return cache

    def decode(self, tokens: torch.Tensor, *, enc_out: torch.Tensor | None = None,
               cache: dict | None = None,
               last_only: bool = False) -> tuple[torch.Tensor, dict | None]:
        """The module-level ``decode`` on the compute-dtype copies."""
        return decode(self._params(), self.cfg, tokens, enc_out=enc_out, cache=cache,
                      layers=self.dec_layers, last_only=last_only, mode=self.mode)

    def prefill(self, tokens: torch.Tensor, audio_embeds: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
        """Encode, fill the cache's cross K/V, then decode the prompt:
        (last-position logits [B, 1, Vp], cache)."""
        self.fill_cross_kv(cache, self.encode(audio_embeds))
        return self.decode(tokens, cache=cache, last_only=True)

    def forward(self, tokens: torch.Tensor, *, audio_embeds: torch.Tensor,
                cache: dict | None = None,
                last_only: bool = False) -> tuple[torch.Tensor, dict | None]:
        """Teacher forcing: encode, then decode ``tokens`` in one call."""
        return self.decode(tokens, enc_out=self.encode(audio_embeds), cache=cache,
                           last_only=last_only)
