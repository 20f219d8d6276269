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

``EncDecLM`` is an ``nn.Module`` built from the JAX parameter tree:
``embed`` [Vp, D], ``enc_pos`` [enc_seq, D], ``enc_layers`` and
``dec_layers`` (leaves stacked on a leading layer axis), ``enc_ln_f``,
``ln_f``, ``lm_head`` [D, Vp]. Its layers are Python loops over per-layer
modules whose weights are views of the stacked tensors.

The cache is the JAX one, whatever ``kv_cache_dtype`` says: the decoder's
self-attention ``k`` and ``v`` [L, B, max_len, Hkv, dh] and the
cross-attention ``xk`` and ``xv`` [L, B, enc_seq, Hkv, dh], all bf16, and
``len``, here a host ``int``. Calls write into it in place.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from . import layers as L
from .params import ParamInfo, stack_layers


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
                   ("layer", "batch", None, "kv_heads", None), "zeros", dtype=torch.bfloat16)
    xkv = ParamInfo((cfg.n_layers, batch, cfg.enc_seq, Hkv, dh),
                    ("layer", "batch", None, "kv_heads", None), "zeros", dtype=torch.bfloat16)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def _unstack(stacked: Mapping, i: int) -> dict:
    return {blk: {n: t[i] for n, t in leaves.items()} for blk, leaves in stacked.items()}


class EncoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = L.Norm(cfg, p["ln1"])
        self.attn = L.Attention(cfg, p["attn"])
        self.ln2 = L.Norm(cfg, p["ln2"])
        self.mlp = L.MLP(cfg, p["mlp"])

    def forward(self, x, *, positions, mode=None):
        a, _ = self.attn(self.ln1(x), positions=positions, causal=False, rope_on=False,
                         mode=mode)
        x = x + a
        return x + self.mlp(self.ln2(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = L.Norm(cfg, p["ln1"])
        self.self_attn = L.Attention(cfg, p["self_attn"])
        self.ln_x = L.Norm(cfg, p["ln_x"])
        self.cross_attn = L.CrossAttention(cfg, p["cross_attn"])
        self.ln2 = L.Norm(cfg, p["ln2"])
        self.mlp = L.MLP(cfg, p["mlp"])

    def forward(self, x, *, positions, rope_cs, enc_kv, cache=None, mode=None):
        a, _ = self.self_attn(self.ln1(x), positions=positions, cache=cache, mode=mode,
                              rope_cs=rope_cs)
        x = x + a
        x = x + self.cross_attn(self.ln_x(x), enc_kv, mode=mode)
        return x + self.mlp(self.ln2(x))


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
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, _unstack(params["enc_layers"], i))
                                        for i in range(cfg.enc_layers))
        self.enc_ln_f = L.Norm(cfg, params["enc_ln_f"])
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, _unstack(params["dec_layers"], i))
                                        for i in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, params["ln_f"])

    def encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The bidirectional encoder over frame embeddings [B, enc_seq, D]:
        its output [B, enc_seq, D] in the compute dtype."""
        dt = self.cfg.compute_dtype
        x = audio_embeds.to(dt) + self.c["enc_pos"][None]
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in self.enc_layers:
            x = layer(x, positions=positions, mode=self.mode)
        return self.enc_ln_f(x)

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
        """The decoder on tokens [B, S]: (logits [B, S or 1, Vp] in the
        compute dtype, new_cache). Without a cache the cross-attention K/V
        come from ``enc_out``; with one, from its ``xk``/``xv``, and the call
        appends S tokens at ``cache['len']``."""
        cfg = self.cfg
        x = L.embed(self.c["embed"], tokens, cfg.compute_dtype)
        S = x.shape[1]
        offset = int(cache["len"]) if cache is not None else 0
        positions = offset + torch.arange(S, device=x.device)
        rope_cs = L.rope_tables(positions, cfg.d_head, cfg.rope_theta)
        if cache is None and enc_out is None:
            raise ValueError("decode without a cache needs the encoder output")
        for i, layer in enumerate(self.dec_layers):
            if cache is None:
                lc, enc_kv = None, layer.cross_attn.kv(enc_out)
            else:
                lc = {"k": cache["k"][i], "v": cache["v"][i], "len": offset}
                enc_kv = (cache["xk"][i], cache["xv"][i])
            x = layer(x, positions=positions, rope_cs=rope_cs, enc_kv=enc_kv, cache=lc,
                      mode=self.mode)
        new_cache = None if cache is None else dict(cache, len=offset + S)
        if last_only:  # the norm is per position: normalise only what is kept
            x = x[:, -1:, :]
        logits = self.ln_f(x) @ self.c["lm_head"]
        return L.mask_padded_logits(logits, cfg.vocab), new_cache

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
