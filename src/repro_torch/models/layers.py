"""Layers of the LMs (counterpart of ``repro/models/layers.py``): norms,
RoPE, GQA attention with a KV cache (bf16, or int8 codes with per-row
scales) and an optional sliding window, cross-attention on an encoder's
K/V, the dense MLP, and the top-k routed MoE FFN.

Each layer is a plain function on tensors (``*_apply``, taking a mapping
from the JAX parameter names to tensors, cast to the compute dtype inside
as the JAX package does) and an ``nn.Module`` that holds the float32
master weights under the same names, makes their compute-dtype copies once
(``Weights.refresh``) and calls the function. ``*_infos`` declare the
parameters with the JAX layouts (``wq`` [D, H, dh], ``wi`` [D, 2, F], ...).

Attention runs through ``kernels.ops.gqa_flash_attention``: the
hand-written CUDA kernel for CUDA tensors, its plain PyTorch version for
CPU tensors (or wherever ``mode='torch'`` is asked for). That covers the
causal self-attention of the decoders, the encoder's bidirectional
self-attention (``causal=False, rope_on=False``) and cross-attention.
An int8 cache is dequantized, as the JAX layer does it, into a fresh
compute-dtype buffer of the rows the queries see, which the kernel then
reads. ``chunked_attention``, the JAX models' own attention, is not on
the forward path: it is the backward's. When q, k or v need a gradient
(the training path), self- and cross-attention go through
``FlashAttention``, an autograd Function whose forward is that same kernel
call and whose backward differentiates ``chunked_attention`` recomputed
from q, k and v, as JAX differentiates its jnp attention (``grad_route``
picks it, as the WKV and the selective scan pick theirs). MoE is the JAX
package's sort-based dispatch into per-expert capacity buffers,
differentiated through its gathers and the top-k's values.

**On a mesh.** ``activation_sharding(ctx)`` installs a :class:`MeshContext`
(JAX's ``activation_sharding`` and ``mesh_info``): the (data, model) mesh
of ``distributed.collectives``, its groups and this rank's coordinates,
and the spec of every parameter (``distributed.sharding.param_specs``,
JAX's). Each rank holds its slices of the parameters and its rows of the
batch. JAX lets GSPMD place the collectives from ``shard`` constraints;
here each route places them itself, with Megatron's pairs
(``collectives.copy_to`` before a column-parallel product, ``reduce_from``
after a row-parallel one), so every gradient of a leaf replicated over
'model' comes out whole on each rank. A decoder layer first gathers what
its rank does not compute on sharded (``MeshContext.gather``): the FSDP
rows over the data axes, in the compute dtype (a reduce-scatter in the
backward), and 'model' where the spec put it on a weight's 'dmodel'
dimension. 'model' on heads, kv heads, the MLP width, the vocab and the
experts stays: those are the tensor-parallel products.

* ``sharded_embed`` (JAX ``:118``): each rank gathers from its vocab rows,
  one float32 all-reduce over 'model'.
* attention (JAX ``attention_apply``): q, k, v column-parallel over the
  rank's heads, ``wo`` row-parallel. Where the kv heads do not divide TP
  (JAX's kv expansion), k and v are computed whole and each rank reads the
  kv heads its query heads map to. With ``cfg.attn_shard == 'seq'`` and no
  cache, ``_seq_sharded_attention`` (JAX ``:303``): each rank attends its
  S / tp queries of every head at ``q_offset = rank * S / tp`` against all
  S kv rows.
* ``mlp_apply``: ``wi`` column-parallel, ``wo`` row-parallel.
* ``_moe_expert_parallel`` (JAX ``:539``): each rank dispatches its rows
  into a local capacity buffer of its E / tp experts; one combine
  all-reduce over 'model' in float32 (or bf16, ``moe_combine_dtype``).

In the 'dp' layout 'model' is one more data axis: no tensor parallelism,
every weight gathered. The KV cache is sharded over kv heads where they
divide TP and replicated over 'model' where they do not (JAX shards it over
time there, ``cache_time``: ROADMAP 10p-c).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MeshConfig, sharding_rules
from ..distributed import collectives as C
from ..kernels import ops
from ..kernels.flash_attention import NEG_INF, first_visible_row, flash_attention
from .params import ParamInfo, axis_names, map_infos, partition_specs


class Weights(nn.Module):
    """Parameters under their JAX names, as float32 masters, and their
    compute-dtype copies.

    The copies are made once, at construction and after any ``.to()`` /
    ``.cuda()`` (``_apply``), not at every call: casting per call would
    give the same values for more work. Names in ``keep`` (norm scales and
    biases, which the JAX layers use in float32) are not cast. ``c`` maps
    every name to the tensor the layer computes with.
    """

    def __init__(self, params: Mapping[str, torch.Tensor], compute_dtype: torch.dtype,
                 keep: tuple[str, ...] = ()):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.compute_dtype = compute_dtype
        self.keep = frozenset(keep)
        self.refresh()

    def refresh(self) -> None:
        self.c = {n: p.detach() if n in self.keep else p.detach().to(self.compute_dtype)
                  for n, p in self._parameters.items()}

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.refresh()
        return self


# --- the mesh context ------------------------------------------------------------------

#: leaves a layer uses in float32 whatever the compute dtype (the norms', the router)
KEEP_F32 = ("scale", "bias", "router")
#: logical axes of a weight's residual-stream dimension
DMODEL_AXES = ("dmodel", "expert_dmodel")


@dataclasses.dataclass(frozen=True, eq=False)
class MeshContext:
    """What the layers read on a mesh: the mesh, the configuration, and per
    leaf of the LM's parameter tree its spec (JAX's rules on the mesh's
    sizes) and its logical axes.

    ``tp`` is the tensor-parallel width ('model' in the 'tp' layout, 1 in
    the 'dp' layout); the batch is split over ``batch_axes`` ('data', or
    every axis in the 'dp' layout), ``dp`` ranks in all."""

    mesh: Any
    cfg: Any
    specs: Mapping
    axes: Mapping

    @classmethod
    def build(cls, mesh, cfg, infos) -> "MeshContext":
        """The context of ``cfg``'s LM, whose parameters ``infos`` declares
        (``Model.param_infos()``), on ``mesh`` (``collectives.Mesh``)."""
        mcfg = MeshConfig(data=mesh.sizes["data"], model=mesh.sizes["model"])
        return cls(mesh, cfg, partition_specs(infos, sharding_rules(cfg, mcfg), mesh.sizes),
                   map_infos(lambda i: i.axes, infos))

    @property
    def tp(self) -> int:
        return self.mesh.sizes["model"] if self.cfg.layout == "tp" else 1

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return ("data",) if self.cfg.layout == "tp" else ("data", "model")

    @property
    def dp(self) -> int:
        return self.mesh.size(self.batch_axes)

    @property
    def rank(self) -> int:
        """This rank's index along 'model'."""
        return self.mesh.coords["model"]

    def local_rows(self, batch: Mapping[str, torch.Tensor]) -> dict:
        """This rank's rows of a global batch (every tensor's leading dim,
        which ``dp`` must divide)."""
        out = {}
        for k, v in batch.items():
            if v.shape[0] % self.dp:
                raise ValueError(f"batch {k} of {v.shape[0]} rows does not split over "
                                 f"{self.dp} data-parallel ranks")
            out[k] = self.mesh.local_slice(v, self.batch_axes, 0)
        return out

    def gather_leaf(self, t: torch.Tensor, spec, logical, name: str) -> torch.Tensor:
        """One leaf as the layer computes with it: cast to the compute
        dtype (unless ``name`` is in KEEP_F32), then gathered over each
        batch axis of its spec (``gather_sum``: a reduce-scatter in the
        backward) and over 'model' on a 'dmodel' dimension (``gather_from``:
        that weight's compute is replicated over 'model'), innermost axis
        first. 'model' on any other dimension stays, and an axis of one
        rank (whose gather is the identity) is skipped."""
        if name not in KEEP_F32:
            t = t.to(self.cfg.compute_dtype)
        for dim, entry in enumerate(spec):
            for ax in reversed(axis_names(entry)):
                if self.mesh.sizes[ax] == 1:
                    continue
                if ax in self.batch_axes:
                    t = C.gather_sum(t, self.mesh, ax, dim)
                elif logical[dim] in DMODEL_AXES:
                    t = C.gather_from(t, self.mesh, ax, dim)
        return t

    def gather(self, p: Mapping, specs: Mapping, axes: Mapping, drop: int = 0) -> dict:
        """``gather_leaf`` over a parameter subtree and its specs and axes;
        ``drop`` leading spec entries are left out (a stacked layer's
        'layer' axis, for one layer's slice)."""
        out = {}
        for k, v in p.items():
            if isinstance(v, Mapping):
                out[k] = self.gather(v, specs[k], axes[k], drop)
            else:
                out[k] = self.gather_leaf(v, specs[k][drop:], axes[k][drop:], k)
        return out

    def gather_layer(self, p: Mapping) -> dict:
        """One decoder layer's slice of the stacked ``params['layers']``."""
        return self.gather(p, self.specs["layers"], self.axes["layers"], drop=1)


_CTX: dict = {"mesh": None}


@contextlib.contextmanager
def activation_sharding(ctx: MeshContext | None):
    """Install ``ctx`` for the layers while the block runs (JAX's
    ``activation_sharding``); None runs them on one device."""
    prev = _CTX["mesh"]
    _CTX["mesh"] = ctx
    try:
        yield ctx
    finally:
        _CTX["mesh"] = prev


def mesh_info() -> MeshContext | None:
    """The installed context, or None (JAX's ``mesh_info``)."""
    return _CTX["mesh"]


def _tp(ctx: MeshContext | None) -> bool:
    return ctx is not None and ctx.tp > 1


# --- vocab padding ------------------------------------------------------------------

def padded_vocab(v: int) -> int:
    return -(-v // 256) * 256


def mask_padded_logits(logits: torch.Tensor, true_vocab: int, offset: int = 0) -> torch.Tensor:
    """Padded vocab columns to -1e30; ``offset`` is the global index of the
    first column (a rank's block of a vocab-parallel unembedding)."""
    if offset == 0 and logits.shape[-1] == true_vocab:
        return logits
    col = offset + torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= true_vocab, NEG_INF)


def vocab_split(ctx: MeshContext | None, head: torch.Tensor) -> bool:
    """Whether ``head`` [D, V] is this rank's block of a vocab-parallel
    unembedding (its columns split over 'model')."""
    return _tp(ctx) and head.shape[-1] * ctx.tp == padded_vocab(ctx.cfg.vocab)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's single-device embedding lookup: the table in the
    compute dtype, gathered."""
    return table.to(dtype)[tokens]


def sharded_embed(table: torch.Tensor, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The embedding lookup on a mesh (JAX ``sharded_embed``). ``table`` is
    this rank's block [Vp / tp, D] of rows (its FSDP columns already
    gathered): each rank gathers the ids in its range, the others give
    zeros, and one float32 all-reduce over 'model' assembles the
    embeddings (identity backward: each rank's gradient lands in its own
    rows). The dense lookup where the rows are not split (tp 1, the 'dp'
    layout, a vocab that does not divide)."""
    ctx = mesh_info()
    if not _tp(ctx) or table.shape[0] * ctx.tp != padded_vocab(cfg.vocab):
        return embed(table, tokens, cfg.compute_dtype)
    v_loc = table.shape[0]
    local = tokens.long() - ctx.rank * v_loc
    ok = (local >= 0) & (local < v_loc)
    x = torch.where(ok[..., None], table[local.clamp(0, v_loc - 1)].float(), 0.0)
    return C.reduce_from(x, ctx.mesh, "model").to(cfg.compute_dtype)


# --- norms -----------------------------------------------------------------------

def norm_infos(cfg) -> dict:
    d = {"scale": ParamInfo((cfg.d_model,), ("dmodel",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamInfo((cfg.d_model,), ("dmodel",), "zeros")
    return d


def norm_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:  # rmsnorm
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return y.to(x.dtype)


class Norm(Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype, keep=("scale", "bias"))
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_apply(self.c, x, self.cfg)


# --- rotary position embeddings ----------------------------------------------------

def rope_tables(positions: torch.Tensor, dh: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [S, 1, dh/2] in float32 for absolute ``positions`` [S]."""
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[:, None].float() * freqs[None, :]
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on x [..., S, H, dh] with tables from ``rope_tables``, in float32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE. x: [..., S, H, dh], positions: [S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization per (token, head): x [B, S, H, dh] ->
    (int8 codes [B, S, H, dh], bf16 scales [B, S, H]). The codes divide by
    the float32 scale, rounded half to even; the scale is stored in bf16."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """codes [B, T, H, dh] int8 and scales [B, T, H] as a new tensor in
    ``dtype``: codes.to(dtype) * scale.to(dtype), one rounding, as JAX."""
    return codes.to(dtype) * scale.to(dtype)[..., None]


# --- GQA attention ------------------------------------------------------------------

def attention_infos(cfg) -> dict:
    H, Hkv, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    d = {
        "wq": ParamInfo((D, H, dh), ("dmodel", "heads", None)),
        "wk": ParamInfo((D, Hkv, dh), ("dmodel", "kv_heads", None)),
        "wv": ParamInfo((D, Hkv, dh), ("dmodel", "kv_heads", None)),
        "wo": ParamInfo((H, dh, D), ("heads", None, "dmodel")),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamInfo((H, dh), ("heads", None), "zeros")
        d["bk"] = ParamInfo((Hkv, dh), ("kv_heads", None), "zeros")
        d["bv"] = ParamInfo((Hkv, dh), ("kv_heads", None), "zeros")
    return d


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, rope_cs):
    """Project to q [B, S, H, dh] and k, v [B, S, Hkv, dh] in the compute
    dtype, with RoPE from ``rope_cs`` = (cos, sin) (none if it is None)."""
    dt = cfg.compute_dtype
    q = _project(x, p["wq"].to(dt))
    k = _project(x, p["wk"].to(dt))
    v = _project(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if rope_cs is None:
        return q, k, v
    return apply_rope(q, *rope_cs), apply_rope(k, *rope_cs), v


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, Hkv, G, dh]
    k: torch.Tensor,  # [B, Skv, Hkv, dh]
    v: torch.Tensor,  # [B, Skv, Hkv, dh]
    *,
    causal: bool,
    q_offset: int = 0,
    kv_offset: int = 0,
    kv_valid: int | None = None,
    chunk: int = 1024,
    window: int = 0,
) -> torch.Tensor:
    """The JAX models' attention, chunked over queries: scores in the input
    dtype then float32, softmax in float32, the weights cast back to the
    input dtype before P.V. A plain function the tests hold the JAX one
    to; the model's path is ``gqa_flash_attention``."""
    B, Sq, Hkv, G, dh = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    kv_pos = kv_offset + torch.arange(Skv, device=q.device)
    outs = []
    for c0 in range(0, Sq, chunk):
        qc = q[:, c0:c0 + chunk]
        q_pos = q_offset + c0 + torch.arange(qc.shape[1], device=q.device)
        s = torch.einsum("bqhgk,bthk->bhgqt", qc, k).float() * scale
        mask = torch.ones((q_pos.shape[0], Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_valid is not None:
            mask &= kv_pos[None, :] < kv_valid
        s = s.masked_fill(~mask, NEG_INF)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhgqt,bthk->bqhgk", w, v))
    return torch.cat(outs, dim=1)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: ``apply(q, k, v, causal, window, chunk)``
    on q [B, Sq, H, dh], k, v [B, Skv, Hkv, dh] (self-attention, or
    cross-attention on an encoder's rows); a seventh argument ``q_offset``
    places the queries at absolute positions q_offset.. (the
    sequence-sharded attention's rows of one rank).

    The forward is ``kernels.flash_attention.flash_attention``: the
    hand-written kernel on CUDA tensors (a launch like serving's, counted in
    its ``LAUNCHES``), its plain version on CPU tensors. It keeps q, k and v.
    The backward recomputes the attention with ``chunked_attention`` (query
    chunks of ``chunk``, the JAX models' attention and the function JAX
    differentiates; its ``jax.checkpoint`` per chunk recomputes as this does)
    and returns its gradients: dk and dv sum over each kv head's query group.
    The JAX package has no backward kernel (its Pallas flash kernel has none).
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, chunk: int, *q_offset: int):
        ctx.save_for_backward(q, k, v)
        off = int(q_offset[0]) if q_offset else 0
        ctx.opts = (causal, window, chunk, off, len(q_offset))
        return flash_attention(q, k, v, causal=causal, q_offset=off, window=window)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, window, chunk, off, n_extra = ctx.opts
        B, Sq, H, dh = q.shape
        Hkv = k.shape[2]
        with torch.enable_grad():
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            out = chunked_attention(qg.view(B, Sq, Hkv, H // Hkv, dh), kg, vg, causal=causal,
                                    q_offset=off, window=window, chunk=chunk)
            dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), dout.reshape(out.shape))
        return (dq, dk, dv, None, None, None) + (None,) * n_extra


def grad_route(mode: str, *xs: torch.Tensor) -> bool:
    """Whether a kernel call takes its autograd Function: where a gradient
    is asked for through any of ``xs`` (the training forward). There the
    Function's forward is the kernel on CUDA tensors, so ``mode`` may not
    ask for the plain route on them, and 'cuda' needs CUDA tensors (or meta
    ones, where the kernel gives shapes only: the dry run's count). On meta
    tensors 'torch' takes autograd through the plain version, the dry run's
    count of the plain route."""
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return False
    if mode == "torch" and xs[0].is_meta:
        return False
    if mode == "cuda":
        ops.require_cuda(xs[0])
    elif xs[0].is_cuda:
        raise ValueError("the training forward on CUDA tensors runs the kernel; "
                         f"mode={mode!r} asks for the plain route")
    return True


def attention_apply(
    p: Mapping[str, torch.Tensor],
    x: torch.Tensor,  # [B, S, D]
    cfg,
    *,
    positions: torch.Tensor,  # [S] absolute positions of x
    cache: dict | None = None,  # {'k': [B, T, Hkv, dh], 'v': ..., 'len': int}
    causal: bool = True,
    rope_on: bool = True,
    window: int = 0,
    mode: str | None = None,
    rope_cs: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention with RoPE and an optional KV cache: (out [B, S, D],
    new_cache). ``causal=False, rope_on=False`` is the encoder's
    bidirectional attention.

    With a cache, k and v are written in place into its rows
    [len, len + S) (the returned cache shares the tensors) and the queries,
    at q_offset = len, read its first len + S rows. A bf16 cache (the
    models' own) or a float32 one (JAX's layer writes whatever dtype the
    cache holds) is read where it lies. An int8 cache ({'k', 'v': int8 codes, 'k_scale',
    'v_scale': [B, T, Hkv] bf16}) takes the new rows quantized by
    ``quantize_kv``; the rows the queries see are dequantized into a new
    compute-dtype buffer, which the kernel reads. ``window`` > 0 is a
    sliding window: a query sees only the last ``window`` keys up to its
    position. The kernel masks the rows below it and starts reading at the
    first tile a query sees, which equals the JAX layer's read of the
    cache's last window + S rows. ``mode`` picks the kernel route ('cuda')
    or the plain one ('torch'); ``None`` takes 'cuda' for CUDA tensors and
    'torch' for CPU tensors. ``rope_cs`` reuses RoPE tables of
    ``positions``. Without a cache, when q, k or v need a gradient, the
    attention is ``FlashAttention`` (chunk ``cfg.attn_chunk``): there
    ``mode`` may not ask for the plain route on CUDA tensors, whose forward
    is the kernel.
    """
    dt = cfg.compute_dtype
    if not rope_on:
        rope_cs = None
    elif rope_cs is None:
        rope_cs = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    if mode is None:
        mode = "cuda" if x.is_cuda else "torch"
    ctx = mesh_info()
    if _tp(ctx):
        return _attention_tp(p, x, cfg, ctx, cache=cache, causal=causal, window=window,
                             mode=mode, rope_cs=rope_cs)
    q, k, v = qkv(p, x, cfg, rope_cs)
    B, S = x.shape[:2]
    if cache is None:
        out = _attend(q, k, v, cfg, causal=causal, window=window, mode=mode)
        new_cache = None
    else:
        rk, rv, q_offset, new_cache = _cache_rows(cache, k, v, window, dt)
        out = ops.gqa_flash_attention(q.contiguous(), rk, rv, causal=causal, q_offset=q_offset,
                                      window=window, mode=mode)
    wo = p["wo"].to(dt)
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, new_cache


def _cache_rows(cache: dict, k: torch.Tensor, v: torch.Tensor, window: int, dt: torch.dtype):
    """Write k, v [B, S, Hkv, dh] into the cache's rows [len, len + S) in
    place and return (the rows the queries read, k and v, the queries'
    offset into them, the new cache). An int8 cache takes the rows
    quantized; the visible rows come back dequantized into a new buffer."""
    ck, cv, idx = cache["k"], cache["v"], int(cache["len"])
    end = idx + k.shape[1]
    new_cache = {"k": ck, "v": cv, "len": end}
    if ck.dtype == torch.int8:
        (ck[:, idx:end], cache["k_scale"][:, idx:end]) = quantize_kv(k)
        (cv[:, idx:end], cache["v_scale"][:, idx:end]) = quantize_kv(v)
        lo = first_visible_row(idx, window)  # rows below it no query sees
        rk = dequantize_kv(ck[:, lo:end], cache["k_scale"][:, lo:end], dt)
        rv = dequantize_kv(cv[:, lo:end], cache["v_scale"][:, lo:end], dt)
        new_cache.update(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
        return rk, rv, idx - lo, new_cache
    if ck.dtype in (torch.bfloat16, torch.float32):
        ck[:, idx:end] = k
        cv[:, idx:end] = v
        return ck[:, :end], cv[:, :end], idx, new_cache
    raise TypeError(f"a KV cache is bf16, float32 or int8, got {ck.dtype}")


def _attend(q, k, v, cfg, *, causal: bool, window: int, mode: str, q_offset: int = 0):
    """The kernel (or, where a gradient is asked for, ``FlashAttention``)
    on q [B, Sq, H, dh] at ``q_offset`` against k, v [B, Skv, Hkv, dh]."""
    if grad_route(mode, q, k, v):
        at = (q_offset,) if q_offset else ()  # the Function's optional seventh argument
        return FlashAttention.apply(q.contiguous(), k, v, causal, window, cfg.attn_chunk, *at)
    return ops.gqa_flash_attention(q.contiguous(), k, v, causal=causal, q_offset=q_offset,
                                   window=window, mode=mode)


def _kv_for_heads(k: torch.Tensor, first: int, n: int, G: int) -> torch.Tensor:
    """The kv heads that query heads [first, first + n) read (query head h
    reads kv head h // G), from k [B, T, Hkv, dh] holding every kv head, in
    the kernel's grouping: a view of the contiguous kv heads where each
    reads whole groups or all read one kv head, else one kv head per query
    head (JAX's kv expansion)."""
    if n % G == 0:
        return k[:, :, first // G:first // G + n // G]
    if G % n == 0:
        return k[:, :, first // G:first // G + 1]
    return k.index_select(2, torch.arange(first, first + n, device=k.device) // G)


def _attention_tp(p, x, cfg, ctx: MeshContext, *, cache, causal: bool, window: int, mode: str,
                  rope_cs):
    """Attention on a mesh (JAX ``attention_apply`` under GSPMD). ``p``
    holds this rank's weights: ``wq`` [D, H / tp, dh] and ``wo`` when the
    heads divide TP (else whole), ``wk`` and ``wv`` over H_kv / tp heads
    when those divide (else whole). Sharded projections are
    column-parallel (``copy_to`` on x) and ``wo`` row-parallel (one
    all-reduce); whole k and v are computed on every rank, and each rank
    reads the kv heads of its query heads. With ``cfg.attn_shard == 'seq'``,
    no cache and S > 1 dividing TP the attention is
    ``_seq_sharded_attention``. A cache holds this rank's kv heads (all of
    them where they do not divide TP)."""
    mesh, tp, dt = ctx.mesh, ctx.tp, cfg.compute_dtype
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    Hl, heads_split, kv_split = p["wq"].shape[1], p["wq"].shape[1] < H, p["wk"].shape[1] < Hkv
    x_col = C.copy_to(x, mesh, "model") if heads_split else x

    def project(xx, w: str, b: str) -> torch.Tensor:
        y = _project(xx, p[w].to(dt))
        return y + p[b].to(dt) if cfg.qkv_bias else y

    q = project(x_col, "wq", "bq")
    xkv = x_col if kv_split else x
    k, v = project(xkv, "wk", "bk"), project(xkv, "wv", "bv")
    if rope_cs is not None:
        q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)
    B, S = x.shape[:2]
    first, G = ctx.rank * Hl if heads_split else 0, H // Hkv
    if cache is None:
        seq = cfg.attn_shard == "seq" and S > 1 and S % tp == 0
        if not kv_split and (heads_split or seq):
            # whole k, v of which each rank reads a part: their gradients add
            k, v = C.copy_to(k, mesh, "model"), C.copy_to(v, mesh, "model")
        if seq:
            out = _seq_sharded_attention(q, k, v, cfg, ctx, heads_split=heads_split,
                                         kv_split=kv_split, causal=causal, window=window,
                                         mode=mode)
        else:
            if heads_split and not kv_split:
                k, v = _kv_for_heads(k, first, Hl, G), _kv_for_heads(v, first, Hl, G)
            out = _attend(q, k, v, cfg, causal=causal, window=window, mode=mode)
        new_cache = None
    else:
        rk, rv, q_offset, new_cache = _cache_rows(cache, k, v, window, dt)
        if heads_split and not kv_split:
            rk, rv = _kv_for_heads(rk, first, Hl, G), _kv_for_heads(rv, first, Hl, G)
        out = ops.gqa_flash_attention(q.contiguous(), rk, rv, causal=causal, q_offset=q_offset,
                                      window=window, mode=mode)
    wo = p["wo"].to(dt)
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    if heads_split:
        y = C.reduce_from(y, mesh, "model")
    return y, new_cache


def _seq_sharded_attention(q, k, v, cfg, ctx: MeshContext, *, heads_split: bool,
                           kv_split: bool, causal: bool, window: int, mode: str):
    """Sequence-sharded attention (JAX ``_seq_sharded_attention``): rank r
    attends queries [r S / tp, (r + 1) S / tp) of every head at ``q_offset
    = r S / tp`` against all S kv rows. With the heads split, q, k and v are
    first gathered over the heads and the rows' output goes back to the
    heads layout (all-gathers whose backward is a reduce-scatter); with
    them whole, each rank takes its rows of q and the outputs are
    gathered. Returns [B, S, H / tp, dh] (heads split) or [B, S, H, dh]."""
    mesh, r = ctx.mesh, ctx.rank
    S = q.shape[1]
    Sl = S // ctx.tp
    if heads_split:
        q = C.gather_sum(q, mesh, "model", 2).narrow(1, r * Sl, Sl)
        if kv_split:
            k, v = C.gather_sum(k, mesh, "model", 2), C.gather_sum(v, mesh, "model", 2)
    else:
        q = C.scatter_to(q, mesh, "model", 1)
    out = _attend(q, k, v, cfg, causal=causal, window=window, mode=mode, q_offset=r * Sl)
    if heads_split:
        Hl = out.shape[2] // ctx.tp
        return C.gather_sum(out, mesh, "model", 1).narrow(2, r * Hl, Hl)
    return C.gather_from(out, mesh, "model", 1)


class Attention(Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype)
        self.cfg = cfg

    def forward(self, x, *, positions, cache=None, causal=True, rope_on=True, mode=None,
                rope_cs=None):
        return attention_apply(self.c, x, self.cfg, positions=positions, cache=cache,
                               causal=causal, rope_on=rope_on, window=self.cfg.sliding_window,
                               mode=mode, rope_cs=rope_cs)


def encoder_kv(p: Mapping[str, torch.Tensor], enc_out: torch.Tensor,
               cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K, V [B, T_enc, Hkv, dh] in the compute dtype from the
    encoder output [B, T_enc, D] (computed once, at the prefill)."""
    dt = cfg.compute_dtype
    k = _project(enc_out, p["wk"].to(dt))
    v = _project(enc_out, p["wv"].to(dt))
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


def cross_attention_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg,
                          enc_kv: tuple[torch.Tensor, torch.Tensor], *,
                          mode: str | None = None) -> torch.Tensor:
    """Cross-attention of x [B, S, D] (no RoPE) on the encoder's K, V
    [B, T_enc, Hkv, dh]: every query sees every encoder row. The K, V may
    be the bf16 cache's rows under a float32 q (the kernel reads them as
    they are; JAX casts them to float32, which changes no value). When a
    gradient is asked for (``grad_route``) the attention is
    ``FlashAttention``, non-causal over the encoder's rows."""
    dt = cfg.compute_dtype
    q = _project(x, p["wq"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    if mode is None:
        mode = "cuda" if x.is_cuda else "torch"
    k, v = enc_kv
    if grad_route(mode, q, k, v):
        out = FlashAttention.apply(q.contiguous(), k, v, False, 0, cfg.attn_chunk)
    else:
        out = ops.gqa_flash_attention(q.contiguous(), k, v, causal=False, mode=mode)
    wo = p["wo"].to(dt)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


class CrossAttention(Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype)
        self.cfg = cfg

    def kv(self, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return encoder_kv(self.c, enc_out, self.cfg)

    def forward(self, x, enc_kv, *, mode=None):
        return cross_attention_apply(self.c, x, self.cfg, enc_kv, mode=mode)


# --- dense MLP ------------------------------------------------------------------------

def mlp_infos(cfg, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    Fh = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi": ParamInfo((D, 2, Fh), ("dmodel", None, "mlp")),  # gate & up fused
            "wo": ParamInfo((Fh, D), ("mlp", "dmodel")),
        }
    return {
        "wi": ParamInfo((D, Fh), ("dmodel", "mlp")),
        "bi": ParamInfo((Fh,), ("mlp",), "zeros"),
        "wo": ParamInfo((Fh, D), ("mlp", "dmodel")),
        "bo": ParamInfo((D,), ("dmodel",), "zeros"),
    }


def mlp_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    """The MLP; on a mesh whose 'model' splits its hidden width, ``wi`` is
    column-parallel and ``wo`` row-parallel (one all-reduce before the
    bias)."""
    dt = cfg.compute_dtype
    ctx = mesh_info()
    split = _tp(ctx) and p["wo"].shape[0] < cfg.d_ff
    if split:
        x = C.copy_to(x, ctx.mesh, "model")
    if cfg.act == "swiglu":
        h = _project(x, p["wi"].to(dt))  # [B, S, 2, F]
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        h = F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh")
    y = h @ p["wo"].to(dt)
    if split:
        y = C.reduce_from(y, ctx.mesh, "model")
    if cfg.act != "swiglu":
        y = y + p["bo"].to(dt)
    return y


class MLP(Weights):
    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.c, x, self.cfg)


# --- Mixture of Experts -------------------------------------------------------------

def moe_infos(cfg) -> dict:
    D, E, Fh = cfg.d_model, cfg.moe_experts, cfg.moe_dff
    return {
        "router": ParamInfo((D, E), ("dmodel", "expert"), "small"),
        "wi": ParamInfo((E, D, 2, Fh), ("expert", "expert_dmodel", None, None)),
        "wo": ParamInfo((E, Fh, D), ("expert", None, "expert_dmodel")),
    }


def moe_capacity(cfg, tokens_per_group: int) -> int:
    """Slots per expert for one dispatch group of ``tokens_per_group``."""
    c = math.ceil(tokens_per_group * cfg.moe_topk * cfg.moe_capacity_factor / cfg.moe_experts)
    return max(4, int(c))


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, ties to the
    lower index (as ``jax.lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_tokens(tokens: torch.Tensor, expert_idx: torch.Tensor, gate_w: torch.Tensor,
                     E: int, C: int):
    """Sort-based dispatch of token groups (JAX ``layers._dispatch_tokens``,
    batched over any leading group dims).

    tokens [..., N, D]; expert_idx, gate_w [..., N, K]. Expert ids >= E (the
    dropped bucket) or beyond capacity are dropped. Returns
      buf   [..., E, C, D]  tokens gathered per expert (capacity-truncated)
      meta  (src [..., E, C] token index or -1, w [..., E, C] float32 gate weight)
    """
    buf, meta, _ = _dispatch(tokens, expert_idx, gate_w, E, C)
    return buf, meta


def _dispatch(tokens, expert_idx, gate_w, E: int, C: int):
    """``_dispatch_tokens``, and the slot of each (token, k) choice:
    [G, N * K] indices into the flattened [E * C] slots, E * C where the
    choice was dropped."""
    *lead, N, K = expert_idx.shape
    D = tokens.shape[-1]
    G = math.prod(lead)
    dev = tokens.device
    flat_e = expert_idx.reshape(G, N * K).clamp_max(E)
    flat_w = gate_w.reshape(G, N * K)
    flat_tok = torch.arange(N, device=dev).repeat_interleave(K)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    sw, st = flat_w.gather(1, order), flat_tok[order]
    counts = torch.zeros((G, E + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, se, torch.ones_like(se))
    seg_start = counts.cumsum(1) - counts
    pos = torch.arange(N * K, device=dev) - seg_start.gather(1, se)  # place in the expert
    keep = (pos < C) & (se < E)
    slot = torch.where(keep, se * C + pos, E * C)  # E * C: the overflow slot, dropped
    src = torch.full((G, E * C + 1), -1, dtype=torch.long, device=dev).scatter_(1, slot, st)
    w = torch.zeros((G, E * C + 1), dtype=torch.float32, device=dev).scatter_(1, slot, sw.float())
    src, w = src[:, :-1], w[:, :-1]
    rows = tokens.reshape(G, N, D).gather(1, src.clamp_min(0)[..., None].expand(G, E * C, D))
    buf = torch.where(src[..., None] >= 0, rows, 0.0)
    return (buf.reshape(*lead, E, C, D),
            (src.reshape(*lead, E, C), w.reshape(*lead, E, C)),
            torch.empty_like(slot).scatter_(1, order, slot))


def _experts(p: Mapping[str, torch.Tensor], buf: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The SwiGLU experts on capacity buffers [G, E, C, D]: one batched
    product per weight over the experts, [G, E, C, D] out."""
    G, E, C, D = buf.shape
    wi, wo = p["wi"].to(dt), p["wo"].to(dt)  # [E, D, 2, F], [E, F, D]
    x = buf.transpose(0, 1).reshape(E, G * C, D)
    h = torch.bmm(x, wi.reshape(E, D, -1)).view(E, G * C, 2, -1)
    h = F.silu(h[..., 0, :]) * h[..., 1, :]
    return torch.bmm(h, wo).view(E, G, C, D).transpose(0, 1)


def moe_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, *,
              group: str = "seq") -> torch.Tensor:
    """Top-k routed MoE FFN (SwiGLU experts), sort-based dispatch: the JAX
    package's single-device path.

    group='seq'   dispatch each sequence on its own (prefill): capacity is
                  per (sequence, expert);
    group='batch' dispatch the whole [B * S] token set at once (decode, S = 1).

    The router runs in float32 on the float32 cast of x (JAX's einsum
    promotes x); gate weights are renormalised over the top k. The combine
    adds each token's kept contributions onto zeros in the order of their
    experts' ids, each sum rounded to the compute dtype: the order of the
    capacity slots, in which the JAX package's scatter-add visits them. It
    gathers the contributions, so it is the same on every device and run;
    an ``index_add_`` would add in the order of the card's atomics, and on
    the CPU accumulates bf16 in float32 (both differ from JAX once top k
    exceeds 2).

    On a mesh whose 'model' divides the experts (the 'tp' layout) this is
    ``_moe_expert_parallel``, JAX's rule. Otherwise a batch-wide dispatch
    over data-parallel rows first gathers every rank's rows, as GSPMD runs
    JAX's dispatch over the global batch.
    """
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    ctx = mesh_info()
    if _tp(ctx) and E % ctx.tp == 0:
        return _moe_expert_parallel(p, x, cfg, group, ctx)
    if group not in ("seq", "batch"):
        raise ValueError(f"group must be seq|batch, got {group!r}")
    rows = group == "batch" and ctx is not None and ctx.dp > 1
    if rows:
        x = C.gather_from(x, ctx.mesh, ctx.batch_axes, 0)
    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    gate_w, expert_idx = top_k(gates, K)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    C_ = moe_capacity(cfg, S if group == "seq" else x.shape[0] * S)
    y = _route(p, x, expert_idx, gate_w, E, C_, group, cfg.compute_dtype)
    return C.scatter_to(y, ctx.mesh, ctx.batch_axes, 0) if rows else y


def _route(p, x, expert_idx, gate_w, E: int, C_: int, group: str, dt) -> torch.Tensor:
    """Dispatch x [B, S, D] to E experts of C_ slots (per sequence or over
    the batch), run them, and combine each token's kept contributions in
    its experts' order (``moe_apply``); ids >= E are dropped."""
    B, S, D = x.shape
    K = expert_idx.shape[-1]
    if group == "seq":
        n_tok, tok, eidx, gw = S, x, expert_idx, gate_w
    else:
        n_tok, tok, eidx, gw = B * S, x.reshape(1, B * S, D), \
            expert_idx.reshape(1, B * S, K), gate_w.reshape(1, B * S, K)
    buf, _, slot = _dispatch(tok, eidx, gw, E, C_)  # [G, E, C, D]
    out = _experts(p, buf.to(dt), dt)
    G = out.shape[0]
    # each token's slots in ascending order, which is its experts' order
    # (the dropped, E * C, last), and their gate weights, 0 where dropped
    slot, by_slot = slot.view(G, n_tok, K).sort(dim=-1)
    w = torch.where(slot < E * C_, gw.reshape(G, n_tok, K).gather(-1, by_slot), 0.0).to(dt)
    parts = out.reshape(G, E * C_, D).gather(
        1, slot.clamp_max(E * C_ - 1).view(G, n_tok * K, 1).expand(G, n_tok * K, D))
    parts = parts.view(G, n_tok, K, D) * w[..., None]
    y = parts[:, :, 0]
    for j in range(1, K):
        y = y + parts[:, :, j]
    return y.reshape(B, S, D)


def _moe_expert_parallel(p, x, cfg, group: str, ctx: MeshContext) -> torch.Tensor:
    """Expert-parallel MoE (JAX ``_moe_expert_parallel``): this rank holds
    experts [r E / tp, (r + 1) E / tp) (``wi``, ``wo``, their FSDP rows
    already gathered) and its data-parallel rows. It routes over the whole
    router (gathered over 'model'), dispatches its rows to its experts only
    into a local capacity buffer [E / tp, C, D] (C from the global batch,
    as JAX's), and one all-reduce over 'model' in float32 (bf16 with
    ``moe_combine_dtype == 'bf16'``) adds the ranks' partial outputs."""
    mesh, E, K = ctx.mesh, cfg.moe_experts, cfg.moe_topk
    El = E // ctx.tp
    B, S, _ = x.shape
    if group not in ("seq", "batch"):
        raise ValueError(f"group must be seq|batch, got {group!r}")
    C_ = moe_capacity(cfg, S if group == "seq" else B * ctx.dp * S)
    x = C.copy_to(x, mesh, "model")
    router = C.gather_sum(p["router"], mesh, "model", 1)  # [D, E]
    gates = torch.softmax(x.float() @ router.float(), dim=-1)
    gate_w, expert_idx = top_k(gates, K)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    e0 = ctx.rank * El
    local_idx = torch.where((expert_idx >= e0) & (expert_idx < e0 + El), expert_idx - e0, El)
    y = _route(p, x, local_idx, gate_w, El, C_, group, cfg.compute_dtype)
    comb = torch.bfloat16 if cfg.moe_combine_dtype == "bf16" else torch.float32
    return C.reduce_from(y.to(comb), mesh, "model").to(cfg.compute_dtype)


class MoE(Weights):
    """The MoE FFN; the router stays float32 (JAX casts it to float32)."""

    def __init__(self, cfg, params: Mapping[str, torch.Tensor]):
        super().__init__(params, cfg.compute_dtype, keep=("router",))
        self.cfg = cfg

    def forward(self, x: torch.Tensor, group: str = "seq") -> torch.Tensor:
        return moe_apply(self.c, x, self.cfg, group=group)
