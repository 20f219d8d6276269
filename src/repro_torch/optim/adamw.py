"""Optimizers (copied from ``repro/optim/adamw.py``): AdamW, 8-bit AdamW,
Adafactor, as plain functions over trees (``repro_torch.tree``) of tensors.

All three share one functional interface:
    state = init(params)
    new_params, new_state, stats = update(params, grads, state, lr, cfg, norm=None)
(``norm``: the gradients' global norm, when the caller computed it).

Memory policy (why three):
  * adamw     -- float32 m/v; the default for <=10B-param archs.
  * adamw8bit -- int8 block-quantized m/v with per-block scales (4x less
                 optimizer state; the quantized state is the accumulator).
  * adafactor -- factored second moment (rank-1): O(rows+cols) state.

The arithmetic is the JAX code's, op for op and in its order, in float32:
the bias corrections ``1 - b1 ** step`` are float32 powers of a float32
step; the clip scale is folded into each leaf's update; weight decay
applies to every leaf, norms included; leaves are walked in JAX's tree
order (sorted dict keys), so ``global_norm`` sums in JAX's order. Updates
are out of place: the caller's params and state are not written, and the
new tensors replace them (the training step drops the old ones). Called
under ``torch.no_grad()`` by the training step.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..tree import leaves, tree_map, unzip


@dataclasses.dataclass(frozen=True)
class OptConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    block: int = 256  # 8-bit quantization block size
    # adafactor
    eps2: float = 1e-30
    clip_threshold: float = 1.0


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_scale(grads, max_norm: float,
               norm: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Global-norm clip as a scalar (scale, norm); callers fold the scale
    into each leaf's update instead of materialising a clipped tree.
    ``norm`` is the gradients' global norm where the caller has it (the
    sharded step, whose ranks hold slices of the gradients)."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return scale, gn


def clip_by_global_norm(grads, max_norm: float):
    scale, gn = clip_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _first(params) -> torch.Tensor:
    return leaves(params)[0]


def _bias_corrections(step: torch.Tensor, cfg: OptConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """1 - b ** step for b1 and b2, each a float32 power of the float32 step."""
    s = step.float()
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=s.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=s.device)
    return 1 - torch.pow(b1, s), 1 - torch.pow(b2, s)


# --- plain AdamW ---------------------------------------------------------------

def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=_first(params).device),
        "v": tree_map(zeros, params),
    }


def adamw_update(params, grads, state, lr, cfg: OptConfig, norm=None):
    scale, gn = clip_scale(grads, cfg.grad_clip, norm)
    step = state["step"] + 1
    b1c, b2c = _bias_corrections(step, cfg)

    def upd(p, g, m, v):
        g = g.float() * scale  # fused into the elementwise update
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m2 / b1c
        vh = v2 / b2c
        d = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * d).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = unzip(params, out, 3)
    return new_p, {"m": new_m, "step": step, "v": new_v}, {"grad_norm": gn}


# --- 8-bit AdamW ------------------------------------------------------------------

def _q8(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantization of a float32 array, flattened:
    (codes [n_blocks, block] int8, scales [n_blocks, 1] float32)."""
    n = x.numel()
    pad = (-n) % block
    xf = F.pad(x.reshape(-1), (0, pad)).reshape(-1, block)
    scale = xf.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape, block: int) -> torch.Tensor:
    xf = q.float() * scale
    return xf.reshape(-1)[: math.prod(shape)].reshape(shape)


def adamw8bit_init(params, block: int = 256):
    def q(p):
        qq, s = _q8(torch.zeros(p.shape, dtype=torch.float32, device=p.device), block)
        return {"q": qq, "s": s}

    return {
        "m": tree_map(q, params),
        "step": torch.zeros((), dtype=torch.int32, device=_first(params).device),
        "v": tree_map(q, params),
    }


def adamw8bit_update(params, grads, state, lr, cfg: OptConfig, norm=None):
    scale, gn = clip_scale(grads, cfg.grad_clip, norm)
    step = state["step"] + 1
    b1c, b2c = _bias_corrections(step, cfg)

    def upd(p, g, mq, vq):
        g = g.float() * scale
        m = _dq8(mq["q"], mq["s"], p.shape, cfg.block)
        v = _dq8(vq["q"], vq["s"], p.shape, cfg.block)
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m2 / b1c
        vh = torch.clamp_min(v2, 0.0) / b2c
        d = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p2 = (p.float() - lr * d).to(p.dtype)
        q_m, s_m = _q8(m2, cfg.block)
        q_v, s_v = _q8(v2, cfg.block)
        return p2, {"q": q_m, "s": s_m}, {"q": q_v, "s": s_v}

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = unzip(params, out, 3)
    return new_p, {"m": new_m, "step": step, "v": new_v}, {"grad_norm": gn}


# --- Adafactor ----------------------------------------------------------------------

def adafactor_init(params):
    """Factored second moment: a row factor over shape[:-1], a column
    factor over the last dim; rank-1 reconstruction. 0-d and 1-d leaves
    keep a full second moment."""

    def per(p):
        if p.ndim >= 2:
            return {"vc": torch.zeros(p.shape[-1:], dtype=torch.float32, device=p.device),
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    return {"state": tree_map(per, params),
            "step": torch.zeros((), dtype=torch.int32, device=_first(params).device)}


def adafactor_update(params, grads, state, lr, cfg: OptConfig, norm=None):
    scale, gn = clip_scale(grads, cfg.grad_clip, norm)
    step = state["step"] + 1
    decay = 1.0 - (step.float() + 1.0) ** -0.8

    def upd(p, g, s):
        g = g.float() * scale
        g2 = g * g + cfg.eps2
        if p.ndim >= 2:
            lead = tuple(range(p.ndim - 1))
            vr = decay * s["vr"] + (1 - decay) * g2.mean(dim=-1)
            vc = decay * s["vc"] + (1 - decay) * g2.mean(dim=lead)
            denom = torch.clamp_min(vr.mean(), cfg.eps2)
            vhat = vr[..., None] * vc / denom
            new_s = {"vc": vc, "vr": vr}
        else:
            vhat = decay * s["v"] + (1 - decay) * g2
            new_s = {"v": vhat}
        # relative update clipping (Adafactor's RMS clip) as a scalar
        rms = torch.sqrt(torch.mean(g2 / (vhat + cfg.eps2)) + 1e-30)
        denom = torch.clamp_min(rms / cfg.clip_threshold, 1.0)
        u = g / torch.sqrt(vhat + cfg.eps2) / denom
        d = u + cfg.weight_decay * p.float()
        return (p.float() - lr * d).to(p.dtype), new_s

    out = tree_map(upd, params, grads, state["state"])
    new_p, new_s = unzip(params, out, 2)
    return new_p, {"state": new_s, "step": step}, {"grad_norm": gn}


# --- dispatch --------------------------------------------------------------------------

def make_optimizer(name: str, cfg: OptConfig):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adamw8bit":
        return (lambda p: adamw8bit_init(p, cfg.block)), adamw8bit_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
