"""Gradient utilities: compression with error feedback, bucketing
(counterpart of ``repro/optim/grad_utils.py``, the same arithmetic).

The sharded training step (``distributed.train_step``) averages the
gradients of leaves replicated over the data-parallel ranks with
``compressed_psum_mean``: each rank quantizes its gradient plus the
residual it kept from the last step (error feedback: the quantization
noise does not bias SGD), the decompressed values are summed over the
group in float32 and divided by its size. As in JAX's, the sum is of the
decompressed float32 values (an int8 sum would overflow its codes), so
what the method changes is the values each rank contributes.
``bucket_by_size`` groups the leaves so that one reduction fires per
bucket.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..distributed import collectives as C
from ..tree import leaves, leaves_with_path, tree_map


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale): max |x| / 127, at least 1e-12; the codes
    round half to even and clip to [-127, 127]."""
    scale = torch.clamp_min(x.abs().max() / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress(g: torch.Tensor, method: str, err: torch.Tensor | None):
    """-> (payload, aux, new_error); ``err`` is the error-feedback residual."""
    gf = g.float()
    if err is not None:
        gf = gf + err
    if method == "bf16":
        p = gf.to(torch.bfloat16)
        return p, None, gf - p.float()
    if method == "int8":
        q, s = _quantize_int8(gf)
        return q, s, gf - q.float() * s
    if method != "none":
        raise ValueError(f"method must be none|bf16|int8, got {method!r}")
    return gf, None, torch.zeros_like(gf) if err is not None else None


def decompress(payload: torch.Tensor, aux, method: str) -> torch.Tensor:
    if method == "int8":
        return payload.float() * aux
    return payload.float()


def compressed_psum_mean(grads, group, method: str = "bf16", errors=None):
    """Mean over the ranks of ``group`` (a ``torch.distributed`` process
    group, where JAX's takes named mesh axes) of every leaf of ``grads``,
    each rank's contribution compressed by ``method`` with error feedback
    from ``errors`` (a tree like ``grads``, or None).

    Returns (mean_grads_fp32, new_errors); with method 'none' this is a
    plain mean, and new_errors is None unless ``errors`` was given (then
    zeros), as in JAX's. The leaves' decompressed values go through one
    all-reduce together."""
    n = dist.get_world_size(group)
    flat_g = leaves(grads)
    flat_e = [None] * len(flat_g) if errors is None else leaves(errors)
    sent, new_e = [], []
    for g, e in zip(flat_g, flat_e):
        p, aux, ne = compress(g, method, e)
        sent.append(decompress(p, aux, method))
        new_e.append(ne)
    if not sent:
        return grads, errors
    buf = torch.cat([s.reshape(-1) for s in sent])
    dist.all_reduce(buf, group=group)
    C.CALLS[("all_reduce", "grad_mean")] += 1
    buf = buf / n
    outs, start = [], 0
    for s in sent:
        outs.append(buf[start:start + s.numel()].view(s.shape))
        start += s.numel()
    it_g, it_e = iter(outs), iter(new_e)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_e), grads))


def keystr(path: tuple) -> str:
    """JAX's ``keystr`` of a tree path: ``['key']`` per dict key, ``[i]``
    per sequence index."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def bucket_by_size(tree, bucket_bytes: int = 4 << 20) -> list[list[str]]:
    """Greedy size-bucketing of the leaves in tree order: a new bucket starts
    where the next leaf would take the current one past ``bucket_bytes``.
    Returns the buckets as lists of ``keystr`` paths, JAX's."""
    buckets, cur, cur_bytes = [], [], 0
    for path, leaf in leaves_with_path(tree):
        nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(keystr(path))
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets
