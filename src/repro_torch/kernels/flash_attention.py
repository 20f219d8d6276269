"""Flash attention as a hand-written CUDA kernel, with the GQA head map inside.

For q [B, Sq, H, dh] and k, v [B, Skv, Hkv, dh] (query head h reads kv head
h // (H / Hkv)) it computes, per batch row, head and query i,

  out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // G] / sqrt(dh)) . v[b, j, h // G]

over the visible j: all of them, or, when causal, j <= q_offset + i. Scores,
softmax and P.V are float32; the output has q's dtype.

Counterpart of the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``, which takes [N, Sq, dh] with the kv heads already
repeated. This one takes the model layout, so k and v are read in place as
slices of the KV cache, ``q_offset`` is a runtime argument, and any Sq and
Skv work; the design and its bound are in ``csrc/flash_attention.cu``.

``flash_attention`` launches the kernel on CUDA tensors and runs the plain
PyTorch version, ``flash_attention_torch``, on CPU tensors. On any other
device, or when the build or the launch fails, it raises. Both check the
kernel's contract: q float32 or bf16, k and v of one dtype, float32 or bf16
(not float32 with a bf16 q), dh in {16, 32, 64, 128}, the last dim
contiguous, and k/v strides that allow 16-byte loads.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches per shape (B, Sq, Skv, H, Hkv, dh), counted where the
#: kernel is launched and nowhere else (``reset_launches`` zeroes it)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def visible_rows(Sq: int, Skv: int, causal: bool, q_offset: int) -> int:
    """The kv rows any query sees: the first ``visible_rows`` of k and v."""
    return min(Skv, q_offset + Sq) if causal else Skv


def flash_attention_torch(
    q: torch.Tensor,  # [B, Sq, H, dh]
    k: torch.Tensor,  # [B, Skv, Hkv, dh]
    v: torch.Tensor,  # [B, Skv, Hkv, dh]
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same mask (-1e30 on masked
    scores), float32 scores, softmax and P.V, the output in q's dtype. Rows
    no query sees are left out before the product, as the kernel never
    reads them (they would add exact zeros)."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    Skv = visible_rows(Sq, k.shape[1], causal, q_offset)
    qf = q.float().reshape(B, Sq, Hkv, H // Hkv, dh)
    kf, vf = k[:, :Skv].float(), v[:, :Skv].float()
    s = torch.einsum("bqhgd,bthd->bhgqt", qf, kf) * (1.0 / math.sqrt(dh))
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", w, vf)
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
    """Raise on anything the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q must be [B, Sq, H, dh] and k, v [B, Skv, Hkv, dh]")
    B, Sq, H, dh = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes dh in {HEAD_DIMS}, got {dh}")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: the kernel takes float32 "
                        f"or bf16, k and v of one dtype")
    if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise TypeError("a bf16 q with float32 k and v is not taken")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if k.shape[1] == 0:
        raise ValueError("no kv rows")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, strides {x.stride()}")
    size = k.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.data_ptr() % 16 or any(s * size % 16 for s in x.stride()[:3]):
            raise ValueError(f"{name}: pointer and strides {x.stride()} must allow 16-byte "
                             f"row loads")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 9
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention out [B, Sq, H, dh] in q's dtype (see the module docstring).

    On CUDA tensors the kernel runs on PyTorch's current stream and reads
    only the visible kv rows; ``Sq == 0`` returns an empty output without
    a launch. CPU tensors go to the plain version.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, q_offset=q_offset)
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    if Sq == 0 or B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), dh,
            B, Sq, Skv, H, Hkv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(q_offset), stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    LAUNCHES[(B, Sq, Skv, H, Hkv, dh)] += 1
    return out
