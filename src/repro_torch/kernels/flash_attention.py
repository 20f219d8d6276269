"""Flash attention as a hand-written CUDA kernel, with the GQA head map inside.

For q [B, Sq, H, dh] and k, v [B, Skv, Hkv, dh] (query head h reads kv head
h // (H / Hkv)) it computes, per batch row, head and query i,

  out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // G] / sqrt(dh)) . v[b, j, h // G]

over the visible j: all of them, or, when causal, j <= q_offset + i; with a
sliding window (``window`` > 0) also j > q_offset + i - window. Scores,
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

The kernel has three entries (``entry``): CUDA cores for a float32 q, and
tensor cores for bf16 -- one for prefill, and for decode (Sq = 1) one that
splits the visible kv rows over CTAs (``split_plan``) and combines their
partials in a fixed order.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import _build, meta

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

#: the kernel's entries: CUDA cores (float32 q), tensor cores (bf16, Sq > 1),
#: tensor cores with the kv rows split over CTAs (bf16, Sq = 1)
ENTRIES = ("simt", "mma", "mma_split")
#: kv rows per tile of the tensor-core entries; a split covers whole tiles
KV_TILE = 64
#: query rows (queries x heads of one group) of a split CTA
SPLIT_ROWS = 16
#: CTAs the split entry aims for: two per SM of an H100
TARGET_CTAS = 2 * 132
#: kernel launches per (entry, B, Sq, Skv, H, Hkv, dh), counted where the
#: kernel is launched and nowhere else (``reset_launches`` zeroes it)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def visible_rows(Sq: int, Skv: int, causal: bool, q_offset: int) -> int:
    """The kv rows any query sees: the first ``visible_rows`` of k and v."""
    return min(Skv, q_offset + Sq) if causal else Skv


def first_visible_row(q_offset: int, window: int) -> int:
    """The first kv row any query sees: rows below it lie outside every
    query's window (0 without a window)."""
    return max(0, q_offset - window + 1) if window else 0


def entry(q_dtype: torch.dtype, kv_dtype: torch.dtype, Sq: int) -> str:
    """The kernel entry for these dtypes (a pair ``_check`` accepts) and Sq."""
    if q_dtype == torch.float32:
        return "simt"
    return "mma_split" if Sq == 1 else "mma"


def split_grid(B: int, Sq: int, H: int, Hkv: int) -> int:
    """CTAs of the split entry per split: query blocks x head groups x B x
    Hkv, SPLIT_ROWS rows (queries x heads of one group) each."""
    G = H // Hkv
    Gc = min(G, SPLIT_ROWS)
    return B * Hkv * -(-G // Gc) * -(-Sq // (SPLIT_ROWS // Gc))


def split_plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, causal: bool, q_offset: int,
               window: int) -> tuple[int, int]:
    """(splits, kv rows per split) of the split entry: the visible rows, from
    the first one's tile on, cut into whole-tile splits, enough that the
    grid reaches TARGET_CTAS where there are tiles for it."""
    base = first_visible_row(q_offset, window) // KV_TILE * KV_TILE
    tiles = max(1, -(-(visible_rows(Sq, Skv, causal, q_offset) - base) // KV_TILE))
    per = -(-tiles // min(tiles, -(-TARGET_CTAS // split_grid(B, Sq, H, Hkv))))
    return -(-tiles // per), per * KV_TILE


def flash_attention_torch(
    q: torch.Tensor,  # [B, Sq, H, dh]
    k: torch.Tensor,  # [B, Skv, Hkv, dh]
    v: torch.Tensor,  # [B, Skv, Hkv, dh]
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same mask (-1e30 on masked
    scores), float32 scores, softmax and P.V, the output in q's dtype. Rows
    no query sees (past the last query, or below the first query's window)
    are left out before the product, as the kernel never reads them (they
    would add exact zeros)."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    lo, Skv = first_visible_row(q_offset, window), visible_rows(Sq, k.shape[1], causal, q_offset)
    qf = q.float().reshape(B, Sq, Hkv, H // Hkv, dh)
    kf, vf = k[:, lo:Skv].float(), v[:, lo:Skv].float()
    s = torch.einsum("bqhgd,bthd->bhgqt", qf, kf) * (1.0 / math.sqrt(dh))
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(lo, Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv - lo), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window:
        mask &= kv_pos > q_pos - window
    if causal or window:
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", w, vf)
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
           window: int) -> None:
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
    if window < 0:
        raise ValueError(f"window must be >= 0 (0: no window), got {window}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, strides {x.stride()}")
    size = k.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.data_ptr() % 16 or any(s * size % 16 for s in x.stride()[:3]):
            raise ValueError(f"{name}: pointer and strides {x.stride()} must allow 16-byte "
                             f"row loads")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library."""
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_mma_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("flash_attention"))


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           q_offset: int, window: int, stream: int) -> tuple[str, torch.Tensor]:
    """One launch of ``lib``'s entry for these inputs (checked by ``_check``,
    Sq >= 1): (the entry, out [B, Sq, H, dh] in q's dtype). Raises if the
    launch fails."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    name = entry(q.dtype, k.dtype, Sq)
    shape = (B, Sq, Skv, H, Hkv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if name == "simt":
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(k.dtype == torch.bfloat16), dh, *shape, int(causal), int(q_offset), int(window),
            stream)
    else:
        splits, rows, part = 0, 0, None
        if name == "mma_split":
            splits, rows = split_plan(B, Sq, Skv, H, Hkv, causal, q_offset, window)
            part = torch.empty(split_grid(B, Sq, H, Hkv) * splits * SPLIT_ROWS * (dh + 2),
                               dtype=torch.float32, device=q.device)
        err = lib.flash_attention_mma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if part is None else part.data_ptr(), dh, *shape, int(causal), int(q_offset),
            int(window), splits, rows, stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    return name, out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
) -> torch.Tensor:
    """Attention out [B, Sq, H, dh] in q's dtype (see the module docstring).

    On CUDA tensors the kernel runs on PyTorch's current stream and reads
    only the visible kv rows (with a window, from the first tile that holds
    a row some query of the CTA sees); ``Sq == 0`` returns an empty output
    without a launch. CPU tensors go to the plain version; meta tensors
    get the output's shape only (``kernels.meta``), with no launch.
    """
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu (meta: shapes only), not {q.device}")
    _check(q, k, v, q_offset, window)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, q_offset=q_offset, window=window)
    if q.device.type == "meta":
        return meta.flash_attention(q, k, v, causal, q_offset, window)
    B, Sq, H, dh = q.shape
    if Sq == 0 or B == 0:
        return torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        name, out = launch(_lib(), q, k, v, causal, q_offset, window,
                           torch.cuda.current_stream().cuda_stream)
    LAUNCHES[(name, B, Sq, k.shape[1], H, k.shape[2], dh)] += 1
    return out
