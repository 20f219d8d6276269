"""The WKV6 recurrence of RWKV6 ("Finch") as a hand-written CUDA kernel.

For r, k, v and the log decay wlog [B, S, H, dh], the bonus u [H, dh] and
the initial state s0 [B, H, dh, dh] (key dim first) it computes, for each
batch row b and head h, token by token,

  y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
  S      <- exp(wlog_t[i]) * S[i, j] + k_t[i] * v_t[j]

and returns y [B, S, H, dh] and the final state sT [B, H, dh, dh], both
float32 (``ref.rwkv6_ref`` is the definition).

Counterpart of the Pallas kernel ``repro/kernels/rwkv6_scan.py::
rwkv6_scan``, which takes [B * H, S, dh] and asserts S % chunk == 0. This
one takes the model layout with strides and any S >= 1, decode's S = 1
included; the design and its bound are in ``csrc/rwkv6_scan.cu``.

``rwkv6_scan`` launches the kernel on CUDA tensors and runs the plain
PyTorch version, ``rwkv6_scan_torch``, on CPU tensors. On any other
device, or when the build or the launch fails, it raises. Both check the
kernel's contract: r, k, v of one dtype, float32 or bf16; wlog, u and s0
float32; dh in {16, 64}; the last dim contiguous; u and s0 contiguous;
for the chunked entry, r, k, v and wlog with 16-byte aligned pointers
and strides.

The kernel has two entries (``entry``): the sequential recurrence on the
CUDA cores, for float32 r/k/v and every decode step (S = 1), and a
chunked form on the tensor cores for bf16 r/k/v with S > 1 (the prefill).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIMS = (16, 64)
DTYPES = (torch.float32, torch.bfloat16)
#: tokens per chunk of the plain version (the JAX model's ``WKV_CHUNK``)
CHUNK = 32
#: the log-domain mask of the plain version's intra-chunk decays
NEG_INF = -1e30

#: the kernel's entries: the sequential recurrence on the CUDA cores, and
#: chunks of 16 tokens on the tensor cores
ENTRIES = ("sequential", "chunked")
#: kernel launches per (entry, B, S, H, dh), counted where the kernel is
#: launched and nowhere else (``reset_launches`` zeroes it)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def entry(dtype: torch.dtype, S: int) -> str:
    """The kernel entry for r/k/v of ``dtype`` and S tokens: the chunked
    tensor-core entry for bf16 with S > 1, the sequential one for float32
    and for every decode step (S = 1)."""
    return "chunked" if dtype == torch.bfloat16 and S > 1 else "sequential"


def rwkv6_scan_torch(
    r: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,
    v: torch.Tensor,
    wlog: torch.Tensor,  # [B, S, H, dh], log decay < 0
    u: torch.Tensor,  # [H, dh]
    s0: torch.Tensor,  # [B, H, dh, dh]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the JAX model's chunked WKV6
    (``repro/models/rwkv.py::wkv_chunked``) in float32. Chunks of
    C = min(32, S) tokens; a ragged tail is padded with r = k = v = 0 and
    wlog = 0, which adds nothing and keeps the state. Inside a chunk the
    decays between tokens are taken relative to cumulative sums of wlog, and
    the pairs above the diagonal are masked in the log domain before
    ``exp``, where their positive exponents would overflow."""
    B, S, H, dh = r.shape
    C = min(CHUNK, S)
    n = -(-S // C)
    pad = n * C - S

    def chunks(x):
        return F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, C, H, dh)

    rs, ks, vs, ws = chunks(r), chunks(k), chunks(v), chunks(wlog)
    uf = u.float()
    below = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device), -1)  # u < t
    s = s0.float()
    ys = []
    for c in range(n):
        rc, kc, vc, wc = rs[:, c], ks[:, c], vs[:, c], ws[:, c]  # [B, C, H, dh]
        cl = torch.cumsum(wc, dim=1)  # cumulative log decay, inclusive
        cl_excl = cl - wc
        # from the state carried in: sum_i r[t,i] exp(cl_excl[t,i]) s[i,j]
        y = torch.einsum("bchi,bhij->bchj", rc * torch.exp(cl_excl), s)
        # within the chunk: exp(cl_excl[t,i] - cl[u,i]) for u < t
        dlog = cl_excl[:, :, None] - cl[:, None, :]  # [B, C(t), C(u), H, dh]
        dmat = torch.exp(torch.where(below[None, :, :, None, None], dlog, NEG_INF))
        att = (rc[:, :, None] * dmat * kc[:, None, :]).sum(-1)  # [B, C(t), C(u), H]
        y = y + torch.einsum("btuh,buhj->bthj", att, vc)
        # the bonus on the diagonal
        y = y + (rc * uf * kc).sum(-1, keepdim=True) * vc
        # s' = exp(cl[-1]) s + sum_u exp(cl[-1] - cl[u]) k_u v_u^T
        k_dec = kc * torch.exp(cl[:, -1:] - cl)
        s = torch.exp(cl[:, -1])[..., None] * s + torch.einsum("buhi,buhj->bhij", k_dec, vc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], s


def _check(r, k, v, wlog, u, s0) -> None:
    """Raise on anything the kernel does not take."""
    if r.ndim != 4:
        raise ValueError(f"r must be [B, S, H, dh], got {tuple(r.shape)}")
    B, S, H, dh = r.shape
    for name, x in (("k", k), ("v", v), ("wlog", wlog)):
        if tuple(x.shape) != tuple(r.shape):
            raise ValueError(f"{name} {tuple(x.shape)} does not match r {tuple(r.shape)}")
    if tuple(u.shape) != (H, dh):
        raise ValueError(f"u {tuple(u.shape)}, want {(H, dh)}")
    if tuple(s0.shape) != (B, H, dh, dh):
        raise ValueError(f"s0 {tuple(s0.shape)}, want {(B, H, dh, dh)}")
    if B == 0 or S == 0 or H == 0:
        raise ValueError(f"empty input {tuple(r.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes dh in {HEAD_DIMS}, got {dh}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r {r.dtype}, k {k.dtype}, v {v.dtype}: the kernel takes float32 or "
                        f"bf16, all three of one dtype")
    for name, x in (("wlog", wlog), ("u", u), ("s0", s0)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if len({x.device for x in (r, k, v, wlog, u, s0)}) != 1:
        raise ValueError("r, k, v, wlog, u and s0 must lie on one device")
    for name, x in (("r", r), ("k", k), ("v", v), ("wlog", wlog)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, strides {x.stride()}")
    for name, x in (("u", u), ("s0", s0)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides {x.stride()}")
    if entry(r.dtype, S) == "chunked":
        for name, x in (("r", r), ("k", k), ("v", v), ("wlog", wlog)):
            size = x.element_size()
            if x.data_ptr() % 16 or any(st * size % 16 for st in x.stride()[:3]):
                raise ValueError(f"{name}: pointer and strides {x.stride()} must allow 16-byte "
                                 f"row loads (the chunked entry)")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library."""
    lib.rwkv6_scan_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                      + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    lib.rwkv6_scan_launch.restype = ctypes.c_int
    lib.rwkv6_scan_chunked_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                                              + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    lib.rwkv6_scan_chunked_launch.restype = ctypes.c_int
    lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("rwkv6_scan"))


def launch(lib: ctypes.CDLL, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           wlog: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
           stream: int) -> tuple[str, torch.Tensor, torch.Tensor]:
    """One launch of ``lib``'s entry for these inputs (checked by ``_check``):
    (the entry, y [B, S, H, dh], sT [B, H, dh, dh]), both float32. Raises if
    the launch fails."""
    B, S, H, dh = r.shape
    y = torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    name = entry(r.dtype, S)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), sT.data_ptr())
    strides = (*r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *wlog.stride()[:3])
    if name == "chunked":
        err = lib.rwkv6_scan_chunked_launch(*ptrs, dh, B, S, H, *strides, stream)
    else:
        err = lib.rwkv6_scan_launch(*ptrs, int(r.dtype == torch.bfloat16), dh, B, S, H,
                                    *strides, stream)
    if err:
        msg = lib.rwkv6_scan_error_string(err).decode()
        raise RuntimeError(f"rwkv6_scan launch failed: {msg} ({err})")
    return name, y, sT


def rwkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    wlog: torch.Tensor,
    u: torch.Tensor,
    s0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, H, dh], sT [B, H, dh, dh]), both float32 (see the module
    docstring). On CUDA tensors the kernel's entry for the dtype and S runs
    on PyTorch's current stream; CPU tensors go to the plain version."""
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rwkv6_scan runs on cuda or cpu, not {r.device}")
    _check(r, k, v, wlog, u, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_torch(r, k, v, wlog, u, s0)
    with torch.cuda.device(r.device):
        name, y, sT = launch(_lib(), r, k, v, wlog, u, s0,
                             torch.cuda.current_stream().cuda_stream)
    LAUNCHES[(name, *r.shape)] += 1
    return y, sT
