"""Mamba's selective scan (S6) as a hand-written CUDA kernel.

For every batch row b and channel e, with the state h [N] starting at
h0[b, e], token by token

  h     <- da_t[e] * h + dbu_t[e]        (elementwise over the N states)
  y_t[e] = sum_n h[n] * c_t[n]

and the final state hT [B, E, N]; y and hT are float32 (``ref.mamba_ref``
is the definition).

Counterpart of the Pallas kernel ``repro/kernels/mamba_scan.py::
mamba_scan``, which takes da, dbu [B, S, E, N] and asserts S % chunk == 0
and E % eblock == 0. One CUDA source (``csrc/mamba_scan.cu``) has two entry
points that share the recurrence:

- ``mamba_scan`` (the contract): da, dbu [B, S, E, N] float32, c [B, S, N]
  float32, h0 [B, E, N] float32, as the Pallas kernel; any S >= 1 and any
  E;
- ``mamba_selective_scan`` (the model's route): delta [B, S, E] float32,
  u [B, S, E], B and C [B, S, N] (u, B and C in one dtype, float32 or
  bf16; B and C may be strided views of one projection), A [E, N] and h0
  float32. It forms da = exp(delta * A) and dbu = (delta * u) * B inside
  the kernel and never materialises [B, S, E, N].

Each launches the kernel on CUDA tensors and runs its plain PyTorch version
(``mamba_scan_torch``, the sequential loop; ``mamba_selective_scan_torch``,
the JAX model's chunked scan) on CPU tensors. On any other device, or when
the build or the launch fails, they raise. Both check the kernel's
contract: N in {4, 8, 16}, B <= 65535, the dtypes above, contiguous inputs
(the last dim of B and C at least), and 16-byte aligned h0, A, da and dbu
(each thread moves four states as one 16-byte access). The kernel's
layout and bound are in ``csrc/mamba_scan.cu``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

STATE_DIMS = (4, 8, 16)
DTYPES = (torch.float32, torch.bfloat16)
#: tokens per chunk of the JAX model's scan, when they divide S (else one chunk)
CHUNK = 256
MAX_BATCH = 65535

#: kernel launches per (entry, B, S, E, N), entry 'contract' or 'model',
#: counted where the kernel is launched and nowhere else (``reset_launches``
#: zeroes it)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def mamba_scan_torch(
    da: torch.Tensor,  # [B, S, E, N]
    dbu: torch.Tensor,  # [B, S, E, N]
    c: torch.Tensor,  # [B, S, N]
    h0: torch.Tensor,  # [B, E, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the contract entry: the sequential
    recurrence in float32."""
    h = h0.float()
    cf = c.float()
    ys = []
    for t in range(da.shape[1]):
        h = da[:, t].float() * h + dbu[:, t].float()
        ys.append(torch.einsum("ben,bn->be", h, cf[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_selective_scan_torch(
    delta: torch.Tensor,  # [B, S, E] float32
    u: torch.Tensor,  # [B, S, E]
    bm: torch.Tensor,  # [B, S, N]
    cm: torch.Tensor,  # [B, S, N]
    A: torch.Tensor,  # [E, N] float32
    h0: torch.Tensor,  # [B, E, N] float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the model entry: the JAX model's chunked
    scan (``repro/models/mamba.py:102-123``), chunks of 256 tokens when they
    divide S, else one chunk, each forming da = exp(delta * A) and dbu =
    (delta * u) * B over [B, c, E, N] before the sequential steps
    (``chunk_scan``)."""
    h = h0.float()
    ys = []
    for c0, c1 in chunks(delta.shape[1]):
        y, h = chunk_scan(delta[:, c0:c1], u[:, c0:c1], bm[:, c0:c1], cm[:, c0:c1], A, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def chunks(S: int) -> list[tuple[int, int]]:
    """The [start, end) token ranges of the JAX model's scan: chunks of
    CHUNK tokens when they divide S, else one chunk."""
    c = CHUNK if S % CHUNK == 0 else S
    return [(c0, c0 + c) for c0 in range(0, S, c)]


def chunk_scan(d_c, u_c, b_c, c_c, A, h) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the plain model entry from the state h [B, E, N] (JAX's
    ``chunk_body``): da = exp(delta * A) and dbu = (delta * u) * B over
    [B, c, E, N], the sequential steps, then y_t = h_t . C_t for every token
    of the chunk in one contraction (the same sums over N as JAX's per-step
    einsum; under autograd, two ops a token instead of JAX's per-step
    einsum's several); (y [B, c, E], h after the chunk), float32."""
    d_c = d_c.float()
    da_c = torch.exp(d_c[..., None] * A)  # [B, c, E, N]
    dbu_c = (d_c * u_c.float())[..., None] * b_c.float()[:, :, None, :]
    hs = []
    for da_t, dbu_t in zip(da_c.unbind(1), dbu_c.unbind(1)):
        h = da_t * h + dbu_t
        hs.append(h)
    y = torch.einsum("bcen,bcn->bce", torch.stack(hs, dim=1), c_c.float())
    return y, h


def _same_device(*xs: torch.Tensor) -> None:
    if len({x.device for x in xs}) != 1:
        raise ValueError(f"inputs on {sorted({str(x.device) for x in xs})}: want one device")


def _check_state(B: int, S: int, E: int, N: int, h0: torch.Tensor) -> None:
    if B == 0 or S == 0 or E == 0:
        raise ValueError(f"empty input: B={B} S={S} E={E}")
    if B > MAX_BATCH:
        raise ValueError(f"the kernel takes B <= {MAX_BATCH}, got {B}")
    if N not in STATE_DIMS:
        raise ValueError(f"the kernel takes N in {STATE_DIMS}, got {N}")
    if tuple(h0.shape) != (B, E, N):
        raise ValueError(f"h0 {tuple(h0.shape)}, want {(B, E, N)}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32, got {h0.dtype}")
    if not h0.is_contiguous() or h0.data_ptr() % 16:
        raise ValueError(f"h0 must be contiguous and 16-byte aligned, strides {h0.stride()}")


def _check(da, dbu, c, h0) -> None:
    """Raise on anything the contract entry does not take."""
    if da.ndim != 4:
        raise ValueError(f"da must be [B, S, E, N], got {tuple(da.shape)}")
    B, S, E, N = da.shape
    if tuple(dbu.shape) != tuple(da.shape):
        raise ValueError(f"dbu {tuple(dbu.shape)} does not match da {tuple(da.shape)}")
    if tuple(c.shape) != (B, S, N):
        raise ValueError(f"c {tuple(c.shape)}, want {(B, S, N)}")
    _check_state(B, S, E, N, h0)
    for name, x in (("da", da), ("dbu", dbu), ("c", c)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    _same_device(da, dbu, c, h0)
    for name, x in (("da", da), ("dbu", dbu)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if c.stride(-1) != 1:
        raise ValueError(f"c needs a contiguous last dim, strides {c.stride()}")


def _check_model(delta, u, bm, cm, A, h0) -> None:
    """Raise on anything the model entry does not take."""
    if delta.ndim != 3:
        raise ValueError(f"delta must be [B, S, E], got {tuple(delta.shape)}")
    B, S, E = delta.shape
    if tuple(u.shape) != (B, S, E):
        raise ValueError(f"u {tuple(u.shape)} does not match delta {tuple(delta.shape)}")
    if A.ndim != 2 or A.shape[0] != E:
        raise ValueError(f"A {tuple(A.shape)}, want [{E}, N]")
    N = A.shape[1]
    for name, x in (("B", bm), ("C", cm)):
        if tuple(x.shape) != (B, S, N):
            raise ValueError(f"{name} {tuple(x.shape)}, want {(B, S, N)}")
    _check_state(B, S, E, N, h0)
    for name, x in (("delta", delta), ("A", A)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if u.dtype not in DTYPES or bm.dtype != u.dtype or cm.dtype != u.dtype:
        raise TypeError(f"u {u.dtype}, B {bm.dtype}, C {cm.dtype}: the kernel takes float32 "
                        f"or bf16, all three of one dtype")
    _same_device(delta, u, bm, cm, A, h0)
    for name, x in (("delta", delta), ("u", u), ("A", A)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides {x.stride()}")
    if A.data_ptr() % 16:
        raise ValueError("A must be 16-byte aligned")
    for name, x in (("B", bm), ("C", cm)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, strides {x.stride()}")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library."""
    lib.mamba_scan_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                      + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    lib.mamba_scan_launch.restype = ctypes.c_int
    lib.mamba_selective_scan_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                                + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    lib.mamba_selective_scan_launch.restype = ctypes.c_int
    lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
    lib.mamba_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("mamba_scan"))


def launch(lib: ctypes.CDLL, entry: str, inputs: tuple[torch.Tensor, ...],
           stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``lib``'s ``entry`` ('contract': da, dbu, c, h0;
    'model': delta, u, B, C, A, h0; checked by ``_check`` or
    ``_check_model``): (y [B, S, E], hT [B, E, N]), both float32. Raises if
    the launch fails."""
    h0 = inputs[-1]
    B, E, N = h0.shape
    S = inputs[0].shape[1]
    y = torch.empty((B, S, E), dtype=torch.float32, device=h0.device)
    hT = torch.empty((B, E, N), dtype=torch.float32, device=h0.device)
    if entry == "contract":
        da, dbu, c, _ = inputs
        err = lib.mamba_scan_launch(
            da.data_ptr(), dbu.data_ptr(), c.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), B, S, E, N, *c.stride()[:2], stream)
        name = "mamba_scan"
    else:
        delta, u, bm, cm, A, _ = inputs
        err = lib.mamba_selective_scan_launch(
            delta.data_ptr(), u.data_ptr(), bm.data_ptr(), cm.data_ptr(), A.data_ptr(),
            h0.data_ptr(), y.data_ptr(), hT.data_ptr(), int(u.dtype == torch.bfloat16),
            B, S, E, N, *bm.stride()[:2], *cm.stride()[:2], stream)
        name = "mamba_selective_scan"
    if err:
        msg = lib.mamba_scan_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    return y, hT


def _device_check(x: torch.Tensor, name: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def mamba_scan(
    da: torch.Tensor,
    dbu: torch.Tensor,
    c: torch.Tensor,
    h0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The contract entry: (y [B, S, E], hT [B, E, N]), both float32 (see the
    module docstring). On CUDA tensors the kernel runs on PyTorch's current
    stream; CPU tensors go to the plain version."""
    _device_check(da, "mamba_scan")
    _check(da, dbu, c, h0)
    if da.device.type == "cpu":
        return mamba_scan_torch(da, dbu, c, h0)
    with torch.cuda.device(da.device):
        y, hT = launch(_lib(), "contract", (da, dbu, c, h0),
                       torch.cuda.current_stream().cuda_stream)
    LAUNCHES[("contract", *da.shape)] += 1
    return y, hT


def mamba_selective_scan(
    delta: torch.Tensor,
    u: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    A: torch.Tensor,
    h0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The model entry: (y [B, S, E], hT [B, E, N]), both float32, with da
    and dbu formed inside the kernel (see the module docstring). On CUDA
    tensors the kernel runs on PyTorch's current stream; CPU tensors go to
    the plain version."""
    _device_check(delta, "mamba_selective_scan")
    _check_model(delta, u, bm, cm, A, h0)
    if delta.device.type == "cpu":
        return mamba_selective_scan_torch(delta, u, bm, cm, A, h0)
    with torch.cuda.device(delta.device):
        y, hT = launch(_lib(), "model", (delta, u, bm, cm, A, h0),
                       torch.cuda.current_stream().cuda_stream)
    LAUNCHES[("model", *delta.shape, A.shape[1])] += 1
    return y, hT
