"""The telemetry estimator's pair-statistic scatter as a hand-written CUDA kernel.

For a batch of B completion observations -- target grid type ``t_b``,
co-resident exposure row ``cbar_b`` [T], and K stacked statistics
``v_b^k`` (the estimator's residual numerator and exposure weight) -- it
computes, for every statistic k,

  pair[k, u, t] = sum_b cbar_b[u] * v_b^k * 1{t_b == t}        [K, T, T]
  base[k, t]    = sum_b            v_b^k * 1{t_b == t}         [K, T]

Counterpart of the Pallas kernel ``repro/kernels/telemetry.py::pair_scatter``,
with the same inputs and outputs; the design and its bound are in
``csrc/pair_scatter.cu``. Types outside [0, T) contribute nothing: -1 marks
padding and evicted rows.

``pair_scatter`` launches the kernel on CUDA tensors and runs the plain
PyTorch version, ``pair_scatter_torch``, on CPU tensors. On any other
device, or when the build or the launch fails, it raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

#: statistics one pass can carry (register accumulators per thread)
MAX_K = 4
#: exposure columns one CTA covers (one thread each)
MAX_T = 256

#: kernel launches per shape (B, T, K), counted where the kernel is launched
#: and nowhere else (``reset_launches`` zeroes it)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def pair_scatter_torch(
    types: torch.Tensor,  # i32[B] target grid type per observation
    cbar: torch.Tensor,  # f32[B, T] co-resident exposure rows
    vals: torch.Tensor,  # f32[B] or f32[K, B]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the one-hot contraction of the
    JAX package's ``_scatter_jnp_device`` in float32 (TF32 off on the card,
    ``device.resolve_device``)."""
    T = cbar.shape[1]
    squeeze = vals.ndim == 1
    vals2 = (vals[None, :] if squeeze else vals).to(torch.float32)  # [K, B]
    onehot = (torch.arange(T, device=cbar.device)[None, :]
              == types.long()[:, None]).to(torch.float32)  # [B, T]
    base = vals2 @ onehot  # [K, T]
    sel = onehot[None, :, :] * vals2[:, :, None]  # [K, B, T]
    pair = cbar.to(torch.float32).T[None] @ sel  # [K, T(u), T(t)]
    return (pair[0], base[0]) if squeeze else (pair, base)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pair_scatter")
    fn = lib.pair_scatter_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pair_scatter_error_string.argtypes = [ctypes.c_int]
    lib.pair_scatter_error_string.restype = ctypes.c_char_p
    return lib


def _check(types, cbar, vals) -> None:
    if cbar.ndim != 2:
        raise ValueError(f"cbar must be [B, T], got shape {tuple(cbar.shape)}")
    B, T = cbar.shape
    if vals.ndim not in (1, 2):
        raise ValueError(f"vals must be [B] or [K, B], got shape {tuple(vals.shape)}")
    want = {"types": (types, (B,), torch.int32),
            "cbar": (cbar, (B, T), torch.float32),
            "vals": (vals, (B,) if vals.ndim == 1 else (vals.shape[0], B), torch.float32)}
    for name, (x, shape, dtype) in want.items():
        if x.device != cbar.device:
            raise ValueError(f"{name} is on {x.device}, cbar on {cbar.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, want {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < T <= MAX_T:
        raise ValueError(f"the kernel takes 1..{MAX_T} types, got T={T}")
    K = 1 if vals.ndim == 1 else vals.shape[0]
    if not 0 < K <= MAX_K:
        raise ValueError(f"the kernel takes 1..{MAX_K} stacked statistics, got K={K}")


def _check_index_space(types: torch.Tensor, T: int) -> None:
    """Raise on a type >= T (reads ``types`` to the host)."""
    t = types.cpu()
    if t.numel() and int(t.max()) >= T:
        bad = int(torch.nonzero(t >= T)[0, 0])
        raise ValueError(
            f"pair_scatter index-space contract violated: types[{bad}] = "
            f"{int(t[bad])} >= T = {T}. Negative types (padding / evicted "
            f"pool rows) are dropped by design, but an index past the "
            f"table means a misrouted pool id or grid type -- the scatter "
            f"would silently discard that observation.")


def pair_scatter(
    types: torch.Tensor,
    cbar: torch.Tensor,
    vals: torch.Tensor,
    *,
    debug: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sufficient statistics for one observation batch.

    ``vals`` of shape [B] returns ``(pair [T, T], base [T])``; [K, B]
    returns ``(pair [K, T, T], base [K, T])``, all K statistics in one pass
    (K = 1 stacked keeps its axis). On CUDA tensors (``types`` int32,
    ``cbar`` and ``vals`` float32, all contiguous) the kernel runs on
    PyTorch's current stream; ``B == 0`` returns zeros without a launch.
    CPU tensors go to the plain version. ``debug=True`` reads ``types`` to
    the host first and raises on any type >= T, which the kernel would
    silently drop.
    """
    if debug:
        _check_index_space(types, cbar.shape[1])
    if cbar.device.type == "cpu":
        return pair_scatter_torch(types, cbar, vals)
    if cbar.device.type != "cuda":
        raise ValueError(f"pair_scatter runs on cuda or cpu, not {cbar.device}")
    _check(types, cbar, vals)
    B, T = cbar.shape
    squeeze = vals.ndim == 1
    K = 1 if squeeze else vals.shape[0]
    alloc = torch.empty if B > 0 else torch.zeros  # the kernel writes every element
    pair = alloc((K, T, T), dtype=torch.float32, device=cbar.device)
    base = alloc((K, T), dtype=torch.float32, device=cbar.device)
    if B > 0:
        lib = _lib()
        with torch.cuda.device(cbar.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.pair_scatter_launch(
                types.data_ptr(), cbar.data_ptr(), vals.data_ptr(), pair.data_ptr(),
                base.data_ptr(), B, T, K, stream)
        if err:
            msg = lib.pair_scatter_error_string(err).decode()
            raise RuntimeError(f"pair_scatter launch failed: {msg} ({err})")
        LAUNCHES[(B, T, K)] += 1
    return (pair[0], base[0]) if squeeze else (pair, base)
