"""The telemetry estimator's pair-statistic scatter as a hand-written CUDA kernel.

For a batch of B completion observations -- key ``key_b``, co-resident
exposure row ``cbar_b`` [T], and K stacked statistics ``v_b^k`` (the
estimator's residual numerator and exposure weight) -- the kernel computes,
for every statistic k,

  acc[k, r, u] = sum_b cbar_b[u] * v_b^k * 1{key_b == r}

through one of two entries over one body (``csrc/pair_scatter.cu``, which
holds the design and its bound):

  ``pair_scatter``         the contract of the Pallas kernel
                           ``repro/kernels/telemetry.py::pair_scatter``: key
                           = target type t, returning
                           pair[k, u, t] [K, T, T] and
                           base[k, t] = sum_b v_b^k 1{t_b == t} [K, T];
  ``pair_scatter_banked``  the estimator bank's scatter over the combined
                           (bank row, type) key space of ``n_rows`` keys,
                           returning only the rows the batch touches, as a
                           compact block and its key list.

Keys outside the key space contribute nothing: -1 marks padding, evicted
rows and dump slots.

Each entry launches the kernel on CUDA tensors and runs its plain PyTorch
version (``pair_scatter_torch``, ``pair_scatter_banked_torch``) on CPU
tensors. On any other device, or when the build or the launch fails, it
raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

#: statistics one pass can carry (register accumulators per thread)
MAX_K = 4
#: keys the banked entry's sort keeps in shared memory; above, it takes
#: 4 B ints of global scratch
SMEM_ROWS = 8192
#: exposure columns one row may have (T / 32 per lane, in registers)
MAX_T = 256

#: kernel launches by entry and shape -- ("contract", B, T, K) and ("banked",
#: B, T, K, n_rows) -- counted where the kernel is launched and nowhere else
#: (``reset_launches`` zeroes it)
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


def pair_scatter_banked_torch(
    keys: torch.Tensor,  # i32[B] bank row * T + type per observation
    co: torch.Tensor,  # f32[B, T] co-resident exposure rows
    vals: torch.Tensor,  # f32[K, B]
    n_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the banked entry: the one-hot contraction
    over the combined (bank row, type) column space -- the arithmetic of the
    JAX package's MXU form -- restricted to the B columns of the keys the
    batch touches, in float32. Returns (rows [K, B, T], slot_keys i32[B]) in
    the kernel's layout: slot j holds the j-th distinct in-range key in
    ascending order; slots past the last hold zeros and the key ``n_rows``.
    Fixed shapes throughout: nothing is read back to the host."""
    B, T = co.shape
    k64 = keys.long()
    ok = (k64 >= 0) & (k64 < n_rows)
    sk = torch.sort(torch.where(ok, k64, n_rows)).values
    head = sk < n_rows
    head[1:] &= sk[1:] != sk[:-1]
    slot = torch.cumsum(head, 0) - 1  # each distinct key's slot
    slot_keys = torch.full((B + 1,), n_rows, dtype=torch.int64, device=co.device)
    slot_keys.scatter_(0, torch.where(head, slot, B), sk)  # slot B: a dump
    slot_keys = slot_keys[:B]
    onehot = ((k64[:, None] == slot_keys[None, :]) & ok[:, None]).to(torch.float32)
    sel = onehot[None, :, :] * vals.to(torch.float32)[:, :, None]  # [K, B, slots]
    rows = sel.transpose(1, 2) @ co.to(torch.float32)  # [K, slots, T]
    return rows, slot_keys.to(torch.int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pair_scatter")
    fn = lib.pair_scatter_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.pair_scatter_banked_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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


def _check_index_space(types: torch.Tensor, T: int, name: str = "types",
                       space: str = "T") -> None:
    """Raise on a key >= T, the size of the key space (reads the keys to
    the host)."""
    t = types.cpu()
    if t.numel() and int(t.max()) >= T:
        bad = int(torch.nonzero(t >= T)[0, 0])
        raise ValueError(
            f"pair_scatter index-space contract violated: {name}[{bad}] = "
            f"{int(t[bad])} >= {space} = {T}. Negative types (padding / evicted "
            f"pool rows) are dropped by design, but an index past the "
            f"table means a misrouted pool id or grid type -- the scatter "
            f"would silently discard that observation.")


def _scratch_ints(B: int, banked: bool) -> int:
    """int32 scratch of one launch. The contract: per chunk of 256 rows its
    sorted rows and each type's count and first position. The bank: the
    sorted rows [B], the segment starts [B + 1], and the sort's ping-pong
    halves [4 B] when B passes ``SMEM_ROWS``."""
    if not banked:
        return 3 * 256 * -(-B // 256)
    return 2 * B + 1 + (4 * B if B > SMEM_ROWS else 0)


def _raise_on(lib, err: int, entry: str) -> None:
    if err:
        msg = lib.pair_scatter_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({err})")


def pair_scatter(
    types: torch.Tensor,
    cbar: torch.Tensor,
    vals: torch.Tensor,
    *,
    debug: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sufficient statistics for one observation batch (the contract entry).

    ``vals`` of shape [B] returns ``(pair [T, T], base [T])``; [K, B]
    returns ``(pair [K, T, T], base [K, T])``, all K statistics in one pass
    (K = 1 stacked keeps its axis). On CUDA tensors (``types`` int32,
    ``cbar`` and ``vals`` float32, all contiguous) the kernel runs on
    PyTorch's current stream and writes target-major rows, so ``pair`` is
    the [K, T(u), T(t)] transposed view of them; ``B == 0`` returns zeros
    without a launch. CPU tensors go to the plain version. ``debug=True``
    reads ``types`` to the host first and raises on any type >= T, which the
    kernel would silently drop.
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
    acc = alloc((K, T, T), dtype=torch.float32, device=cbar.device)  # [K, T(t), T(u)]
    base = alloc((K, T), dtype=torch.float32, device=cbar.device)
    if B > 0:
        lib = _lib()
        scratch = torch.empty(_scratch_ints(B, False), dtype=torch.int32, device=cbar.device)
        with torch.cuda.device(cbar.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.pair_scatter_launch(
                types.data_ptr(), cbar.data_ptr(), vals.data_ptr(), acc.data_ptr(),
                base.data_ptr(), scratch.data_ptr(), B, T, K, stream)
        _raise_on(lib, err, "pair_scatter")
        LAUNCHES[("contract", B, T, K)] += 1
    pair = acc.transpose(1, 2)
    return (pair[0], base[0]) if squeeze else (pair, base)


def _check_banked(keys, co, vals, n_rows: int) -> None:
    if co.ndim != 2 or vals.ndim != 2:
        raise ValueError(f"co must be [B, T] and vals [K, B], got shapes "
                         f"{tuple(co.shape)} and {tuple(vals.shape)}")
    _check(keys, co, vals)
    if not 0 < n_rows < 2**31:
        raise ValueError(f"n_rows must lie in [1, 2**31), got {n_rows}")


def pair_scatter_banked(
    keys: torch.Tensor,
    co: torch.Tensor,
    vals: torch.Tensor,
    n_rows: int,
    *,
    debug: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The banked entry: ``keys`` i32[B] in the combined key space
    [0, ``n_rows``) (bank row * T + type; anything else is dropped),
    ``co`` f32[B, T], ``vals`` f32[K, B].

    Returns ``(rows [K, B, T], slot_keys i32[B])``: slot j holds the sum of
    ``co[b] * vals[k, b]`` over the rows whose key is the j-th distinct
    in-range key, in ascending key order; slots past the last key hold zeros
    and the key ``n_rows``. No dense [K, n_rows, T] table is formed. On CUDA
    tensors the kernel runs on PyTorch's current stream; ``B == 0`` returns
    empty tensors without a launch. CPU tensors go to the plain version.
    ``debug=True`` reads ``keys`` to the host first and raises on a key >=
    ``n_rows``.
    """
    if debug:
        _check_index_space(keys, n_rows, "keys", "n_rows")
    if co.device.type == "cpu":
        return pair_scatter_banked_torch(keys, co, vals, n_rows)
    if co.device.type != "cuda":
        raise ValueError(f"pair_scatter_banked runs on cuda or cpu, not {co.device}")
    _check_banked(keys, co, vals, n_rows)
    B, T = co.shape
    K = vals.shape[0]
    rows = torch.empty((K, B, T), dtype=torch.float32, device=co.device)
    slot_keys = torch.empty(B, dtype=torch.int32, device=co.device)
    if B > 0:
        lib = _lib()
        scratch = torch.empty(_scratch_ints(B, True), dtype=torch.int32, device=co.device)
        with torch.cuda.device(co.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.pair_scatter_banked_launch(
                keys.data_ptr(), co.data_ptr(), vals.data_ptr(), rows.data_ptr(),
                slot_keys.data_ptr(), scratch.data_ptr(), B, T, K, n_rows, stream)
        _raise_on(lib, err, "pair_scatter_banked")
        LAUNCHES[("banked", B, T, K, n_rows)] += 1
    return rows, slot_keys
