"""The drift detector's CUSUM scan as a hand-written CUDA kernel.

Folds a block of B observation rows, in stream order, into the detector
state of ``fleet.detect`` (the sequential half of JAX's ``_cusum_update``,
``repro/fleet/detect.py:85-143``, a ``lax.scan``; it has no Pallas twin):
per valid row b, on server ``server[b]`` in pool row ``row[b]`` with
residual ``resid[b]``, the pool-centered CUSUM pair ``stat`` [m, 2], the
residual level ``level`` [m] and its exposure ``n`` [m], and the pool row's
level ``pool_level`` and exposure ``pool_n`` [rows] take one step each
(``csrc/cusum_scan.cu`` holds the recurrence, the design and the bound:
the pool chains walked first, handing each row its centered residual, then
the server chains, each in stream order). Invalid rows change nothing. The
residuals are computed before the launch: rows are independent there. The
kernel reads the state and writes a new one, so nothing is copied before
the launch.

``cusum_scan`` launches the kernel on CUDA tensors and runs its plain
version ``cusum_scan_torch`` (a Python loop over the rows, one masked
update each, nothing read back to the host) on CPU tensors; on any other
device, or when the build or the launch fails, it raises. Both round every
operation on its own, so they agree bit for bit, and one block gives the
same state as the same rows split over several calls.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from ..device import resolve_device
from . import _build

#: kernel launches per (B, m, rows), counted where the kernel is launched and
#: nowhere else (``reset_launches`` zeroes it)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


class CusumState(NamedTuple):
    """Per-server (and per-pool-row) detector state as float32 tensors on
    one device: what the scan updates (``fleet.detect`` holds it)."""

    stat: torch.Tensor  # f32[m, 2] (S+, S-) CUSUM pair, pool-centered residual
    level: torch.Tensor  # f32[m] exposure-weighted EWMA of the raw residual
    n: torch.Tensor  # f32[m] decayed exposure behind ``level``
    pool_level: torch.Tensor  # f32[rows] EWMA of each pool row's residual
    pool_n: torch.Tensor  # f32[rows] decayed exposure behind ``pool_level``

    @classmethod
    def zeros(cls, m: int, rows: int | None = None, *,
              device: str | torch.device | None = None) -> "CusumState":
        """Fresh all-zero state for ``m`` servers (``rows`` pool rows)."""
        rows = m if rows is None else rows
        f32 = dict(dtype=torch.float32, device=resolve_device(device))
        return cls(stat=torch.zeros((m, 2), **f32), level=torch.zeros(m, **f32),
                   n=torch.zeros(m, **f32), pool_level=torch.zeros(rows, **f32),
                   pool_n=torch.zeros(rows, **f32))


def _constants(k: float, level_decay: float, device) -> tuple[torch.Tensor, ...]:
    """k, d and 1 - d as float32, each rounded once from the Python double
    (the JAX scan's weakly typed constants), as the kernel takes them."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.full((), k, **f32), torch.full((), level_decay, **f32),
            torch.full((), 1.0 - level_decay, **f32))


def cusum_scan_torch(
    state: CusumState,
    server: torch.Tensor,  # i32[B] server per row (in [0, m) where valid)
    row: torch.Tensor,  # i32[B] pool row per row (in [0, rows) where valid)
    resid: torch.Tensor,  # f32[B] residual per row
    valid: torch.Tensor,  # bool[B]
    *,
    k: float,
    level_decay: float,
) -> CusumState:
    """Plain PyTorch version of the kernel: the rows one at a time, each
    update written under its row's mask, every operation rounded on its own.
    Returns new tensors; the inputs are not written."""
    stat, level, n, pool_level, pool_n = (a.clone() for a in state)
    dev = stat.device
    kk, d, omd = _constants(k, level_decay, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tiny = torch.full((), 1e-12, dtype=torch.float32, device=dev)
    s_all, w_all = server.long(), row.long()
    for b in range(int(server.shape[0])):
        s, w = s_all[b:b + 1], w_all[b:b + 1]
        ok, r = valid[b:b + 1], resid[b:b + 1]
        pl, pn = pool_level[w], pool_n[w]
        hat = torch.where(pn > 0, pl / torch.maximum(omd * pn, tiny), zero)
        x = r - hat
        st = stat[s]  # [1, 2]
        pos = torch.maximum(zero, st[:, 0] + (x - kk))
        neg = torch.maximum(zero, st[:, 1] - (x + kk))
        lvl = d * level[s] + omd * r
        cnt = d * n[s] + 1.0
        plv = d * pl + omd * r
        pcn = d * pn + 1.0
        stat.index_put_((s,), torch.where(ok[:, None], torch.stack([pos, neg], dim=1), st))
        level.index_put_((s,), torch.where(ok, lvl, level[s]))
        n.index_put_((s,), torch.where(ok, cnt, n[s]))
        pool_level.index_put_((w,), torch.where(ok, plv, pl))
        pool_n.index_put_((w,), torch.where(ok, pcn, pn))
    return CusumState(stat, level, n, pool_level, pool_n)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launcher's C signature on a loaded library."""
    lib.cusum_scan_launch.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                                      + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.cusum_scan_launch.restype = ctypes.c_int
    lib.cusum_scan_error_string.argtypes = [ctypes.c_int]
    lib.cusum_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("cusum_scan"))


def _check(state: CusumState, server, row, resid, valid) -> None:
    m, rows = state.level.shape[0], state.pool_level.shape[0]
    B = server.shape[0]
    want = {"stat": (state.stat, (m, 2), torch.float32),
            "level": (state.level, (m,), torch.float32), "n": (state.n, (m,), torch.float32),
            "pool_level": (state.pool_level, (rows,), torch.float32),
            "pool_n": (state.pool_n, (rows,), torch.float32),
            "server": (server, (B,), torch.int32), "row": (row, (B,), torch.int32),
            "resid": (resid, (B,), torch.float32), "valid": (valid, (B,), torch.bool)}
    for name, (x, shape, dtype) in want.items():
        if x.device != state.stat.device:
            raise ValueError(f"{name} is on {x.device}, stat on {state.stat.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, want {dtype}")
    if m == 0 or rows == 0:
        raise ValueError("the scan needs at least one server and one pool row")


def launch(lib: ctypes.CDLL, state: CusumState, server, row, resid, valid, *, k: float,
           level_decay: float, stream: int) -> CusumState:
    """One launch of ``lib``'s scan: it reads ``state`` and writes the new
    state into new tensors, which it returns. Raises if the launch fails."""
    state = CusumState(*(a.contiguous() for a in state))
    out = CusumState(*(torch.empty_like(a) for a in state))
    server, row, resid, valid = (x.contiguous() for x in (server, row, resid, valid))
    m, rows = int(out.level.shape[0]), int(out.pool_level.shape[0])
    # the keys' counts, where they do not fit in shared memory
    scratch = torch.empty(2 * (m + rows), dtype=torch.int32, device=server.device)
    # ctypes rounds each double to float32 once, as ``_constants`` does
    err = lib.cusum_scan_launch(
        server.data_ptr(), row.data_ptr(), resid.data_ptr(), valid.data_ptr(),
        *(a.data_ptr() for a in state), *(a.data_ptr() for a in out), scratch.data_ptr(),
        int(server.shape[0]), m, rows, k, level_decay, 1.0 - level_decay, stream)
    if err:
        msg = lib.cusum_scan_error_string(err).decode()
        raise RuntimeError(f"cusum_scan launch failed: {msg} ({err})")
    return out


def cusum_scan(
    state: CusumState,
    server: torch.Tensor,
    row: torch.Tensor,
    resid: torch.Tensor,
    valid: torch.Tensor,
    *,
    k: float,
    level_decay: float,
) -> CusumState:
    """Fold rows [0, B) into ``state`` in order; returns the new state (the
    inputs are not written). On CUDA tensors the kernel runs on PyTorch's
    current stream (at ``B == 0`` it copies the state); CPU tensors go to
    the plain version."""
    dev = state.stat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"cusum_scan runs on cuda or cpu, not {dev}")
    _check(state, server, row, resid, valid)
    if dev.type == "cpu":
        return cusum_scan_torch(state, server, row, resid, valid, k=k, level_decay=level_decay)
    B = int(server.shape[0])
    with torch.cuda.device(dev):
        out = launch(_lib(), state, server, row, resid, valid, k=k, level_decay=level_decay,
                     stream=torch.cuda.current_stream().cuda_stream)
    LAUNCHES[(B, int(state.level.shape[0]), int(state.pool_level.shape[0]))] += 1
    return out
