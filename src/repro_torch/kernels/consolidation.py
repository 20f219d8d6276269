"""The paper's greedy-placement scoring loop as a hand-written CUDA kernel.

For each of Q candidate workloads, score all m servers by tentatively
placing the workload (Fig 8 steps 2-3): cache_in_use' and Max(D_y)' under
the additive model (Eqn 3). Counterpart of the Pallas kernel
``repro/kernels/consolidation.py::consolidation_scores``, with the same
inputs and the same ``[Q, m]`` outputs; the design and its bound are in
``csrc/consolidation_scores.cu``.

The kernel has two paths with bitwise-equal outputs (``choose_path``): a
single pass for small Q, which is launch-bound, and for larger Q a table
path that forms one entry per (candidate type, server) and then gathers
the ``[Q, m]`` outputs from it, so each needed row of D is read once.

``consolidation_scores`` launches the kernel on CUDA tensors and runs the
plain PyTorch version, ``consolidation_scores_torch``, on CPU tensors. On
any other device, or when the build or the launch fails, it raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

#: candidates per CTA of the single pass: 64 servers x 1024 candidates ->
#: 1024 CTAs on 132 SMs
Q_CHUNK = 64
#: the largest Q that takes the single pass (one launch); above it the
#: table path (two launches) is faster
CROSSOVER_Q = 16
PATHS = ("single", "table")
#: CTAs of the table path's gather
GATHER_BLOCKS = 132 * 8

#: kernel launches per (path, candidate-batch size Q), counted where the
#: kernel is launched and nowhere else (``reset_launches`` zeroes it)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def consolidation_scores_torch(
    counts: torch.Tensor,  # [m, T] resident workload counts per server
    D: torch.Tensor,  # [m, T, T] profiled pairwise degradations
    rs: torch.Tensor,  # [T] request sizes (bytes)
    fs_resident: torch.Tensor,  # [m, T] fs * (fs <= llc) per server
    llc_budget: torch.Tensor,  # [m] alpha * CacheSize
    wtypes: torch.Tensor,  # [Q] candidate grid types
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (cache_after, maxd_after), [Q, m]."""
    T = counts.shape[1]
    # one-hot by comparison: one_hot() reads the types' range back to the
    # host on the CPU, and this runs inside the event loop's blocks
    types = torch.arange(T, device=counts.device)
    onehot = (wtypes.long()[:, None] == types[None, :]).to(counts.dtype)  # [Q, T]
    c = counts[:, None, :] + onehot[None, :, :]  # [m, Q, T]
    comp = (c * rs).sum(-1) + (c * fs_resident[:, None, :]).sum(-1)  # [m, Q]
    cache = comp / llc_budget[:, None]
    col = torch.bmm(c, D)  # [m, Q, T] = c @ D[s]
    diag = torch.diagonal(D, dim1=1, dim2=2)  # [m, T]
    d_pred = torch.clamp(col - diag[:, None, :], 0.0, 1.0)
    maxd = torch.where(c > 0, d_pred, -torch.inf).amax(-1)  # [m, Q]
    return cache.T.contiguous(), maxd.T.contiguous()


def choose_path(Q: int) -> str:
    """The kernel's path for Q candidates: ``"single"`` up to CROSSOVER_Q,
    ``"table"`` above it."""
    return "single" if Q <= CROSSOVER_Q else "table"


def table_shares(m: int) -> int:
    """CTAs per server in the table path's first pass: enough that m
    servers fill the card twice over (m x shares >= 264), at most 8."""
    return max(1, min(8, -(-2 * 132 // m)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library."""
    fn = lib.consolidation_scores_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.consolidation_scores_table_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.consolidation_scores_error_string.argtypes = [ctypes.c_int]
    lib.consolidation_scores_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("consolidation_scores"))


def launch(lib: ctypes.CDLL, args: tuple, path: str, stream: int) -> tuple[torch.Tensor, ...]:
    """One launch of ``lib``'s ``path`` on ``args`` (checked by ``_check``,
    Q >= 1): (cache, maxd). Raises if the launch fails."""
    counts, D, rs, fs_resident, llc_budget, wtypes = args
    m, T = counts.shape
    Q = wtypes.shape[0]
    cache = torch.empty((Q, m), dtype=torch.float32, device=counts.device)
    maxd = torch.empty((Q, m), dtype=torch.float32, device=counts.device)
    ptrs = (*(x.data_ptr() for x in args), cache.data_ptr(), maxd.data_ptr())
    if path == "single":
        err = lib.consolidation_scores_launch(*ptrs, m, T, Q, Q_CHUNK, stream)
    else:
        table = torch.empty((2, T, m), dtype=torch.float32, device=counts.device)
        err = lib.consolidation_scores_table_launch(
            *ptrs, table[0].data_ptr(), table[1].data_ptr(), m, T, Q, table_shares(m),
            GATHER_BLOCKS, stream)
    if err:
        msg = lib.consolidation_scores_error_string(err).decode()
        raise RuntimeError(f"consolidation_scores launch failed: {msg} ({err})")
    return cache, maxd


def _check(counts, D, rs, fs_resident, llc_budget, wtypes) -> None:
    m, T = counts.shape
    want = {"counts": (counts, (m, T), torch.float32),
            "D": (D, (m, T, T), torch.float32),
            "rs": (rs, (T,), torch.float32),
            "fs_resident": (fs_resident, (m, T), torch.float32),
            "llc_budget": (llc_budget, (m,), torch.float32),
            "wtypes": (wtypes, (wtypes.shape[0],), torch.int32)}
    for name, (x, shape, dtype) in want.items():
        if x.device != counts.device:
            raise ValueError(f"{name} is on {x.device}, counts on {counts.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, want {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < T <= 256:
        raise ValueError(f"the kernel takes 1..256 types, got T={T}")
    if -(-wtypes.shape[0] // Q_CHUNK) > 65535:
        raise ValueError(f"Q={wtypes.shape[0]} exceeds the launch grid")


def consolidation_scores(
    counts: torch.Tensor,
    D: torch.Tensor,
    rs: torch.Tensor,
    fs_resident: torch.Tensor,
    llc_budget: torch.Tensor,
    wtypes: torch.Tensor,
    *,
    path: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cache_after [Q, m], maxd_after [Q, m]) for placing each candidate.

    Launches the CUDA kernel on PyTorch's current stream for CUDA tensors
    (float32, ``wtypes`` int32, all contiguous), by ``path`` or, when it is
    None, by ``choose_path(Q)``; CPU tensors go to the plain version. Grid
    types in ``wtypes`` must lie in [0, T); the kernel writes NaN for a
    type outside it.
    """
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None, got {path!r}")
    if counts.device.type == "cpu":
        return consolidation_scores_torch(counts, D, rs, fs_resident, llc_budget, wtypes)
    if counts.device.type != "cuda":
        raise ValueError(f"consolidation_scores runs on cuda or cpu, not {counts.device}")
    _check(counts, D, rs, fs_resident, llc_budget, wtypes)
    m, Q = counts.shape[0], wtypes.shape[0]
    if Q == 0:
        empty = torch.empty((0, m), dtype=torch.float32, device=counts.device)
        return empty, empty.clone()
    path = path or choose_path(Q)
    with torch.cuda.device(counts.device):
        out = launch(_lib(), (counts, D, rs, fs_resident, llc_budget, wtypes), path,
                     torch.cuda.current_stream().cuda_stream)
    LAUNCHES[(path, Q)] += 1
    return out
