"""The fleet controller's action loops as a hand-written CUDA kernel.

The split loop and the evict loop of JAX's ``fleet_step``
(``repro/fleet/controller.py:223-297``, two ``lax.fori_loop`` s over the m
servers in index order; no Pallas twin) with live pool membership: a step
sees the routing that earlier steps left. One CUDA source
(``csrc/fleet_actions.cu``, which holds the design and the bound) has an
entry per loop:

- ``split_loop``: a flagged server in a pool of two or more leaves it,
  seeded with the pool's posterior (a leader hands the pool to its
  smallest other member, whose pool-centering detector row moves along);
  every flagged server's CUSUM pair is zeroed;
- ``evict_loop``: an active server with a level hit, or a base hit in a pool
  of one, leaves the fleet while more than one server is active (a leader
  first hands its pool on): routing -1, active false, detector rows zeroed,
  its statistic recorded.

Both carry ``src_of``, the bank-row provenance map (final content of row r
= input row ``src_of[r]``); the caller gathers the bank through it once.
Every input a step decides on is an integer or a boolean (the float tests
are made before the launch), so the kernel and its plain version agree
exactly. ``ctl`` = (take_slow, act_ok) as device int32: with take_slow 0
(the pre-action screen found nothing that can fire) the kernel copies its
inputs to its outputs in one pass, as the loops would leave them. Where
something can act, one warp walks the acting servers with each pool row's
member count in shared memory (the source holds the design). The kernel
writes its outputs out of place, so the wrappers copy nothing before the
launch.

Each wrapper launches the kernel on CUDA tensors and runs its plain PyTorch
version (``split_loop_torch``, ``evict_loop_torch``: the loops written out,
nothing read back to the host) on CPU tensors; on any other device, or when
the build or the launch fails, it raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

#: kernel launches per (entry, m), entry 'split' or 'evict', counted where
#: the kernel is launched and nowhere else (``reset_launches`` zeroes it)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


class SplitOut(NamedTuple):
    row_map: torch.Tensor  # i32[m] update routing (-1 = dropped)
    read_row: torch.Tensor  # i32[m] read routing
    src_of: torch.Tensor  # i32[m] bank-row provenance
    stat: torch.Tensor  # f32[m, 2] CUSUM pairs
    pool_level: torch.Tensor  # f32[m] pool-centering level per pool row
    pool_n: torch.Tensor  # f32[m] its exposure
    fired: torch.Tensor  # bool[m] servers that split


class EvictOut(NamedTuple):
    row_map: torch.Tensor
    read_row: torch.Tensor
    src_of: torch.Tensor
    active: torch.Tensor  # bool[m] placement eligibility
    stat: torch.Tensor
    level: torch.Tensor  # f32[m] residual level
    n: torch.Tensor  # f32[m] its exposure
    pool_level: torch.Tensor
    pool_n: torch.Tensor
    fired: torch.Tensor  # bool[m] servers evicted
    stats: torch.Tensor  # f32[m] the evicted servers' statistic, 0 elsewhere


def _put(dst: torch.Tensor, i: torch.Tensor, value, mask: torch.Tensor) -> None:
    """dst[i] = value where mask, else unchanged (``i`` of shape [1]; a
    Python ``value`` takes ``dst``'s dtype without a copy from the host)."""
    dst.index_put_((i,), torch.where(mask, value, dst[i]))


def _hand_over(s, row, members, row_map, read_row, src_of, pool_level, pool_n, leader, idx):
    """A leader's pool moves to its smallest other member (where ``leader``):
    the bank row is seeded from the pool's (src_of), the others' routing
    moves, and so do the pool-centering detector rows. Returns the new row."""
    m = row_map.shape[0]
    others = members & (idx != s)
    new = torch.where(others, idx, m).min().reshape(1)
    newc = new.clamp(max=m - 1).long()
    src = row.clamp(0, m - 1).long()
    _put(src_of, newc, src_of[src], leader)
    move = leader & others
    row_map.copy_(torch.where(move, new, row_map))
    read_row.copy_(torch.where(move, new, read_row))
    v_l, v_n = pool_level[src], pool_n[src]
    _put(pool_level, newc, v_l, leader)
    _put(pool_level, src, 0.0, leader)
    _put(pool_n, newc, v_n, leader)
    _put(pool_n, src, 0.0, leader)
    return new


def split_loop_torch(flags, row_map, read_row, src_of, stat, pool_level, pool_n,
                     ctl=None) -> SplitOut:
    """Plain PyTorch version of the split entry: JAX's ``split_body`` for
    s = 0..m-1 with every write masked. ``ctl`` is not needed: nothing can
    split where no server is flagged."""
    m = row_map.shape[0]
    row_map, read_row, src_of, stat, pool_level, pool_n = (
        a.clone() for a in (row_map, read_row, src_of, stat, pool_level, pool_n))
    idx = torch.arange(m, dtype=torch.int32, device=row_map.device)
    fired = torch.zeros(m, dtype=torch.bool, device=row_map.device)
    for s in range(m):
        si = idx[s:s + 1].long()
        row = row_map[s:s + 1]
        members = (row_map == row) & (row_map >= 0)
        can = flags[s:s + 1] & (row >= 0) & (members.sum() > 1)
        leader = can & (row == s)
        _put(src_of, si, src_of[row.clamp(0, m - 1).long()], can & ~leader)
        _hand_over(s, row, members, row_map, read_row, src_of, pool_level, pool_n, leader, idx)
        _put(row_map, si, s, can & ~leader)
        _put(read_row, si, s, can & ~leader)
        stat.index_put_((si,), torch.where(flags[s:s + 1, None], 0.0, stat[si]))
        _put(fired, si, True, can)
    return SplitOut(row_map, read_row, src_of, stat, pool_level, pool_n, fired)


def evict_loop_torch(level_hits, base_ok, stat_val, row_map, read_row, src_of, active, stat,
                     level, n, pool_level, pool_n, ctl) -> EvictOut:
    """Plain PyTorch version of the evict entry: JAX's ``evict_body`` for
    s = 0..m-1 with every write masked; ``ctl[1]`` is act_ok."""
    m = row_map.shape[0]
    row_map, read_row, src_of, active, stat, level, n, pool_level, pool_n = (
        a.clone() for a in (row_map, read_row, src_of, active, stat, level, n, pool_level,
                            pool_n))
    dev = row_map.device
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    fired = torch.zeros(m, dtype=torch.bool, device=dev)
    stats = torch.zeros(m, dtype=torch.float32, device=dev)
    act_ok = ctl[1:2] != 0
    for s in range(m):
        si = idx[s:s + 1].long()
        row = row_map[s:s + 1]
        members = (row_map == row) & (row_map >= 0)
        size = members.sum()
        gate = active[s:s + 1] & (active.sum() > 1) & act_ok
        base_hit = (size == 1) & base_ok[s:s + 1]
        fire = gate & (level_hits[s:s + 1] | base_hit)
        leader = fire & (row == s) & (size > 1)
        _hand_over(s, row, members, row_map, read_row, src_of, pool_level, pool_n, leader, idx)
        _put(row_map, si, -1, fire)
        _put(active, si, False, fire)
        stat.index_put_((si,), torch.where(fire[:, None], 0.0, stat[si]))
        _put(level, si, 0.0, fire)
        _put(n, si, 0.0, fire)
        _put(fired, si, True, fire)
        _put(stats, si, stat_val[si], fire)
    return EvictOut(row_map, read_row, src_of, active, stat, level, n, pool_level, pool_n,
                    fired, stats)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library."""
    lib.fleet_split_launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_void_p]
    lib.fleet_split_launch.restype = ctypes.c_int
    lib.fleet_evict_launch.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int, ctypes.c_void_p]
    lib.fleet_evict_launch.restype = ctypes.c_int
    lib.fleet_actions_max_servers.argtypes = []
    lib.fleet_actions_max_servers.restype = ctypes.c_int
    lib.fleet_actions_error_string.argtypes = [ctypes.c_int]
    lib.fleet_actions_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("fleet_actions"))


_INT = ("row_map", "read_row", "src_of")
_FLOAT = ("stat", "level", "n", "pool_level", "pool_n", "stat_val")
_BOOL = ("flags", "level_hits", "base_ok", "active")


def _check(m: int, **tensors) -> None:
    dev = tensors["row_map"].device
    for name, x in tensors.items():
        want = (torch.int32 if name in _INT or name == "ctl" else
                torch.float32 if name in _FLOAT else torch.bool)
        shape = (2,) if name == "ctl" else (m, 2) if name == "stat" else (m,)
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, row_map on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if x.dtype != want:
            raise TypeError(f"{name} has dtype {x.dtype}, want {want}")


def _raise_on(lib, err: int, entry: str) -> None:
    if err:
        msg = lib.fleet_actions_error_string(err).decode()
        raise RuntimeError(f"fleet_actions {entry} launch failed: {msg} ({err})")


def launch_split(lib: ctypes.CDLL, flags, row_map, read_row, src_of, stat, pool_level, pool_n,
                 ctl, stream: int) -> SplitOut:
    """One launch of ``lib``'s split entry: it reads the inputs and writes
    new output tensors, which it returns."""
    m = row_map.shape[0]
    ins = tuple(x.contiguous() for x in (flags, row_map, read_row, src_of, stat, pool_level,
                                         pool_n))
    out = SplitOut(*(torch.empty_like(a) for a in ins[1:]), torch.empty_like(ins[0]))
    err = lib.fleet_split_launch(*(a.data_ptr() for a in ins), *(a.data_ptr() for a in out),
                                 ctl.contiguous().data_ptr(), m, stream)
    _raise_on(lib, err, "split")
    return out


def launch_evict(lib: ctypes.CDLL, level_hits, base_ok, stat_val, row_map, read_row, src_of,
                 active, stat, level, n, pool_level, pool_n, ctl, stream: int) -> EvictOut:
    """One launch of ``lib``'s evict entry: it reads the inputs and writes
    new output tensors, which it returns."""
    m = row_map.shape[0]
    ins = tuple(x.contiguous() for x in (level_hits, base_ok, stat_val, row_map, read_row,
                                         src_of, active, stat, level, n, pool_level, pool_n))
    out = EvictOut(*(torch.empty_like(a) for a in ins[3:]), torch.empty_like(ins[0]),
                   torch.empty_like(ins[2]))
    err = lib.fleet_evict_launch(*(a.data_ptr() for a in ins), *(a.data_ptr() for a in out),
                                 ctl.contiguous().data_ptr(), m, stream)
    _raise_on(lib, err, "evict")
    return out


def _cuda_lib(dev: torch.device, m: int) -> ctypes.CDLL:
    if dev.type != "cuda":
        raise ValueError(f"fleet_actions runs on cuda or cpu, not {dev}")
    lib = _lib()
    if m > lib.fleet_actions_max_servers():
        raise ValueError(f"fleet_actions holds at most {lib.fleet_actions_max_servers()} "
                         f"servers in shared memory, got m={m}")
    return lib


def split_loop(flags, row_map, read_row, src_of, stat, pool_level, pool_n, ctl) -> SplitOut:
    """The split loop (see the module docstring); returns new tensors."""
    m = row_map.shape[0]
    _check(m, flags=flags, row_map=row_map, read_row=read_row, src_of=src_of, stat=stat,
           pool_level=pool_level, pool_n=pool_n, ctl=ctl)
    dev = row_map.device
    if dev.type == "cpu":
        return split_loop_torch(flags, row_map, read_row, src_of, stat, pool_level, pool_n, ctl)
    lib = _cuda_lib(dev, m)
    with torch.cuda.device(dev):
        out = launch_split(lib, flags, row_map, read_row, src_of, stat, pool_level, pool_n, ctl,
                           torch.cuda.current_stream().cuda_stream)
    LAUNCHES[("split", m)] += 1
    return out


def evict_loop(level_hits, base_ok, stat_val, row_map, read_row, src_of, active, stat, level,
               n, pool_level, pool_n, ctl) -> EvictOut:
    """The evict loop (see the module docstring); returns new tensors."""
    m = row_map.shape[0]
    _check(m, level_hits=level_hits, base_ok=base_ok, stat_val=stat_val, row_map=row_map,
           read_row=read_row, src_of=src_of, active=active, stat=stat, level=level, n=n,
           pool_level=pool_level, pool_n=pool_n, ctl=ctl)
    dev = row_map.device
    args = (level_hits, base_ok, stat_val, row_map, read_row, src_of, active, stat, level, n,
            pool_level, pool_n, ctl)
    if dev.type == "cpu":
        return evict_loop_torch(*args)
    lib = _cuda_lib(dev, m)
    with torch.cuda.device(dev):
        out = launch_evict(lib, *args, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[("evict", m)] += 1
    return out
