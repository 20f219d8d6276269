"""Port: the schedules of the fleet plane's two CUDA kernels, on the CPU.

``csrc/cusum_scan.cu`` and ``csrc/fleet_actions.cu`` run only on the card,
so this file holds a Python model of each kernel's schedule, step for step
as the source walks it, to the plain versions the wrappers run on the CPU:

- ``cusum_schedule``: chunks of compacted valid rows (each warp's
  contiguous share, in stream order); the stable partitions by pool row and
  by server (warps owning residue classes of the keys rank each row among
  the earlier rows of its key 32 rows at a time, as ``__match_any_sync``
  groups them; one exclusive scan over both partitions' counts gives each
  key its first slot); each pool row's pool_level and pool_n chains over
  its slots, leaving the state before every row; each row's x from that
  state; then each server's chain over its slots. float32 rounding at every
  operation, as the kernel rounds with ``__f*_rn``. Held bit for bit to
  ``cusum_scan_torch``.
- ``split_schedule`` / ``evict_schedule``: the acting servers as bits of
  32-server words walked by ``__ffs``, each pool row's member count, the
  hand-over's two strided passes over ``row_map`` (a per-lane minimum, a
  warp minimum, the relabel), and the last pass that writes every output
  from the inputs. Held exactly to ``split_loop_torch`` / ``evict_loop_torch``.

Inputs are made with numpy from a seed (hypothesis draws the seeds, few
examples) at smoke sizes.
"""
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro_torch.kernels import cusum as kcu
from repro_torch.kernels import fleet_actions as kfa

F32 = np.float32
# cusum_scan.cu: kThreads / 32, kMaxChunk, kPoolWarps, kServerWarps
WARPS, MAX_CHUNK, POOL_WARPS, SERVER_WARPS = 16, 4096, 2, 6


# --- cusum_scan ---------------------------------------------------------------

def _compact(server, row, valid, base, cnt, m, rows):
    """The chunk's valid in-range rows in stream order, as the warps compact
    them: warp w its contiguous share, a ballot per 32 rows, at the offset of
    the earlier warps' counts."""
    per = -(-cnt // (WARPS * 32)) * 32
    shares = []
    for warp in range(WARPS):
        lo = min(cnt, warp * per)
        hi = min(cnt, lo + per)
        shares.append([base + i for i in range(lo, hi)
                       if valid[base + i] and 0 <= server[base + i] < m
                       and 0 <= row[base + i] < rows])
    return [b for share in shares for b in share]


def _rank(keys, parts, offset, cnt):
    """``rank_keys``: warp ``part`` of ``parts`` ranks the rows of its keys
    (key % parts == part) 32 at a time in stream order; within a tile a
    key's group takes consecutive ranks in lane order. Counts go to
    cnt[key + offset]."""
    rank = [0] * len(keys)
    for part in range(parts):
        for t0 in range(0, len(keys), 32):
            groups = {}
            for lane, key in enumerate(keys[t0:t0 + 32]):
                if key % parts == part:
                    groups.setdefault(key, []).append(lane)
            for key, lanes in groups.items():
                at = cnt[key + offset]
                for j, lane in enumerate(lanes):
                    rank[t0 + lane] = at + j
                cnt[key + offset] = at + len(lanes)
    return rank


def cusum_schedule(state, server, row, resid, valid, *, k, level_decay, max_chunk=MAX_CHUNK):
    """``cusum_scan.cu``'s schedule in float32 numpy (see the module docstring)."""
    stat, level, n, pool_level, pool_n = (a.numpy().astype(F32).copy() for a in state)
    server, row, valid = server.numpy(), row.numpy(), valid.numpy()
    resid = resid.numpy().astype(F32)
    kk, d, omd = F32(k), F32(level_decay), F32(1.0 - level_decay)
    B, m, rows = len(server), len(level), len(pool_level)
    chunk = -(-min(max(B, 1), max_chunk) // 32) * 32
    for base in range(0, B, chunk):
        comp = _compact(server, row, valid, base, min(chunk, B - base), m, rows)
        c_row = [int(row[b]) for b in comp]
        c_srv = [int(server[b]) for b in comp]
        cnt = [0] * (rows + m)  # the pool rows' keys, then the servers'
        pool_rank = _rank(c_row, POOL_WARPS, 0, cnt)
        srv_rank = _rank(c_srv, SERVER_WARPS, rows, cnt)
        start = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(int)
        ord_, p_r = [0] * (2 * len(comp)), [F32(0.0)] * len(comp)
        for i, b in enumerate(comp):
            q = start[c_row[i]] + pool_rank[i]
            ord_[q], p_r[q] = i, resid[b]
            ord_[start[rows + c_srv[i]] + srv_rank[i]] = i
        p_pl, p_pn = [F32(0.0)] * len(comp), [F32(0.0)] * len(comp)
        for w in range(rows):  # the pool chains, pool_level and pool_n apart
            slots = range(start[w], start[w] + cnt[w])
            for q in slots:
                p_pl[q] = pool_level[w]
                pool_level[w] = F32(d * pool_level[w]) + F32(omd * p_r[q])
            for q in slots:
                p_pn[q] = pool_n[w]
                pool_n[w] = F32(d * pool_n[w]) + F32(1.0)
        x = [F32(0.0)] * len(comp)
        for q in range(len(comp)):  # each row's hat, off the chains
            pl, pn = p_pl[q], p_pn[q]
            hat = pl / max(F32(omd * pn), F32(1e-12)) if pn > 0 else F32(0.0)
            x[ord_[q]] = p_r[q] - hat
        for s in range(m):  # the server chains
            for q in range(start[rows + s], start[rows + s] + cnt[rows + s]):
                i = ord_[q]
                stat[s, 0] = max(F32(0.0), stat[s, 0] + F32(x[i] - kk))
                stat[s, 1] = max(F32(0.0), stat[s, 1] - F32(x[i] + kk))
                level[s] = F32(d * level[s]) + F32(omd * resid[comp[i]])
                n[s] = F32(d * n[s]) + F32(1.0)
    return kcu.CusumState(*(torch.from_numpy(a) for a in (stat, level, n, pool_level, pool_n)))


def _cusum_case(seed, m=24, rows=None, B=300, pools=3, one_row=True):
    """A seeded block: servers in ``pools`` spec pools (pool row = the pool's
    first server) or, with ``one_row`` False, each row naming a random pool
    row; repeated servers, singleton rows and voided rows. Out-of-range
    servers and pool rows reach the scan as ``_cusum_update`` passes them:
    clamped into range and invalid."""
    rng = np.random.default_rng(seed)
    rows = m if rows is None else rows
    state = kcu.CusumState(
        torch.from_numpy(rng.exponential(0.5, (m, 2)).astype(F32)),
        torch.from_numpy(rng.normal(0, 0.3, m).astype(F32)),
        torch.from_numpy((rng.exponential(2.0, m) * (rng.random(m) < 0.8)).astype(F32)),
        torch.from_numpy(rng.normal(0, 0.3, rows).astype(F32)),
        torch.from_numpy((rng.exponential(2.0, rows) * (rng.random(rows) < 0.7)).astype(F32)))
    server = rng.integers(-2, m + 2, B)
    lead = np.arange(m) % pools
    row_map = np.where(rng.random(m) < 0.2, np.arange(m), lead)  # some servers split off
    if one_row:
        row = row_map[np.clip(server, 0, m - 1)]
    else:
        row = rng.integers(-1, rows + 1, B)
    valid = ((rng.random(B) < 0.75) & (server >= 0) & (server < m) & (row >= 0)
             & (row < rows))
    server = np.clip(server, 0, m - 1).astype(np.int32)
    row = np.clip(row, 0, rows - 1).astype(np.int32)
    resid = rng.normal(0, 0.5, B).astype(F32)
    return state, tuple(torch.from_numpy(a) for a in (server, row, resid, valid))


def _assert_bitwise(got, want):
    for name, a, b in zip(type(want)._fields, got, want):
        assert torch.equal(a, b), f"{name} differs"


@pytest.mark.parametrize("one_row", [True, False], ids=["one pool row", "rows mixed"])
@pytest.mark.parametrize("max_chunk", [MAX_CHUNK, 64], ids=["one chunk", "chunks of 64"])
def test_cusum_schedule_is_the_plain_fold_bitwise(one_row, max_chunk):
    state, rows = _cusum_case(5, one_row=one_row)
    kw = dict(k=0.25, level_decay=0.9)
    want = kcu.cusum_scan_torch(state, *rows, **kw)
    _assert_bitwise(cusum_schedule(state, *rows, **kw, max_chunk=max_chunk), want)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), pools=st.integers(1, 5), one_row=st.booleans(),
       cut=st.integers(0, 160))
def test_cusum_schedule_property(seed, pools, one_row, cut):
    """Random blocks with several pools, split into two calls at ``cut``,
    through the schedule with small chunks: bit for bit the plain fold of
    the whole block."""
    state, (server, row, resid, valid) = _cusum_case(seed, m=12, rows=9, B=160, pools=pools,
                                                     one_row=one_row)
    kw = dict(k=0.3, level_decay=0.85)
    want = kcu.cusum_scan_torch(state, server, row, resid, valid, **kw)
    mid = cusum_schedule(state, server[:cut], row[:cut], resid[:cut], valid[:cut], **kw,
                         max_chunk=32)
    got = cusum_schedule(mid, server[cut:], row[cut:], resid[cut:], valid[cut:], **kw,
                         max_chunk=96)
    _assert_bitwise(got, want)


def test_cusum_schedule_long_pool_chains_and_singletons():
    """Two spec pools over a fleet-like block (each tile has two long
    groups) and a block of one valid row per server (every group a
    singleton)."""
    m, B = 64, 512
    state, (server, row, resid, valid) = _cusum_case(9, m=m, B=B, pools=2)
    kw = dict(k=0.25, level_decay=0.9)
    valid = torch.arange(B) < 271  # the fused rack's block: the valid rows first
    _assert_bitwise(cusum_schedule(state, server, row, resid, valid, **kw),
                    kcu.cusum_scan_torch(state, server, row, resid, valid, **kw))
    perm = torch.from_numpy(np.random.default_rng(3).permutation(m).astype(np.int32))
    ones = torch.ones(m, dtype=torch.bool)
    args = (perm, perm % 2, resid[:m], ones)
    _assert_bitwise(cusum_schedule(state, *args, **kw),
                    kcu.cusum_scan_torch(state, *args, **kw))


def test_cusum_schedule_empty_block_copies_the_state():
    state, (server, row, resid, valid) = _cusum_case(2)
    got = cusum_schedule(state, server[:0], row[:0], resid[:0], valid[:0], k=0.25,
                         level_decay=0.9)
    _assert_bitwise(got, state)


# --- fleet_actions --------------------------------------------------------------

def _words(bits) -> list[int]:
    """One 32-bit word per 32 servers (a ballot each)."""
    bits = np.asarray(bits, bool)
    return [sum(1 << j for j in range(32) if 32 * w + j < len(bits) and bits[32 * w + j])
            for w in range(-(-len(bits) // 32))]


def _walk(cand_words):
    """Acting servers in index order: each word's set bits by ``__ffs``."""
    for w, left in enumerate(cand_words):
        while left:
            yield 32 * w + (left & -left).bit_length() - 1
            left &= left - 1


def _count(row, m):
    cnt = np.zeros(m, np.int64)
    for r in row:
        if 0 <= r < m:
            cnt[r] += 1
    return cnt


def _hand_over(s, r, size, row, src, cnt, read_row, pool_level, pool_n):
    """Warp 0 at leader ``s``: each lane's minimum over its strided servers,
    the warp minimum, then the relabel pass; lane 0 moves the rest."""
    m = len(row)
    firsts = [min([i for i in range(lane, m, 32) if i != s and row[i] == r], default=m)
              for lane in range(32)]
    nxt = min(firsts)
    for lane in range(32):
        for i in range(lane, m, 32):
            if i != s and row[i] == r:
                row[i] = nxt
                read_row[i] = nxt
    src[nxt] = src[r]
    cnt[nxt] += size - 1
    cnt[r] -= size - 1
    pool_level[nxt], pool_n[nxt] = pool_level[r], pool_n[r]
    pool_level[r] = pool_n[r] = 0.0


def _np(*tensors):
    return [t.numpy().copy() for t in tensors]


def split_schedule(flags, row_map, read_row, src_of, stat, pool_level, pool_n, ctl):
    """``fleet_split_kernel``'s schedule (see the module docstring)."""
    flags, row, read_row, src, stat, pool_level, pool_n, ctl = _np(
        flags, row_map, read_row, src_of, stat, pool_level, pool_n, ctl)
    m = len(row)
    fired = np.zeros(m, bool)
    if ctl[0] != 0:
        cnt = _count(row, m)
        for s in _walk(_words(flags)):
            r = row[s]
            size = cnt[r] if 0 <= r < m else 0
            if size < 2:
                continue
            if r == s:
                _hand_over(s, r, size, row, src, cnt, read_row, pool_level, pool_n)
            else:
                src[s] = src[r]
                cnt[r] -= 1
                cnt[s] += 1
                row[s] = read_row[s] = s
            fired[s] = True
    stat[flags] = 0.0
    return kfa.SplitOut(*(torch.from_numpy(a) for a in
                          (row, read_row, src, stat, pool_level, pool_n, fired)))


def evict_schedule(level_hits, base_ok, stat_val, row_map, read_row, src_of, active, stat,
                   level, n, pool_level, pool_n, ctl):
    """``fleet_evict_kernel``'s schedule (see the module docstring)."""
    hits, base, stat_val, row, read_row, src, active, stat, level, n, pool_level, pool_n, ctl = (
        _np(level_hits, base_ok, stat_val, row_map, read_row, src_of, active, stat, level, n,
            pool_level, pool_n, ctl))
    m = len(row)
    fired = np.zeros(m, bool)
    if ctl[0] != 0:
        cnt = _count(row, m)
        n_active = int(active.sum())
        cand = active & (hits | base) & (ctl[1] != 0)
        for s in _walk(_words(cand)):
            r = row[s]
            live = 0 <= r < m
            size = cnt[r] if live else 0
            if not (n_active > 1 and (hits[s] or (size == 1 and base[s]))):
                continue
            if r == s and size > 1:
                _hand_over(s, r, size, row, src, cnt, read_row, pool_level, pool_n)
            if live:
                cnt[r] -= 1
            row[s] = -1
            fired[s] = True
            n_active -= 1
    active &= ~fired
    stat[fired] = 0.0
    level[fired] = 0.0
    n[fired] = 0.0
    stats = np.where(fired, stat_val, F32(0.0)).astype(F32)
    return kfa.EvictOut(*(torch.from_numpy(a) for a in (
        row, read_row, src, active, stat, level, n, pool_level, pool_n, fired, stats)))


def _pools(m, pools, rng, drop=0.1):
    """Spec-pool routing: each pool's rows its first member's index, some
    servers already split off (their own row) or dropped (-1)."""
    row = (np.arange(m) % pools).astype(np.int32)
    u = rng.random(m)
    row = np.where(u < 0.15, np.arange(m), row)
    return np.where(u > 1 - drop, -1, row).astype(np.int32)


def _actions_case(seed, m=40, pools=3, p_flag=0.25, p_hit=0.15, p_base=0.3, p_active=0.9,
                  act_ok=True, row_map=None):
    rng = np.random.default_rng(seed)
    row_map = _pools(m, pools, rng) if row_map is None else np.asarray(row_map, np.int32)
    read_row = np.where(row_map >= 0, row_map, np.arange(m)).astype(np.int32)
    f32 = lambda *shape: torch.from_numpy(rng.normal(0, 1, shape).astype(F32))  # noqa: E731
    b = lambda p: torch.from_numpy(rng.random(m) < p)  # noqa: E731
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    flags, hits, base, active = b(p_flag), b(p_hit), b(p_base), b(p_active)
    ctl = i32([1, int(act_ok)])
    split = (flags, i32(row_map), i32(read_row), i32(np.arange(m)), f32(m, 2), f32(m), f32(m),
             ctl)
    evict = (hits, base, f32(m), None, None, None, active, None, f32(m), f32(m), None, None, ctl)
    return split, evict


def _evict_args(evict, sp):
    """The evict entry's inputs after a split, as ``fleet_step`` chains them."""
    hits, base, stat_val, _, _, _, active, _, level, n, _, _, ctl = evict
    return (hits, base, stat_val, sp.row_map, sp.read_row, sp.src_of, active, sp.stat, level, n,
            sp.pool_level, sp.pool_n, ctl)


def _assert_equal(got, want):
    for name, a, b in zip(type(want)._fields, got, want):
        assert torch.equal(a, b), f"{name} differs: {a} vs {b}"


def _both_loops(split, evict):
    """Split then evict through the schedules and the plain loops; returns
    the plain outputs."""
    sp = kfa.split_loop_torch(*split)
    _assert_equal(split_schedule(*split), sp)
    ev_args = _evict_args(evict, sp)
    ev = kfa.evict_loop_torch(*ev_args)
    _assert_equal(evict_schedule(*ev_args), ev)
    return sp, ev


def test_actions_schedule_leaders_and_members_act():
    split, evict = _actions_case(1, m=40, pools=3, p_flag=0.3, p_hit=0.2)
    flags = split[0].clone()
    flags[:3] = True  # the three pools' leaders
    sp, ev = _both_loops((flags,) + split[1:], evict)
    assert int(sp.fired.sum()) > 3 and int(ev.fired.sum()) > 0


def test_actions_schedule_pool_handed_over_twice():
    """One pool of ten: its leader 0 splits to 1, which is flagged too and
    hands the pool to 2; at evict, leader 2 hands it to 3."""
    m = 12
    row_map = [0] * 10 + [10, 11]
    split, evict = _actions_case(2, m=m, p_flag=0.0, p_hit=0.0, p_base=0.0, p_active=1.0,
                                 row_map=row_map)
    split = (torch.tensor([s in (0, 1, 6) for s in range(m)]),) + split[1:]
    evict = (torch.tensor([s == 2 for s in range(m)]),) + evict[1:]
    sp, ev = _both_loops(split, evict)
    assert sp.row_map.tolist()[:10] == [0, 1, 2, 2, 2, 2, 6, 2, 2, 2]
    assert ev.row_map.tolist()[:10] == [0, 1, -1, 3, 3, 3, 6, 3, 3, 3]
    assert sp.src_of[2] == 0 and ev.src_of[3] == 0


def test_actions_schedule_evicts_down_to_one_active():
    """Every active server hits: evictions stop with one left."""
    split, evict = _actions_case(3, m=37, p_flag=0.0, p_hit=1.0, p_active=0.6)
    sp, ev = _both_loops(split, evict)
    assert int(ev.active.sum()) == 1 and int(ev.fired.sum()) == int(evict[6].sum()) - 1


def test_actions_schedule_base_hits_in_pools_of_one():
    """Base hits fire only in pools of one: servers 3 mod 6 are alone, the
    rest in pools of five led by the multiples of 6."""
    m = 33
    row_map = np.where(np.arange(m) % 3 == 0, np.arange(m), (np.arange(m) // 6) * 6)
    split, evict = _actions_case(4, m=m, p_flag=0.0, p_hit=0.0, p_base=0.7, p_active=1.0,
                                 row_map=row_map)
    sp, ev = _both_loops(split, evict)
    fired = np.flatnonzero(ev.fired.numpy())
    assert len(fired) > 0 and all(s % 6 == 3 for s in fired)


def test_actions_schedule_quiet_and_act_ok_off():
    split, evict = _actions_case(5, p_flag=0.0, p_hit=0.0, p_base=0.0)
    quiet = torch.tensor([0, 1], dtype=torch.int32)
    split, evict = split[:-1] + (quiet,), evict[:-1] + (quiet,)
    sp, ev = _both_loops(split, evict)
    assert not sp.fired.any() and not ev.fired.any()
    split, evict = _actions_case(6, act_ok=False)
    _, ev = _both_loops(split, evict)
    assert not ev.fired.any()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), m=st.integers(1, 70), pools=st.integers(1, 6),
       p_flag=st.sampled_from([0.0, 0.1, 0.5]), p_hit=st.sampled_from([0.0, 0.1, 0.6]),
       arbitrary=st.booleans())
def test_actions_schedule_property(seed, m, pools, p_flag, p_hit, arbitrary):
    """Random fleets, with spec pools or any routing in [-1, m) (labels that
    are no member's index, pools whose leader was dropped)."""
    rng = np.random.default_rng(seed)
    row_map = rng.integers(-1, m, m) if arbitrary else None
    split, evict = _actions_case(seed, m=m, pools=pools, p_flag=p_flag, p_hit=p_hit,
                                 row_map=row_map)
    _both_loops(split, evict)
