"""Decision flight recorder: device-resident placement provenance.

Counterpart of ``repro/obs/recorder.py``. The metrics plane aggregates and
can say *that* a floor violation or a regret spike happened, never *why
decision k chose server s*. This module records the decision itself: one
packed row per placement commit (and per queue-at-arrival decision),
written by tensor ops inside ``engine_torch``'s event loop at the one point
every placement flows through (``place_if``), and carried through the
fused closed loop like the observation ring. Behind a ``record=`` flag;
nothing here feeds back into scoring, so recorded runs are
decision-identical.

Row layout (``REC_TOPK = K`` candidate slots):

  ints   i32[cap, 6 + K]
    0 arrival   trace-local arrival index (requeued work first, then chunk)
    1 segment   closed-loop segment counter (the carry's ``seen`` at entry)
    2 server    committed server id, or -1 when queued
    3 kind      0 = placed at arrival, 1 = drain commit, 2 = queued
    4 qdepth    queued arrivals at commit (drain rows count the drained one)
    5 pool_row  the estimator read row the scheduler consulted (-1 queued)
    6: cand     the K lowest-score candidate server ids (-1 = none
                feasible / past the fleet edge)
  floats f32[cap, 5 + K]
    0 time      commit time, chunk-relative (the trace clock)
    1 headroom  Eqn-4 budget left on the committed server, post-commit
    2 margin    runner-up score minus winner score (argmin tie margin)
    3 n_pair    min pair-confidence exposure over the newly co-located
                pairs (-1 = no co-residents, or no estimator context)
    4 cusum     the committed server's CUSUM level (max of the S+/S- pair)
    5: score    the K candidate scores (inf = infeasible)

:func:`record_row` writes its row in place with a masked write (the old
row is written back when off) and advances the cursor by the mask: no
branch and no host read, so it runs inside a captured block.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: candidate slots recorded per decision (winner first)
REC_TOPK = 4

#: row kinds (the ints[:, 3] column)
KIND_ARRIVE, KIND_DRAIN, KIND_QUEUED = 0, 1, 2

_INT_COLS = 6 + REC_TOPK
_FLOAT_COLS = 5 + REC_TOPK


class DecisionBlock(NamedTuple):
    """The packed decision rows (two tensors, like ``RingBlock``)."""

    ints: torch.Tensor  # i32[cap, 6 + K]
    floats: torch.Tensor  # f32[cap, 5 + K]

    arrival = property(lambda s: s.ints[:, 0])
    segment = property(lambda s: s.ints[:, 1])
    server = property(lambda s: s.ints[:, 2])
    kind = property(lambda s: s.ints[:, 3])
    qdepth = property(lambda s: s.ints[:, 4])
    pool_row = property(lambda s: s.ints[:, 5])
    cand = property(lambda s: s.ints[:, 6:])
    time = property(lambda s: s.floats[:, 0])
    headroom = property(lambda s: s.floats[:, 1])
    margin = property(lambda s: s.floats[:, 2])
    n_pair_min = property(lambda s: s.floats[:, 3])
    cusum = property(lambda s: s.floats[:, 4])
    score = property(lambda s: s.floats[:, 5:])


class RecState(NamedTuple):
    """The recorder's state: ring block + cursor."""

    block: DecisionBlock
    ptr: torch.Tensor  # i32 next write slot (kept modulo capacity)
    total: torch.Tensor  # i32 rows ever recorded

    @property
    def capacity(self) -> int:
        return int(self.block.ints.shape[0])


class RecCtx(NamedTuple):
    """Estimator/detector context the recorder samples at each commit.

    Built once per segment (host path: from the live fleet objects; fused
    loop: from the carry) -- the state the scheduler *consulted*, not the
    post-segment state.
    """

    n_pair: "torch.Tensor | None"  # f32[rows, T, T] pair-exposure bank rows
    row_of: torch.Tensor  # i32[m] server -> bank row
    cusum: torch.Tensor  # f32[m] per-server CUSUM level (max S+/S-)
    pool_row: torch.Tensor  # i32[m] recorded read row per server
    segment: torch.Tensor  # i32 segment counter at entry


def init(capacity: int, device: str | torch.device = "cpu") -> RecState:
    """Fresh all-sentinel recorder state (``ints`` -1, ``floats`` 0)."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive (got {capacity})")
    i32 = dict(dtype=torch.int32, device=device)
    return RecState(
        block=DecisionBlock(
            ints=torch.full((capacity, _INT_COLS), -1, **i32),
            floats=torch.zeros((capacity, _FLOAT_COLS), dtype=torch.float32, device=device)),
        ptr=torch.zeros((), **i32), total=torch.zeros((), **i32))


def clone(rec: RecState) -> RecState:
    return RecState(DecisionBlock(rec.block.ints.clone(), rec.block.floats.clone()),
                    rec.ptr.clone(), rec.total.clone())


def copy_(dst: RecState, src: RecState) -> RecState:
    """``dst``'s tensors take ``src``'s values, in place (same capacity)."""
    dst.block.ints.copy_(src.block.ints)
    dst.block.floats.copy_(src.block.floats)
    dst.ptr.copy_(src.ptr)
    dst.total.copy_(src.total)
    return dst


def default_ctx(m: int, device: str | torch.device = "cpu") -> RecCtx:
    """Context for engines without an estimator in the loop: identity pool
    routing, zero CUSUM, no pair-exposure table (n_pair records -1)."""
    i32 = dict(dtype=torch.int32, device=device)
    return RecCtx(
        n_pair=None,
        row_of=torch.arange(m, **i32),
        cusum=torch.zeros((m,), dtype=torch.float32, device=device),
        pool_row=torch.arange(m, **i32),
        segment=torch.zeros((), **i32))


def top_candidates(score_row: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cand i32[K], score f32[K]): the K lowest-score candidates.

    ``score_row`` is the feasibility-masked score over all servers
    (infeasible = inf). A stable sort reproduces the scheduler's
    lowest-index tie-break (``torch.topk`` is not stable); infeasible slots
    keep their inf score but null their candidate id. Fleets smaller than K
    pad with (-1, inf).
    """
    m = int(score_row.shape[0])
    dev = score_row.device
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    if m < REC_TOPK:
        pad = REC_TOPK - m
        score_row = torch.cat(
            [score_row, torch.full((pad,), torch.inf, dtype=score_row.dtype, device=dev)])
        idx = torch.cat([idx, torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    sc, order = torch.sort(score_row, stable=True)
    sc, order = sc[:REC_TOPK], order[:REC_TOPK]
    cand = torch.where(torch.isfinite(sc), idx[order], -1)
    return cand, sc


def tie_margin(scores: torch.Tensor) -> torch.Tensor:
    """Runner-up minus winner from a sorted top-K score row (inf when there
    is no finite runner-up -- a one-horse race has no tie to break)."""
    return torch.where(torch.isfinite(scores[1]) & torch.isfinite(scores[0]),
                       scores[1] - scores[0], torch.inf)


def pair_exposure_min(n_pair_row: torch.Tensor, counts_row: torch.Tensor,
                      wtype: torch.Tensor) -> torch.Tensor:
    """Min pair-confidence exposure over the newly co-located pairs.

    ``n_pair_row`` is one estimator row's decayed per-pair exposure table
    [T, T] (both orientations are min-ed, so the estimator's target-major
    transpose does not matter); ``counts_row`` the committed server's
    *post-commit* type counts. Returns -1 when the placement co-locates
    with nothing.
    """
    T = int(counts_row.shape[0])
    # a [1] index: a gather, where a 0-d tensor index would read the host
    t = torch.clamp(wtype.reshape(1), 0, T - 1).long()
    types = torch.arange(T, device=counts_row.device)
    co = counts_row - (types == t).to(counts_row.dtype)
    present = co > 0
    both = torch.minimum(n_pair_row.index_select(0, t)[0],
                         n_pair_row.index_select(1, t)[:, 0])  # [T]
    val = torch.where(present, both, torch.inf).amin()
    return torch.where(present.any(), val, -1.0)


def record_row(rec: RecState, *, on, arrival, segment, server, kind, qdepth,
               pool_row, cand, scores, t, headroom, margin, n_pair_min,
               cusum) -> RecState:
    """Write one decision row when ``on`` (a 0-d bool tensor), in place; when
    off the slot keeps its old row and the cursor stays. Every scalar is a
    0-d (or one-element) tensor on the ring's device. Returns ``rec``."""
    cap = rec.capacity
    ints, floats = rec.block

    def col(x, dtype):
        return x.reshape(1).to(dtype)

    ints_row = torch.cat([col(arrival, torch.int32), col(segment, torch.int32),
                          col(server, torch.int32), col(kind, torch.int32),
                          col(qdepth, torch.int32), col(pool_row, torch.int32),
                          cand.to(torch.int32)])
    floats_row = torch.cat([col(t, torch.float32), col(headroom, torch.float32),
                            col(margin, torch.float32), col(n_pair_min, torch.float32),
                            col(cusum, torch.float32), scores.to(torch.float32)])
    slot = rec.ptr.reshape(1).long()
    on = on.reshape(())
    ints.index_copy_(0, slot, torch.where(on, ints_row[None], ints[slot]))
    floats.index_copy_(0, slot, torch.where(on, floats_row[None], floats[slot]))
    one = on.to(torch.int32)
    rec.ptr.copy_((rec.ptr + one) % cap)
    rec.total.add_(one)
    return rec


class DecisionRing:
    """Host mirror of the device-resident decision ring.

    Like :class:`~repro_torch.telemetry.log.ObservationRing`: a host object
    holding the device ``RecState``, adopted wholesale after each recorded
    run (host-alternating per segment, the fused loop once per run).
    Capacity is spent in decisions; once full, the oldest are overwritten --
    flight-recorder semantics.
    """

    def __init__(self, capacity: int, device: str | torch.device = "cpu"):
        self.capacity = int(capacity)
        self._state = init(capacity, device)

    @property
    def state(self) -> RecState:
        return self._state

    @property
    def ptr(self) -> int:
        return int(self._state.ptr)

    @property
    def total(self) -> int:
        return int(self._state.total)

    def __len__(self) -> int:
        return min(self.total, self.capacity)

    def adopt(self, state: RecState) -> None:
        """Adopt a post-run device state (the host mirror of the carry)."""
        if state.capacity != self.capacity:
            raise ValueError(
                f"adopting a ring of capacity {state.capacity} into one of {self.capacity}")
        self._state = state

    def columns(self) -> dict[str, np.ndarray]:
        """Decoded rows, oldest-first, as named numpy columns.

        Never-written slots are dropped; wrapped rings unwrap so row 0 is
        the oldest surviving decision.
        """
        ints = self._state.block.ints.cpu().numpy()
        floats = self._state.block.floats.cpu().numpy().astype(np.float64)
        n = len(self)
        if self.total > self.capacity:  # wrapped: oldest row sits at ptr
            p = self.ptr
            sel = np.concatenate([np.arange(p, self.capacity), np.arange(p)])
        else:
            sel = np.arange(n)
        ints, floats = ints[sel], floats[sel]
        return {
            "arrival": ints[:, 0], "segment": ints[:, 1],
            "server": ints[:, 2], "kind": ints[:, 3],
            "qdepth": ints[:, 4], "pool_row": ints[:, 5],
            "cand": ints[:, 6:],
            "time": floats[:, 0], "headroom": floats[:, 1],
            "margin": floats[:, 2], "n_pair_min": floats[:, 3],
            "cusum": floats[:, 4], "score": floats[:, 5:],
        }
