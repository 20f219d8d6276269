"""Regret attribution over a recorded run: replay every decision against
the true dynamics and say what each one cost.

Copied from ``repro/obs/explain.py`` onto the port's float64 oracle
(``core.binpack``, ``core.scheduler``) and decision ring.

The decision ring (``obs.recorder``) says *what* the scheduler did -- which
server, at what score margin, under what headroom and estimator confidence.
This module says *what it cost*: for each recorded decision, the makespan
delta attributable to taking it instead of what the true-D oracle would
have done, decomposed into the three ways the closed loop loses time:

``estimation``  the scheduler's D-hat ranked a worse server above the true
                best (model error at commit);
``queueing``    the same server was (or would have been) chosen, but the
                commit happened at a different time -- work waited in the
                section-V queue that the oracle would have started, or vice
                versa;
``detection``   the divergent choice involved a server whose CUSUM level
                was already elevated at commit -- the detector had evidence
                of drift the scheduler had not yet acted on.

Method: *telescoping forced replay*. For a segment with p recorded
decisions, run p + 1 float64 reference replays (the trusted
``core.scheduler.OnlineScheduler`` event loop over the true profiled D).
Replay ``R_j`` forces the first j recorded decisions -- workload-j's server
at arrival, or its queue-then-commit at the recorded commit time -- and
lets the true-D greedy finish the rest. ``R_0`` is the oracle, ``R_p`` the
recorded run re-enacted. Each decision's cost is the adjacent difference

    delta_j = duration(R_j) - duration(R_{j-1})

so the per-decision costs sum to ``duration(R_p) - duration(R_0)`` --
the segment's regret -- *exactly* (it telescopes; the acceptance gate's
1e-5 is pure float-summation slack). The counterfactual for bucketing
decision j is workload j's fate in ``R_{j-1}``, where it is the first
unforced decision.

The replays are host-side and O(p) per decision -- this is a post-mortem
tool, not a hot path. It needs the per-segment arrival chunks and true
specs alongside the ring; ``python -m repro_torch.obs --explain`` wires a canned
stationary adaptive run end to end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from ..core.binpack import ClusterState, greedy_place
from ..core.scheduler import OnlineScheduler
from .recorder import KIND_ARRIVE, KIND_DRAIN, KIND_QUEUED, DecisionRing

#: recorded CUSUM level at or above which a divergent decision is blamed on
#: detection lag rather than estimation error (half the default split
#: threshold ``cusum_h=2.0`` -- evidence was accumulating, action had not
#: fired yet)
CUSUM_GATE = 1.0

#: relative slack when matching a forced drain commit to a replay finish
#: event (the ring stores f32 chunk-relative times; the replay runs f64)
TIME_RTOL = 1e-4
TIME_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class DecisionAttribution:
    """One recorded decision, costed against its oracle counterfactual."""

    row: int  # ring row (oldest-first decode order)
    segment: int
    arrival: int  # trace-local arrival id
    kind: int  # recorder KIND_*
    server: int  # recorded committed server (-1 on queue rows)
    shadow_server: "int | None"  # true-D greedy's choice in R_{j-1}
    delta: float  # duration(R_j) - duration(R_{j-1}), seconds
    bucket: str  # 'estimation' | 'queueing' | 'detection' | 'aligned'
    time: float  # recorded commit time (chunk-relative)
    margin: float  # recorded argmin tie margin
    headroom: float  # recorded Eqn-4 headroom at commit
    cusum: float  # recorded CUSUM level of the committed server
    n_pair_min: float  # recorded min pair-confidence exposure


@dataclasses.dataclass(frozen=True)
class SegmentAttribution:
    """A segment's full decomposition: oracle -> recorded, one delta per
    decision, summing exactly to the regret."""

    segment: int
    duration_oracle: float  # R_0: free true-D greedy replay
    duration_forced: float  # R_p: every recorded decision forced
    regret: float  # duration_forced - duration_oracle == sum of deltas
    decisions: tuple[DecisionAttribution, ...]
    #: recorded run duration minus duration_forced: how faithfully the f64
    #: replay re-enacts the f32 engine (diagnostic; ~0 on healthy runs)
    replay_gap: "float | None" = None

    @property
    def by_bucket(self) -> dict:
        out: dict[str, float] = {}
        for d in self.decisions:
            out[d.bucket] = out.get(d.bucket, 0.0) + d.delta
        return out


@dataclasses.dataclass
class _Forced:
    """How a forced workload behaves in a replay."""

    server: "int | None" = None  # arrival-time server (kind 0)
    queued: bool = False  # kind-2 row in the prefix
    commit_server: "int | None" = None  # kind-1 row in the prefix
    commit_time: float = 0.0


def _replay(
    chunk: Sequence[tuple[float, object]],
    servers,
    D,
    alpha,
    objective: str,
    forced: "dict[int, _Forced]",
):
    """One reference replay with a forced prefix; returns the
    ``ScheduleResult`` (placements keyed by chunk position)."""
    copies = [(t, dataclasses.replace(w)) for t, w in chunk]
    wid = {id(w): i for i, (_, w) in enumerate(copies)}
    state = ClusterState.empty(list(servers), [np.array(d) for d in D], alpha)
    calls: dict[int, int] = {}
    sched_box: list[OnlineScheduler] = []

    def place(st: ClusterState, w) -> "int | None":
        idx = wid[id(w)]
        calls[idx] = calls.get(idx, 0) + 1
        f = forced.get(idx)
        if f is None:
            return greedy_place(st, w, objective=objective)
        if f.server is not None:  # forced arrival-time placement
            st.assignments[f.server].append(w)
            return f.server
        # forced queue-at-arrival
        if calls[idx] == 1:
            return None
        if f.commit_server is None:
            # the commit row is past the forced prefix: free greedy retries
            return greedy_place(st, w, objective=objective)
        events = sched_box[0].events
        now = events[-1].time if events else 0.0
        if now + TIME_ATOL + TIME_RTOL * abs(f.commit_time) >= f.commit_time:
            st.assignments[f.commit_server].append(w)
            return f.commit_server
        return None  # the recorded commit is still in the future

    sched = OnlineScheduler(state, place=place)
    sched_box.append(sched)
    return sched.run(copies)


def attribute_segment(
    segment: int,
    rows: dict,
    chunk: Sequence[tuple[float, object]],
    servers,
    true_D,
    *,
    alpha=1.3,
    objective: str = "sum_avg",
    recorded_duration: "float | None" = None,
    cusum_gate: float = CUSUM_GATE,
) -> SegmentAttribution:
    """Attribute one segment's recorded decisions (``rows``: the ring's
    decoded columns already filtered to this segment, in ring order).

    ``chunk`` must be the segment's arrivals in *trace order* (time-sorted,
    requeued work first -- the order recorded ``arrival`` ids index) on the
    chunk-relative clock, and ``true_D`` the true profiled D per server.
    """
    t0 = chunk[0][0] if len(chunk) else 0.0
    chunk = [(t - t0, w) for t, w in chunk]
    p = len(rows["arrival"])

    # build the forced-decision table for each prefix length incrementally
    prefixes: list[dict[int, _Forced]] = [dict()]
    acc: dict[int, _Forced] = {}
    for j in range(p):
        a = int(rows["arrival"][j])
        kind = int(rows["kind"][j])
        f = dataclasses.replace(acc.get(a, _Forced()))
        if kind == KIND_ARRIVE:
            f.server = int(rows["server"][j])
        elif kind == KIND_QUEUED:
            f.queued = True
        else:  # KIND_DRAIN
            f.commit_server = int(rows["server"][j])
            f.commit_time = float(rows["time"][j])
        acc = dict(acc)
        acc[a] = f
        prefixes.append(acc)

    durations: list[float] = []
    results = []
    for forced in prefixes:
        res = _replay(chunk, servers, true_D, alpha, objective, forced)
        results.append(res)
        durations.append(float(res.makespan))

    decisions = []
    for j in range(p):
        a = int(rows["arrival"][j])
        kind = int(rows["kind"][j])
        rec_server = int(rows["server"][j])
        prev = results[j]  # R_{j-1}: decision j is the first unforced one
        shadow = prev.placements.get(a)
        shadow_queued = a in _queued_positions(prev, chunk)
        delta = durations[j + 1] - durations[j]

        if kind == KIND_ARRIVE:
            divergent = shadow_queued or shadow != rec_server
            same_server = (not shadow_queued) and shadow == rec_server
        elif kind == KIND_QUEUED:
            divergent = not shadow_queued
            same_server = False
        else:  # KIND_DRAIN
            divergent = shadow != rec_server
            same_server = shadow == rec_server
        if not divergent and kind != KIND_DRAIN:
            bucket = "aligned"
        elif not divergent and kind == KIND_DRAIN:
            bucket = "aligned" if abs(delta) < 1e-9 else "queueing"
        elif same_server or kind == KIND_QUEUED:
            bucket = "queueing"
        elif float(rows["cusum"][j]) >= cusum_gate:
            bucket = "detection"
        else:
            bucket = "estimation"
        decisions.append(DecisionAttribution(
            row=int(rows.get("row", np.arange(p))[j]), segment=segment,
            arrival=a, kind=kind, server=rec_server,
            shadow_server=None if shadow is None else int(shadow),
            delta=delta, bucket=bucket,
            time=float(rows["time"][j]), margin=float(rows["margin"][j]),
            headroom=float(rows["headroom"][j]),
            cusum=float(rows["cusum"][j]),
            n_pair_min=float(rows["n_pair_min"][j])))

    forced_dur = durations[-1]
    return SegmentAttribution(
        segment=segment,
        duration_oracle=durations[0],
        duration_forced=forced_dur,
        regret=forced_dur - durations[0],
        decisions=tuple(decisions),
        replay_gap=(None if recorded_duration is None
                    else recorded_duration - forced_dur))


def _queued_positions(result, chunk) -> set:
    """Chunk positions whose workload hit the queue in a replay (matched by
    arrival order: 'arrive' events fire in chunk order, and a 'queue' event
    immediately follows its arrival)."""
    queued: set[int] = set()
    order = iter(range(len(chunk)))
    pos = -1
    for ev in result.events:
        if ev.kind == "arrive":
            pos = next(order)
        elif ev.kind == "queue":
            queued.add(pos)
    return queued


def attribute_run(
    ring: DecisionRing,
    chunks: Sequence[Sequence[tuple[float, object]]],
    specs_of: Callable[[int], Sequence],
    true_D_of: Callable[[int], Sequence],
    *,
    alpha=1.3,
    objective: str = "sum_avg",
    durations: "Sequence[float] | None" = None,
    cusum_gate: float = CUSUM_GATE,
) -> list[SegmentAttribution]:
    """Attribute every segment surviving in the ring.

    ``chunks[k]`` is segment k's arrivals in trace order; ``specs_of(k)`` /
    ``true_D_of(k)`` the true server specs and profiled D for that segment
    (drift-aware callers resolve per segment). Segments whose rows were
    overwritten by ring wrap-around are skipped -- the flight recorder
    keeps the newest decisions.
    """
    cols = ring.columns()
    cols = dict(cols, row=np.arange(len(cols["arrival"])))
    out = []
    for k, chunk in enumerate(chunks):
        sel = cols["segment"] == k
        if not sel.any():
            continue
        rows = {name: v[sel] for name, v in cols.items()}
        # a wrapped ring may have lost this segment's head: decisions can
        # only be replayed from a complete prefix
        if int(rows["arrival"].min()) != 0 or len(chunk) == 0:
            continue
        out.append(attribute_segment(
            k, rows, chunk, specs_of(k), true_D_of(k), alpha=alpha,
            objective=objective,
            recorded_duration=(None if durations is None else
                               float(durations[k])),
            cusum_gate=cusum_gate))
    return out


# --- rendering -------------------------------------------------------------

def _fmt(v: float) -> str:
    if not np.isfinite(v):
        return "inf" if v > 0 else "-inf"
    if v == 0:
        return "0"
    if abs(v) >= 1e5 or abs(v) < 1e-3:
        return f"{v:.3g}"
    return f"{v:.4g}"


_KIND_NAME = {KIND_ARRIVE: "place", KIND_DRAIN: "drain", KIND_QUEUED: "queue"}


def render_timeline(atts: Sequence[SegmentAttribution]) -> str:
    """The per-decision timeline: one line per recorded decision."""
    lines = [
        "  seg  row    t(rel)  kind   arr  srv  shadow     margin   headroom"
        "    cusum      delta  bucket"]
    for att in atts:
        for d in att.decisions:
            shadow = "-" if d.shadow_server is None else str(d.shadow_server)
            lines.append(
                f"  {d.segment:>3}  {d.row:>3} {_fmt(d.time):>9}  "
                f"{_KIND_NAME.get(d.kind, '?'):<5} {d.arrival:>4} "
                f"{d.server:>4}  {shadow:>6} {_fmt(d.margin):>10} "
                f"{_fmt(d.headroom):>10} {_fmt(d.cusum):>8} "
                f"{d.delta:>10.4g}  {d.bucket}")
    return "\n".join(lines)


def render_attribution(atts: Sequence[SegmentAttribution]) -> str:
    """The per-segment attribution table: regret split by bucket, with the
    telescoping identity made visible."""
    buckets = ("estimation", "queueing", "detection", "aligned")
    head = ("  seg   oracle(s)   forced(s)   regret(s) "
            + " ".join(f"{b:>12}" for b in buckets) + "   sum-check")
    lines = [head]
    for att in atts:
        by = att.by_bucket
        total = sum(d.delta for d in att.decisions)
        lines.append(
            f"  {att.segment:>3} {att.duration_oracle:>11.5g} "
            f"{att.duration_forced:>11.5g} {att.regret:>11.4g} "
            + " ".join(f"{by.get(b, 0.0):>12.4g}" for b in buckets)
            + f" {abs(total - att.regret):>11.2g}")
    return "\n".join(lines)


def check_reconstruction(ring: DecisionRing, placements) -> "list[str]":
    """Verify the ring reconstructs every placement of the run it recorded.

    ``placements``: per segment, the run's own arrival -> server outcome
    list (``EngineResult.placements``; None = never placed). Every placed
    arrival must have exactly one commit row (arrive or drain) naming the
    same server, and never-placed arrivals must have no commit row.
    Returns human-readable failures (empty = ring is a faithful record).
    """
    cols = ring.columns()
    failures = []
    for k, segp in enumerate(placements):
        sel = cols["segment"] == k
        commits: dict[int, list[int]] = {}
        for j in np.flatnonzero(sel):
            if int(cols["kind"][j]) == KIND_QUEUED:
                continue
            commits.setdefault(int(cols["arrival"][j]), []).append(
                int(cols["server"][j]))
        for a, s in enumerate(segp):
            got = commits.get(a, [])
            if s is None:
                if got:
                    failures.append(
                        f"segment {k} arrival {a}: ring has commit rows "
                        f"{got} but the run never placed it")
            elif got != [int(s)]:
                failures.append(
                    f"segment {k} arrival {a}: run placed on {s}, ring "
                    f"says {got or 'nothing'}")
    return failures


def check_exactness(atts: Sequence[SegmentAttribution],
                    tol: float = 1e-5) -> "list[str]":
    """The acceptance gate: per-decision deltas sum to the segment regret
    within ``tol``. Returns human-readable failures (empty = pass)."""
    failures = []
    for att in atts:
        total = sum(d.delta for d in att.decisions)
        if abs(total - att.regret) > tol:
            failures.append(
                f"segment {att.segment}: sum(deltas) {total:.8g} != regret "
                f"{att.regret:.8g} (|err| {abs(total - att.regret):.3g})")
    return failures
