"""Run reports over the metrics plane: tables, timelines, flat records.

Copied from ``repro/obs/report.py`` onto the port's ``obs.metrics``.
Renders an ``EngineResult`` / ``AdaptiveResult`` (run with ``metrics=True``)
into the fixed-width text report ``python -m repro_torch.obs`` prints: counter and
gauge tables, p50/p95/p99 percentile tables for every histogram, per-server
placement/finish/floor-violation columns, and -- for adaptive runs with a
fleet controller -- the health-event timeline from ``result.health``.
:func:`snapshot_records` flattens a frame into the ``(name, value, unit)``
rows a benchmark harness stamps into its records.
"""
from __future__ import annotations

import numpy as np

from . import metrics as M


def _fmt(v: float) -> str:
    if np.isnan(v):
        return "nan"
    if np.isinf(v):
        return "inf" if v > 0 else "-inf"
    if v == 0:
        return "0"
    if abs(v) >= 1e5 or abs(v) < 1e-3:
        return f"{v:.3g}"
    return f"{v:.4g}"


def counter_table(frame: M.MetricFrame) -> str:
    rows = [(n, M.counter_value(frame, n)) for n in M.COUNTERS]
    width = max(len(n) for n, _ in rows)
    return "\n".join(f"  {n:<{width}}  {v:>10d}" for n, v in rows)


def gauge_table(frame: M.MetricFrame) -> str:
    rows = [(n, M.gauge_value(frame, n)) for n in M.GAUGES]
    width = max(len(n) for n, _ in rows)
    return "\n".join(f"  {n:<{width}}  {_fmt(v):>10}" for n, v in rows)


def percentile_table(frame: M.MetricFrame,
                     names: "tuple[str, ...] | None" = None) -> str:
    """count / p50 / p95 / p99 per histogram (all of them by default)."""
    names = tuple(names) if names is not None else tuple(
        s.name for s in M.HISTOGRAMS)
    width = max(len(n) for n in names)
    lines = [f"  {'':<{width}}  {'count':>9} {'p50':>10} {'p95':>10} {'p99':>10}"]
    for n in names:
        total = float(M.hist_counts(frame, n).sum())
        p50, p95, p99 = M.percentiles(frame, n)
        lines.append(
            f"  {n:<{width}}  {total:>9.0f} {_fmt(p50):>10} {_fmt(p95):>10} "
            f"{_fmt(p99):>10}")
    return "\n".join(lines)


#: fleets up to this size render one row per server; past it the table
#: switches to pod rollups + the top-k busiest rows (a 10k-server fleet
#: would otherwise print 10k lines nobody reads)
FULL_TABLE_MAX = 64


def _server_rows(cols, servers) -> list:
    lines = []
    for s in servers:
        flag = "!" if cols["floor_violations"][s] > 0 else " "
        lines.append(f"  {s:>5}{flag}  " + " ".join(
            f"{cols[n][s]:>16.0f}" for n in M.PER_SERVER))
    return lines


def per_server_table(frame: M.MetricFrame, top_k: int = 16,
                     pods: "int | None" = None) -> str:
    """Per-server placement/finish/violation columns; '!' flags servers that
    violated the paper's utilization floor.

    Fleets up to ``FULL_TABLE_MAX`` servers get the classic one-row-per-
    server table. Larger fleets get pod rollups (sum per contiguous pod,
    with the pod count taken from ``pods`` or defaulted to ~32 servers per
    pod) followed by the ``top_k`` busiest servers by placements -- the rows
    an operator actually scans for hot spots.
    """
    cols = {n: M.server_values(frame, n) for n in M.PER_SERVER}
    header = ["  server  " + " ".join(f"{n:>16}" for n in M.PER_SERVER)]
    m = frame.m
    if m <= FULL_TABLE_MAX:
        return "\n".join(header + _server_rows(cols, range(m)))

    if pods is None or pods <= 1 or m % pods:
        pods = max(1, m // 32)
        while m % pods:
            pods -= 1
    S = m // pods
    lines = [f"  pod rollups ({pods} pods x {S} servers):"]
    lines += ["  pod     " + " ".join(f"{n:>16}" for n in M.PER_SERVER)]
    for p in range(pods):
        sums = {n: float(cols[n][p * S:(p + 1) * S].sum())
                for n in M.PER_SERVER}
        flag = "!" if sums["floor_violations"] > 0 else " "
        lines.append(f"  {p:>5}{flag}  " + " ".join(
            f"{sums[n]:>16.0f}" for n in M.PER_SERVER))
    busy = np.argsort(-np.asarray(cols["placements"]),
                      kind="stable")[:min(top_k, m)]
    lines += ["", f"  top {len(busy)} busiest servers (by placements):"]
    lines += header
    lines += _server_rows(cols, (int(s) for s in busy))
    return "\n".join(lines)


def health_timeline(health) -> str:
    """Flatten AdaptiveResult.health into one line per fired event."""
    lines = []
    for k, events in enumerate(health):
        for ev in events:
            lines.append(
                f"  segment {k:>3}  {ev.kind:<6} server {ev.server:>4}  "
                f"stat {_fmt(float(ev.stat)):>8}  {ev.detail}")
    return "\n".join(lines) if lines else "  (no health events)"


def phase_tree(log) -> str:
    """Render a ``trace.SpanLog`` as an indented host-phase tree: children
    nest under the span that was open when they started, in open order."""
    spans = sorted(log.spans, key=lambda s: s.id)
    if not spans:
        return "  (no spans)"
    by_id = {s.id: s for s in spans}
    children: dict = {}
    roots = []
    for s in spans:
        if s.parent is None or s.parent not in by_id:
            roots.append(s)
        else:
            children.setdefault(s.parent, []).append(s)
    width = max(2 * s.depth + len(s.name) for s in spans)
    lines = []

    def walk(s, indent):
        label = "  " * indent + s.name
        attrs = " ".join(f"{k}={v}" for k, v in s.attrs.items())
        lines.append(f"  {label:<{width}}  {s.duration_s * 1e3:>10.3f} ms"
                     + (f"  {attrs}" if attrs else ""))
        for c in children.get(s.id, ()):
            walk(c, indent + 1)

    for r in roots:
        walk(r, 0)
    return "\n".join(lines)


def worst_decisions_table(attributions, k: int = 10) -> str:
    """The k costliest recorded decisions by attributed makespan delta
    (``obs.explain`` output): the rows an operator triages first."""
    decs = sorted((d for att in attributions for d in att.decisions),
                  key=lambda d: -d.delta)[:k]
    if not decs:
        return "  (no recorded decisions)"
    lines = ["  seg  arr  kind   srv  shadow   delta(s)  bucket     "
             "    margin   headroom    cusum"]
    kind_name = {0: "place", 1: "drain", 2: "queue"}
    for d in decs:
        shadow = "-" if d.shadow_server is None else str(d.shadow_server)
        lines.append(
            f"  {d.segment:>3} {d.arrival:>4}  {kind_name.get(d.kind, '?'):<5}"
            f" {d.server:>4}  {shadow:>6} {d.delta:>10.4g}  {d.bucket:<10}"
            f" {_fmt(d.margin):>9} {_fmt(d.headroom):>10} {_fmt(d.cusum):>8}")
    return "\n".join(lines)


def render_report(result=None, frame: "M.MetricFrame | None" = None,
                  title: str = "run report", attribution=None,
                  spans=None) -> str:
    """The full text report. ``result`` may be an ``EngineResult`` or an
    ``AdaptiveResult`` (its ``metrics`` supplies the frame unless ``frame``
    is given explicitly); a bare frame renders without the run header.
    ``attribution`` (a list of ``obs.explain.SegmentAttribution``) appends
    the worst-decisions section; ``spans`` (a ``trace.SpanLog``, defaulting
    to the active one when tracing is enabled) appends the host-phase
    tree."""
    if frame is None:
        frame = getattr(result, "metrics", None)
    if frame is None:
        raise ValueError(
            "no MetricFrame to report: run the engine with metrics=True")
    lines = [f"== {title} ==", ""]
    if result is not None and hasattr(result, "segments"):  # AdaptiveResult
        durs = result.durations
        lines += [
            f"segments: {len(result.segments)}   "
            f"observations: {result.total_obs}   "
            f"total segment time: {_fmt(float(np.sum(durs)))} s", ""]
    elif result is not None and hasattr(result, "makespan"):  # EngineResult
        lines += [
            f"arrivals: {len(result.placements)}   backend: {result.backend}  "
            f" makespan: {_fmt(result.makespan)} s   max degradation: "
            f"{_fmt(result.max_observed_degradation)}", ""]
    lines += ["counters:", counter_table(frame), ""]
    lines += ["gauges (high-water):", gauge_table(frame), ""]
    lines += ["percentiles:", percentile_table(frame), ""]
    lines += ["per-server:", per_server_table(frame)]
    health = getattr(result, "health", None)
    if health:
        lines += ["", "health-event timeline:", health_timeline(health)]
    if attribution is not None:
        lines += ["", "worst 10 decisions (by attributed regret):",
                  worst_decisions_table(attribution)]
    if spans is None:
        from . import trace
        spans = trace.active_log()
    if spans is not None and spans.spans:
        lines += ["", "host phases:", phase_tree(spans)]
    return "\n".join(lines)


def snapshot_records(frame: M.MetricFrame, prefix: str = "obs"):
    """Flatten a frame into (name, value, unit) rows for benchmark records.

    Counters all land; histograms contribute count/p50/p99 when non-empty.
    Every gauge lands with an explicit ``_set`` companion (1 = recorded at
    least once): a peak of 0 is a legitimate reading (requeue_peak on a run
    with no evictions), so presence in the record set must not encode
    set-ness -- ``--compare`` needs the set stable across runs.
    """
    records = []
    for n in M.COUNTERS:
        records.append((f"{prefix}/counter_{n}", float(M.counter_value(frame, n)),
                        "count"))
    for n in M.GAUGES:
        records.append((f"{prefix}/gauge_{n}", float(M.gauge_value(frame, n)),
                        "peak"))
        records.append((f"{prefix}/gauge_{n}_set",
                        1.0 if M.gauge_set(frame, n) else 0.0, "bool"))
    for spec in M.HISTOGRAMS:
        total = float(M.hist_counts(frame, spec.name).sum())
        if total <= 0:
            continue
        p50, _, p99 = M.percentiles(frame, spec.name)
        records.append((f"{prefix}/{spec.name}_count", total, "count"))
        records.append((f"{prefix}/{spec.name}_p50", float(p50), spec.desc or "value"))
        records.append((f"{prefix}/{spec.name}_p99", float(p99), spec.desc or "value"))
    return records
