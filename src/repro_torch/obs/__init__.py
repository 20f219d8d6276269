"""repro_torch.obs: the observability plane (counterpart of ``repro.obs``).

Three layers, hot to cold:

``metrics``   fixed-shape metric state (:class:`MetricFrame`) that the event
              loop updates in place inside its blocks of micro-events --
              counters, high-water gauges, log-spaced streaming histograms,
              a per-server block -- with ``count/observe/merge`` ops and
              host-side percentile extraction. Enabled per run by a
              ``metrics=`` flag on the engines; off, the loop runs exactly
              the operations it runs without the plane.
``trace``     host-side structured spans around the phases that *surround*
              the device loop (pack/dispatch/epilogue), emitted both as
              ``torch.profiler.record_function`` ranges and as an optional
              JSONL span+snapshot log stamped with the git commit.
``report``    renders a run report (counter/gauge/percentile tables,
              per-server utilization-floor violations, fleet health-event
              timeline) from an ``EngineResult``/``AdaptiveResult``.

Two colder layers ride on the same mechanism:

``recorder``  the decision flight recorder: a fixed-capacity ring of packed
              per-placement provenance rows (chosen server, top-k candidate
              scores, tie margin, Eqn-4 headroom, queue depth, pair-
              confidence exposure, CUSUM level, pool row) written inside the
              event loop behind a ``record=`` flag -- recorder-on runs stay
              decision-identical.
``explain``   host-side regret attribution over an exported ring: forced
              true-dynamics replays decompose each recorded decision's
              makespan contribution into estimation error / queueing delay /
              detection lag, telescoping exactly to the total regret.

``python -m repro_torch.obs --selfcheck`` exercises the histogram math, the
report path, and the recorder/attribution plane end to end;
``python -m repro_torch.obs --explain`` renders a recorded run's
per-decision timeline and attribution table. Both take ``--device``.
"""
from .metrics import (
    COUNTERS,
    GAUGES,
    HIST_BINS,
    HISTOGRAMS,
    PER_SERVER,
    HistSpec,
    MetricFrame,
    add_server,
    count,
    counter_value,
    gauge_max,
    gauge_set,
    gauge_value,
    hist_counts,
    merge,
    observe,
    percentiles,
    snapshot,
    zeros,
)
from .recorder import KIND_ARRIVE, KIND_DRAIN, KIND_QUEUED, REC_TOPK, DecisionRing, RecCtx, RecState
from .trace import SpanLog, disable_tracing, enable_tracing, span

__all__ = [
    "COUNTERS",
    "GAUGES",
    "HIST_BINS",
    "HISTOGRAMS",
    "KIND_ARRIVE",
    "KIND_DRAIN",
    "KIND_QUEUED",
    "PER_SERVER",
    "REC_TOPK",
    "DecisionRing",
    "HistSpec",
    "MetricFrame",
    "RecCtx",
    "RecState",
    "SpanLog",
    "add_server",
    "count",
    "counter_value",
    "disable_tracing",
    "enable_tracing",
    "gauge_max",
    "gauge_set",
    "gauge_value",
    "hist_counts",
    "merge",
    "observe",
    "percentiles",
    "snapshot",
    "span",
    "zeros",
]
