"""Host-side structured spans around the device-resident programs.

Counterpart of ``repro/obs/trace.py``. The hot path runs on the card with
one host read per block of micro-events; what *is* host-visible, and what
dominates interactive latency, are the phases around it: packing segment
buffers, the dispatch (graph capture on a cold engine, replays on a warm
one), and the epilogue that adopts device outcomes back into host
bookkeeping. :func:`span` wraps those phases with

  * ``torch.profiler.record_function`` -- so ``torch.profiler`` traces are
    navigable by phase name, and
  * an optional JSONL log (:class:`SpanLog`) of ``{"kind": "span", ...}``
    rows stamped with wall-clock times and the git commit, plus
    ``{"kind": "snapshot", ...}`` rows for MetricFrame snapshots.

Tracing is off by default; :func:`span` then degrades to a bare profiler
annotation. Enable with ``enable_tracing(path)``; rows append eagerly so a
crashed run keeps its prefix.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import subprocess
import time

from torch.profiler import record_function


def _git_commit() -> str:
    try:
        root = pathlib.Path(__file__).resolve().parents[3]
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


_COMMIT: "str | None" = None


def commit_stamp() -> str:
    global _COMMIT
    if _COMMIT is None:
        _COMMIT = _git_commit()
    return _COMMIT


@dataclasses.dataclass
class Span:
    name: str
    t_start: float
    duration_s: float
    attrs: dict
    #: stable per-log id, assigned at span *open* so parents number before
    #: their children even though children close (and append) first
    id: int = 0
    #: id of the enclosing open span, None for top-level phases
    parent: "int | None" = None
    #: nesting depth (0 = top level)
    depth: int = 0


class SpanLog:
    """Collects spans and metric snapshots; optionally appends JSONL rows.

    Nested :meth:`span` calls are linked: each span records the ``id`` of
    the span that was open when it started (``parent``) and its nesting
    ``depth``, so nested phases render as a tree
    (:func:`repro_torch.obs.report.phase_tree`).
    """

    def __init__(self, path: "str | pathlib.Path | None" = None):
        self.path = pathlib.Path(path) if path is not None else None
        self.spans: "list[Span]" = []
        self._t0 = time.time()
        self._next_id = 0
        self._open: "list[int]" = []  # ids of currently open spans

    def _write(self, row: dict) -> None:
        if self.path is None:
            return
        row = dict(row, commit=commit_stamp())
        with self.path.open("a") as fh:
            fh.write(json.dumps(row) + "\n")

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sid = self._next_id
        self._next_id += 1
        parent = self._open[-1] if self._open else None
        depth = len(self._open)
        self._open.append(sid)
        t0 = time.time()
        p0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            self._open.pop()
        dt = time.perf_counter() - p0
        self.spans.append(Span(name, t0, dt, attrs, id=sid, parent=parent, depth=depth))
        self._write({"kind": "span", "name": name, "t_start": t0,
                     "duration_s": dt, "attrs": attrs, "id": sid,
                     "parent": parent, "depth": depth})

    def snapshot(self, name: str, payload: dict) -> None:
        """Record a point-in-time payload (e.g. ``metrics.snapshot(frame)``)."""
        self._write({"kind": "snapshot", "name": name, "t": time.time(),
                     "payload": payload})

    def durations(self) -> "dict[str, float]":
        """Total seconds per span name."""
        out: dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out


_ACTIVE: "SpanLog | None" = None


def enable_tracing(path: "str | pathlib.Path | None" = None) -> SpanLog:
    """Install a process-wide SpanLog (optionally JSONL-backed)."""
    global _ACTIVE
    _ACTIVE = SpanLog(path)
    return _ACTIVE


def disable_tracing() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_log() -> "SpanLog | None":
    """The installed SpanLog, if tracing is enabled."""
    return _ACTIVE


@contextlib.contextmanager
def span(name: str, **attrs):
    """Annotate a host-side phase; logs to the active SpanLog if any."""
    if _ACTIVE is not None:
        with _ACTIVE.span(name, **attrs):
            yield
    else:
        with record_function(name):
            yield
