"""Operator-level purity audit of the registered hot entries.

Counterpart of the JAX package's jaxpr walk (``repro/analysis/
jaxpr_audit.py``). The port has no jaxpr to lower, so the audit runs one
eager call of each registered entry (``registry.REGISTRY``) under a
``TorchDispatchMode`` that sees every aten operation the call dispatches,
with its outputs, and checks the entry's tier:

  host-callback   a host read: ``aten._local_scalar_dense`` (``.item()``,
                  ``bool()``, ``int()`` or ``float()`` of a tensor), a copy of
                  a card tensor to the CPU, or ``Tensor.tolist`` /
                  ``Tensor.numpy`` (which never reach the dispatcher, so the
                  walk wraps them). Each is a device round trip in a path
                  that promises none.
  dynamic-shape   an operation whose output shape depends on the data:
                  ``nonzero``, ``masked_select``, ``unique*``, indexing by a
                  boolean mask, ``repeat_interleave`` without
                  ``output_size``. Each also breaks CUDA-graph capture.
  float64-leak    a float64 output on a ``device`` tier entry.

On the card the same call runs again under ``torch.cuda.set_sync_debug_mode
("error")`` (``host-sync``): the mode raises at any synchronizing call,
which includes copies from host memory that the dispatcher shows as plain
copies. The walk always runs eagerly, never inside a graph capture.
"""
from __future__ import annotations

import collections
import contextlib
import pathlib
import time
import traceback
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import Finding
from .registry import REGISTRY, TIER_RELAXATIONS, BuildCtx, HotEntry, shapes_for

_aten = torch.ops.aten
#: operations that read a tensor's value back to the host
HOST_READS = frozenset({_aten._local_scalar_dense})
#: operations whose output shape depends on the data
DYNAMIC_SHAPE = frozenset({_aten.nonzero, _aten.masked_select, _aten.unique_consecutive, _aten.unique_dim,
                           _aten._unique, _aten._unique2, _aten.argwhere})
_INDEXING = frozenset({_aten.index, _aten.index_put, _aten.index_put_, _aten._index_put_impl_})
_SRC_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _site() -> str:
    """The innermost frame of the port's own code outside this package:
    where the offending call was made (``file:line``)."""
    for frame in reversed(traceback.extract_stack()):
        path = pathlib.Path(frame.filename)
        try:
            rel = path.resolve().relative_to(_SRC_ROOT)
        except ValueError:
            continue
        if rel.parts[0] != "analysis":
            return f"{rel}:{frame.lineno}"
    return "?"


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


class OpRecorder(TorchDispatchMode):
    """Records every aten operation of a call and the rule each breaks.

    ``ops`` counts operations by name; ``hits`` lists (rule, detail) in the
    order they happened. Nothing is refused: the call runs on, so one walk
    reports every offending site."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.hits: list[tuple[str, str]] = []

    def note(self, rule: str, what: str) -> None:
        self.hits.append((rule, f"{what} at {_site()}"))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        self.ops[str(packet.__name__)] += 1
        if packet in HOST_READS:
            self.note("host-callback", f"host read `{func}`")
        elif packet in DYNAMIC_SHAPE:
            self.note("dynamic-shape", f"data-dependent shape `{func}`")
        elif packet in _INDEXING and any(
                t.dtype in (torch.bool, torch.uint8) for t in _tensors(args[1])):
            self.note("dynamic-shape", f"boolean-mask index `{func}`")
        elif packet is _aten.repeat_interleave and kwargs.get("output_size") is None and not (
                len(args) > 3 and args[3] is not None):
            self.note("dynamic-shape", f"`{func}` without output_size")
        elif packet in (_aten._to_copy, _aten.copy_):
            src = args[1] if packet is _aten.copy_ else args[0]
            dst = args[0] if packet is _aten.copy_ else out
            if (isinstance(src, torch.Tensor) and src.device.type == "cuda"
                    and isinstance(dst, torch.Tensor) and dst.device.type == "cpu"):
                self.note("host-callback", f"copy to the CPU `{func}`")
        for t in _tensors(out):
            if t.dtype in (torch.float64, torch.complex128):
                self.note("float64-leak", f"{t.dtype} output of `{func}`")
                break
        return out


@contextlib.contextmanager
def recording() -> Iterator[OpRecorder]:
    """An :class:`OpRecorder` active around the block, with ``Tensor.tolist``
    and ``Tensor.numpy`` (which never reach the dispatcher) wrapped to
    record a host read too."""
    rec = OpRecorder()
    saved = {name: getattr(torch.Tensor, name) for name in ("tolist", "numpy")}

    def wrap(name, fn):
        def read(self, *args, **kwargs):
            rec.note("host-callback", f"host read `Tensor.{name}`")
            return fn(self, *args, **kwargs)
        return read

    for name, fn in saved.items():
        setattr(torch.Tensor, name, wrap(name, fn))
    try:
        with rec:
            yield rec
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def host_sync_error(fn, args: tuple) -> str | None:
    """Run ``fn(*args)`` under the sync debug mode "error" (on the card):
    the first synchronizing call's message, or None. The mode is reset in a
    ``finally``, whatever the call does."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*args)
    except RuntimeError as err:
        return str(err).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return None


def audit_entry(entry: HotEntry, ctx: BuildCtx) -> tuple[list[Finding], dict]:
    """The dispatch walk of one entry at one shape (and, on the card, its
    host-sync run): (findings, info)."""
    relaxed = TIER_RELAXATIONS[entry.tier]
    start = time.perf_counter()
    fn, args = entry.build(ctx)
    built = time.perf_counter()
    with recording() as rec:
        fn(*args)
    # one finding per rule: its first sites, and how many operations broke it
    by_rule: dict[str, list[str]] = {}
    for rule, detail in rec.hits:
        if rule not in relaxed:
            by_rule.setdefault(rule, []).append(detail)
    findings = []
    for rule, details in by_rule.items():
        sites = list(dict.fromkeys(details))
        more = f"; {len(details) - 3} more" if len(details) > 3 else ""
        findings.append(Finding("dispatch", rule, entry.name,
                                f"{'; '.join(sites[:3])}{more} ({ctx.shape.label})"))
    info = {"ops": sum(rec.ops.values()), "distinct_ops": len(rec.ops),
            "build_s": round(built - start, 3)}
    if ctx.device.type == "cuda":
        # the walk's call warmed it up (library loads, allocator blocks,
        # cuBLAS handles); a second call on the same inputs is what a step
        # of the hot loop is
        err = host_sync_error(fn, args)
        info["host_sync"] = err is None
        if err is not None and "host-sync" not in relaxed:
            findings.append(Finding("sync", "host-sync", entry.name,
                                    f"{err} ({ctx.shape.label})"))
    info["s"] = round(time.perf_counter() - start, 3)
    return findings, info


@contextlib.contextmanager
def one_rank_axis(device: torch.device):
    """A factory of the audit's one-rank ``ServerAxis`` (NCCL on the card,
    gloo on the CPU, over an in-process store), made on first use; a group
    made here is destroyed on exit."""
    import torch.distributed as dist

    from ..distributed.server_axis import ServerAxis

    made = []

    def factory():
        if not made:
            fresh = not dist.is_initialized()
            made.append((ServerAxis.over_process_group(device=device), fresh))
        return made[0][0]

    try:
        yield factory
    finally:
        if made and made[0][1] and dist.is_initialized():
            dist.destroy_process_group()


def run_dispatch_audit(device: torch.device, stats: "dict | None" = None) -> list[Finding]:
    """Walk every registered entry at each of the device's shapes."""
    findings: list[Finding] = []
    entry_stats: dict[str, dict] = {}
    with torch.no_grad(), one_rank_axis(device) as axis:
        for entry in REGISTRY:
            per_shape = {}
            shapes = shapes_for(device)
            for shape in shapes[:1] if entry.unscaled else shapes:
                fs, info = audit_entry(entry, BuildCtx(device, shape, axis))
                # a rule broken at several shapes is one finding (the first)
                have = {f.key() for f in findings}
                findings += [f for f in fs if f.key() not in have]
                per_shape[shape.label] = info
            entry_stats[entry.name] = {"tier": entry.tier, "kernel": entry.kernel,
                                       "shapes": per_shape}
    if stats is not None:
        stats["dispatch"] = entry_stats
    return findings
