"""Source lint of the registered hot bodies: host habits that break the loop.

Counterpart of ``repro/analysis/ast_rules.py``. The dispatch walk proves
what one call of each entry does on its inputs; this pass reads the source
of every function a registered entry names (``HotEntry.bodies``: the event
loop's block and every ``_TraceLoop`` method it calls, the fused segment
body, the estimator, detector, controller, ring and recorder steps, the
kernel wrappers), so a branch the walk's inputs never took is read too:

  host-item        ``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()`` or
                   ``.to("cpu")`` on a tensor: a device round trip per call.
  host-coercion    ``float()`` / ``int()`` / ``bool()`` / ``complex()`` of a
                   tensor expression: the same round trip, implicitly.
  np-on-traced     a ``np.*`` call fed a tensor: numpy reads it to the host.
  traced-branch    Python ``if`` / ``while`` / ``assert`` or a conditional
                   expression on a tensor: a host read, and a branch a
                   captured graph freezes (``torch.where`` is the device
                   form).
  stale-ring-view  reading a name bound from ``ObservationRing.view()`` after
                   a later ``push`` / ``push_trace`` on the same ring. The
                   case holds in the port: ``view`` returns the ring's own
                   tensors (``log.py``, ``ObservationRing.view``) and ``push``
                   writes them in place, so an earlier view silently shows
                   the newer rows. It is checked in every function of the
                   package.
  kernel-uncovered a ``_build.load("<name>")`` site in
                   ``src/repro_torch/kernels/*.py``, or a ``csrc/*.cu``
                   source, that ``registry.KERNEL_COVERAGE`` does not name
                   (``pallas-uncovered`` in JAX): every kernel needs a
                   registered entry that launches it, so the dispatch walk
                   and the resource pass see it.

JAX's ``traced-iteration`` does not carry over: a Python ``for`` over a
tensor iterates its leading dimension, a host value, and reads no data.

Tensor-ness is tracked through assignment, as JAX's taint linter tracks
tracers: a body's positional parameters start as tensors, keyword-only ones
as host values (each entry's ``static`` and ``traced`` adjust that), and an
attribute of ``self`` is a tensor unless the entry names it among the
object's host attributes (``host_attrs``: sizes, flags, the axis). Shape
metadata is host data by construction: ``.shape``, ``.ndim``, ``.dtype``,
``.device``, ``.dim()``, ``.numel()``, ``len()`` and the port's own shape
properties (``.rows``, ``.capacity``, ``.m``, ``.T``) never taint, and an
``is`` / ``is not`` comparison reads no tensor.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import pathlib
import textwrap
from typing import Iterable

from . import Finding
from .registry import KERNEL_COVERAGE, REGISTRY

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
SRC_ROOT = REPO_ROOT / "src" / "repro_torch"
KERNELS_DIR = SRC_ROOT / "kernels"
CSRC_DIR = KERNELS_DIR / "csrc"

#: attributes that yield host metadata even on a tensor
SHAPE_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "rows", "capacity", "m", "T"})
#: methods and builtins that return host metadata of a tensor
SHAPE_CALLS = frozenset({"dim", "numel", "size", "stride", "element_size", "data_ptr",
                         "is_contiguous", "len", "isinstance", "is_tensor"})
HOST_READ_METHODS = frozenset({"item", "tolist", "numpy", "cpu"})
HOST_COERCIONS = frozenset({"float", "int", "bool", "complex"})


def _dotted(node) -> str:
    """'torch.cuda.current_stream' for nested Attribute chains ('' if not one)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@dataclasses.dataclass
class Body:
    """One function body the pass reads, and where its source lives."""

    qualname: str  # module:qualname
    fn: ast.FunctionDef
    rel: str  # repo-relative file
    first_line: int  # line of the def in the file
    static: frozenset[str]
    traced: frozenset[str]
    host_attrs: frozenset[str] = frozenset()


def resolve_body(spec: str, static=frozenset(), traced=frozenset(),
                 host_attrs=frozenset()) -> Body:
    """The parsed source of ``module:qualname`` (methods as ``Class.name``)."""
    mod_name, qual = spec.split(":")
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    obj = inspect.unwrap(obj)
    lines, first = inspect.getsourcelines(obj)
    tree = ast.parse(textwrap.dedent("".join(lines)))
    fn = tree.body[0]
    path = pathlib.Path(inspect.getsourcefile(obj)).resolve()
    try:
        rel = str(path.relative_to(REPO_ROOT))
    except ValueError:
        rel = str(path)
    return Body(spec, fn, rel, first, frozenset(static), frozenset(traced),
                frozenset(host_attrs))


class _TaintLinter(ast.NodeVisitor):
    """Walk one body, propagating tensor-ness and flagging host reads."""

    def __init__(self, body: Body):
        self.body = body
        a = body.fn.args
        positional = [p.arg for p in list(a.posonlyargs) + list(a.args)]
        self.tainted: set[str] = {p for p in positional if p != "self" and p not in body.static}
        self.tainted |= {p.arg for p in a.kwonlyargs if p.arg in body.traced}
        if a.vararg is not None:
            self.tainted.add(a.vararg.arg)
        self.findings: list[Finding] = []

    def _flag(self, rule: str, node, detail: str):
        line = self.body.first_line + node.lineno - 1
        self.findings.append(Finding(
            "ast", rule, f"{self.body.rel}:{line}", f"{detail} (in `{self.body.fn.name}`)"))

    # -- tensor-ness -------------------------------------------------------------
    def _is_tainted(self, node) -> bool:
        t = self._is_tainted
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in SHAPE_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr not in self.body.host_attrs
            return t(node.value)
        if isinstance(node, ast.Subscript):
            return t(node.value)
        if isinstance(node, ast.Call):
            name = _dotted(node.func).split(".")[-1]
            if name in SHAPE_CALLS:
                return False
            return (any(map(t, node.args)) or any(t(kw.value) for kw in node.keywords)
                    or t(node.func))
        if isinstance(node, ast.BinOp):
            return t(node.left) or t(node.right)
        if isinstance(node, ast.BoolOp):
            return any(map(t, node.values))
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False  # identity reads no tensor
            return t(node.left) or any(map(t, node.comparators))
        if isinstance(node, ast.UnaryOp):
            return t(node.operand)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(map(t, node.elts))
        if isinstance(node, ast.IfExp):
            return t(node.body) or t(node.orelse)
        if isinstance(node, ast.Starred):
            return t(node.value)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)):
            # the element, with each target bound to its iterable's tensor-ness
            saved = set(self.tainted)
            try:
                for gen in node.generators:
                    (self._taint_target if t(gen.iter) else self._untaint_target)(gen.target)
                elts = (node.key, node.value) if isinstance(node, ast.DictComp) else (node.elt,)
                return any(map(t, elts))
            finally:
                self.tainted = saved
        return False

    def _taint_target(self, target):
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._taint_target(el)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)

    def _untaint_target(self, target):
        if isinstance(target, ast.Name):
            self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._untaint_target(el)

    # -- statements ----------------------------------------------------------------
    def visit_Assign(self, node):
        self.visit(node.value)
        for tgt in node.targets:
            if self._is_tainted(node.value):
                self._taint_target(tgt)
            else:
                self._untaint_target(tgt)

    def visit_AugAssign(self, node):
        self.visit(node.value)
        if self._is_tainted(node.value):
            self._taint_target(node.target)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self.visit(node.value)
            if self._is_tainted(node.value):
                self._taint_target(node.target)

    def visit_For(self, node):
        # the loop variable of a tensor (or of a zip over tensors) is one
        if self._is_tainted(node.iter):
            self._taint_target(node.target)
        self.generic_visit(node)

    def visit_If(self, node):
        if self._is_tainted(node.test):
            self._flag("traced-branch", node, "Python `if` on a tensor -- use torch.where")
        self.generic_visit(node)

    def visit_While(self, node):
        if self._is_tainted(node.test):
            self._flag("traced-branch", node, "Python `while` on a tensor")
        self.generic_visit(node)

    def visit_Assert(self, node):
        if self._is_tainted(node.test):
            self._flag("traced-branch", node, "`assert` on a tensor reads it")
        self.generic_visit(node)

    def visit_IfExp(self, node):
        if self._is_tainted(node.test):
            self._flag("traced-branch", node, "conditional expression on a tensor")
        self.generic_visit(node)

    def visit_Call(self, node):
        callee = _dotted(node.func)
        root = callee.split(".")[0] if callee else ""
        args_tainted = any(map(self._is_tainted, node.args)) or any(
            self._is_tainted(kw.value) for kw in node.keywords)
        if root in ("np", "numpy") and args_tainted:
            self._flag("np-on-traced", node, f"`{callee}` on a tensor reads it to the host")
        if isinstance(node.func, ast.Attribute) and self._is_tainted(node.func.value):
            attr = node.func.attr
            to_cpu = attr == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu" for a in node.args)
            if attr in HOST_READ_METHODS or to_cpu:
                self._flag("host-item", node, f"`.{attr}()` on a tensor is a device round trip")
        if (isinstance(node.func, ast.Name) and node.func.id in HOST_COERCIONS
                and args_tainted):
            self._flag("host-coercion", node, f"`{node.func.id}()` of a tensor reads it")
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        if node is self.body.fn:
            self.generic_visit(node)
            return
        # a nested def keeps the enclosing names (closures); its own
        # positional parameters are tensors, as the body's are
        self.tainted.update(p.arg for p in node.args.args)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self.tainted.update(p.arg for p in node.args.args)
        self.generic_visit(node)

    def run(self) -> list[Finding]:
        self.visit(self.body.fn)
        return self.findings


def lint_body(body: Body) -> list[Finding]:
    return _TaintLinter(body).run()


def lint_source(src: str, static=frozenset(), traced=frozenset(), host_attrs=frozenset(),
                rel: str = "snippet.py") -> list[Finding]:
    """Every top-level function of ``src`` as a registered body (with
    ``static`` and ``traced`` as an entry declares them), and the ring-view
    rule over the whole snippet."""
    tree = ast.parse(textwrap.dedent(src))
    findings = []
    for fn in tree.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings += lint_body(Body(fn.name, fn, rel, 1, frozenset(static),
                                       frozenset(traced), frozenset(host_attrs)))
    ring = _RingViewLinter(rel)
    ring.visit(tree)
    return findings + ring.findings


# -- stale ring views --------------------------------------------------------------------

class _RingViewLinter(ast.NodeVisitor):
    """Flag reads of a ``.view()`` binding after a later push on the same
    ring. ``.view()`` with arguments is a tensor reshape, not a ring view."""

    def __init__(self, rel: str):
        self.rel = rel
        self.findings: list[Finding] = []

    def visit_FunctionDef(self, node):
        views: dict[str, str] = {}  # view var -> ring expression text
        poisoned: dict[str, int] = {}  # view var -> push lineno
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
                call = sub.value
                if (isinstance(call.func, ast.Attribute) and call.func.attr == "view"
                        and not call.args and not call.keywords and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Name)):
                    views[sub.targets[0].id] = _dotted(call.func.value)
            elif isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
                if sub.func.attr in ("push", "push_trace"):
                    ring = _dotted(sub.func.value)
                    for var, src in views.items():
                        if src == ring and var not in poisoned:
                            poisoned[var] = sub.lineno
            elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                if sub.id in poisoned and sub.lineno > poisoned[sub.id]:
                    self.findings.append(Finding(
                        "ast", "stale-ring-view", f"{self.rel}:{sub.lineno}",
                        f"`{sub.id}` (a ring view) read after the push at line "
                        f"{poisoned[sub.id]} overwrote the ring's rows"))
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def ring_view_findings(path: pathlib.Path, root: pathlib.Path = REPO_ROOT) -> list[Finding]:
    rel = str(path.relative_to(root))
    linter = _RingViewLinter(rel)
    linter.visit(ast.parse(path.read_text(), filename=rel))
    return linter.findings


# -- kernel coverage ------------------------------------------------------------------------

def kernel_coverage_findings(kernels_dir: pathlib.Path = KERNELS_DIR,
                             csrc_dir: pathlib.Path = CSRC_DIR,
                             coverage: "dict[str, str] | None" = None,
                             root: pathlib.Path = REPO_ROOT) -> tuple[list[Finding], int]:
    """Every ``_build.load("<name>")`` site and every ``csrc/*.cu`` source
    that ``coverage`` (source -> wrapper file) does not name; returns
    (findings, load sites seen)."""
    coverage = KERNEL_COVERAGE if coverage is None else coverage
    findings, sites = [], 0
    for path in sorted(kernels_dir.glob("*.py")):
        rel = str(path.relative_to(root))
        for node in ast.walk(ast.parse(path.read_text(), filename=rel)):
            if not (isinstance(node, ast.Call) and _dotted(node.func).endswith("_build.load")):
                continue
            sites += 1
            arg = node.args[0] if node.args else None
            name = arg.value if isinstance(arg, ast.Constant) else None
            if coverage.get(name) != rel:
                findings.append(Finding(
                    "ast", "kernel-uncovered", f"{rel}:{node.lineno}",
                    f"`_build.load({name!r})` outside registry.KERNEL_COVERAGE: register an "
                    "entry that launches it"))
    for src in sorted(csrc_dir.glob("*.cu")):
        if src.stem not in coverage:
            findings.append(Finding(
                "ast", "kernel-uncovered", str(src.relative_to(root)),
                "kernel source outside registry.KERNEL_COVERAGE: register an entry that "
                "launches it"))
    return findings, sites


# -- the pass ----------------------------------------------------------------------------------

def registered_bodies() -> Iterable[Body]:
    """Every body a registry entry names, once."""
    seen = set()
    for entry in REGISTRY:
        for spec in entry.bodies:
            if spec not in seen:
                seen.add(spec)
                yield resolve_body(spec, entry.static, entry.traced, entry.host_attrs)


def run_ast_rules(stats: "dict | None" = None) -> list[Finding]:
    findings: list[Finding] = []
    bodies = list(registered_bodies())
    for body in bodies:
        findings += lint_body(body)
    files = sorted(SRC_ROOT.rglob("*.py"))
    for path in files:
        findings += ring_view_findings(path)
    cover, sites = kernel_coverage_findings()
    findings += cover
    if stats is not None:
        stats["ast"] = {"bodies": len(bodies), "files": len(files), "kernel_loads": sites,
                        "kernel_sources": len(list(CSRC_DIR.glob("*.cu"))),
                        "findings": len(findings)}
    return findings
