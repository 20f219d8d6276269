"""Resource budget of the hand-written Hopper kernels.

Counterpart of the JAX package's Pallas VMEM budget (``pallas_budget_findings``
in ``repro/analysis/jaxpr_audit.py``). A TPU kernel's resident blocks must
fit VMEM; a Hopper kernel's registers, shared memory and local memory decide
whether it launches at all and how many CTAs share an SM. ``nvcc`` reports
them, and ``cuobjdump --dump-resource-usage`` reads them back from each
built library (``kernels._build.library_path``), per ``__global__``
function:

  kernel-budget  static shared memory over 48 KiB (more needs the opt-in
                 dynamic carve-out, up to 227 KiB per CTA on H100), or more
                 than 255 registers per thread (the most a thread can
                 address; ``-maxrregcount`` cannot raise it)
  kernel-spill   local memory above 0 bytes per thread: the stack frame
                 (``STACK``, where ptxas puts register spills) or local
                 arrays (``LOCAL``), each access a round trip to L1 / HBM in
                 a kernel the port wrote to keep its working set on chip

The budget is Hopper's (the ``sm_90a`` target all seven sources build for:
64 K 32-bit registers and 228 KiB of shared memory per SM, 48 KiB of static
shared memory per CTA). :func:`parse_resource_usage` takes text, so a sample
recorded from the card tests it anywhere.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess

from . import Finding
from .registry import KERNEL_COVERAGE

STATIC_SMEM_LIMIT = 48 * 1024
MAX_REGISTERS = 255

_FUNCTION = re.compile(r"^\s*Function\s+(\S+?):\s*$")
_FIELD = re.compile(r"([A-Z_]+(?:\[\d+\])?):(\d+)")


def parse_resource_usage(text: str) -> list[dict]:
    """Each ``Function <name>:`` block of ``cuobjdump --dump-resource-usage``
    output as {function, registers, shared, stack, local, constant}."""
    out, current = [], None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = {"function": m.group(1)}
            out.append(current)
            continue
        if current is None or "REG:" not in line:
            continue
        fields = dict(_FIELD.findall(line))
        current.update(
            registers=int(fields.get("REG", 0)), shared=int(fields.get("SHARED", 0)),
            stack=int(fields.get("STACK", 0)), local=int(fields.get("LOCAL", 0)),
            constant=sum(int(v) for k, v in fields.items() if k.startswith("CONSTANT")))
        current = None
    return [f for f in out if "registers" in f]


def _short(name: str) -> str:
    """``void (anonymous namespace)::k<64>(float const*, int)`` -> ``k<64>``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


def demangle(names: list[str]) -> dict[str, str]:
    """Short readable names by ``c++filt`` where the host has it (else as
    given)."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = res.stdout.splitlines() if res.returncode == 0 else names
    return {n: (_short(d) or n) for n, d in zip(names, lines)}


def budget_findings(source: str, usage: list[dict]) -> list[Finding]:
    """The budget rules over one library's kernels (``source`` is its
    ``csrc`` name)."""
    findings = []
    for k in usage:
        where = f"{source}:{k.get('name', k['function'])}"
        if k["shared"] > STATIC_SMEM_LIMIT:
            findings.append(Finding("kernel", "kernel-budget", where,
                                    f"{k['shared']} B of static shared memory > "
                                    f"{STATIC_SMEM_LIMIT} B"))
        if k["registers"] > MAX_REGISTERS:
            findings.append(Finding("kernel", "kernel-budget", where,
                                    f"{k['registers']} registers > {MAX_REGISTERS}"))
        if k["local"] + k["stack"] > 0:
            findings.append(Finding("kernel", "kernel-spill", where,
                                    f"{k['stack']} B of stack frame (register spills) + "
                                    f"{k['local']} B of local arrays per thread, "
                                    f"{k['registers']} registers"))
    return findings


def cuobjdump() -> str:
    """The toolkit's ``cuobjdump``, beside its ``nvcc``."""
    from ..kernels import _build
    path = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(path):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return path


def run_kernel_budget(stats: "dict | None" = None) -> list[Finding]:
    """Build every covered source (one nvcc each, started together) and
    check each library's kernels."""
    from ..kernels import _build
    _build.build(sorted(KERNEL_COVERAGE))
    tool = cuobjdump()
    findings: list[Finding] = []
    per_source: dict[str, list[dict]] = {}
    for source in sorted(KERNEL_COVERAGE):
        lib = _build.library_path(source)
        text = subprocess.run([tool, "--dump-resource-usage", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        usage = parse_resource_usage(text)
        if not usage:
            raise RuntimeError(f"cuobjdump reported no kernel in {lib}")
        names = demangle([k["function"] for k in usage])
        for k in usage:
            k["name"] = names[k["function"]]
        findings += budget_findings(source, usage)
        per_source[source] = [{key: k[key] for key in ("name", "registers", "shared", "local",
                                                      "stack")} for k in usage]
    if stats is not None:
        stats["kernel"] = per_source
    return findings
