"""Port hygiene: ``repro_torch`` and ``chip_smoke.py`` stand alone.

They import neither JAX nor the JAX package, entry points run on the card
unless the caller asks for the CPU, and ``chip_smoke.py`` refuses to report
without a CUDA device or without the repository beside it.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.device
from repro_torch.configs import get_config
from repro_torch.core import M1, ConsolidationEngine, PackedCluster, PackedDynamics
from repro_torch.core import profile_pairwise_fast
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("PYTHONSTARTUP", None)
    return env


def test_import_loads_neither_jax_nor_repro():
    """In a fresh interpreter (this test process has jax loaded by conftest)."""
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.models, repro_torch.configs, "
            "repro_torch.distributed.serve_step, repro_torch.launch.serve, repro_torch.fleet, "
            "repro_torch.core.closed_loop, repro_torch.obs, repro_torch.obs.explain, "
            "repro_torch.obs.report, repro_torch.core.scheduler, repro_torch.core.refine; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    D = profile_pairwise_fast(M1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ConsolidationEngine([M1], D=D)
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedCluster.build([M1], D)
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedDynamics.build([M1])
    model = build_model(get_config("tinyllama-1.1b", smoke=True))
    for serving_entry in (model.init, lambda: model.init_cache(1, 4),
                          lambda: serve.admission_check("tinyllama-1.1b", 1),
                          lambda: serve.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            serving_entry()
    assert repro_torch.device.resolve_device("cpu") == torch.device("cpu")
    assert ConsolidationEngine([M1], D=D, device="cpu").cluster.device.type == "cpu"


def test_ops_cuda_mode_refuses_cpu_tensors():
    m, T, Q = 2, 230, 3
    args = (torch.zeros(m, T), torch.zeros(m, T, T), torch.ones(T), torch.zeros(m, T),
            torch.ones(m), torch.zeros(Q, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.greedy_scores(*args, mode="cuda")
    cache, maxd = ops.greedy_scores(*args, mode="torch")
    assert cache.shape == maxd.shape == (Q, m)
    assert np.isfinite(maxd.numpy()).all()


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Without a CUDA device, the repository's copy and a copy alone in an
    empty directory both exit nonzero and print no result line."""
    env = _env()
    env.pop("PYTHONPATH")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
