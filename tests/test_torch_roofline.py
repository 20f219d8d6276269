"""The port's roofline (``repro_torch.launch.roofline``) against JAX's
``repro/launch/roofline.py``: MODEL_FLOPS bit for bit for all 40 cells,
the same extrapolation and artifact schema, and the H100 data sheet as the
one home of the constants ``chip_smoke.py`` bounds its kernels with."""
import dataclasses
import importlib.util
import json
import pathlib

import pytest

from repro.configs.registry import cells as jcells
from repro.configs.registry import get_config as jget
from repro.launch import roofline as jroof
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch import roofline as troof

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_cells_match_jax():
    assert cells(include_skipped=True) == jcells(include_skipped=True)
    assert cells() == jcells()
    assert len(cells(include_skipped=True)) == 40


@pytest.mark.parametrize("arch,shape,skip", jcells(include_skipped=True),
                         ids=lambda x: str(x))
def test_model_flops_bitwise(arch, shape, skip):
    jc, tc = jget(arch), get_config(arch)
    assert troof.n_eff_per_token(tc) == jroof.n_eff_per_token(jc)
    assert troof.model_flops(tc, shape) == jroof.model_flops(jc, shape)
    assert troof.model_flops(tc, dict(SHAPES[shape])) == jroof.model_flops(jc, shape)


@pytest.mark.parametrize("args", [(1.0, 3.0, 1, 2, 22), (5e12, 9.5e12, 8, 16, 32),
                                  (7.0, 7.0, 2, 2, 9), (0.1, 0.3, 1, 2, 1), (3e9, 2e9, 1, 3, 24)])
def test_extrapolate_equals_jax(args):
    assert troof.extrapolate(*args) == jroof.extrapolate(*args)


def _artifact(mod):
    return mod.CellArtifact(
        cell="tinyllama-1.1b__train_4k__single", arch="tinyllama-1.1b", shape="train_4k",
        kind="train", mesh="single", chips=256, flops=3.1e13, bytes_accessed=2.2e12,
        collective_bytes=4.4e9, collective_breakdown={"all-reduce": 4.4e9},
        peak_memory_per_device=9.5e9, memory_breakdown={"params": 1e9}, model_flops=6.5e15,
        compile_seconds=1.5, extras={"fits_hbm": True})


def test_cell_artifact_schema_and_round_trip(tmp_path):
    names = [f.name for f in dataclasses.fields(troof.CellArtifact)]
    assert names == [f.name for f in dataclasses.fields(jroof.CellArtifact)]
    art = _artifact(troof)
    art.save(tmp_path)
    path = tmp_path / f"{art.cell}.json"
    assert troof.CellArtifact.load(path) == art
    # JAX's loader reads the port's file, and the port's JAX's
    assert dataclasses.asdict(jroof.CellArtifact.load(path)) == dataclasses.asdict(art)
    jart = _artifact(jroof)
    jart.save(tmp_path / "jax")
    assert troof.CellArtifact.load(tmp_path / "jax" / f"{art.cell}.json") == art
    assert set(json.loads(path.read_text())) == set(names)


def test_terms_on_the_h100_data_sheet():
    assert (troof.PEAK_FLOPS, troof.FP32_FLOPS, troof.HBM_BW, troof.LINK_BW,
            troof.HBM_BYTES) == (989e12, 67e12, 3.35e12, 450e9, 80e9)
    art, jart = _artifact(troof), _artifact(jroof)
    t = art.terms()
    assert t == {"compute_s": 3.1e13 / 989e12, "memory_s": 2.2e12 / 3.35e12,
                 "collective_s": 4.4e9 / 450e9}
    assert art.bottleneck() == "memory" and art.step_time() == t["memory_s"]
    assert art.useful_flops_ratio() == jart.useful_flops_ratio()
    assert art.roofline_fraction() == 6.5e15 / (256 * 989e12) / t["memory_s"]


def test_chip_smoke_reads_the_data_sheet_here():
    spec = importlib.util.spec_from_file_location("chip_smoke_roofline", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.HBM_BYTES_PER_S, mod.FP32_FLOPS, mod.BF16_FLOPS) == (3.35e12, 67e12, 989e12)
    src = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.launch.roofline import" in src
    assert "= 3.35e12" not in src and "= 989e12" not in src and "= 67e12" not in src
