"""The port's sharding specs (``repro_torch.distributed.sharding``) and
meshes (``repro_torch.launch.mesh``) against JAX's
``repro/distributed/sharding.py`` and ``repro/launch/mesh.py``.

Parameter, cache (decode_32k) and batch specs equal JAX's entry for entry
for all ten archs on both production meshes, in the 'tp' and 'dp' layouts
with FSDP on and off (leaves matched by name: the port declares JAX's
tree); optimizer-state specs equal as a multiset of (shape, spec); the
bytes a device holds equal those computed from JAX's specs. A spec is a
plain tuple, the entries of JAX's ``PartitionSpec``."""
import collections
import dataclasses
import math
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

from repro.configs.base import MeshConfig as JMesh
from repro.configs.base import batch_axes as jbatch_axes
from repro.configs.base import sharding_rules as jrules
from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as jget
from repro.distributed import sharding as js
from repro.models.api import build_model as jbuild
from repro.models.params import ParamInfo as JInfo
from repro.models.params import abstract, count_params as jcount
from repro.optim import OptConfig as JOpt
from repro.optim import make_optimizer as jopt
from repro_torch.configs import SHAPES, MeshConfig, batch_axes, get_config, sharding_rules
from repro_torch.distributed import sharding as ts
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models.params import count_params, partition_specs
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import leaves

LAYOUTS = {"tp": {}, "tp_fsdp": {"fsdp": True}, "tp_nofsdp": {"fsdp": False},
           "dp": {"layout": "dp"}, "dp_nofsdp": {"layout": "dp", "fsdp": False}}
DECODE = SHAPES["decode_32k"]


def _flat(tree, is_leaf, path=()):
    if is_leaf(tree):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _flat(tree[k], is_leaf, path + (k,))


def jspecs(tree) -> dict:
    return {p: tuple(s) for p, s in _flat(tree, lambda x: isinstance(x, PartitionSpec))}


def tspecs(tree) -> dict:
    return dict(_flat(tree, lambda x: isinstance(x, tuple)))


def _models(arch: str, layout: str):
    kw = LAYOUTS[layout]
    return (jbuild(dataclasses.replace(jget(arch), **kw)),
            build_model(dataclasses.replace(get_config(arch), **kw)))


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_cache_and_batch_specs_equal_jax(arch, multi):
    jm_cfg, tm_cfg = JMesh(multi_pod=multi), MeshConfig(multi_pod=multi)
    assert ts.axis_sizes(tm_cfg) == js.axis_sizes(jm_cfg)
    for layout in LAYOUTS:
        jm, tm = _models(arch, layout)
        assert sharding_rules(tm.cfg, tm_cfg) == jrules(jm.cfg, jm_cfg)
        jp, tp = jspecs(js.param_specs(jm, jm_cfg)), tspecs(ts.param_specs(tm, tm_cfg))
        assert tp == jp, layout
        jc = jspecs(js.cache_specs(jm, jm_cfg, DECODE["global_batch"], DECODE["seq_len"]))
        tc = tspecs(ts.cache_specs(tm, tm_cfg, DECODE["global_batch"], DECODE["seq_len"]))
        assert jc.pop(("len",)) == ()  # the port's cache carries its fill count as an int
        assert tc == jc, layout
        for shape in SHAPES:
            jin, tin = jm.input_specs(shape), tm.input_specs(shape)
            assert {k: tuple(v.shape) for k, v in tin.items()} == {
                k: tuple(v.shape) for k, v in jin.items()}
            assert all(v.is_meta for v in tin.values())
            assert {k: tuple(v) for k, v in js.batch_specs(jm, jm_cfg, jin).items()} == \
                ts.batch_specs(tm, tm_cfg, tin), (layout, shape)
    assert batch_axes(tm_cfg) == jbatch_axes(jm_cfg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_without_axis_sizes_and_param_counts(arch):
    """Rules alone (no divisibility) resolve as JAX's do; the parameter
    counts are JAX's."""
    jm, tm = _models(arch, "tp")
    rules = sharding_rules(tm.cfg, MeshConfig())
    from repro.models.params import partition_specs as jpartition
    assert tspecs(partition_specs(tm.param_infos(), rules)) == jspecs(
        jpartition(jm.param_infos(), rules))
    assert count_params(tm.param_infos()) == jcount(jm.param_infos())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_specs_equal_jax(arch):
    jm, tm = _models(arch, "tp")
    jinit, _ = jopt(jm.cfg.optimizer, JOpt())
    tinit, _ = make_optimizer(tm.cfg.optimizer, OptConfig())
    p_abs = abstract(jm.param_infos())
    jstate = jax.eval_shape(jinit, p_abs)
    jos = js.opt_state_specs(jinit, p_abs, js.param_specs(jm, JMesh()))
    want = collections.Counter(
        (tuple(x.shape), tuple(s)) for x, s in zip(
            jax.tree_util.tree_leaves(jstate),
            jax.tree_util.tree_leaves(jos, is_leaf=lambda x: isinstance(x, PartitionSpec))))
    pm = ts.meta_params(tm.param_infos())
    tstate = tinit(pm)
    assert all(x.is_meta for x in leaves(tstate))
    tos = ts.opt_state_specs(tinit, pm, ts.param_specs(tm, MeshConfig()))
    got = collections.Counter((tuple(x.shape), s)
                              for x, s in zip(leaves(tstate), ts.leaves_of_specs(tos)))
    assert got == want


def _jax_bytes(tree, specs, sizes) -> float:
    """Per-device bytes from JAX's infos and specs."""
    infos = dict(_flat(tree, lambda x: isinstance(x, JInfo)))
    total = 0.0
    for path, spec in jspecs(specs).items():
        info = infos[path]
        shards = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                shards *= sizes.get(a, 1)
        total += math.prod(info.shape) * np.dtype(info.dtype).itemsize / shards
    return total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bytes_per_device_equal_jax_specs(arch):
    for multi in (False, True):
        for layout in ("tp", "dp"):
            jm, tm = _models(arch, layout)
            sizes = js.axis_sizes(JMesh(multi_pod=multi))
            tm_cfg = MeshConfig(multi_pod=multi)
            got = ts.bytes_per_device(tm.param_infos(), ts.param_specs(tm, tm_cfg), sizes)
            assert got == pytest.approx(_jax_bytes(
                jm.param_infos(), js.param_specs(jm, JMesh(multi_pod=multi)), sizes), rel=1e-12)
            B, S = DECODE["global_batch"], DECODE["seq_len"]
            jcache = jm.cache_infos(B, S)
            jcache.pop("len")
            jcs = js.cache_specs(jm, JMesh(multi_pod=multi), B, S)
            jcs.pop("len")
            got = ts.bytes_per_device(tm.cache_infos(B, S), ts.cache_specs(tm, tm_cfg, B, S),
                                      sizes)
            assert got == pytest.approx(_jax_bytes(jcache, jcs, sizes), rel=1e-12)


def test_bytes_per_device_divides_by_the_sharding_axes():
    x = torch.empty((32, 64), dtype=torch.bfloat16, device="meta")
    sizes = {"data": 4, "model": 8, "pod": 2}
    assert ts.bytes_per_device({"w": x}, {"w": ("data", "model")}, sizes) == 32 * 64 * 2 / 32
    assert ts.bytes_per_device({"w": x}, {"w": (("pod", "data"), None)}, sizes) == 32 * 64 * 2 / 8
    assert ts.bytes_per_device({"w": x}, {"w": (None, None)}, sizes) == 32 * 64 * 2
    with pytest.raises(ValueError):
        ts.bytes_per_device({"w": x, "v": x}, {"w": (None, None)}, sizes)


# -- meshes -------------------------------------------------------------------------------

def test_mesh_layouts_are_jax():
    assert tmesh.mesh_layout(MeshConfig()) == ((16, 16), ("data", "model"))
    assert tmesh.mesh_layout(MeshConfig(multi_pod=True)) == ((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.mesh_layout(MeshConfig(data=4, model=2)) == ((4, 2), ("data", "model"))
    for multi in (False, True):
        shape, _ = tmesh.mesh_layout(MeshConfig(multi_pod=multi))
        assert math.prod(shape) == JMesh(multi_pod=multi).n_devices


def test_importing_mesh_touches_no_device_or_group():
    code = ("import sys, torch.distributed as dist, repro_torch.launch.mesh; "
            "import torch; sys.exit(1 if dist.is_initialized() or torch.cuda.is_initialized() "
            "else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_meshes_over_a_one_rank_group():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        m = tmesh.make_mesh(MeshConfig(data=1, model=1), device="cpu")
        assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")
        assert m.device_type == "cpu"
        m = tmesh.make_mesh(MeshConfig(multi_pod=True, pods=1, data=1, model=1), device="cpu")
        assert tuple(m.shape) == (1, 1, 1) and m.mesh_dim_names == ("pod", "data", "model")
        h = tmesh.make_host_mesh(device="cpu")
        assert tuple(h.shape) == (1, 1) and h.mesh_dim_names == ("data", "model")
        with pytest.raises(Exception):
            tmesh.make_production_mesh(device="cpu")  # 256 devices on a one-rank group
        with pytest.raises(ValueError, match="cuda or cpu"):
            tmesh.make_mesh(MeshConfig(data=1, model=1), device="meta")
    finally:
        dist.destroy_process_group()
