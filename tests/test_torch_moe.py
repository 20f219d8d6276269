"""Port: the MoE FFN (``repro_torch.models.layers.moe_apply``) against the
JAX package's single-device path.

SMOKE configuration of jamba-v0.1-52b (d_model 64, 4 experts of width 128,
top-2). Weights come from the JAX package's ``materialize`` of the MoE
declaration; inputs are seeded numpy arrays with a mean of 1, and the
router's expert-0 column is raised, so that every token prefers expert 0:
at SMOKE's capacity factor of 1.25 the dispatch drops tokens (checked),
at 8.0 it drops none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models import materialize as jax_materialize
from repro_torch.configs import get_config
from repro_torch.models import build_model, materialize
from repro_torch.models import layers as TL

ARCH = "jamba-v0.1-52b"
#: float32 compute: max |port - JAX| within 1e-5 of the JAX output's max |.|
F32_TOL = 1e-5
#: bf16 compute, one layer: a few bf16 roundings apart
BF16_TOL = 2e-2


def _configs(compute, factor):
    jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    return (dataclasses.replace(jcfg, compute_dtype=getattr(jnp, compute),
                                moe_capacity_factor=factor),
            dataclasses.replace(tcfg, compute_dtype=getattr(torch, compute),
                                moe_capacity_factor=factor))


def _gap(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max()) / float(np.abs(w).max())


def _moe_params(jcfg, seed=2):
    """JAX's init, the router's expert-0 column raised so that, on inputs
    with a mean of 1, expert 0 is over-subscribed."""
    p = jax.tree_util.tree_map(np.array, jax_materialize(JL.moe_infos(jcfg),
                                                         jax.random.PRNGKey(seed)))
    p["router"][:, 0] += 0.05
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def routed():
    """Seeded routing decisions for 3 groups of 24 tokens over 4 experts,
    top-2, skewed towards expert 0: (tokens, expert_idx, gate_w) numpy."""
    rng = np.random.default_rng(7)
    tokens = rng.normal(size=(3, 24, 8)).astype(np.float32)
    p = np.array([0.55, 0.2, 0.15, 0.1])
    idx = np.stack([np.stack([rng.choice(4, 2, replace=False, p=p) for _ in range(24)])
                    for _ in range(3)]).astype(np.int32)
    idx[0, 5, 1] = 4  # an out-of-range id (the dropped bucket)
    w = rng.uniform(size=(3, 24, 2)).astype(np.float32)
    return tokens, idx, w


@pytest.mark.parametrize("C", [4, 9, 48])
def test_dispatch_matches_jax(routed, C):
    """The sort-based dispatch of each group: src, w and the gathered
    buffers equal JAX's (vmapped over the groups), capacity drops and the
    dropped bucket included."""
    tokens, idx, w = routed
    jbuf, (jsrc, jw) = jax.vmap(lambda t, e, g: JL._dispatch_tokens(t, e, g, 4, C))(
        jnp.asarray(tokens), jnp.asarray(idx), jnp.asarray(w))
    buf, (src, tw) = TL._dispatch_tokens(torch.from_numpy(tokens), torch.from_numpy(idx).long(),
                                         torch.from_numpy(w), 4, C)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    kept = int((src >= 0).sum())
    assert kept == int((np.asarray(jsrc) >= 0).sum())
    if C == 4:
        assert kept < idx.size - 1  # capacity dropped tokens


@pytest.fixture(scope="module")
def moe_outputs():
    """The inputs, and JAX's and the port's ``moe_apply`` on the same
    weights and inputs for each (compute, capacity factor, group)."""
    rng = np.random.default_rng(3)
    x = (1.0 + rng.normal(size=(2, 24, 64))).astype(np.float32)
    out = {}
    for compute in ("float32", "bfloat16"):
        for factor in (1.25, 8.0):
            jcfg, tcfg = _configs(compute, factor)
            jp, tp = _moe_params(jcfg)
            jx = jnp.asarray(x, jcfg.compute_dtype)
            tx = torch.from_numpy(x).to(tcfg.compute_dtype)
            for group in ("seq", "batch"):
                want = JL.moe_apply(jp, jx, jcfg, group=group)
                got = TL.moe_apply(tp, tx, tcfg, group=group)
                out[compute, factor, group] = (got, want)
    return x, out


@pytest.mark.parametrize("group", ["seq", "batch"])
@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(moe_outputs, compute, factor, group):
    """Per sequence (prefill) and over the batch (decode), at SMOKE's
    capacity factor and at 8.0: within 1e-5 of JAX at float32, 2e-2 at
    bf16."""
    _, out = moe_outputs
    got, want = out[compute, factor, group]
    assert got.dtype == getattr(torch, compute) and tuple(got.shape) == (2, 24, 64)
    assert _gap(got, want) <= (F32_TOL if compute == "float32" else BF16_TOL)


def test_smoke_capacity_drops_tokens(moe_outputs):
    """The skewed router over-subscribes expert 0: at capacity factor 1.25
    the per-sequence dispatch drops routed tokens (so the parity above
    covers drops), at 8.0 none."""
    x, _ = moe_outputs
    for factor, dropped in ((1.25, True), (8.0, False)):
        _, tcfg = _configs("float32", factor)
        _, tp = _moe_params(_configs("float32", factor)[0])
        gates = torch.softmax(torch.from_numpy(x) @ tp["router"], dim=-1)
        gw, idx = TL.top_k(gates, 2)
        C = TL.moe_capacity(tcfg, 24)
        _, (src, _) = TL._dispatch_tokens(torch.from_numpy(x), idx, gw, 4, C)
        assert (int((src >= 0).sum()) < idx.numel()) == dropped


def test_top_k_prefers_the_lower_index_on_ties():
    gates = torch.tensor([[0.25, 0.5, 0.25, 0.5], [0.1, 0.1, 0.1, 0.7]])
    vals, idx = TL.top_k(gates, 2)
    assert idx.tolist() == [[1, 3], [3, 0]] and vals.tolist()[0] == [0.5, 0.5]
    _, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    assert np.asarray(ji).tolist() == idx.tolist()


def test_moe_capacity_matches_jax():
    for factor in (1.25, 8.0):
        jcfg, tcfg = _configs("float32", factor)
        for n in (1, 8, 24, 512, 4096):
            assert TL.moe_capacity(tcfg, n) == JL.moe_capacity(jcfg, n)


def test_expert_weights_take_one_experts_fan_in():
    """The port's init skips the 'expert' axis (and the 'layer' axis) of an
    MoE weight: ``wi`` [E, D, 2, F] is drawn 1/sqrt(D) wide and ``wo``
    [E, F, D] 1/sqrt(F), so a random MoE layer keeps its input's scale; the
    router stays float32 in the module."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), moe_dff=400)
    infos = build_model(cfg).param_infos()["periods"]["sub1"]["moe"]
    p = materialize(infos, torch.Generator().manual_seed(0))
    trunc = 0.8796  # the std of N(0, 1) truncated to [-2, 2]
    for name, fan_in in (("wi", 64), ("wo", 400)):
        std = float(p[name].float().std())
        assert abs(std - trunc / np.sqrt(fan_in)) <= 0.05 * trunc / np.sqrt(fan_in), name
    assert p["wi"].dtype == torch.float32  # SMOKE keeps float32 masters
    moe = TL.MoE(cfg, {k: v[0] for k, v in p.items()})
    assert moe.c["router"].dtype == torch.float32 and moe.c["wi"].dtype == torch.bfloat16
