"""Port: the MoE LMs (``moonshot-v1-16b-a3b``, ``kimi-k2-1t-a32b``: the
dense transformer with the top-k routed MoE FFN on every layer) against
JAX's ``transformer.forward`` through ``Model.prefill`` / ``decode_step``.

SMOKE configurations (2 layers, d_model 64, 4 experts, top-2). Weights
are JAX's draw carried across with ``convert.lm_params_from_numpy``, or,
for the bf16 logits, the port's draw carried to JAX (one layer's fan-in:
JAX's stacked draw of an expert weight takes the layer count as its
fan-in, ROADMAP Queue 3). Inputs are seeded numpy arrays. The prefill
dispatches per sequence (``group='seq'``), decode over the whole batch
(``group='batch'``), as in JAX. Tolerances are test_torch_models.py's:
``F32_TOL`` at float32 compute, ``BF16_LOGITS_TOL`` of the logits' scale
at bf16. The full configurations are declared, with JAX's shapes; kimi's
head dim of 112 is one the flash kernel refuses, so it serves as SMOKE.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.distributed.serve_step import make_serve_steps as jax_serve_steps
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.models import materialize as jax_materialize
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import flash_attention as kf
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.params import map_infos
from test_torch_models import (BF16_LOGITS_TOL, BF16_TOL, F32_TOL, _bf16_logits_gap, _configs,
                               _jax_lm, _layer_params, _np, assert_bf16_ulp_close)

MOE = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"]
#: parameters of the published configurations
N_PARAMS = {"moonshot-v1-16b-a3b": 28.07e9, "kimi-k2-1t-a32b": 1.0412e12}


def _prefill_decode(jcfg, tcfg, seed=0, B=2, S=16):
    """(JAX, port) logits of a prefill and one decode step on JAX's weights,
    the same tokens and zero caches, and both caches after the decode (the
    port's carried from JAX's zero cache by ``cache_from_numpy``)."""
    jm, params, params_np = _jax_lm(jcfg, seed)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    cache = jax_materialize(jm.cache_infos(B, S + 8), jax.random.PRNGKey(seed))
    jl1, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S])}, cache)
    jl2, jc = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, S:]))
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    tc = cache_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, cache), batch=B,
                          max_len=S + 8, device="cpu")
    tl1, tc = tm.prefill(lm, {"tokens": torch.from_numpy(toks[:, :S])}, tc)
    tl2, tc = tm.decode_step(lm, tc, torch.from_numpy(toks[:, S:]))
    return (jl1, jl2, jc), (tl1, tl2, tc)


def _shapes_and_dtypes(tinfos, jinfos):
    got = map_infos(lambda i: (i.shape, str(i.dtype).split(".")[-1]), tinfos)
    want = jax.tree_util.tree_map(lambda i: (i.shape, str(np.dtype(i.dtype))), jinfos,
                                  is_leaf=lambda x: hasattr(x, "init"))
    return got, want


@pytest.mark.parametrize("arch", MOE)
def test_full_config_declares_jax_shapes(arch):
    """The published configuration: the same parameter tree, shapes and
    dtypes as JAX's declaration (moonshot 28.07 B parameters; kimi 1.041 T in
    bf16), MoE on every layer, and the same cache declaration."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert (tcfg.family, tcfg.moe_experts, tcfg.moe_topk) == ("moe", jcfg.moe_experts,
                                                              jcfg.moe_topk)
    tinfos = build_model(tcfg).param_infos()
    got, want = _shapes_and_dtypes(tinfos, jax_build(jcfg).param_infos())
    assert got == want
    assert "moe" in tinfos["layers"] and "mlp" not in tinfos["layers"]
    n = sum(int(np.prod(i.shape)) for i in jax.tree_util.tree_leaves(
        map_infos(lambda i: i, tinfos), is_leaf=lambda x: hasattr(x, "init")))
    assert n == pytest.approx(N_PARAMS[arch], rel=2e-3)
    tc = build_model(tcfg).cache_infos(8, 544)
    jc = jax_build(jcfg).cache_infos(8, 544)
    assert {k: i.shape for k, i in tc.items()} == {k: i.shape for k, i in jc.items()
                                                   if k != "len"}


def test_kimi_head_dim_is_refused_by_the_kernel():
    """kimi's full width attends at dh 112: the kernel's wrapper raises
    (the same check runs before a launch on the card), nothing falls back."""
    cfg = get_config("kimi-k2-1t-a32b")
    assert cfg.d_head == 112 and cfg.d_head not in kf.HEAD_DIMS
    q = torch.zeros(1, 2, cfg.n_heads, cfg.d_head, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, cfg.n_kv_heads, cfg.d_head, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dh in"):
        kf.flash_attention(q, kv, kv)


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_float32_logits_and_cache_match_jax(arch, monkeypatch):
    """A 16-token prefill (MoE group 'seq') and a decode step (group
    'batch') at float32 compute on JAX's weights: logits within F32_TOL,
    the bf16 KV caches within one bf16 ulp of JAX's."""
    groups = []
    real = TL.moe_apply
    monkeypatch.setattr(TL, "moe_apply", lambda p, x, cfg, group="seq": (
        groups.append((group, tuple(x.shape))), real(p, x, cfg, group=group))[1])
    (jl1, jl2, jc), (tl1, tl2, tc) = _prefill_decode(*_configs(arch, "float32"))
    assert groups == [("seq", (2, 16, 64))] * 2 + [("batch", (2, 1, 64))] * 2
    for got, want in ((tl1, jl1), (tl2, jl2)):
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert tc["len"] == int(jc["len"]) == 17
    for name in ("k", "v"):
        assert tc[name].dtype == torch.bfloat16
        assert_bf16_ulp_close(tc[name], jc[name])


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_bf16_logits_match_jax(arch):
    """bf16 compute on the port's weights carried to JAX: the prefill and
    decode logits within BF16_LOGITS_TOL of their scale of JAX's."""
    gap = _bf16_logits_gap(arch)
    print(f"{arch}: bf16 logits, port vs JAX, {gap:.4g} of their scale")
    assert gap <= BF16_LOGITS_TOL, gap


@pytest.mark.parametrize("arch", MOE)
def test_moe_greedy_tokens_match_jax(arch):
    """8 greedy tokens for 2 requests of 16 at float32 compute:
    ``serve.generate`` against the JAX serving steps jitted without a mesh."""
    jcfg, tcfg = _configs(arch, "float32")
    jm, params, params_np = _jax_lm(jcfg, seed=3)
    B, S, n = 2, 16, 8
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    prefill_step, decode_step = (jax.jit(f) for f in jax_serve_steps(jm))
    cache = jax_materialize(jm.cache_infos(B, S + n), jax.random.PRNGKey(3))
    tok, cache = prefill_step(params, {"tokens": jnp.asarray(prompts)}, cache)
    want = [np.asarray(tok)]
    for _ in range(n - 1):
        tok, cache = decode_step(params, cache, tok[:, None])
        want.append(np.asarray(tok))
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    assert isinstance(lm, TT.TransformerLM) and hasattr(lm.layers[0], "moe")
    run = serve.generate(tm, lm, torch.from_numpy(prompts), n)
    np.testing.assert_array_equal(run.tokens.numpy(), np.stack(want, axis=1))


def test_moe_lm_int8_cache_matches_jax():
    """moonshot SMOKE with an int8 KV cache (every family JAX gives one):
    prefill and decode logits within F32_TOL of JAX's at float32 compute."""
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype="int8")
                  for c in _configs("moonshot-v1-16b-a3b", "float32"))
    (jl1, jl2, jc), (tl1, tl2, tc) = _prefill_decode(jcfg, tcfg, seed=1)
    for got, want in ((tl1, jl1), (tl2, jl2)):
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert tc["k"].dtype == torch.int8 and set(tc) == {"k", "v", "k_scale", "v_scale", "len"}
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", ["seq", "batch"])
def test_moe_top6_matches_jax(group, compute):
    """The MoE FFN at moonshot's top 6 (of 8 experts here): more than two
    contributions per token, which the combine adds in expert order with
    each sum rounded, as JAX's scatter-add; within F32_TOL (or the bf16
    layer tolerance) of JAX's ``moe_apply``, and bitwise equal on a rerun."""
    jcfg, tcfg = (dataclasses.replace(c, moe_experts=8, moe_topk=6)
                  for c in _configs("moonshot-v1-16b-a3b", compute))
    jp, tp = _layer_params(jcfg, JL.moe_infos, 6)
    x = np.random.default_rng(6).normal(size=(3, 10, jcfg.d_model)).astype(np.float32)
    want = JL.moe_apply(jp, jnp.asarray(x, jcfg.compute_dtype), jcfg, group=group)
    got = TL.moe_apply(tp, torch.from_numpy(x).to(tcfg.compute_dtype), tcfg, group=group)
    tol = F32_TOL if compute == "float32" else BF16_TOL
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **tol)
    again = TL.moe_apply(tp, torch.from_numpy(x).to(tcfg.compute_dtype), tcfg, group=group)
    assert torch.equal(got, again)
