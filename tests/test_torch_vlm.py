"""Port: the vlm (``internvl2-2b``: patch embeddings prepended to the token
embeddings of the dense transformer) against JAX's ``transformer.forward``
through ``Model.prefill`` / ``decode_step``, and the serving loop's
cache sizing.

SMOKE configuration (2 layers, d_model 64, 8 patch embeddings). Weights
are JAX's draw carried across with ``convert.lm_params_from_numpy``, or
the port's draw carried to JAX for the bf16 logits and for the float32
logits at every position (JAX's stacked draw takes the layer count as the
fan-in, and its near one-hot softmaxes amplify float32 summation order to
1.4e-5 at a few of the 11264 logits; ROADMAP Queue 3); patch embeddings
and tokens are seeded numpy arrays. Tolerances are test_torch_models.py's:
``F32_TOL`` at float32 compute, one bf16 ulp for the bf16 caches,
``BF16_LOGITS_TOL`` of the logits' scale at bf16.

The JAX serve script sizes the cache for the prompt and the generated tokens
plus ``CACHE_PAD`` (128) rows, not for the patch embeddings the prefill
writes first: with more of them than ``CACHE_PAD`` plus the generated
tokens the prefill does not fit (at the published 256 patches, 512 prompt
and 32 generated tokens, 768 rows into 672). The port's ``generate`` sizes
the cache for every row.
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
from repro.models import materialize as jax_materialize
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import CACHE_PAD, Model, build_model
from test_torch_models import (BF16_LOGITS_TOL, F32_TOL, _configs, _jax_lm, _np,
                               _port_weights_lm, assert_bf16_ulp_close)
from test_torch_moe_lm import _shapes_and_dtypes

ARCH = "internvl2-2b"


def _vis(jcfg, B, seed):
    return np.random.default_rng(seed + 100).normal(
        size=(B, jcfg.vis_tokens, jcfg.d_model)).astype(np.float32)


def _jax_greedy(jm, params, prompts, vis, n, rows):
    """JAX's serving steps jitted without a mesh, the cache declared for
    ``rows`` (plus ``CACHE_PAD``): (tokens [B, n], final cache)."""
    prefill_step, decode_step = (jax.jit(f) for f in jax_serve_steps(jm))
    cache = jax_materialize(jm.cache_infos(prompts.shape[0], rows), jax.random.PRNGKey(3))
    tok, cache = prefill_step(params, {"tokens": jnp.asarray(prompts),
                                       "vis_embeds": jnp.asarray(vis, jm.cfg.compute_dtype)},
                              cache)
    out = [np.asarray(tok)]
    for _ in range(n - 1):
        tok, cache = decode_step(params, cache, tok[:, None])
        out.append(np.asarray(tok))
    return np.stack(out, axis=1), cache


def test_full_config_declares_jax_shapes():
    """24 layers at d_model 2048, dh 128, 256 patch embeddings: JAX's
    parameter tree, shapes and dtypes; ``prepare`` draws the patch
    embeddings [B, 256, D] in the compute dtype."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    assert (tcfg.family, tcfg.vis_tokens, tcfg.d_head) == ("vlm", 256, 128)
    got, want = _shapes_and_dtypes(build_model(tcfg).param_infos(),
                                   jax_build(jcfg).param_infos())
    assert got == want
    assert build_model(tcfg).prefill_extras(8) == {"vis_embeds": (8, 256, 2048)}
    smoke = get_config(ARCH, smoke=True)
    _, _, prompts, extras = serve.prepare(smoke, requests=3, prompt_len=5, device="cpu")
    assert tuple(prompts.shape) == (3, 5) and set(extras) == {"vis_embeds"}
    assert tuple(extras["vis_embeds"].shape) == (3, 8, 64)
    assert extras["vis_embeds"].dtype == smoke.compute_dtype


def test_vlm_float32_prefill_and_decode_match_jax():
    """At float32 compute on the port's weights: the prefill of 8 patch
    embeddings and a 12-token prompt, then two decode steps: logits within
    F32_TOL, the KV caches within one bf16 ulp, ``len`` 8 + 12 + 2; and the
    full forward without a cache, its logits at every position (patches
    included) within F32_TOL."""
    jcfg, tcfg = _configs(ARCH, "float32")
    jm, params, params_np = _port_weights_lm(jcfg, tcfg, seed=2)
    B, S, P = 2, 12, jcfg.vis_tokens
    vis = _vis(jcfg, B, 2)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (B, S + 2)).astype(np.int32)
    jzero = jax_materialize(jm.cache_infos(B, P + S + 4), jax.random.PRNGKey(0))
    tc = cache_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jzero), batch=B,
                          max_len=P + S + 4, device="cpu")
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S]),
                                          "vis_embeds": jnp.asarray(vis)}, jzero)
    tl, tc = tm.prefill(lm, {"tokens": torch.from_numpy(toks[:, :S]),
                             "vis_embeds": torch.from_numpy(vis)}, tc)
    got, want = [tl], [jl]
    for t in range(2):
        jl, jc = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, S + t:S + t + 1]))
        tl, tc = tm.decode_step(lm, tc, torch.from_numpy(toks[:, S + t:S + t + 1]))
        got.append(tl)
        want.append(jl)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape) == (B, 1, 256)
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)
    assert tc["len"] == int(jc["len"]) == P + S + 2
    for name in ("k", "v"):
        assert_bf16_ulp_close(tc[name], jc[name])
    want_full, _ = JT.forward(params, jcfg, jnp.asarray(toks), prefix_embeds=jnp.asarray(vis))
    got_full, _ = lm(torch.from_numpy(toks), prefix_embeds=torch.from_numpy(vis))
    assert tuple(got_full.shape) == (B, P + S + 2, 256)
    np.testing.assert_allclose(_np(got_full), _np(want_full), **F32_TOL)


def test_vlm_greedy_tokens_match_jax():
    """8 greedy tokens for 2 requests of 16 with 8 patch embeddings at
    float32 compute: ``serve.generate`` against the JAX serving steps (at
    SMOKE the JAX serve script's cache sizing holds: 8 < CACHE_PAD + 8)."""
    jcfg, tcfg = _configs(ARCH, "float32")
    jm, params, params_np = _jax_lm(jcfg, seed=3)
    B, S, n = 2, 16, 8
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    vis = _vis(jcfg, B, 3)
    want, _ = _jax_greedy(jm, params, prompts, vis, n, S + n)
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    run = serve.generate(tm, lm, torch.from_numpy(prompts), n,
                         extras={"vis_embeds": torch.from_numpy(vis)})
    np.testing.assert_array_equal(run.tokens.numpy(), want)


def test_vlm_bf16_logits_match_jax():
    """bf16 compute on the port's weights carried to JAX: prefill and decode
    logits within BF16_LOGITS_TOL of their scale of JAX's."""
    jcfg, tcfg = _configs(ARCH, "bfloat16")
    jm, params, params_np = _port_weights_lm(jcfg, tcfg, seed=4)
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    B, S, P = 2, 16, jcfg.vis_tokens
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    vis = _vis(jcfg, B, 4)
    jl1, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S]),
                                           "vis_embeds": jnp.asarray(vis, jnp.bfloat16)},
                                  jax_materialize(jm.cache_infos(B, P + S + 8),
                                                  jax.random.PRNGKey(0)))
    jl2, _ = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, S:]))
    tl1, tc = tm.prefill(lm, {"tokens": torch.from_numpy(toks[:, :S]),
                              "vis_embeds": torch.from_numpy(vis).bfloat16()},
                         tm.init_cache(B, P + S + 8, device="cpu"))
    tl2, _ = tm.decode_step(lm, tc, torch.from_numpy(toks[:, S:]))
    gap = max(float(np.abs(_np(t) - _np(j)).max()) / float(np.abs(_np(j)).max())
              for t, j in ((tl1, jl1), (tl2, jl2)))
    print(f"{ARCH}: bf16 logits, port vs JAX, {gap:.4g} of their scale")
    assert gap <= BF16_LOGITS_TOL, gap


def test_cache_holds_the_patches_where_jax_sizing_does_not(monkeypatch):
    """A SMOKE vlm with 160 patch embeddings, more than CACHE_PAD plus the 8
    generated tokens: the JAX serve script's cache (16 + 8 + 128 = 152 rows) does
    not take the 176-row prefill, while the port's ``generate`` sizes the
    cache for 160 + 16 + 8 rows (plus the pad) and gives the tokens of a
    JAX run whose cache is sized so. With 132 patches the JAX prefill fits
    but decode runs past the last row: JAX's ``len`` ends past its cache,
    whose writes there clamp to the last rows."""
    jcfg, tcfg = (dataclasses.replace(c, vis_tokens=160) for c in _configs(ARCH, "float32"))
    jm, params, params_np = _jax_lm(jcfg, seed=5)
    B, S, n = 2, 16, 8
    assert jcfg.vis_tokens > CACHE_PAD + n
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    vis = _vis(jcfg, B, 5)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        _jax_greedy(jm, params, prompts, vis, n, S + n)
    want, _ = _jax_greedy(jm, params, prompts, vis, n, jcfg.vis_tokens + S + n)
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    sizes = []
    real = Model.init_cache
    monkeypatch.setattr(Model, "init_cache",
                        lambda self, b, m, **kw: (sizes.append(m), real(self, b, m, **kw))[1])
    run = serve.generate(tm, lm, torch.from_numpy(prompts), n,
                         extras={"vis_embeds": torch.from_numpy(vis)})
    assert sizes == [jcfg.vis_tokens + S + n]
    np.testing.assert_array_equal(run.tokens.numpy(), want)

    jcfg = dataclasses.replace(jcfg, vis_tokens=CACHE_PAD + 4)
    _, cache = _jax_greedy(jax_build(jcfg), params, prompts, vis[:, :jcfg.vis_tokens], n, S + n)
    assert int(cache["len"]) == jcfg.vis_tokens + S + n - 1 > cache["k"].shape[2]
