"""Port: the int8 KV cache (``repro_torch.models.layers.quantize_kv`` and
the int8 branch of ``attention_apply``) against the JAX package.

``quantize_kv`` must give JAX's codes and scales bit for bit. The
tinyllama SMOKE model with ``kv_cache_dtype='int8'`` at float32 compute
runs a prefill and 4 decode steps on JAX's weights (carried across with
``convert.lm_params_from_numpy``) from the same zero cache: logits within
``F32_TOL`` of JAX's (test_torch_models.py), codes and scales equal. The
greedy tokens of the serving loops must be equal. The hybrid keeps a bf16
cache whatever ``kv_cache_dtype`` says, in JAX and in the port. On the CPU
attention runs the kernel's plain version; the buffer it is handed on the
int8 route is a fresh dequantized one that the kernel's checks accept.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.serve_step import make_serve_steps as jax_serve_steps
from repro.models import build_model as jax_build
from repro.models import hybrid as JH
from repro.models import layers as JL
from repro.models import materialize as jax_materialize
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, materialize
from repro_torch.models import hybrid as TH
from repro_torch.models import layers as TL
from test_torch_models import F32_TOL, _configs, _jax_lm, _np, _layer_params

ARCH = "tinyllama-1.1b"


def _int8(jcfg, tcfg):
    return (dataclasses.replace(jcfg, kv_cache_dtype="int8"),
            dataclasses.replace(tcfg, kv_cache_dtype="int8"))


def _kv_rows(rng, shape, dtype):
    """Unit-scale rows, with an all-zero row (scale 1e-8), rows whose
    values sit on a code's half-way point (round half to even) and a row
    with one large outlier."""
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 0, 0] = 0.0
    # scale 63.5 / 127 = 0.5 exactly, the others at odd multiples of 0.25: x / scale
    # lands on k + 0.5, which rounds to the even neighbour
    x[0, 1, 0, :-1] = (np.arange(shape[-1] - 1) - 7 + 0.5) * 0.5
    x[0, 1, 0, -1] = 63.5
    x[-1, -1, -1, 3] = 40.0
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype).name))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_kv_bitwise_equal_to_jax(dtype):
    jx, tx = _kv_rows(np.random.default_rng(0), (3, 7, 4, 16), dtype)
    jq, js = JL.quantize_kv(jx)
    tq, ts = TL.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(tq.shape) == (3, 7, 4, 16) and tuple(ts.shape) == (3, 7, 4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    assert float(ts[0, 0, 0]) == pytest.approx(1e-8, rel=1e-2)  # the zero row's floor
    # dequantized as JAX's layer does it, in either compute dtype
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = TL.dequantize_kv(tq, ts, tdt)
        want = jq.astype(jdt) * js[..., None].astype(jdt)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("S", [1, 5])
def test_int8_attention_apply_matches_jax(S, window):
    """One attention layer on an int8 cache of 40 rows holding 21, the rows
    past them garbage that must stay unread: output within F32_TOL of
    JAX's, the new codes and scales equal to JAX's. With a window of 8 the
    cache is longer than window + S, so JAX reads only its last window + S
    rows; the port dequantizes the rows from the first one a query sees."""
    jcfg, tcfg = _int8(*_configs(ARCH, "float32"))
    jcfg, tcfg = (dataclasses.replace(c, sliding_window=window) for c in (jcfg, tcfg))
    rng = np.random.default_rng(3)
    B, T, idx = 2, 40, 21
    jp, tp = _layer_params(jcfg, JL.attention_infos, 4)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, T, jcfg.n_kv_heads, jcfg.d_head)).astype(np.float32)
    codes, scales = zip(*(JL.quantize_kv(jnp.asarray(a)) for a in kv))
    codes = [np.asarray(c).copy() for c in codes]
    for c in codes:
        c[:, idx + S:] = 127  # garbage past the written rows
    jcache = {"k": jnp.asarray(codes[0]), "v": jnp.asarray(codes[1]), "k_scale": scales[0],
              "v_scale": scales[1], "len": jnp.int32(idx)}
    tcache = {"k": torch.from_numpy(codes[0].copy()), "v": torch.from_numpy(codes[1].copy()),
              "k_scale": torch.from_numpy(np.asarray(scales[0]).view(np.int16).copy()).view(
                  torch.bfloat16),
              "v_scale": torch.from_numpy(np.asarray(scales[1]).view(np.int16).copy()).view(
                  torch.bfloat16),
              "len": idx}
    pos = np.arange(idx, idx + S)
    want, jnew = JL.attention_apply(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                    cache=jcache, window=window)
    got, tnew = TL.attention_apply(tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                                   cache=tcache, window=window)
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **F32_TOL)
    assert tnew["len"] == idx + S and tnew["k"] is tcache["k"]  # written in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(tnew[name].numpy(), np.asarray(jnew[name]))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tnew[name].view(torch.int16).numpy(),
                                      np.asarray(jnew[name]).view(np.int16))



@pytest.mark.parametrize("S", [1, 5])
def test_float32_cache_attention_apply_matches_jax(S):
    """One attention layer at float32 compute on a float32 cache of 40 rows
    holding 21, the rows past them garbage that must stay unread: JAX's
    layer writes whatever dtype its cache holds, and so does the port's
    (the float32 cache is the witness that takes the bf16 roundings out of
    a card-against-CPU comparison). Output and the new rows, unrounded,
    within F32_TOL of JAX's (the projections' float32 summation orders
    differ); the other rows untouched."""
    jcfg, tcfg = _configs(ARCH, "float32")
    rng = np.random.default_rng(5)
    B, T, idx = 2, 40, 21
    jp, tp = _layer_params(jcfg, JL.attention_infos, 4)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, T, jcfg.n_kv_heads, jcfg.d_head)).astype(np.float32)
    kv[:, :, idx + S:] = 1e4  # garbage past the written rows
    jcache = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]), "len": jnp.int32(idx)}
    tcache = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy()),
              "len": idx}
    pos = np.arange(idx, idx + S)
    want, jnew = JL.attention_apply(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                    cache=jcache)
    got, tnew = TL.attention_apply(tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                                   cache=tcache)
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **F32_TOL)
    assert tnew["len"] == idx + S and tnew["k"] is tcache["k"]  # written in place
    for i, name in enumerate(("k", "v")):
        assert tnew[name].dtype == torch.float32
        got_rows, want_rows = tnew[name].numpy(), np.asarray(jnew[name])
        np.testing.assert_allclose(got_rows[:, idx:idx + S], want_rows[:, idx:idx + S],
                                   **F32_TOL)
        assert np.abs(got_rows[:, idx:idx + S] - kv[i, :, idx:idx + S]).max() > 0  # written
        for rows in (slice(0, idx), slice(idx + S, T)):
            np.testing.assert_array_equal(got_rows[:, rows], kv[i, :, rows])
    with pytest.raises(TypeError, match="float16"):
        TL.attention_apply(tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
                           cache=dict(tcache, k=tcache["k"].half(), v=tcache["v"].half()))

def test_int8_route_hands_the_kernel_a_fresh_buffer(monkeypatch):
    """On the int8 route the kernel reads a new compute-dtype buffer of the
    visible rows, not a view of the cache, and the kernel's contract
    (``_check``: dtypes, 16-byte row loads) accepts it at bf16 compute."""
    _, tcfg = _int8(*_configs(ARCH, "bfloat16"))
    seen = []
    real = ops.gqa_flash_attention

    def spy(q, k, v, **kw):
        kf._check(q, k, v, kw.get("q_offset", 0), kw.get("window", 0))
        seen.append((k, v, kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "gqa_flash_attention", spy)
    model = build_model(tcfg)
    lm = model.init(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(2, 12, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)))
    _, cache = model.prefill(lm, {"tokens": tokens}, cache)
    model.decode_step(lm, cache, tokens[:, :1])
    assert len(seen) == 2 * tcfg.n_layers
    store = {cache[n].untyped_storage().data_ptr() for n in ("k", "v", "k_scale", "v_scale")}
    for k, v, kw in seen:
        assert k.dtype == v.dtype == torch.bfloat16 and k.is_contiguous()
        assert k.untyped_storage().data_ptr() not in store
    assert seen[-1][0].shape[1] == 10 and seen[-1][2]["q_offset"] == 9


def _jax_int8_run(jcfg, params, toks, B, S, steps, rows):
    jm = jax_build(jcfg)
    cache = jax_materialize(jm.cache_infos(B, rows), jax.random.PRNGKey(0))
    logits, cache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S])}, cache)
    out = [logits]
    decode = jax.jit(jm.decode_step)
    for t in range(steps):
        logits, cache = decode(params, cache, jnp.asarray(toks[:, S + t:S + t + 1]))
        out.append(logits)
    return out, cache


def test_int8_prefill_and_decode_match_jax():
    """tinyllama SMOKE, int8 cache, float32 compute: a 16-token prefill and
    4 decode steps on JAX's weights from the same zero cache. Every call's
    logits within F32_TOL of JAX's; after the last, the codes, the scales
    and ``len`` equal JAX's (the port's cache carried from JAX's zero
    cache through ``cache_from_numpy``)."""
    jcfg, tcfg = _int8(*_configs(ARCH, "float32"))
    B, S, steps, rows = 2, 16, 4, 24
    _, params, params_np = _jax_lm(jcfg, seed=5)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (B, S + steps)).astype(np.int32)
    want, jc = _jax_int8_run(jcfg, params, toks, B, S, steps, rows)

    jzero = jax_materialize(jax_build(jcfg).cache_infos(B, rows), jax.random.PRNGKey(0))
    tc = cache_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jzero), batch=B,
                          max_len=rows, device="cpu")
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == torch.bfloat16
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    logits, tc = tm.prefill(lm, {"tokens": torch.from_numpy(toks[:, :S])}, tc)
    got = [logits]
    for t in range(steps):
        logits, tc = tm.decode_step(lm, tc, torch.from_numpy(toks[:, S + t:S + t + 1]))
        got.append(logits)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)
    assert tc["len"] == int(jc["len"]) == S + steps
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tc[name].view(torch.int16).numpy(),
                                      np.asarray(jc[name]).view(np.int16))


def test_int8_greedy_tokens_match_jax():
    """8 greedy tokens for 2 requests of 16 at float32 compute with an int8
    cache: ``serve.generate`` against the JAX serving steps; and the int8
    cache's tokens beside the bf16 cache's (the quantization is visible in
    the logits, not a no-op)."""
    jcfg, tcfg = _int8(*_configs(ARCH, "float32"))
    _, params, params_np = _jax_lm(jcfg, seed=3)
    B, S, n = 2, 16, 8
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jm = jax_build(jcfg)
    prefill_step, decode_step = (jax.jit(f) for f in jax_serve_steps(jm))
    cache = jax_materialize(jm.cache_infos(B, S + n), jax.random.PRNGKey(3))
    tok, cache = prefill_step(params, {"tokens": jnp.asarray(prompts)}, cache)
    want = [np.asarray(tok)]
    for _ in range(n - 1):
        tok, cache = decode_step(params, cache, tok[:, None])
        want.append(np.asarray(tok))
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    run = serve.generate(tm, lm, torch.from_numpy(prompts), n, keep_logits=True)
    np.testing.assert_array_equal(run.tokens.numpy(), np.stack(want, axis=1))
    bf16 = dataclasses.replace(tcfg, kv_cache_dtype="bf16")
    ref = serve.generate(build_model(bf16), lm_params_from_numpy(bf16, params_np, device="cpu"),
                         torch.from_numpy(prompts), n, keep_logits=True)
    gap = max(float((a - b).abs().max()) for a, b in zip(run.logits, ref.logits))
    assert 0 < gap, "the int8 cache changed no logit"


def test_hybrid_int8_keeps_a_bf16_cache_and_equals_the_bf16_run():
    """jamba SMOKE with ``kv_cache_dtype='int8'``: JAX's hybrid declares a
    bf16 cache and so does the port's (it no longer raises); the serving
    run's tokens and logits equal the bf16 configuration's."""
    _, tcfg = _configs("jamba-v0.1-52b")
    jcfg, tcfg8 = _int8(*_configs("jamba-v0.1-52b"))
    jinfos = JH.cache_infos(jcfg, 2, 40)
    tinfos = TH.cache_infos(tcfg8, 2, 40)
    assert jinfos["k"].dtype == jnp.bfloat16 and tinfos["k"].dtype == torch.bfloat16
    assert set(tinfos) == set(jinfos) - {"len"}
    params = materialize(build_model(tcfg).param_infos(), torch.Generator().manual_seed(1))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 16)))
    runs = []
    for cfg in (tcfg, tcfg8):
        model = build_model(cfg)
        runs.append(serve.generate(model, model.build(params), prompts, 6, keep_logits=True))
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert all(torch.equal(a, b) for a, b in zip(runs[0].logits, runs[1].logits))


@pytest.mark.parametrize("arch", [ARCH, "whisper-medium"])
def test_cache_from_numpy_checks_keys_shapes_and_dtypes(arch):
    """JAX's int8 KV cache (codes and scales) and encoder-decoder cache
    (self and cross K/V) carried across bit for bit; a missing or extra
    entry, a wrong shape or a wrong dtype raises, naming the entry."""
    jcfg, tcfg = _int8(*_configs(arch))
    B, T = 2, 10
    jcache = jax_materialize(jax_build(jcfg).cache_infos(B, T), jax.random.PRNGKey(0))
    jcache = jax.tree_util.tree_map(np.asarray, jcache)
    rng = np.random.default_rng(0)
    jcache["k"] = rng.integers(-127, 128, jcache["k"].shape).astype(jcache["k"].dtype)
    jcache["len"] = np.int32(3)
    got = cache_from_numpy(tcfg, jcache, batch=B, max_len=T, device="cpu")
    want_keys = ({"k", "v", "xk", "xv"} if arch == "whisper-medium"
                 else {"k", "v", "k_scale", "v_scale"})
    assert set(got) == want_keys | {"len"} and got["len"] == 3
    assert got["k"].dtype == (torch.bfloat16 if arch == "whisper-medium" else torch.int8)
    np.testing.assert_array_equal(got["k"].float().numpy(), jcache["k"].astype(np.float32))
    drop = sorted(want_keys)[-1]
    with pytest.raises(KeyError, match=drop):
        cache_from_numpy(tcfg, {k: v for k, v in jcache.items() if k != drop}, batch=B,
                         max_len=T, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        cache_from_numpy(tcfg, dict(jcache, h=np.zeros(1)), batch=B, max_len=T, device="cpu")
    with pytest.raises(KeyError, match="len"):
        cache_from_numpy(tcfg, {k: v for k, v in jcache.items() if k != "len"}, batch=B,
                         max_len=T, device="cpu")
    with pytest.raises(ValueError, match="/k: shape"):
        cache_from_numpy(tcfg, jcache, batch=B, max_len=T + 1, device="cpu")
    with pytest.raises(TypeError, match="/v: dtype"):
        cache_from_numpy(tcfg, dict(jcache, v=jcache["v"].astype(np.float32)), batch=B,
                         max_len=T, device="cpu")
