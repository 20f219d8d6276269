"""Port: the dense LM (``repro_torch.models``) against the JAX models.

Weights come from the JAX package's ``materialize`` (or, for the bf16
logits, from the port's) and are carried across with
``convert.lm_params_from_numpy``; inputs are seeded numpy arrays. The
JAX steps run jitted without a mesh (the JAX serving driver's host-mesh
path raises a ShardingTypeError on a CPU host, see ROADMAP Queue 3). On
the CPU the port's attention runs the kernel's plain version.
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
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.distributed.serve_step import greedy_generate
from repro_torch.launch import serve
from repro_torch.models import build_model, materialize
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import hybrid as TH
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as TT
from repro_torch.models.params import ParamInfo, map_infos

DENSE = ["tinyllama-1.1b", "llama3.2-3b", "starcoder2-7b", "qwen2-72b"]
#: float32 compute: sums in another order, through two layers and the head
F32_TOL = dict(atol=1e-5, rtol=1e-5)
#: bf16 compute, one layer on unit-scale inputs: a few bf16 roundings apart
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _configs(arch, compute="bfloat16"):
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    if compute == "float32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    return jcfg, tcfg


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _layer_params(jcfg, infos_fn, seed):
    """One layer's parameters, for JAX and for the port: the JAX init of the
    unstacked declaration (fan-in scale, so unit-scale inputs stay unit
    scale), with noise on the constant ones (norm scales, biases)."""
    p = jax_materialize(infos_fn(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(a) + (0.1 * rng.normal(size=a.shape).astype(np.float32)
                             if np.all(np.asarray(a) == np.asarray(a).flat[0]) else 0)
         for k, a in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
# rmsnorm with swiglu, layernorm with gelu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "starcoder2-7b"])
def test_norm_rope_mlp_match_jax(arch, compute):
    jcfg, tcfg = _configs(arch, compute)
    tol = F32_TOL if compute == "float32" else BF16_TOL
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jcfg.compute_dtype), torch.from_numpy(x).to(tcfg.compute_dtype)

    jp, tp = _layer_params(jcfg, JL.norm_infos, 2)
    np.testing.assert_allclose(_np(TL.norm_apply(tp, tx, tcfg)), _np(JL.norm_apply(jp, jx, jcfg)),
                               **tol)

    pos = np.arange(5, 14)
    h = rng.normal(size=(2, 9, 3, jcfg.d_head)).astype(np.float32)
    got = TL.rope(torch.from_numpy(h).to(tcfg.compute_dtype), torch.from_numpy(pos),
                  tcfg.rope_theta)
    want = JL.rope(jnp.asarray(h, jcfg.compute_dtype), jnp.asarray(pos), jcfg.rope_theta)
    np.testing.assert_allclose(_np(got), _np(want), **tol)

    jp, tp = _layer_params(jcfg, JL.mlp_infos, 3)
    want = JL.mlp_apply(jp, jx, jcfg)
    got = TL.mlp_apply(tp, tx, tcfg)
    assert got.dtype == tcfg.compute_dtype
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **tol)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-72b"])  # without and with qkv bias
def test_attention_apply_matches_jax(arch, cached, compute):
    jcfg, tcfg = _configs(arch, compute)
    tol = F32_TOL if compute == "float32" else BF16_TOL
    rng = np.random.default_rng(4)
    B, S, T, idx = 2, 7, 24, 9
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jcfg.compute_dtype), torch.from_numpy(x).to(tcfg.compute_dtype)
    jp, tp = _layer_params(jcfg, JL.attention_infos, 5)
    pos = np.arange(idx, idx + S) if cached else np.arange(S)
    jcache = tcache = None
    if cached:  # earlier rows hold values, rows past idx + S garbage that must stay unread
        kv = rng.normal(size=(2, B, T, jcfg.n_kv_heads, jcfg.d_head)).astype(np.float32)
        kv[:, :, idx + S:] = 1e4
        jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in kv)
        jcache = {"k": jk, "v": jv, "len": jnp.int32(idx)}
        tcache = {"k": tensor_from_numpy(np.asarray(jk), "cpu"),
                  "v": tensor_from_numpy(np.asarray(jv), "cpu"), "len": idx}
    want, jnew = JL.attention_apply(jp, jx, jcfg, positions=jnp.asarray(pos), cache=jcache)
    got, tnew = TL.attention_apply(tp, tx, tcfg, positions=torch.from_numpy(pos), cache=tcache)
    assert got.dtype == tcfg.compute_dtype and tuple(got.shape) == (B, S, jcfg.d_model)
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **tol)
    if cached:
        assert tnew["len"] == idx + S and tnew["k"] is tcache["k"]  # written in place
        for name in ("k", "v"):
            if compute == "float32":  # one rounding of float32 values to bf16
                assert_bf16_ulp_close(tnew[name], jnew[name])
            else:
                np.testing.assert_allclose(_np(tnew[name]), _np(jnew[name]), **tol)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_chunked_attention_matches_jax(compute):
    """The JAX models' attention, ported as a plain function (not on the
    path): bf16 scores and weights included."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 40, 2, 3, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 50, 2, 16)).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)
    kw = dict(causal=True, q_offset=10, kv_valid=50, chunk=16)
    want = JL.chunked_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), **kw)
    got = TL.chunked_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    tol = F32_TOL if compute == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _jax_lm(jcfg, seed=0):
    model = jax_build(jcfg)
    params = jax_materialize(model.param_infos(), jax.random.PRNGKey(seed))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _port_weights_lm(jcfg, tcfg, seed=0):
    """(JAX model, params, numpy params) with the weights the port draws
    (one layer's fan-in), carried to JAX as numpy arrays."""
    model = jax_build(jcfg)
    drawn = materialize(build_model(tcfg).param_infos(), torch.Generator().manual_seed(seed))
    params_np = jax.tree_util.tree_map(lambda t: t.numpy(), drawn)
    return model, jax.tree_util.tree_map(jnp.asarray, params_np), params_np


def _prefill_decode(arch, compute, seed=0, B=2, S=16, port_weights=False):
    """(JAX, port) logits of the prefill and one decode step on the same
    weights, tokens and zero cache, and both caches after the decode.
    The weights are JAX's draw, or the port's with ``port_weights``."""
    jcfg, tcfg = _configs(arch, compute)
    jm, params, params_np = (_port_weights_lm(jcfg, tcfg, seed) if port_weights
                             else _jax_lm(jcfg, seed))
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    cache = jax_materialize(jm.cache_infos(B, S + 8), jax.random.PRNGKey(seed))
    jl1, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S])}, cache)
    jl2, jc = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, S:]))
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    tc = tm.init_cache(B, S + 8, device="cpu")
    tl1, tc = tm.prefill(lm, {"tokens": torch.from_numpy(toks[:, :S])}, tc)
    tl2, tc = tm.decode_step(lm, tc, torch.from_numpy(toks[:, S:]))
    return (jl1, jl2, jc), (tl1, tl2, tc)


def assert_bf16_ulp_close(got, want):
    """bf16 caches written from float32 values that differ by float32 noise:
    within one bf16 ulp of the larger magnitude, or within 1e-4 where a
    value is so near zero that the noise of its float32 sum (dozens of
    unit-scale terms) spans several of its ulps."""
    a, b = _np(got), _np(want)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(a - b) > np.maximum(ulp, 1e-4)
    assert not bad.any(), f"{bad.sum()} cache entries apart, e.g. {a[bad][:4]} vs {b[bad][:4]}"


@pytest.mark.parametrize("arch", DENSE)
def test_lm_float32_logits_and_cache_match_jax(arch):
    (jl1, jl2, jc), (tl1, tl2, tc) = _prefill_decode(arch, "float32")
    for got, want in ((tl1, jl1), (tl2, jl2)):
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert tc["len"] == int(jc["len"]) == 17
    for name in ("k", "v"):
        assert tc[name].dtype == torch.bfloat16
        assert_bf16_ulp_close(tc[name], jc[name])


#: bf16 compute through the whole LM: logits within 2e-2 of their scale
BF16_LOGITS_TOL = 2e-2


def _bf16_logits_gap(arch) -> float:
    """max |port - JAX| of the bf16 prefill and decode logits over the JAX
    logits' max |.|, on the port's weights."""
    (jl1, jl2, _), (tl1, tl2, _) = _prefill_decode(arch, "bfloat16", port_weights=True)
    assert tl1.dtype == tl2.dtype == torch.bfloat16
    return max(float(np.abs(_np(t) - _np(j)).max()) / float(np.abs(_np(j)).max())
               for t, j in ((tl1, jl1), (tl2, jl2)))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama3.2-3b"])
def test_lm_bf16_logits_match_jax(arch):
    """bf16 compute on the port's weights (one layer's fan-in, carried to
    both packages): the port's prefill and decode logits within 2e-2 of
    their scale of JAX's. The two round at other places (JAX's attention
    rounds its scores and weights to bf16, the port's kernel keeps them in
    float32), a few bf16 ulps of the logits."""
    gap = _bf16_logits_gap(arch)
    print(f"{arch}: bf16 logits, port vs JAX, {gap:.4g} of their scale")
    assert gap <= BF16_LOGITS_TOL, gap


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama3.2-3b"])
def test_bf16_logits_limit_rejects_fp8_residual(arch, monkeypatch):
    """Control for the limit above: a port that rounds its residual stream
    to float8 (e4m3) after every layer, a precision below bf16, fails it."""
    forward = TT.DecoderLayer.forward
    monkeypatch.setattr(TT.DecoderLayer, "forward", lambda self, x, **kw: forward(
        self, x, **kw).to(torch.float8_e4m3fn).to(x.dtype))
    gap = _bf16_logits_gap(arch)
    print(f"{arch}: bf16 logits with a float8 residual, port vs JAX, {gap:.4g} of their scale")
    assert gap > BF16_LOGITS_TOL, gap


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama3.2-3b"])
def test_greedy_tokens_match_jax(arch):
    """8 greedy tokens for 2 requests with a 16-token prompt at float32
    compute: the serving driver's loop (``launch.serve.generate``) and the
    library's ``greedy_generate`` against the JAX serving steps jitted
    without a mesh."""
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
    run = serve.generate(tm, lm, torch.from_numpy(prompts), n)
    assert tuple(run.tokens.shape) == (B, n) and len(run.decode_s) == n - 1
    np.testing.assert_array_equal(run.tokens.numpy(), np.stack(want, axis=1))
    got, tc = greedy_generate(tm, lm, {"tokens": torch.from_numpy(prompts)},
                              tm.init_cache(B, S + n, device="cpu"), n)
    assert tc["len"] == S + n - 1
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_lm_params_from_numpy_checks_keys_and_shapes():
    jcfg, tcfg = _configs("llama3.2-3b")
    _, _, p = _jax_lm(jcfg)
    assert "lm_head" not in p  # tied embeddings
    lm = lm_params_from_numpy(tcfg, p, device="cpu")
    assert torch.equal(lm.embed, torch.from_numpy(np.array(p["embed"])))
    wq1 = np.array(p["layers"]["attn"]["wq"][1])
    assert torch.equal(lm.layers[1].attn.wq, torch.from_numpy(wq1))
    missing = dict(p, layers=dict(p["layers"], attn={k: v for k, v in p["layers"]["attn"].items()
                                                     if k != "wv"}))
    with pytest.raises(KeyError, match="wv"):
        lm_params_from_numpy(tcfg, missing, device="cpu")
    with pytest.raises(KeyError, match="lm_head"):
        lm_params_from_numpy(tcfg, dict(p, lm_head=np.zeros((64, 256), np.float32)),
                             device="cpu")
    wrong = dict(p, ln_f={"scale": np.ones(65, np.float32)})
    with pytest.raises(ValueError, match="ln_f/scale"):
        lm_params_from_numpy(tcfg, wrong, device="cpu")
    bf = np.asarray(jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16))
    assert torch.equal(tensor_from_numpy(bf, torch.device("cpu")).float(),
                       torch.from_numpy(bf.astype(np.float32)))


def test_param_declarations_and_init_rules_match_jax():
    """Same tree, shapes and dtypes as the JAX declaration, and the same init
    rules (truncated normal on +-2 sigma times the fan-in scale, embed 0.02,
    ones/zeros), drawn from the generator reproducibly. A stacked layer
    weight takes the fan-in of one layer's weight, as JAX gives an unstacked
    one (JAX's stacked draw takes the layer count instead: ROADMAP Queue 3)."""
    jcfg, tcfg = _configs("starcoder2-7b")
    jinfos = jax_build(jcfg).param_infos()
    tinfos = build_model(tcfg).param_infos()
    shapes = lambda t: map_infos(lambda i: (i.shape, str(i.dtype).split(".")[-1]), t)  # noqa: E731
    jshapes = jax.tree_util.tree_map(lambda i: (i.shape, str(np.dtype(i.dtype))), jinfos,
                                     is_leaf=lambda x: hasattr(x, "init"))
    assert shapes(tinfos) == jshapes
    key = jax.random.PRNGKey(0)
    jp = jax.tree_util.tree_map(np.asarray, jax_materialize(jinfos, key))
    jlayer = jax.tree_util.tree_map(np.asarray, jax_materialize(JT.layer_infos(jcfg), key))
    tp = materialize(tinfos, torch.Generator().manual_seed(0))
    tp2 = materialize(tinfos, torch.Generator().manual_seed(0))

    def check(info: ParamInfo, t, t2, j, fan_in):
        assert torch.equal(t, t2)
        if info.init in ("ones", "zeros"):
            assert torch.equal(t, torch.from_numpy(np.broadcast_to(j, t.shape).copy()))
            return
        bound = 2 * (info.scale or 1 / np.sqrt(fan_in))
        assert float(t.abs().max()) <= bound * (1 + 1e-6)
        assert abs(float(t.std()) - float(j.std())) <= 0.1 * float(j.std())

    for name in ("embed", "lm_head"):
        check(tinfos[name], tp[name], tp2[name], jp[name], tinfos[name].shape[0])
    for blk in tinfos["layers"]:
        for name, info in tinfos["layers"][blk].items():
            check(info, tp["layers"][blk][name], tp2["layers"][blk][name], jlayer[blk][name],
                  info.shape[1] if len(info.shape) > 2 else 1)


def test_other_families_and_options_raise():
    """Every family is ported: the dense family, rwkv6 (family ssm), jamba
    (family hybrid), the MoE archs, whisper (encdec) and internvl (vlm)
    build, MoE layers on the dense LM and the int8 cache too; the dense LM
    takes a sliding window. An unknown arch id or family raises."""
    _, tcfg = _configs("tinyllama-1.1b")
    rwkv = get_config("rwkv6-7b")
    assert rwkv.family == "ssm" and (rwkv.n_layers, rwkv.d_model) == (32, 4096)
    assert get_config("rwkv6-7b", smoke=True).rwkv_head_size == 16
    assert isinstance(build_model(get_config("rwkv6-7b", smoke=True)).init(device="cpu"),
                      TR.RWKVLM)
    jamba = get_config("jamba-v0.1-52b")
    assert jamba.family == "hybrid" and (jamba.n_layers, jamba.d_model) == (32, 4096)
    assert (jamba.sliding_window, jamba.moe_experts, jamba.moe_topk) == (32768, 16, 2)
    smoke = get_config("jamba-v0.1-52b", smoke=True)
    hybrid_lm = build_model(smoke).init(device="cpu")
    assert isinstance(hybrid_lm, TH.HybridLM)
    logits, _ = hybrid_lm(torch.zeros(1, 4, dtype=torch.long))
    assert tuple(logits.shape) == (1, 4, 256) and bool(torch.isfinite(logits.float()).all())
    for arch, family in (("moonshot-v1-16b-a3b", "moe"), ("kimi-k2-1t-a32b", "moe"),
                         ("whisper-medium", "encdec"), ("internvl2-2b", "vlm")):
        assert get_config(arch).family == family
        lm = build_model(get_config(arch, smoke=True)).init(device="cpu")
        assert isinstance(lm, TE.EncDecLM if family == "encdec" else TT.TransformerLM)
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-5")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(tcfg, family="diffusion"))
    assert isinstance(build_model(dataclasses.replace(tcfg, family="hybrid", n_layers=8,
                                                      moe_experts=0)).init(device="cpu"),
                      TH.HybridLM)
    moe_lm = build_model(dataclasses.replace(tcfg, moe_experts=4, moe_topk=2,
                                             moe_dff=32)).init(device="cpu")
    assert all(hasattr(layer, "moe") and not hasattr(layer, "mlp") for layer in moe_lm.layers)
    int8 = build_model(dataclasses.replace(tcfg, kv_cache_dtype="int8")).init_cache(
        1, 4, device="cpu")
    assert int8["k"].dtype == torch.int8 and int8["k_scale"].dtype == torch.bfloat16
    hybrid_int8 = build_model(dataclasses.replace(smoke, kv_cache_dtype="int8")).init_cache(
        1, 4, device="cpu")
    assert hybrid_int8["k"].dtype == torch.bfloat16  # JAX's hybrid keeps a bf16 cache
    # the windowed dense LM runs: its first 8 positions see what the full
    # attention sees, the later ones do not
    windowed = dataclasses.replace(tcfg, sliding_window=8)
    params = materialize(build_model(windowed).param_infos(), torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 12)))
    logits, _ = build_model(windowed).build(params)(tokens)
    full, _ = build_model(tcfg).build(params)(tokens)
    assert tuple(logits.shape) == (1, 12, 256) and bool(torch.isfinite(logits.float()).all())
    assert torch.equal(logits[:, :8], full[:, :8]) and not torch.equal(logits[:, 8:], full[:, 8:])
