"""Port: the Whisper encoder-decoder (``repro_torch.models.encdec``),
cross-attention and the encoder's bidirectional attention against the JAX
package.

SMOKE configuration of whisper-medium (2 encoder and 2 decoder layers,
d_model 64, 16 audio frames, layernorm, GELU, qkv biases). Weights are
the port's draw as a numpy tree, handed to JAX and carried across with
``convert.lm_params_from_numpy``: JAX's own SMOKE draw takes the stacked
layer count (2) as every matrix's fan-in, std ~0.7, and its near one-hot
softmaxes amplify float32 summation order to 1e-4 of the logits (2e-5 of
the encoder output) between any two routes (ROADMAP Queue 3), where the
port's draw keeps the two packages within 2e-6. The frame embeddings and
tokens are seeded numpy arrays. Compared: ``encode``'s output,
``fill_cross_kv``'s bf16 cross K/V, the logits of ``Model.prefill`` and
``decode_step`` and of the teacher-forced ``forward``, the caches, and the
greedy tokens of the serving loops. Tolerances are test_torch_models.py's:
``F32_TOL`` at float32 compute, one bf16 ulp for bf16 caches written from
float32 values, ``CACHE_TOL`` of the logits' scale for float32 compute
through each package's own bf16 caches, ``BF16_TOL`` for one layer and ``BF16_LOGITS_TOL`` of the
logits' scale at bf16. On the CPU attention runs the kernel's plain
version, non-causal for the encoder and the cross-attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.distributed.serve_step import make_serve_steps as jax_serve_steps
from repro.models import build_model as jax_build
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import materialize as jax_materialize
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import flash_attention as kf
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from test_torch_models import (BF16_LOGITS_TOL, BF16_TOL, F32_TOL, _configs, _layer_params, _np,
                               _port_weights_lm, assert_bf16_ulp_close)
from test_torch_moe_lm import _shapes_and_dtypes

ARCH = "whisper-medium"
#: float32 compute through each package's own bf16 caches (test_torch_hybrid.py)
CACHE_TOL = 1e-4


def _audio(jcfg, B, seed):
    return np.random.default_rng(seed).normal(size=(B, jcfg.enc_seq, jcfg.d_model)).astype(
        np.float32)


def test_full_config_declares_jax_shapes():
    """24 + 24 layers at d_model 1024 over 1500 frames: JAX's parameter
    tree, shapes and dtypes, and JAX's cache (bf16 cross K/V of 1500 rows,
    bf16 self K/V even when an int8 cache is asked for)."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    assert (tcfg.family, tcfg.enc_layers, tcfg.n_layers, tcfg.enc_seq) == ("encdec", 24, 24, 1500)
    got, want = _shapes_and_dtypes(build_model(tcfg).param_infos(),
                                   jax_build(jcfg).param_infos())
    assert got == want
    tc = build_model(tcfg).cache_infos(8, 448)
    jc = jax_build(jcfg).cache_infos(8, 448)
    assert {k: (i.shape, i.dtype) for k, i in tc.items()} == {
        "k": ((24, 8, 576, 16, 64), torch.bfloat16), "v": ((24, 8, 576, 16, 64), torch.bfloat16),
        "xk": ((24, 8, 1500, 16, 64), torch.bfloat16),
        "xv": ((24, 8, 1500, 16, 64), torch.bfloat16)}
    assert {k: i.shape for k, i in jc.items() if k != "len"} == {k: i.shape for k, i in tc.items()}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_noncausal_attention_without_rope_matches_jax(compute):
    """The encoder's self-attention alone (``causal=False, rope_on=False``)
    on a ragged 23 frames."""
    jcfg, tcfg = _configs(ARCH, compute)
    tol = F32_TOL if compute == "float32" else BF16_TOL
    jp, tp = _layer_params(jcfg, JL.attention_infos, 7)
    x = np.random.default_rng(7).normal(size=(2, 23, jcfg.d_model)).astype(np.float32)
    pos = np.arange(23)
    want, _ = JL.attention_apply(jp, jnp.asarray(x, jcfg.compute_dtype), jcfg,
                                 positions=jnp.asarray(pos), causal=False, rope_on=False)
    got, _ = TL.attention_apply(tp, torch.from_numpy(x).to(tcfg.compute_dtype), tcfg,
                                positions=torch.from_numpy(pos), causal=False, rope_on=False)
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **tol)
    causal, _ = TL.attention_apply(tp, torch.from_numpy(x).to(tcfg.compute_dtype), tcfg,
                                   positions=torch.from_numpy(pos), rope_on=False)
    assert float((causal.float() - got.float()).abs().max()) > 10 * tol["atol"] * scale


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 9])
def test_cross_attention_and_encoder_kv_match_jax(S, compute):
    """``encoder_kv`` on a 21-frame encoder output, then
    ``cross_attention_apply`` of S decoder positions on it (decode: S = 1);
    at float32 also on the bf16 rounding of the K/V, as the cache holds
    them (JAX casts them to float32; the port hands the bf16 rows to the
    kernel, whose plain version reads them as float32)."""
    jcfg, tcfg = _configs(ARCH, compute)
    tol = F32_TOL if compute == "float32" else BF16_TOL
    jp, tp = _layer_params(jcfg, JL.attention_infos, 8)
    rng = np.random.default_rng(8)
    enc = rng.normal(size=(2, 21, jcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    jdt, tdt = jcfg.compute_dtype, tcfg.compute_dtype
    jkv = JL.encoder_kv(jp, jnp.asarray(enc, jdt), jcfg)
    tkv = TL.encoder_kv(tp, torch.from_numpy(enc).to(tdt), tcfg)
    for g, w in zip(tkv, jkv):
        assert g.dtype == tdt and tuple(g.shape) == (2, 21, jcfg.n_kv_heads, jcfg.d_head)
        scale = float(np.abs(_np(w)).max())
        np.testing.assert_allclose(_np(g) / scale, _np(w) / scale, **tol)
    cases = [(jkv, tkv)]
    if compute == "float32":
        cases.append((tuple(a.astype(jnp.bfloat16) for a in jkv),
                      tuple(t.to(torch.bfloat16) for t in tkv)))
    for jk, tk in cases:
        want = JL.cross_attention_apply(jp, jnp.asarray(x, jdt), jcfg, jk)
        got = TL.cross_attention_apply(tp, torch.from_numpy(x).to(tdt), tcfg, tk)
        assert got.dtype == tdt and tuple(got.shape) == (2, S, jcfg.d_model)
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **tol)


def _decode_chain(jm, tm, params, lm, jcache, tcache, toks, S, steps=2):
    """The prompt toks[:, :S] through ``decode`` with the cache, then
    ``steps`` decode steps, in both packages: (JAX logits, port logits,
    JAX cache, port cache)."""
    jl, jc = jax.jit(lambda p, c, t: JE.decode(p, jm.cfg, t, cache=c, last_only=True))(
        params, jcache, jnp.asarray(toks[:, :S]))
    tl, tc = lm.decode(torch.from_numpy(toks[:, :S]), cache=tcache, last_only=True)
    want, got = [jl], [tl]
    for t in range(steps):
        jl, jc = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, S + t:S + t + 1]))
        tl, tc = tm.decode_step(lm, tc, torch.from_numpy(toks[:, S + t:S + t + 1]))
        want.append(jl)
        got.append(tl)
    return want, got, jc, tc


def test_encode_fill_prefill_decode_match_jax():
    """At float32 compute: ``encode`` within F32_TOL; ``fill_cross_kv``'s
    bf16 cross K/V within one bf16 ulp of JAX's; from JAX's filled cache
    (carried across), the prompt and two ``decode_step`` calls with logits
    within F32_TOL, the self K/V within one bf16 ulp and ``len`` equal;
    ``decode`` without a cache and the teacher-forced ``forward`` within
    F32_TOL. End to end, ``Model.prefill`` (encode, fill, decode the
    prompt) and the decode steps from each package's own caches stay within
    CACHE_TOL of the logits' scale: a float32 K/V value a few ulps from a
    bf16 rounding midpoint rounds to neighbouring bf16 values in the two
    packages (as test_torch_hybrid.py's docstring measures)."""
    jcfg, tcfg = _configs(ARCH, "float32")
    jm, params, params_np = _port_weights_lm(jcfg, tcfg, seed=2)
    tm = build_model(tcfg)
    B, S = 2, 12
    audio = _audio(jcfg, B, 2)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (B, S + 2)).astype(np.int32)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    assert isinstance(lm, TE.EncDecLM)

    want_enc = JE.encode(params, jcfg, jnp.asarray(audio))
    got_enc = lm.encode(torch.from_numpy(audio))
    np.testing.assert_allclose(_np(got_enc), _np(want_enc), **F32_TOL)

    jzero = jax_materialize(jm.cache_infos(B, S + 4), jax.random.PRNGKey(0))
    tc = cache_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jzero), batch=B,
                          max_len=S + 4, device="cpu")
    jfilled = JE.fill_cross_kv(params, jcfg, jzero, want_enc)
    assert lm.fill_cross_kv(tc, got_enc) is tc
    for name in ("xk", "xv"):
        assert tc[name].dtype == torch.bfloat16
        assert_bf16_ulp_close(tc[name], jfilled[name])

    tc = cache_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jfilled), batch=B,
                          max_len=S + 4, device="cpu")
    want, got, jc, tc = _decode_chain(jm, tm, params, lm, jfilled, tc, toks, S)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape) == (B, 1, 256)
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)
    assert tc["len"] == int(jc["len"]) == S + 2
    for name in ("k", "v"):
        assert_bf16_ulp_close(tc[name], jc[name])

    batch = {"tokens": toks[:, :S], "audio_embeds": audio}
    jl, jc = jax.jit(jm.prefill)(params, {k: jnp.asarray(v) for k, v in batch.items()}, jzero)
    tl, tc = tm.prefill(lm, {k: torch.from_numpy(v) for k, v in batch.items()},
                        tm.init_cache(B, S + 4, device="cpu"))
    got, want = [tl], [jl]
    for t in range(2):
        jl, jc = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, S + t:S + t + 1]))
        tl, tc = tm.decode_step(lm, tc, torch.from_numpy(toks[:, S + t:S + t + 1]))
        got.append(tl)
        want.append(jl)
    for g, w in zip(got, want):
        assert float(np.abs(_np(g) - _np(w)).max()) <= CACHE_TOL * float(np.abs(_np(w)).max())
    for name in ("k", "v", "xk", "xv"):
        assert_bf16_ulp_close(tc[name], jc[name])

    want_dec, _ = JE.decode(params, jcfg, jnp.asarray(toks), enc_out=want_enc)
    got_dec, _ = lm.decode(torch.from_numpy(toks), enc_out=got_enc)
    np.testing.assert_allclose(_np(got_dec), _np(want_dec), **F32_TOL)
    want_fw, _ = JE.forward(params, jcfg, jnp.asarray(toks), audio_embeds=jnp.asarray(audio))
    got_fw, _ = lm(torch.from_numpy(toks), audio_embeds=torch.from_numpy(audio))
    np.testing.assert_allclose(_np(got_fw), _np(want_fw), **F32_TOL)
    with pytest.raises(ValueError, match="encoder output"):
        lm.decode(torch.from_numpy(toks))


def test_encdec_greedy_tokens_match_jax():
    """8 greedy tokens for 2 requests of 16 at float32 compute:
    ``serve.generate`` with the frame embeddings against the JAX serving
    steps jitted without a mesh; the flash kernel is never launched on the
    CPU."""
    jcfg, tcfg = _configs(ARCH, "float32")
    jm, params, params_np = _port_weights_lm(jcfg, tcfg, seed=3)
    B, S, n = 2, 16, 8
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    audio = _audio(jcfg, B, 3)
    prefill_step, decode_step = (jax.jit(f) for f in jax_serve_steps(jm))
    cache = jax_materialize(jm.cache_infos(B, S + n), jax.random.PRNGKey(3))
    tok, cache = prefill_step(params, {"tokens": jnp.asarray(prompts),
                                       "audio_embeds": jnp.asarray(audio)}, cache)
    want = [np.asarray(tok)]
    for _ in range(n - 1):
        tok, cache = decode_step(params, cache, tok[:, None])
        want.append(np.asarray(tok))
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    kf.reset_launches()
    run = serve.generate(tm, lm, torch.from_numpy(prompts), n,
                         extras={"audio_embeds": torch.from_numpy(audio)})
    np.testing.assert_array_equal(run.tokens.numpy(), np.stack(want, axis=1))
    assert not kf.LAUNCHES


def test_encdec_bf16_logits_match_jax():
    """bf16 compute on the port's weights carried to JAX: prefill and decode
    logits within BF16_LOGITS_TOL of their scale of JAX's."""
    jcfg, tcfg = _configs(ARCH, "bfloat16")
    jm, params, params_np = _port_weights_lm(jcfg, tcfg, seed=4)
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    B, S = 2, 16
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    audio = _audio(jcfg, B, 4)
    jl1, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S]),
                                           "audio_embeds": jnp.asarray(audio, jnp.bfloat16)},
                                  jax_materialize(jm.cache_infos(B, S + 8),
                                                  jax.random.PRNGKey(0)))
    jl2, _ = jax.jit(jm.decode_step)(params, jc, jnp.asarray(toks[:, S:]))
    tl1, tc = tm.prefill(lm, {"tokens": torch.from_numpy(toks[:, :S]),
                              "audio_embeds": torch.from_numpy(audio).bfloat16()},
                         tm.init_cache(B, S + 8, device="cpu"))
    tl2, _ = tm.decode_step(lm, tc, torch.from_numpy(toks[:, S:]))
    assert tl1.dtype == tl2.dtype == torch.bfloat16
    gap = max(float(np.abs(_np(t) - _np(j)).max()) / float(np.abs(_np(j)).max())
              for t, j in ((tl1, jl1), (tl2, jl2)))
    print(f"{ARCH}: bf16 logits, port vs JAX, {gap:.4g} of their scale")
    assert gap <= BF16_LOGITS_TOL, gap
