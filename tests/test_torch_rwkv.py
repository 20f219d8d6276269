"""Port: RWKV6 (``repro_torch.models.rwkv``) against the JAX model.

SMOKE configuration (2 layers, d_model 64, head size 16). Weights come from
the JAX package's ``materialize`` and are carried across with
``convert.lm_params_from_numpy``; inputs are seeded numpy arrays. At JAX's
init ``w_lora_b`` is zeros and ``w_base`` the constant -2, so the decay
would be the same in every channel and at every token: a WKV that read the
decay at the wrong channel or token, or a LoRA never applied, would pass.
So every test perturbs both leaves first (``w_base`` uniform on [-6, 1],
``w_lora_b`` ~ N(0, 0.1^2)), and ``test_parity_sees_the_decay`` shows that
such faults then fail the float32 parity limit. On the CPU the WKV runs the
kernel's plain version.
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
from repro.models import rwkv as JR
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy, tensor_from_numpy
from repro_torch.distributed.serve_step import greedy_generate
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import rwkv as TR

ARCH = "rwkv6-7b"
#: float32 compute: max |port - JAX| within 1e-5 of the JAX output's max |.|
F32_TOL = 1e-5
#: bf16 compute through the whole LM: logits within 2e-2 of their scale
BF16_LOGITS_TOL = 2e-2
#: decode with the cache against the full forward, float32 (as
#: tests/test_models_decode.py holds the JAX model)
CHAIN_TOL = 1e-3


def _configs(compute="float32"):
    jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if compute == "float32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    return jcfg, tcfg


def _perturb_decay(time: dict, rng) -> None:
    """``w_base`` uniform on [-6, 1] and ``w_lora_b`` ~ N(0, 0.1^2), in place
    on a numpy time-mix tree (one layer's or stacked)."""
    time["w_base"] = rng.uniform(-6.0, 1.0, time["w_base"].shape).astype(np.float32)
    time["w_lora_b"] = (0.1 * rng.normal(size=time["w_lora_b"].shape)).astype(np.float32)


def _gap(got, want) -> float:
    """max |got - want| over max |want|."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max()) / float(np.abs(w).max())


def _jax_params(jcfg, seed=0):
    """(JAX model, JAX params, numpy params): JAX's init with the decay
    perturbed."""
    model = jax_build(jcfg)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a), jax_materialize(model.param_infos(), jax.random.PRNGKey(seed)))
    _perturb_decay(params["layers"]["time"], np.random.default_rng(seed))
    return model, jax.tree_util.tree_map(jnp.asarray, params), params


def _layer_params(jcfg, seed):
    """One layer's parameters for both packages: JAX's init of the unstacked
    declaration, the decay perturbed and the constant leaves (norm scales
    and biases, the group norm's scale) given noise."""
    p = jax.tree_util.tree_map(np.array, jax_materialize(JR.layer_infos(jcfg),
                                                         jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    _perturb_decay(p["time"], rng)
    for blk, name in (("ln1", "scale"), ("ln1", "bias"), ("ln2", "scale"), ("ln2", "bias"),
                      ("time", "gn_scale")):
        p[blk][name] = p[blk][name] + (0.1 * rng.normal(size=p[blk][name].shape)).astype(
            np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, p),
            {blk: {k: torch.from_numpy(v) for k, v in d.items()} for blk, d in p.items()})


def _state(jcfg, B, rng):
    """A nonzero layer state: a WKV state and two shift rows (bf16, as the
    cache holds them)."""
    H, dh = jcfg.d_model // jcfg.rwkv_head_size, jcfg.rwkv_head_size
    wkv = rng.normal(size=(B, H, dh, dh)).astype(np.float32)
    st, sc = (np.asarray(jnp.asarray(rng.normal(size=(B, jcfg.d_model)), jnp.bfloat16))
              for _ in range(2))
    return ({"wkv": jnp.asarray(wkv), "shift_t": jnp.asarray(st), "shift_c": jnp.asarray(sc)},
            {"wkv": tensor_from_numpy(wkv, "cpu"), "shift_t": tensor_from_numpy(st, "cpu"),
             "shift_c": tensor_from_numpy(sc, "cpu"), "len": 0})


@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("block", ["time_mix", "channel_mix", "layer"])
def test_blocks_match_jax(block, stateful):
    """time_mix, channel_mix and one layer at float32 compute, from a zero
    state or a nonzero one, outputs and new states."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    jp, tp = _layer_params(jcfg, 4)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    js, ts = _state(jcfg, 2, rng) if stateful else (None, None)
    if block == "time_mix":
        jst = None if js is None else {"wkv": js["wkv"], "shift": js["shift_t"]}
        tst = None if ts is None else {"wkv": ts["wkv"], "shift": ts["shift_t"]}
        want, wnew = JR.time_mix(jp["time"], jx, jcfg, jst)
        got, gnew = TR.time_mix(tp["time"], tx, tcfg, tst)
        pairs = [("wkv", "wkv"), ("shift", "shift")]
    elif block == "channel_mix":
        jst = None if js is None else {"shift": js["shift_c"]}
        tst = None if ts is None else {"shift": ts["shift_c"]}
        want, wnew = JR.channel_mix(jp["channel"], jx, jcfg, jst)
        got, gnew = TR.channel_mix(tp["channel"], tx, tcfg, tst)
        pairs = [("shift", "shift")]
    else:
        tst = None if ts is None else {n: ts[n] for n in ("wkv", "shift_t", "shift_c")}
        want, wnew = JR._layer_apply(jp, jx, jcfg, js)
        got, gnew = TR._layer_apply(tp, tx, tcfg, tst)
        pairs = [("wkv", "wkv"), ("shift_t", "shift_t"), ("shift_c", "shift_c")]
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    assert _gap(got, want) <= F32_TOL
    for g, w in pairs:
        assert _gap(gnew[g], wnew[w]) <= F32_TOL, g


def test_time_mix_keeps_the_decay_leaves_float32():
    """At bf16 compute the decay's leaves, the bonus and the group norm's
    scale stay float32 masters (JAX uses them uncast); the mix and the
    projections are cast; the norms keep scale and bias."""
    lm = build_model(get_config(ARCH, smoke=True)).init(device="cpu")
    layer = lm.layers[1]
    for name in ("w_base", "w_lora_a", "w_lora_b", "bonus", "gn_scale"):
        assert layer.time.c[name].dtype == torch.float32, name
        assert layer.time.c[name].data_ptr() == getattr(layer.time, name).data_ptr()
    for name in ("mix", "wr", "wk", "wv", "wg", "wo"):
        assert layer.time.c[name].dtype == torch.bfloat16, name
    for name in ("mix", "wk", "wv", "wr"):
        assert layer.channel.c[name].dtype == torch.bfloat16, name
    assert layer.ln1.c["scale"].dtype == layer.ln2.c["bias"].dtype == torch.float32
    assert lm.c["lm_head"].dtype == torch.bfloat16


def _prefill_decode(compute, seed=0, B=2, S=16, port_edit=None):
    """(JAX, port) logits of the prefill and one decode step on the same
    weights, tokens and zero cache, and both caches after the decode.
    ``port_edit`` may change the port's copy of the numpy weights."""
    jcfg, tcfg = _configs(compute)
    jm, params, params_np = _jax_params(jcfg, seed)
    if port_edit is not None:
        params_np = jax.tree_util.tree_map(np.array, params_np)
        port_edit(params_np)
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


def test_lm_float32_logits_and_cache_match_jax():
    (jl1, jl2, jc), (tl1, tl2, tc) = _prefill_decode("float32")
    for got, want in ((tl1, jl1), (tl2, jl2)):
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape) == (2, 1, 256)
        assert _gap(got, want) <= F32_TOL
    assert tc["len"] == int(jc["len"]) == 17
    assert tc["wkv"].dtype == torch.float32 and _gap(tc["wkv"], jc["wkv"]) <= F32_TOL
    for name in ("shift_t", "shift_c"):  # rounded to bf16 from float32 rows: bitwise
        assert tc[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(tc[name].view(torch.int16).numpy(),
                                      np.asarray(jc[name]).view(np.int16))


def test_decode_from_a_jax_prefill_state_matches_jax():
    """The JAX prefill's cache carried across (``cache_from_numpy``):
    three port decode steps from it give JAX's logits and states."""
    jcfg, tcfg = _configs()
    jm, params, params_np = _jax_params(jcfg, 2)
    B, S, n = 2, 9, 3
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (B, S + n)).astype(np.int32)
    cache = jax_materialize(jm.cache_infos(B, S + n), jax.random.PRNGKey(2))
    _, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :S])}, cache)
    tc = cache_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jc), batch=B, max_len=S + n,
                          device="cpu")
    assert tc["len"] == S and tc["shift_t"].dtype == torch.bfloat16
    tm, lm = build_model(tcfg), lm_params_from_numpy(tcfg, params_np, device="cpu")
    decode = jax.jit(jm.decode_step)
    for t in range(S, S + n):
        jl, jc = decode(params, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tm.decode_step(lm, tc, torch.from_numpy(toks[:, t:t + 1]))
        assert _gap(tl, jl) <= F32_TOL and _gap(tc["wkv"], jc["wkv"]) <= F32_TOL
    assert tc["len"] == int(jc["len"]) == S + n


@pytest.mark.parametrize("fault", ["lora dropped", "decay channels flipped",
                                   "decay tokens reversed"])
def test_parity_sees_the_decay(fault, monkeypatch):
    """Controls for the float32 limit: on the perturbed weights a port whose
    LoRA is never applied, or whose WKV reads the decay of the wrong channel
    or token, is beyond it."""
    real = ops.rwkv6_wkv

    def faulty(r, k, v, wlog, u, s0, *, mode):
        wlog = wlog.flip(-1) if fault == "decay channels flipped" else wlog.flip(1)
        return real(r, k, v, wlog, u, s0, mode=mode)

    def drop_lora(p):
        p["layers"]["time"]["w_lora_b"][...] = 0.0

    if fault != "lora dropped":
        monkeypatch.setattr(TR.ops, "rwkv6_wkv", faulty)
    (jl1, jl2, _), (tl1, tl2, _) = _prefill_decode(
        "float32", port_edit=drop_lora if fault == "lora dropped" else None)
    assert max(_gap(tl1, jl1), _gap(tl2, jl2)) > F32_TOL


def test_greedy_tokens_match_jax():
    """8 greedy tokens for 2 requests with a 16-token prompt at float32
    compute: the serving driver's loop (``launch.serve.generate``) and the
    library's ``greedy_generate`` against the JAX serving steps jitted
    without a mesh."""
    jcfg, tcfg = _configs()
    jm, params, params_np = _jax_params(jcfg, seed=3)
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


def test_decode_chain_matches_full_forward():
    """Prefill + N single-token decodes == one forward without a cache over
    the same tokens, at every step, float32."""
    jcfg, tcfg = _configs()
    _, _, params_np = _jax_params(jcfg, 7)
    tm = build_model(tcfg)
    lm = lm_params_from_numpy(tcfg, params_np, device="cpu")
    B, S0, N = 2, 16, 5
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, jcfg.vocab, (B, S0 + N)))
    cache = tm.init_cache(B, S0 + N, device="cpu")
    _, cache = tm.prefill(lm, {"tokens": toks[:, :S0]}, cache)
    for t in range(N):
        step, cache = tm.decode_step(lm, cache, toks[:, S0 + t:S0 + t + 1])
        full, none = lm(toks[:, :S0 + t + 1])
        assert none is None and tuple(full.shape) == (B, S0 + t + 1, 256)
        err = _gap(step[:, 0], full[:, -1].numpy())
        assert err < CHAIN_TOL, (t, err)


def _bf16_logits_gap() -> float:
    """max |port - JAX| of the bf16 prefill and decode logits over the JAX
    logits' max |.|."""
    (jl1, jl2, _), (tl1, tl2, _) = _prefill_decode("bfloat16")
    assert tl1.dtype == tl2.dtype == torch.bfloat16
    return max(_gap(tl1, jl1), _gap(tl2, jl2))


def test_lm_bf16_logits_match_jax():
    """bf16 compute over float32 masters: the port's prefill and decode
    logits within 2e-2 of their scale of JAX's. The two round at other
    places (bf16 products, float32 WKV sums in another order)."""
    gap = _bf16_logits_gap()
    print(f"{ARCH}: bf16 logits, port vs JAX, {gap:.4g} of their scale")
    assert gap <= BF16_LOGITS_TOL, gap


def test_bf16_logits_limit_rejects_fp8_residual(monkeypatch):
    """Control for the limit above: a port that rounds its residual stream
    to float8 (e4m3) after every layer, a precision below bf16, fails it."""
    forward = TR.RWKVLayer.forward

    def fp8(self, x, state=None, mode=None):
        y, new = forward(self, x, state, mode)
        return y.to(torch.float8_e4m3fn).to(x.dtype), new

    monkeypatch.setattr(TR.RWKVLayer, "forward", fp8)
    gap = _bf16_logits_gap()
    print(f"{ARCH}: bf16 logits with a float8 residual, port vs JAX, {gap:.4g} of their scale")
    assert gap > BF16_LOGITS_TOL, gap


def test_convert_checks_keys_and_shapes():
    jcfg, tcfg = _configs("bfloat16")
    _, _, p = _jax_params(jcfg)
    lm = lm_params_from_numpy(tcfg, p, device="cpu")
    assert isinstance(lm, TR.RWKVLM)
    assert torch.equal(lm.layers[1].time.w_base, torch.from_numpy(p["layers"]["time"]["w_base"][1]))
    time = {k: v for k, v in p["layers"]["time"].items() if k != "w_lora_b"}
    with pytest.raises(KeyError, match="w_lora_b"):
        lm_params_from_numpy(tcfg, dict(p, layers=dict(p["layers"], time=time)), device="cpu")
    wrong = dict(p["layers"]["time"], bonus=np.zeros((2, 4, 15), np.float32))
    with pytest.raises(ValueError, match="time/bonus"):
        lm_params_from_numpy(tcfg, dict(p, layers=dict(p["layers"], time=wrong)), device="cpu")
    with pytest.raises(KeyError, match="shift_c"):
        cache_from_numpy(tcfg, {"wkv": np.zeros(1), "shift_t": np.zeros(1), "len": 0},
                         batch=3, max_len=10, device="cpu")
    cache = build_model(tcfg).init_cache(3, 10, device="cpu")
    assert cache["len"] == 0 and set(cache) == {"wkv", "shift_t", "shift_c", "len"}
    assert tuple(cache["wkv"].shape) == (2, 3, 4, 16, 16) and cache["wkv"].dtype == torch.float32
    assert tuple(cache["shift_t"].shape) == (2, 3, 64) and cache["shift_c"].dtype == torch.bfloat16
