"""Port: training the encdec family (whisper-medium's SMOKE configuration:
2 encoder and 2 decoder layers over 16 audio frames) against the JAX
package: ``Model.loss`` and every gradient, microbatches, the
cross-attention through the attention Function, and the encoder's and
decoder's remat.

Weights are the port's draw carried to JAX; frames and tokens are seeded
numpy arrays. On the CPU each attention's forward (the encoder's
non-causal one, the decoder's causal one, and the cross-attention of the
text's queries on the 16 frames) is the flash kernel's plain version and
its backward differentiates the plain chunked attention
(``layers.FlashAttention``).

Tolerances, float32 compute:
  * the loss: 1e-6 relative;
  * every gradient within 5e-6 of its leaf's largest |.| (as the dense
    family's), but the key biases ``bk``, whose gradient is zero in exact
    arithmetic (a shift shared by every key leaves the softmax as it is):
    both packages return rounding noise of ~1e-9, held within 5e-6 of the
    tree's largest gradient;
  * two microbatches against one: the loss within 1e-6, the grad norm
    within 1e-5 and m after one step within 1e-5 of each leaf's scale
    (float32 accumulation in another order);
  * the cross-attention Function against autograd through the plain
    chunked attention: bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_train_common import (LOSS_REL, assert_grads_match, batch, configs,
                                 jax_loss_and_grads, port_params_np, tb)
from repro_torch.configs import RunConfig
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.train_step import loss_and_grads, make_train_step
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.tree import leaves, leaves_with_path

ARCH = "whisper-medium"
GRAD_REL = 5e-6
#: leaves whose gradient is zero in exact arithmetic
ZERO_IN_EXACT = ("bk",)


def test_loss_and_every_gradient_match_jax():
    """Text of 48 tokens over 16 frames; attn_chunk 32 gives the decoder's
    self-attention backward two query chunks."""
    jcfg, tcfg = configs(ARCH)
    pnp = port_params_np(tcfg)
    b = batch(jcfg, S=48)
    jloss, jmet, jgrads = jax_loss_and_grads(jcfg, pnp, b)
    loss, met, grads = loss_and_grads(build_model(tcfg), params_from_numpy(tcfg, pnp, device="cpu"),
                                      tb(b))
    assert float(loss) == pytest.approx(jloss, rel=LOSS_REL)
    for k in ("ce", "zloss"):
        assert float(met[k]) == pytest.approx(jmet[k], rel=LOSS_REL)
    assert len(jgrads) == 46
    assert_grads_match(grads, jgrads, GRAD_REL, ZERO_IN_EXACT)


def test_microbatches_match_one_batch():
    """Two microbatches against one on a batch of 4 with its frames: the
    train step splits ``audio_embeds`` with the tokens."""
    _, tcfg = configs(ARCH)
    tm = build_model(tcfg)
    params = params_from_numpy(tcfg, port_params_np(tcfg), device="cpu")
    b = tb(batch(tcfg, B=4, seed=3))
    outs = []
    for k in (1, 2):
        init, step = make_train_step(tm, RunConfig(model=tcfg, shape="train_4k", warmup_steps=1,
                                                   microbatches=k))
        outs.append(step(params, init(torch.Generator().manual_seed(0))[1], b, 1))
    (_, o1, m1), (_, o2, m2) = outs
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-5)
    for (path, a), b_ in zip(leaves_with_path(o2["m"]), leaves(o1["m"])):
        if path[-1] in ZERO_IN_EXACT:
            continue
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0,
                                   atol=1e-5 * float(b_.abs().max()), err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_function_on_cpu(dtype):
    """Queries of 20 tokens on 37 encoder rows, non-causal (the
    cross-attention's call): the Function's forward is the plain version
    and its gradients, dk and dv of the encoder's length, equal autograd
    through the plain chunked attention (chunk 8) bit for bit."""
    rng = np.random.default_rng(13)
    B, Sq, Skv, H, Hkv, dh, chunk = 2, 20, 37, 4, 2, 16, 8
    dt = getattr(torch, dtype)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dt)  # noqa: E731
    q, k, v, dout = f(B, Sq, H, dh), f(B, Skv, Hkv, dh), f(B, Skv, Hkv, dh), f(B, Sq, H, dh)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = TL.FlashAttention.apply(*xs, False, 0, chunk)
    assert torch.equal(out, flash_attention_torch(q, k, v, causal=False))
    got = torch.autograd.grad(out, xs, dout)
    ps = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = TL.chunked_attention(ps[0].view(B, Sq, Hkv, H // Hkv, dh), ps[1], ps[2], causal=False,
                               chunk=chunk)
    want = torch.autograd.grad(ref, ps, dout.view(ref.shape))
    for g, w, x in zip(got, want, xs):
        assert g.shape == x.shape and g.dtype == dt
        assert torch.equal(g, w)


def test_gradient_check_catches_a_cross_attention_without_grad_fn(monkeypatch):
    """A cross-attention whose output carries no grad_fn (the serving
    route's kernel call) leaves the decoder's cross wq, wk, wv and their
    biases without a gradient; the port refuses to return one. The
    stand-in detaches only where the queries and the keys differ in
    length, so the self-attentions keep their gradients."""
    _, tcfg = configs(ARCH)
    params = params_from_numpy(tcfg, port_params_np(tcfg), device="cpu")
    real = TL.FlashAttention.apply

    def cross_detached(q, k, v, causal, window, chunk):
        if q.shape[1] != k.shape[1]:
            return flash_attention_torch(q.detach(), k.detach(), v.detach(), causal=causal)
        return real(q, k, v, causal, window, chunk)

    monkeypatch.setattr(TL.FlashAttention, "apply", cross_detached)
    with pytest.raises(RuntimeError, match="not have been used"):
        loss_and_grads(build_model(tcfg), params, tb(batch(tcfg, S=48)))


def test_every_attention_takes_the_function_with_a_gradient(monkeypatch):
    """Training calls the Function for each encoder, decoder and cross
    attention twice (the layer's forward and its remat recompute) and
    serving never: the calls' shapes name which is which."""
    _, tcfg = configs(ARCH)
    params = params_from_numpy(tcfg, port_params_np(tcfg), device="cpu")
    calls = []
    real = TL.FlashAttention.apply

    def counted(q, k, v, causal, window, chunk):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal, window, chunk)

    monkeypatch.setattr(TL.FlashAttention, "apply", counted)
    b = tb(batch(tcfg, S=48))
    lm = build_model(tcfg).build(params)
    with torch.no_grad():
        lm(b["tokens"], audio_embeds=b["audio_embeds"])
    assert calls == []
    loss_and_grads(build_model(tcfg), params, b)
    E, T = tcfg.enc_seq, 48
    assert sorted(set(calls)) == sorted({(E, E, False), (T, T, True), (T, E, False)})
    for kind in set(calls):
        assert calls.count(kind) == 2 * tcfg.n_layers, kind


def test_remat_on_and_off_give_equal_gradients():
    _, tcfg = configs(ARCH)
    pnp = port_params_np(tcfg)
    b = tb(batch(tcfg))
    runs = []
    for remat in ("layer", "none"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        runs.append(loss_and_grads(build_model(cfg), params_from_numpy(cfg, pnp, device="cpu"), b))
    (l1, _, g1), (l2, _, g2) = runs
    assert torch.equal(l1, l2)
    for (path, a), b_ in zip(leaves_with_path(g1), leaves(g2)):
        assert torch.equal(a, b_), path


def test_loss_needs_the_frames():
    """The encdec loss takes the encoder's frame embeddings from the batch:
    a batch of tokens and labels alone (what ``launch.train``'s pipeline
    yields) is refused by name."""
    _, tcfg = configs(ARCH)
    params = params_from_numpy(tcfg, port_params_np(tcfg), device="cpu")
    b = {k: v for k, v in tb(batch(tcfg)).items() if k != "audio_embeds"}
    with pytest.raises(KeyError, match="audio_embeds"):
        build_model(tcfg).loss(params, b)
