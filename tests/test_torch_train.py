"""Port: the training path (``Model.loss``, ``distributed.train_step``,
``launch.train``) against the JAX package's, on the SMOKE tinyllama.

Weights are JAX's SMOKE draw carried across (``convert.params_from_numpy``)
or the port's draw carried to JAX; inputs are seeded numpy arrays. On the
CPU the attention's forward is the kernel's plain version and its backward
differentiates the plain chunked attention (``layers.FlashAttention``).

Tolerances, all at float32 compute unless said otherwise:
  * the loss: 1e-6 relative;
  * every parameter's gradient, against the largest |gradient| of its leaf:
    5e-6 on the port's draw, 2e-4 on JAX's SMOKE draw, whose stacked
    fan-in (the layer count, 2) makes its weights ~0.7 wide and its
    softmaxes near one-hot, so float32 rounding in another order grows
    ~100x through two layers (the same draw's float32 logits, ROADMAP
    Queue 3);
  * after 3 steps, on the port's draw: m and v within 5e-6 of their
    scale, the masters within 1e-3 of the peak learning rate (Adam divides
    by each entry's |gradient|, so entries whose gradients are small carry
    the gradients' last-bit differences into the update); the lr within 2
    ulps (XLA's cosine against PyTorch's, ``test_torch_optim.py``);
  * bf16 compute: the loss within 2e-3 relative of JAX's bf16 loss (the
    two round at other places: JAX's attention rounds its scores and
    weights to bf16, the kernel's plain version keeps them in float32).
"""
import dataclasses
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MeshConfig as JMeshConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.registry import get_config as jax_config
from repro.distributed.train_step import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build
from repro.models import materialize as jax_materialize
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import MeshConfig, RunConfig, get_config
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.distributed.train_step import loss_and_grads, make_train_step
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.launch import train
from repro_torch.models import build_model, materialize
from repro_torch.models import layers as TL
from repro_torch.tree import leaves, leaves_with_path

ARCH = "tinyllama-1.1b"
LOSS_REL = 1e-6
GRAD_REL = {"port": 5e-6, "jax": 2e-4}
STATE_REL = 5e-6
MASTER_LR_FRAC = 1e-3
BF16_LOSS_REL = 2e-3


def _configs(compute="float32", **kw):
    jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jdt, tdt = (jnp.float32, torch.float32) if compute == "float32" else (jnp.bfloat16,
                                                                           torch.bfloat16)
    return (dataclasses.replace(jcfg, compute_dtype=jdt, **kw),
            dataclasses.replace(tcfg, compute_dtype=tdt, **kw))


def _params_np(init, jcfg, tcfg, seed=0):
    """Numpy parameters: JAX's SMOKE draw or the port's."""
    if init == "jax":
        drawn = jax_materialize(jax_build(jcfg).param_infos(), jax.random.PRNGKey(seed))
        return jax.tree_util.tree_map(np.asarray, drawn)
    drawn = materialize(build_model(tcfg).param_infos(), torch.Generator().manual_seed(seed))
    return jax.tree_util.tree_map(lambda t: t.numpy(), drawn)


def _batch(vocab, B=2, S=64, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("init", ["jax", "port"])
def test_loss_and_every_gradient_match_jax(init):
    """``Model.loss`` and the gradient of every parameter against
    ``jax.value_and_grad(model.loss)`` (S = 64 over attn_chunk 32: JAX's
    attention runs two checkpointed chunks, the cross-entropy eight)."""
    jcfg, tcfg = _configs()
    pnp = _params_np(init, jcfg, tcfg)
    batch = _batch(jcfg.vocab)
    jm = jax_build(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, pnp), _jb(batch))
    loss, met, grads = loss_and_grads(build_model(tcfg), params_from_numpy(tcfg, pnp, device="cpu"),
                                      _tb(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_REL)
    for k in ("ce", "zloss"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=LOSS_REL)
    got, want = list(leaves_with_path(grads)), jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want) == 11
    for (path, g), w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_REL[init] * scale,
                                   err_msg=str(path))


def test_gradient_check_catches_an_attention_without_grad_fn(monkeypatch):
    """Control for the test above: an attention whose output carries no
    grad_fn (a kernel launched into a fresh tensor, as the serving route
    does) leaves wq, wk and wv without a gradient, and the port refuses to
    return one rather than returning zeros."""
    jcfg, tcfg = _configs()
    params = params_from_numpy(tcfg, _params_np("port", jcfg, tcfg), device="cpu")

    def no_grad_fn(q, k, v, causal, window, chunk):
        return flash_attention_torch(q.detach(), k.detach(), v.detach(), causal=causal,
                                     window=window)

    monkeypatch.setattr(TL.FlashAttention, "apply", no_grad_fn)
    with pytest.raises(RuntimeError, match="not have been used"):
        loss_and_grads(build_model(tcfg), params, _tb(_batch(jcfg.vocab)))


def _train_pair(init, microbatches, n_steps=3):
    """(JAX, port) metrics per step and the final (params, opt state) of
    ``n_steps`` steps from the same carried parameters and batches."""
    jcfg, tcfg = _configs()
    pnp = _params_np(init, jcfg, tcfg)
    kw = dict(shape="train_4k", learning_rate=1e-2, total_steps=10, warmup_steps=1,
              microbatches=microbatches)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    _, jstep = jax_make_train_step(jm, JRunConfig(model=jcfg, mesh=JMeshConfig(data=1, model=1),
                                                  **kw))
    _, tstep = make_train_step(tm, RunConfig(model=tcfg, mesh=MeshConfig(data=1, model=1), **kw))
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    jo = jax_adamw_init(jp)
    tp = params_from_numpy(tcfg, pnp, device="cpu")
    to = opt_state_from_numpy("adamw", jax.tree_util.tree_map(np.asarray, jo), pnp, device="cpu")
    jstep = jax.jit(jstep)
    out = []
    for step in range(n_steps):
        b = _batch(jcfg.vocab, B=4, S=32, seed=10 + step)
        jp, jo, jm_ = jstep(jp, jo, _jb(b), jnp.int32(step))
        tp, to, tm_ = tstep(tp, to, _tb(b), step)
        out.append(({k: float(v) for k, v in jm_.items()}, {k: float(v) for k, v in tm_.items()}))
    return out, (jp, jo), (tp, to)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("init", ["jax", "port"])
def test_three_train_steps_match_jax(init, microbatches):
    """3 steps of ``make_train_step`` (AdamW, warmup 1 of 10, peak lr 1e-2,
    batch 4 x 32) against JAX's jitted step: the same metric keys (ce and
    zloss only with one microbatch, as JAX's), the loss, lr and grad norm at
    every step; the masters, m and v after the last. On JAX's draw only the
    steps before the first update (steps 0 and 1; the lr is 0 at step 0)
    are compared: its gradients lie 1e-4 apart (see the module docstring),
    and Adam's first update, g / (|g| + eps) per entry, turns that into
    embedding entries a whole 2 lr apart, which step 2's loss then sees."""
    out, (jp, jo), (tp, to) = _train_pair(init, microbatches)
    if init == "jax":
        out = out[:2]
    for step, (jmet, tmet) in enumerate(out):
        assert set(tmet) == set(jmet), (set(tmet), set(jmet))
        assert tmet["loss"] == pytest.approx(jmet["loss"], rel=LOSS_REL), step
        assert tmet["lr"] == pytest.approx(jmet["lr"], rel=2 ** -22), step
        assert tmet["grad_norm"] == pytest.approx(jmet["grad_norm"], rel=GRAD_REL[init]), step
    if init == "jax":
        return
    assert int(to["step"]) == int(jo["step"]) == 3
    for part in ("m", "v"):
        w_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jo[part])]
        scale = max(float(np.abs(w).max()) for w in w_leaves)
        for g, w in zip(leaves(to[part]), w_leaves):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=STATE_REL * scale)
    for (path, g), w in zip(leaves_with_path(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=MASTER_LR_FRAC * 1e-2,
                                   err_msg=str(path))


def test_microbatches_match_one_batch():
    """Two microbatches against one batch, one step on the port: the
    accumulated, averaged gradient (m after one step is 0.1 x the clipped
    gradient) and the loss within float32 rounding."""
    _, tcfg = _configs()
    tm = build_model(tcfg)
    params = params_from_numpy(tcfg, _params_np("port", *_configs()), device="cpu")
    b = _tb(_batch(tcfg.vocab, B=4, S=32, seed=3))
    outs = []
    for k in (1, 2):
        init, step = make_train_step(tm, RunConfig(model=tcfg, shape="train_4k", warmup_steps=1,
                                                   microbatches=k))
        opt = init(torch.Generator().manual_seed(0))[1]
        outs.append(step(params, opt, b, 1))
    (_, o1, m1), (_, o2, m2) = outs
    assert m2["loss"] == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-5)
    for a, b_ in zip(leaves(o2["m"]), leaves(o1["m"])):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0,
                                   atol=1e-5 * float(b_.abs().max()))


def test_bf16_loss_beside_jax():
    """bf16 compute on JAX's SMOKE draw: the port's loss within 2e-3
    relative of JAX's bf16 loss, on three batches."""
    jcfg, tcfg = _configs("bfloat16")
    pnp = _params_np("jax", jcfg, tcfg)
    jloss = jax.jit(jax_build(jcfg).loss)
    params = params_from_numpy(tcfg, pnp, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    for seed in range(3):
        b = _batch(jcfg.vocab, seed=seed)
        want = float(jloss(jp, _jb(b))[0])
        with torch.no_grad():
            got, met = build_model(tcfg).loss(params, _tb(b))
        assert met["ce"].dtype == torch.float32
        assert abs(float(got) - want) <= BF16_LOSS_REL * abs(want), (seed, float(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal, window", [(True, 0), (True, 5), (False, 0)])
def test_flash_attention_function_on_cpu(causal, window, dtype):
    """On CPU tensors the Function's forward is the kernel's plain version
    and its gradient is autograd through the plain chunked attention (chunk
    8 of S = 20), both bit for bit; dk and dv sum over each kv head's
    query group of 3."""
    rng = np.random.default_rng(11)
    B, S, H, Hkv, dh, chunk = 2, 20, 6, 2, 16, 8
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, dh)).astype(np.float32)).to(dt)
               for h in (H, Hkv, Hkv))
    dout = torch.from_numpy(rng.normal(size=(B, S, H, dh)).astype(np.float32)).to(dt)
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    out = TL.FlashAttention.apply(*qk, causal, window, chunk)
    assert torch.equal(out, flash_attention_torch(q, k, v, causal=causal, window=window))
    got = torch.autograd.grad(out, qk, dout)
    qp = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = TL.chunked_attention(qp[0].view(B, S, Hkv, H // Hkv, dh), qp[1], qp[2], causal=causal,
                               window=window, chunk=chunk)
    want = torch.autograd.grad(ref, qp, dout.view(ref.shape))
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        assert torch.equal(g, w)


def test_remat_on_and_off_give_equal_gradients():
    jcfg, tcfg = _configs()
    pnp = _params_np("port", jcfg, tcfg)
    b = _tb(_batch(tcfg.vocab))
    runs = []
    for remat in ("layer", "none"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        runs.append(loss_and_grads(build_model(cfg), params_from_numpy(cfg, pnp, device="cpu"), b))
    (l1, _, g1), (l2, _, g2) = runs
    assert torch.equal(l1, l2)
    for a, b_ in zip(leaves(g1), leaves(g2)):
        assert torch.equal(a, b_)


def test_training_modes_and_families_refused():
    """``mode='cuda'`` on CPU tensors raises; every other family's SMOKE
    model now builds a finite loss with a gradient on its own draw (its
    parity with JAX: ``tests/test_torch_train_*.py``); a compressed
    gradient reduction (the sharded step's data-parallel mean,
    ``tests/test_torch_tp_collectives.py``) is taken, an unknown one
    raises."""
    jcfg, tcfg = _configs()
    params = params_from_numpy(tcfg, _params_np("port", jcfg, tcfg), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        loss_and_grads(build_model(tcfg), params, _tb(_batch(tcfg.vocab)), mode="cuda")
    rng = np.random.default_rng(0)
    for arch in ("moonshot-v1-16b-a3b", "rwkv6-7b", "jamba-v0.1-52b", "whisper-medium",
                 "internvl2-2b"):
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        b = _tb(_batch(cfg.vocab, S=32))
        if cfg.family == "vlm":
            b["vis_embeds"] = torch.from_numpy(
                rng.normal(size=(2, cfg.vis_tokens, cfg.d_model)).astype(np.float32))
        if cfg.family == "encdec":
            b["audio_embeds"] = torch.from_numpy(
                rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        loss, _, grads = loss_and_grads(model, materialize(model.param_infos(),
                                                           torch.Generator().manual_seed(0)), b)
        assert bool(torch.isfinite(loss)) and float(loss) > 0, arch
        assert all(bool(torch.isfinite(g).all()) for g in leaves(grads)), arch
    for method in ("bf16", "int8"):
        assert RunConfig(model=tcfg, shape="train_4k", grad_compression=method) \
            .grad_compression == method
    with pytest.raises(ValueError, match="grad_compression"):
        RunConfig(model=tcfg, shape="train_4k", grad_compression="fp8")


def test_launch_train_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])


def test_launch_train_resumes_where_it_stopped(tmp_path):
    """``launch.train`` on the CPU: 6 steps with a checkpoint every 3; a
    restart after a crash that lost the final checkpoint resumes from step
    3 (weights, optimizer state, data cursor) and its 3 steps' losses equal
    the uninterrupted run's bit for bit."""
    args = ["--device", "cpu", "--smoke", "--steps", "6", "--batch", "2", "--seq", "32",
            "--lr", "3e-3", "--ckpt-every", "3", "--log-every", "1", "--ckpt", str(tmp_path)]
    whole = train.train(args)
    assert whole.start_step == 0 and len(whole.losses) == 6
    assert all(np.isfinite(whole.losses))
    shutil.rmtree(pathlib.Path(tmp_path) / "step_000000006")
    resumed = train.train(args)
    assert resumed.start_step == 3
    assert resumed.losses == whole.losses[3:]
    for a, b in zip(leaves(resumed.params), leaves(whole.params)):
        assert torch.equal(a, b)
