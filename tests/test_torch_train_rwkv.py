"""Port: training the ssm family (rwkv6-7b's SMOKE configuration) against
the JAX package: ``Model.loss`` and every gradient, three train steps, the
WKV autograd Function (``models.rwkv.WKV``) and ``launch.train``.

Weights are the port's draw with the decay perturbed (``w_base`` uniform on
[-6, 1], ``w_lora_b`` ~ N(0, 0.1^2)): the init's constant ``w_base`` and
zero ``w_lora_b`` make the decay the same everywhere and ``w_lora_a``'s
gradient exactly zero. On the CPU the WKV's forward is the kernel's plain
version (JAX's chunked WKV) and its backward differentiates it recomputed.

Tolerances, float32 compute:
  * the loss: 1e-6 relative;
  * every gradient within 5e-5 of its leaf's largest |.| (measured 1.7e-5
    at the bonus and 1.1e-5 at wv: the WKV's gradient runs through
    exp(cumsum) differences inside each 32-token chunk, summed in XLA's
    order on one side and PyTorch's on the other, ten times the dense
    family's 5e-6);
  * after 3 steps: the grad norm within 5e-5, m and v within 5e-5 of
    their tree's scale, the masters within 1e-2 of the peak lr (measured
    2.4e-3 at one entry of 16384 of the LoRA: Adam's g / (|g| + eps) per
    entry carries the gradients' last-bit differences of small entries,
    ``tests/test_torch_train.py``, and the WKV's are ten times the dense
    family's);
  * the Function against autograd through the plain version: bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_train_common import (LOSS_REL, assert_grads_match, assert_state_match,
                                 assert_steps_match, batch, configs, jax_loss_and_grads,
                                 launch_train_smoke, port_params_np, tb, train_pair)
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.train_step import loss_and_grads
from repro_torch.kernels import rwkv6_scan as ks
from repro_torch.models import build_model
from repro_torch.models import rwkv as TR
from repro_torch.tree import leaves, leaves_with_path

ARCH = "rwkv6-7b"
GRAD_REL = 5e-5
MASTER_LR_FRAC = 1e-2


def perturb_decay(tree, rng) -> None:
    time = tree["layers"]["time"]
    time["w_base"] = rng.uniform(-6.0, 1.0, time["w_base"].shape).astype(np.float32)
    time["w_lora_b"] = (0.1 * rng.normal(size=time["w_lora_b"].shape)).astype(np.float32)


def test_loss_and_every_gradient_match_jax():
    """S = 64: two 32-token WKV chunks per layer."""
    jcfg, tcfg = configs(ARCH)
    pnp = port_params_np(tcfg, edit=perturb_decay)
    b = batch(jcfg, S=64)
    jloss, jmet, jgrads = jax_loss_and_grads(jcfg, pnp, b)
    loss, met, grads = loss_and_grads(build_model(tcfg), params_from_numpy(tcfg, pnp, device="cpu"),
                                      tb(b))
    assert float(loss) == pytest.approx(jloss, rel=LOSS_REL)
    for k in ("ce", "zloss"):
        assert float(met[k]) == pytest.approx(jmet[k], rel=LOSS_REL)
    assert len(jgrads) == 23
    assert_grads_match(grads, jgrads, GRAD_REL)


def test_three_train_steps_match_jax():
    """3 AdamW steps (warmup 1 of 10, peak lr 1e-2, batch 2 x 40: a ragged
    second WKV chunk) against JAX's jitted step: every step's metrics, then
    the masters, m and v."""
    jcfg, tcfg = configs(ARCH)
    pnp = port_params_np(tcfg, edit=perturb_decay)
    out, (jp, jo), (tp, to) = train_pair(jcfg, tcfg, pnp,
                                         [batch(jcfg, S=40, seed=10 + i) for i in range(3)])
    assert_steps_match(out, GRAD_REL)
    assert int(to["step"]) == 3
    assert_state_match(jo["m"], to["m"], GRAD_REL)
    assert_state_match(jo["v"], to["v"], GRAD_REL)
    for g, w in zip(leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=MASTER_LR_FRAC * 1e-2)


def _wkv_inputs(dtype, S=45, seed=3):
    rng = np.random.default_rng(seed)
    B, H, dh = 2, 3, 16
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    r, k, v = (f(B, S, H, dh).to(dtype) for _ in range(3))
    wlog = -torch.exp(0.5 * f(B, S, H, dh))
    return r, k, v, wlog, 0.1 * f(H, dh), f(B, H, dh, dh), f(B, S, H, dh), f(B, H, dh, dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_function_on_cpu(dtype, with_state):
    """On CPU tensors the Function's forward is the plain version and its
    gradients (every input, s0 included where it needs one; with and
    without a gradient on sT) equal autograd through ``rwkv6_scan_torch``
    bit for bit, over two chunks and a ragged third."""
    *args, dy, dsT = _wkv_inputs(dtype)
    need = [True] * 5 + [with_state]
    xs = [t.clone().requires_grad_(n) for t, n in zip(args, need)]
    y, sT = TR.WKV.apply(*xs)
    py, psT = ks.rwkv6_scan_torch(*args)
    assert torch.equal(y, py) and torch.equal(sT, psT)
    outs, gouts = ([y, sT], [dy, dsT]) if with_state else ([y], [dy])
    got = torch.autograd.grad(outs, [x for x in xs if x.requires_grad], gouts)
    ps = [t.clone().requires_grad_(n) for t, n in zip(args, need)]
    py, psT = ks.rwkv6_scan_torch(*ps)
    want = torch.autograd.grad([py, psT] if with_state else [py],
                               [x for x in ps if x.requires_grad], gouts)
    assert len(got) == len(want) == sum(need)
    for g, w, x in zip(got, want, [x for x in xs if x.requires_grad]):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, w)


def test_time_mix_takes_the_function_only_for_a_gradient(monkeypatch):
    """The time mix routes its WKV through ``WKV`` exactly when a gradient
    is asked for: serving (no gradient) calls the wrapper as before."""
    _, tcfg = configs(ARCH)
    params = params_from_numpy(tcfg, port_params_np(tcfg, edit=perturb_decay), device="cpu")
    calls = []
    real = TR.WKV.apply
    monkeypatch.setattr(TR.WKV, "apply", lambda *a: calls.append("fn") or real(*a))
    tokens = tb(batch(tcfg))["tokens"]
    with torch.no_grad():
        TR.forward(params, tcfg, tokens)
    assert calls == []
    loss_and_grads(build_model(tcfg), params, tb(batch(tcfg)))
    # each layer's forward and its remat recompute
    assert calls == ["fn"] * (2 * tcfg.n_layers)


def test_gradient_check_catches_a_wkv_without_grad_fn(monkeypatch):
    """A WKV whose outputs carry no grad_fn (a kernel launched into fresh
    tensors) leaves wr, wk, wv, the decay's LoRA and the bonus without a
    gradient; the port refuses to return one rather than returning zeros."""
    _, tcfg = configs(ARCH)
    params = params_from_numpy(tcfg, port_params_np(tcfg, edit=perturb_decay), device="cpu")

    def detached(*xs):
        return ks.rwkv6_scan_torch(*(x.detach() for x in xs))

    monkeypatch.setattr(TR.WKV, "apply", detached)
    with pytest.raises(RuntimeError, match="not have been used"):
        loss_and_grads(build_model(tcfg), params, tb(batch(tcfg)))


def test_remat_on_and_off_give_equal_gradients():
    _, tcfg = configs(ARCH)
    pnp = port_params_np(tcfg, edit=perturb_decay)
    b = tb(batch(tcfg))
    runs = []
    for remat in ("layer", "none"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        runs.append(loss_and_grads(build_model(cfg), params_from_numpy(cfg, pnp, device="cpu"), b))
    (l1, _, g1), (l2, _, g2) = runs
    assert torch.equal(l1, l2)
    for (path, a), b_ in zip(leaves_with_path(g1), leaves(g2)):
        assert torch.equal(a, b_), path


def test_launch_train_smoke():
    """``launch.train --device cpu --smoke --arch rwkv6-7b``: 2 steps, finite
    losses and grad norms."""
    launch_train_smoke(ARCH)
