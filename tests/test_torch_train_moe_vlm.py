"""Port: training the moe family (moonshot-v1-16b-a3b's SMOKE
configuration: 2 layers, 4 experts, top 2) and the vlm family
(internvl2-2b's: 2 layers, 8 patch embeddings before the text) against
the JAX package: ``Model.loss`` and every gradient, and microbatches on
the vlm's batch.

The MoE's gradients run through the router's softmax, the top-k's values
(a stable sort, ties to the lower index, as ``jax.lax.top_k``), the
sort-based dispatch with its capacity drops (the SMOKE capacity of 4 slots
per expert drops tokens at S = 64) and the expert-ordered combine, all
plain differentiable ops. The vlm's loss is taken on the text's hidden
states, past the patches, whose embeddings carry no gradient (the
parameters' do).

Weights are the port's draw carried to JAX. Tolerances, float32 compute:
the loss 1e-6 relative; every gradient within 5e-6 of its leaf's largest
|.| (measured 1.0e-6 for both); two microbatches against one as in
``tests/test_torch_train_encdec.py``.
"""
import numpy as np
import pytest
import torch

from _torch_train_common import (LOSS_REL, assert_grads_match, batch, configs,
                                 jax_loss_and_grads, port_params_np, tb)
from repro_torch.configs import RunConfig
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.train_step import loss_and_grads, make_train_step
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.tree import leaves

GRAD_REL = 5e-6


@pytest.mark.parametrize("arch, vis, n_leaves", [
    ("moonshot-v1-16b-a3b", False, 12),
    ("internvl2-2b", True, 11),
    ("internvl2-2b", False, 11),  # text only, as launch.train's pipeline feeds it
])
def test_loss_and_every_gradient_match_jax(arch, vis, n_leaves):
    jcfg, tcfg = configs(arch)
    pnp = port_params_np(tcfg)
    b = batch(jcfg, S=64, vis=vis)
    jloss, jmet, jgrads = jax_loss_and_grads(jcfg, pnp, b)
    loss, met, grads = loss_and_grads(build_model(tcfg), params_from_numpy(tcfg, pnp, device="cpu"),
                                      tb(b))
    assert float(loss) == pytest.approx(jloss, rel=LOSS_REL)
    for k in ("ce", "zloss"):
        assert float(met[k]) == pytest.approx(jmet[k], rel=LOSS_REL)
    assert len(jgrads) == n_leaves
    assert_grads_match(grads, jgrads, GRAD_REL)


def test_moe_routes_with_drops_and_both_orders_of_top_k(monkeypatch):
    """The gradient test's MoE batch drops choices at capacity and its top
    2 come in both orders of expert id, so the test reaches the dropped
    slots and the combine's sort: every dispatch of that loss recorded."""
    _, tcfg = configs("moonshot-v1-16b-a3b")
    params = params_from_numpy(tcfg, port_params_np(tcfg), device="cpu")
    seen = []
    real = TL._dispatch

    def recorded(tokens, expert_idx, gate_w, E, C):
        out = real(tokens, expert_idx, gate_w, E, C)
        seen.append((expert_idx.detach().clone(), out[2].clone(), E * C))
        return out

    monkeypatch.setattr(TL, "_dispatch", recorded)
    loss_and_grads(build_model(tcfg), params, tb(batch(tcfg, S=64)))
    assert len(seen) == 2 * tcfg.n_layers  # each layer's forward and its remat recompute
    for idx, slot, dropped in seen:
        assert bool((slot == dropped).any())
        assert bool((idx[..., 0] < idx[..., 1]).any()) and bool((idx[..., 0] > idx[..., 1]).any())


def test_vlm_microbatches_match_one_batch():
    """Two microbatches against one on a batch of 4 with its patches: the
    train step splits ``vis_embeds`` with the tokens."""
    _, tcfg = configs("internvl2-2b")
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
    for a, b_ in zip(leaves(o2["m"]), leaves(o1["m"])):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0,
                                   atol=1e-5 * float(b_.abs().max()))
