"""Port: training the hybrid family (jamba-v0.1-52b's SMOKE configuration:
one period of 7 Mamba and 1 attention sub-layers, MoE on every other one)
against the JAX package: ``Model.loss`` and every gradient, three
Adafactor train steps, the selective-scan autograd Function
(``models.mamba.SelectiveScan``) and ``launch.train``.

Weights are the port's draw carried to JAX. On the CPU the scan's forward
is the kernel's plain version (JAX's chunked scan) and its backward
recomputes it one chunk at a time; the attention's is the flash kernel's
plain version. The MoE routes on the port's draw with no near-tie here
(a near-tie between two experts' gates would send a token elsewhere on a
last-bit difference: ROADMAP Queue 3).

Tolerances, float32 compute:
  * the loss: 1e-6 relative;
  * every gradient within 2e-5 of its leaf's largest |.| (measured
    6.5e-6);
  * 3 Adafactor steps (the optimizer jamba's card cut trains with): each
    step's grad norm within 2e-5; the masters within 1e-3 of the peak lr
    and the factored second moments within 2e-5 of their tree's scale,
    with the port's CPU arithmetic flushing subnormals to zero as XLA's
    does (measured 2.6e-6 of the lr). Without flushing the port's first
    update of ``a_log`` differs from JAX's by up to 16 lr: a_log's
    gradients are ~1e-12, the factored second moment's product
    ``vr[..., None] * vc`` of such rows is subnormal in float32, XLA
    flushes it to 0 and divides the gradient by sqrt(eps2) = 1e-15,
    which the RMS clip then spreads over the whole leaf (ROADMAP Queue 3);
    the port keeps the subnormal, as PyTorch does on the card;
  * the Function against autograd through the plain version: 1e-6 of each
    gradient's largest |.| (dA adds the chunks' parts in another order).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_train_common import (LOSS_REL, assert_grads_match, assert_state_match,
                                 assert_steps_match, batch, configs, jax_loss_and_grads,
                                 launch_train_smoke, port_params_np, port_steps, tb,
                                 train_pair)
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.train_step import loss_and_grads
from repro_torch.kernels import mamba_scan as km
from repro_torch.models import build_model
from repro_torch.models import hybrid as TH
from repro_torch.models import mamba as TM
from repro_torch.tree import leaves_with_path

ARCH = "jamba-v0.1-52b"
GRAD_REL = 2e-5
MASTER_LR_FRAC = 1e-3
FN_REL = 1e-6


def test_loss_and_every_gradient_match_jax():
    """S = 64 over the window of 64 and attn_chunk 32."""
    jcfg, tcfg = configs(ARCH)
    pnp = port_params_np(tcfg)
    b = batch(jcfg, S=64)
    jloss, jmet, jgrads = jax_loss_and_grads(jcfg, pnp, b)
    loss, met, grads = loss_and_grads(build_model(tcfg), params_from_numpy(tcfg, pnp, device="cpu"),
                                      tb(b))
    assert float(loss) == pytest.approx(jloss, rel=LOSS_REL)
    for k in ("ce", "zloss"):
        assert float(met[k]) == pytest.approx(jmet[k], rel=LOSS_REL)
    assert len(jgrads) == 106
    assert_grads_match(grads, jgrads, GRAD_REL)


def test_three_adafactor_steps_match_jax():
    """3 Adafactor steps (warmup 1 of 10, peak lr 1e-2, batch 2 x 32)
    against JAX's jitted step, the port's CPU arithmetic flushing
    subnormals as XLA's: every step's metrics, then the masters and the
    factored second moments. Then the reference quirk: the port's steps
    without flushing move a_log more than 1 lr away from JAX's (see the
    module docstring)."""
    jcfg, tcfg = configs(ARCH, optimizer="adafactor")
    pnp = port_params_np(tcfg)
    batches = [batch(jcfg, seed=10 + i) for i in range(3)]
    assert torch.set_flush_denormal(True)
    try:
        out, (jp, jo), (tp, to) = train_pair(jcfg, tcfg, pnp, batches)
    finally:
        torch.set_flush_denormal(False)
    assert_steps_match(out, GRAD_REL)
    assert int(to["step"]) == 3
    assert_state_match(jo["state"], to["state"], GRAD_REL)
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, jp)))
    for path, g in leaves_with_path(tp):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0, atol=MASTER_LR_FRAC * 1e-2,
                                   err_msg=str(path))
    kept, _ = port_steps(tcfg, pnp, batches)
    a_log = max(float(np.abs(g.numpy() - want[path]).max())
                for path, g in leaves_with_path(kept) if path[-1] == "a_log")
    assert a_log > 1e-2, a_log


def _scan_inputs(S, dtype, seed=5):
    rng = np.random.default_rng(seed)
    B, E, N = 2, 8, 4
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    delta = torch.nn.functional.softplus(f(B, S, E))
    u = f(B, S, E).to(dtype)
    xdbc = f(B, S, 3 + 2 * N).to(dtype)
    bm, cm = xdbc[..., 3:3 + N], xdbc[..., 3 + N:]  # strided views, as the block's
    A = -torch.exp(0.5 * f(E, N))
    return delta, u, bm, cm, A, f(B, E, N), f(B, S, E), f(B, E, N)


@pytest.mark.parametrize("S, dtype, with_state", [
    (512, torch.float32, True),  # two 256-token chunks
    (512, torch.bfloat16, False),
    (37, torch.float32, True),  # one chunk
])
def test_selective_scan_function_on_cpu(S, dtype, with_state):
    """On CPU tensors the Function's forward is the plain version (bit for
    bit) and its gradients (every input; h0 and the final state's gradient
    where asked for) match autograd through ``mamba_selective_scan_torch``
    within FN_REL of each gradient's scale."""
    *args, dy, dhT = _scan_inputs(S, dtype)
    need = [True] * 5 + [with_state]

    def leaves_of(ts):
        return [t.detach().clone().requires_grad_(n) for t, n in zip(ts, need)]

    xs = leaves_of(args)
    y, hT = TM.SelectiveScan.apply(*xs)
    py, phT = km.mamba_selective_scan_torch(*args)
    assert torch.equal(y, py) and torch.equal(hT, phT)
    outs, gouts = ([y, hT], [dy, dhT]) if with_state else ([y], [dy])
    got = torch.autograd.grad(outs, [x for x in xs if x.requires_grad], gouts)
    ps = leaves_of(args)
    py, phT = km.mamba_selective_scan_torch(*ps)
    want = torch.autograd.grad([py, phT] if with_state else [py],
                               [x for x in ps if x.requires_grad], gouts)
    assert len(got) == len(want) == sum(need)
    for g, w, x in zip(got, want, [x for x in xs if x.requires_grad]):
        assert g.dtype == x.dtype and g.shape == x.shape
        scale = float(w.double().abs().max())
        assert float((g.double() - w.double()).abs().max()) <= FN_REL * scale


def test_mamba_takes_the_function_only_for_a_gradient(monkeypatch):
    """The Mamba block routes its scan through ``SelectiveScan`` exactly
    when a gradient is asked for: serving calls the wrapper as before."""
    _, tcfg = configs(ARCH)
    params = params_from_numpy(tcfg, port_params_np(tcfg), device="cpu")
    calls = []
    real = TM.SelectiveScan.apply
    monkeypatch.setattr(TM.SelectiveScan, "apply", lambda *a: calls.append("fn") or real(*a))
    with torch.no_grad():
        TH.forward(params, tcfg, tb(batch(tcfg))["tokens"])
    assert calls == []
    loss_and_grads(build_model(tcfg), params, tb(batch(tcfg)))
    n_mamba = sum(not TH.is_attn(tcfg, i) for i in range(TH.PERIOD)) * tcfg.n_layers // TH.PERIOD
    # each Mamba layer's forward and its period's remat recompute
    assert calls == ["fn"] * (2 * n_mamba)


def test_gradient_check_catches_a_scan_without_grad_fn(monkeypatch):
    """A scan whose outputs carry no grad_fn leaves in_proj, x_proj,
    dt_proj and the rest upstream of it without their scan path; the
    port's gradients then lack a_log's, which only the scan uses, and it
    refuses to return them rather than returning zeros."""
    _, tcfg = configs(ARCH)
    params = params_from_numpy(tcfg, port_params_np(tcfg), device="cpu")

    def detached(*xs):
        return km.mamba_selective_scan_torch(*(x.detach() for x in xs))

    monkeypatch.setattr(TM.SelectiveScan, "apply", detached)
    with pytest.raises(RuntimeError, match="not have been used"):
        loss_and_grads(build_model(tcfg), params, tb(batch(tcfg)))


def test_launch_train_smoke():
    """``launch.train --device cpu --smoke --arch jamba-v0.1-52b``: 2 steps,
    finite losses and grad norms."""
    launch_train_smoke(ARCH)
