"""Port: the Mamba block (``repro_torch.models.mamba``) against the JAX one.

SMOKE configuration of jamba-v0.1-52b (d_model 64, inner width 128, state
4, conv 4). One block's weights come from the JAX package's ``materialize``
of the unstacked declaration (its fan-in scale keeps unit-scale inputs at
unit scale), with noise on the constant leaves (``conv_b`` zeros,
``d_skip`` ones) so that a leaf read at the wrong place shows; inputs are
seeded numpy arrays. On the CPU the scan runs the kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import mamba as JM
from repro.models import materialize as jax_materialize
from repro_torch.configs import get_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import mamba as TM

ARCH = "jamba-v0.1-52b"
#: float32 compute: max |port - JAX| within 1e-5 of the JAX output's max |.|
F32_TOL = 1e-5
#: bf16 compute, one block on unit-scale inputs: a few bf16 roundings apart
BF16_TOL = 2e-2


def _configs(compute):
    jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    return (dataclasses.replace(jcfg, compute_dtype=getattr(jnp, compute)),
            dataclasses.replace(tcfg, compute_dtype=getattr(torch, compute)))


def _gap(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max()) / float(np.abs(w).max())


def _block_params(jcfg, seed):
    p = jax.tree_util.tree_map(np.array, jax_materialize(JM.layer_infos(jcfg),
                                                         jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "d_skip"):
        p[name] = p[name] + (0.1 * rng.normal(size=p[name].shape)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}


def _state(jcfg, B, rng):
    """A nonzero Mamba state: h float32 and a conv tail rounded to bf16."""
    E, N, K = 2 * jcfg.d_model, jcfg.mamba_dstate, jcfg.mamba_dconv
    h = rng.normal(size=(B, E, N)).astype(np.float32)
    conv = np.asarray(jnp.asarray(rng.normal(size=(B, K - 1, E)), jnp.bfloat16))
    return ({"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
            {"h": torch.from_numpy(h), "conv": tensor_from_numpy(conv, torch.device("cpu"))})


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def blocks(request):
    """(compute, JAX and port results of ``apply`` from a zero state and a
    nonzero one), on the same weights and inputs."""
    compute = request.param
    jcfg, tcfg = _configs(compute)
    jp, tp = _block_params(jcfg, 4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jcfg.compute_dtype), torch.from_numpy(x).to(tcfg.compute_dtype)
    out = {}
    for stateful in (False, True):
        js, ts = _state(jcfg, 2, rng) if stateful else (None, None)
        out[stateful] = (JM.apply(jp, jx, jcfg, js), TM.apply(tp, tx, tcfg, ts))
    return compute, out


@pytest.mark.parametrize("stateful", [False, True])
def test_block_matches_jax(blocks, stateful):
    """The block's output and new state from a zero state or a nonzero one:
    at float32 output and h within 1e-5 and the conv tail bitwise; at bf16
    within 2e-2 (products and elementwise passes round at other places)."""
    compute, out = blocks
    (want, wnew), (got, gnew) = out[stateful]
    tol = F32_TOL if compute == "float32" else BF16_TOL
    assert got.dtype == getattr(torch, compute) and tuple(got.shape) == tuple(want.shape)
    assert _gap(got, want) <= tol
    assert gnew["h"].dtype == torch.float32 and _gap(gnew["h"], wnew["h"]) <= tol
    assert gnew["conv"].dtype == torch.bfloat16
    if compute == "float32":  # rounded to bf16 from float32 rows: bitwise
        np.testing.assert_array_equal(gnew["conv"].view(torch.int16).numpy(),
                                      np.asarray(wnew["conv"]).view(np.int16))
    else:
        assert _gap(gnew["conv"], wnew["conv"]) <= tol


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("stateful", [False, True])
def test_causal_conv_matches_jax(stateful, compute):
    """The depthwise causal convolution and its tail, from zeros or from a
    previous tail: the same taps summed in the same order."""
    rng = np.random.default_rng(5)
    u, w, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 7, 12), (4, 12), (12,)))
    prev = rng.normal(size=(2, 3, 12)).astype(np.float32) if stateful else None
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)
    jy, jt = JM._causal_conv(jnp.asarray(u, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
                             None if prev is None else jnp.asarray(prev, jnp.bfloat16))
    ty, tt = TM._causal_conv(torch.from_numpy(u).to(tdt), torch.from_numpy(w).to(tdt),
                             torch.from_numpy(b).to(tdt),
                             None if prev is None else torch.from_numpy(prev).bfloat16())
    tol = F32_TOL if compute == "float32" else BF16_TOL
    assert _gap(ty, jy) <= tol and tuple(tt.shape) == (2, 3, 12)
    np.testing.assert_array_equal(tt.float().numpy(), np.asarray(jt, np.float32))


def test_block_keeps_a_log_and_dt_bias_float32():
    """At bf16 compute ``a_log`` and ``dt_bias`` stay float32 masters (JAX
    uses them uncast); the projections, conv and skip are cast."""
    lm = build_model(get_config(ARCH, smoke=True)).init(device="cpu")
    block = lm.periods[0].subs["sub0"]["mamba"]
    for name in ("a_log", "dt_bias"):
        assert block.c[name].dtype == torch.float32, name
        assert block.c[name].data_ptr() == getattr(block, name).data_ptr()
    for name in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "d_skip", "out_proj"):
        assert block.c[name].dtype == torch.bfloat16, name


def test_block_runs_its_scan_through_the_op(monkeypatch):
    """The block's scan goes through ``ops.selective_scan`` with the model
    entry's inputs: delta float32 [B, S, E], u contiguous, B and C strided
    views of one projection, A = -exp(a_log)."""
    jcfg, tcfg = _configs("bfloat16")
    _, tp = _block_params(jcfg, 6)
    seen = []
    real = ops.selective_scan

    def spy(delta, u, bm, cm, A, h0, *, mode):
        seen.append((delta.dtype, u.is_contiguous(), bm.is_contiguous(), mode))
        torch.testing.assert_close(A, -torch.exp(tp["a_log"]))
        return real(delta, u, bm, cm, A, h0, mode=mode)

    monkeypatch.setattr(TM.ops, "selective_scan", spy)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32))
    TM.apply(tp, x.bfloat16(), tcfg, None)
    assert seen == [(torch.float32, True, False, "torch")]
