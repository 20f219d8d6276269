"""Port: flash attention (``repro_torch.kernels.flash_attention``).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there). Here the plain version, and the wrapper's CPU
route, are held to the JAX Pallas kernel in interpret mode and to
``attention_ref`` on the shapes of ``tests/test_kernels.py``, and to
``attention_ref`` alone on the ragged shapes and decode offsets that the
Pallas kernel's block divisibility refuses; the wrapper's contract (the
kernel's dtypes, head dims and layouts) is tested.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref

#: f32: sums of dh products in another order; bf16: the output's rounding
#: (tests/test_kernels.py's bounds for the Pallas kernel)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, Sq, Skv, H, Hkv, dh, causal): tests/test_kernels.py's sweep
SWEEP = [
    (1, 64, 64, 2, 2, 32, True),
    (2, 128, 128, 4, 2, 64, True),
    (1, 64, 128, 2, 1, 32, False),  # cross-attention-like
    (2, 1, 128, 4, 4, 32, True),  # decode: Sq=1
]


def _inputs(B, Sq, Skv, H, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, dh)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _fold(x, G):
    """[B, S, Hx, dh] -> [B * Hx * G, S, dh]: kv heads repeated G times, the
    JAX wrapper's layout."""
    B, S, Hx, dh = x.shape
    return torch.repeat_interleave(x, G, dim=2).permute(0, 2, 1, 3).reshape(B * Hx * G, S, dh)


def _ref(q, k, v, causal, q_offset, dtype=torch.float32):
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    out = attention_ref(_fold(q, 1), _fold(k, G), _fold(v, G), causal=causal,
                        q_offset=q_offset, dtype=dtype)
    return out.reshape(B, H, Sq, dh).permute(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,dh,causal", SWEEP)
def test_plain_and_cpu_route_match_pallas_and_ref(B, Sq, Skv, H, Hkv, dh, causal, dtype):
    arrs = _inputs(B, Sq, Skv, H, Hkv, dh, seed=B * 100 + Sq + Skv + H)
    q_offset = Skv - Sq if causal else 0
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    pallas = jops.gqa_flash_attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                                      mode="interpret", block_q=32, block_k=32)
    G = H // Hkv
    fold = lambda x, g: jnp.repeat(x, g, axis=2).transpose(0, 2, 1, 3).reshape(  # noqa: E731
        B * H, -1, dh)
    jax_ref = jref.attention_ref(fold(jq, 1), fold(jk, G), fold(jv, G), causal=causal,
                                 q_offset=q_offset)
    jax_ref = np.asarray(jax_ref, np.float32).reshape(B, H, Sq, dh).transpose(0, 2, 1, 3)
    q, k, v = _torch(arrs, dtype)
    kf.reset_launches()
    for fn in (kf.flash_attention_torch, kf.flash_attention):
        out = fn(q, k, v, causal=causal, q_offset=q_offset)
        assert out.dtype == q.dtype and tuple(out.shape) == (B, Sq, H, dh)
        got = out.float().numpy()
        for want in (np.asarray(pallas, np.float32), jax_ref,
                     _ref(q, k, v, causal, q_offset).float().numpy()):
            np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    assert not kf.LAUNCHES  # the CPU route never counts a launch


# ragged lengths and decode offsets, which the Pallas kernel's divisibility
# assert refuses; (B, Sq, Skv, H, Hkv, dh, causal, q_offset)
RAGGED = [
    (2, 17, 45, 4, 2, 16, True, 28),  # ragged prompt against a ragged cache
    (1, 17, 17, 6, 3, 64, True, 0),
    (2, 17, 45, 4, 1, 32, False, 0),
    (3, 1, 45, 8, 2, 128, True, 0),  # decode at the start of the cache
    (3, 1, 45, 8, 2, 64, True, 30),  # decode mid-cache: rows past 30 unseen
    (3, 1, 45, 8, 2, 64, True, 44),  # decode at the last row
    (2, 5, 300, 32, 4, 64, True, 200),  # a tinyllama group (G = 8), kv tiles of 128
    (1, 3, 20, 24, 8, 128, True, 17),  # a llama3.2 group (G = 3)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,dh,causal,q_offset", RAGGED)
def test_ragged_and_decode_offsets_match_ref(B, Sq, Skv, H, Hkv, dh, causal, q_offset, dtype):
    q, k, v = _torch(_inputs(B, Sq, Skv, H, Hkv, dh, seed=Sq * 1000 + Skv + q_offset), dtype)
    want = _ref(q, k, v, causal, q_offset, dtype=torch.float64).double()
    got = ops.gqa_flash_attention(q, k, v, causal=causal, q_offset=q_offset, mode="torch")
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_unseen_cache_rows_do_not_matter():
    """Causal decode reads only rows <= q_offset: garbage past them (the
    cache's unwritten rows) changes nothing."""
    q, k, v = _torch(_inputs(2, 1, 40, 8, 2, 32, seed=4), "bfloat16")
    a = kf.flash_attention(q, k, v, causal=True, q_offset=20)
    k[:, 21:] = float("nan")
    v[:, 21:] = float("inf")
    b = kf.flash_attention(q, k, v, causal=True, q_offset=20)
    assert torch.equal(a, b)


def test_float32_q_reads_a_bf16_cache():
    """The float32-compute model reads its bf16 KV cache: the same values as
    casting the cache to float32 first."""
    arrs = _inputs(2, 3, 24, 4, 2, 16, seed=6)
    q = torch.from_numpy(arrs[0])
    k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs[1:])
    got = kf.flash_attention(q, k, v, causal=True, q_offset=21)
    assert got.dtype == torch.float32
    want = kf.flash_attention(q, k.float(), v.float(), causal=True, q_offset=21)
    assert torch.equal(got, want)


def test_modes_and_contract():
    q, k, v = _torch(_inputs(1, 4, 8, 2, 1, 16, seed=2), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gqa_flash_attention(q, k, v, mode="cuda")
    with pytest.raises(ValueError, match="mode"):
        ops.gqa_flash_attention(q, k, v, mode="jnp")
    bad = [
        ((q[..., :12], k[..., :12], v[..., :12]), ValueError),  # dh not in 16/32/64/128
        ((q.double(), k, v), TypeError),
        ((q, k.half(), v.half()), TypeError),
        ((q.bfloat16(), k, v), TypeError),  # bf16 q, float32 kv
        ((q, k, v.bfloat16()), TypeError),  # k and v differ
        ((q, k.transpose(1, 3).contiguous().transpose(1, 3), v), ValueError),  # dim stride
        ((q, k[:, :, :, 1:], v[:, :, :, 1:]), ValueError),
        ((torch.zeros(1, 4, 3, 16), k, v), ValueError),  # 3 heads over 1 kv head is fine ...
    ]
    for args, err in bad[:-1]:
        with pytest.raises(err):
            kf.flash_attention(*args)
    assert kf.flash_attention(*bad[-1][0]).shape == (1, 4, 3, 16)  # ... G = 3
    with pytest.raises(ValueError, match="group"):
        kf.flash_attention(torch.zeros(1, 4, 3, 16), torch.zeros(1, 8, 2, 16),
                           torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="q_offset"):
        kf.flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kf.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
