"""Port: the pair-statistic scatter (``repro_torch.kernels.telemetry``).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there). Here the plain PyTorch version and the wrapper's
CPU route are held to a float64 oracle computed inside each test, to the
copied ``pair_scatter_ref`` and to the JAX Pallas kernel in interpret mode,
on the same seeded inputs, and the wrapper's contract (empty batch, stacked
and squeezed statistics, dropped types, the debug raise, argument checks)
is tested.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.telemetry import pair_scatter as pallas_pair_scatter
from repro_torch.kernels import ops
from repro_torch.kernels import telemetry as kt
from repro_torch.kernels.ref import pair_scatter_ref
from repro_torch.telemetry.estimator import make_scatter

#: f32 sums of B products of values in [0, 2) x N(0, 1), against float64: the
#: bound of tests/test_kernels.py's scatter cases
TOL = dict(atol=2e-5, rtol=1e-5)

# (B, T, K): tests/test_kernels.py's shapes (K=None: 1-D vals)
SHAPES = [(1, 16, None), (7, 230, None), (128, 230, None), (300, 64, None), (193, 64, None),
          (40, 64, 2), (300, 32, 3), (64, 230, 1)]


def _inputs(B, T, K, seed):
    """Types drawn from [-1, T + 2): padding and past-the-table rows too."""
    rng = np.random.default_rng(seed)
    types = rng.integers(-1, T + 2, size=B).astype(np.int32)
    cbar = (rng.random((B, T)) * 2).astype(np.float32)
    vals = rng.normal(size=B if K is None else (K, B)).astype(np.float32)
    return types, cbar, vals


def _oracle(types, cbar, vals):
    """float64 one-hot contraction, written out here."""
    T = cbar.shape[1]
    v = np.atleast_2d(vals).astype(np.float64)
    onehot = (np.arange(T)[None, :] == types[:, None]).astype(np.float64)
    base = v @ onehot
    pair = np.einsum("bu,kb,bt->kut", cbar.astype(np.float64), v, onehot)
    return (pair[0], base[0]) if vals.ndim == 1 else (pair, base)


def _tensors(types, cbar, vals):
    return torch.from_numpy(types), torch.from_numpy(cbar), torch.from_numpy(vals)


@pytest.mark.parametrize("B,T,K", SHAPES)
def test_plain_and_cpu_wrapper_match_oracle_ref_and_pallas(B, T, K):
    types, cbar, vals = _inputs(B, T, K, seed=B * 1000 + T + (K or 0))
    want_pair, want_base = _oracle(types, cbar, vals)
    ref_pair, ref_base = pair_scatter_ref(types, cbar, vals)
    np.testing.assert_allclose(ref_pair, want_pair, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ref_base, want_base, rtol=1e-12, atol=1e-12)
    with jax.default_matmul_precision("highest"):
        p_pair, p_base = pallas_pair_scatter(jnp.asarray(types), jnp.asarray(cbar),
                                             jnp.asarray(vals), interpret=True, debug=False)
    kt.reset_launches()
    for fn in (kt.pair_scatter_torch, kt.pair_scatter):
        pair, base = fn(*_tensors(types, cbar, vals))
        assert pair.dtype == base.dtype == torch.float32
        assert pair.shape == want_pair.shape and base.shape == want_base.shape
        for got, want in ((pair, want_pair), (base, want_base)):
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(pair.numpy(), np.asarray(p_pair), **TOL)
        np.testing.assert_allclose(base.numpy(), np.asarray(p_base), **TOL)
    assert not kt.LAUNCHES  # the CPU route never counts a launch


@pytest.mark.parametrize("K", [None, 1, 2])
def test_empty_batch_every_backend(K):
    T = 32
    types, cbar, vals = _inputs(0, T, K, seed=1)
    shape = ((T, T), (T,)) if K is None else ((K, T, T), (K, T))
    for fn in (kt.pair_scatter_torch, kt.pair_scatter):
        pair, base = fn(*_tensors(types, cbar, vals))
        assert (tuple(pair.shape), tuple(base.shape)) == shape
        assert not pair.any() and not base.any()
    pair, base = pair_scatter_ref(types, cbar, vals)
    assert (pair.shape, base.shape) == shape and not pair.any() and not base.any()
    v2 = np.atleast_2d(vals)
    for backend in ("torch", "numpy"):
        pair, base = make_scatter(backend)(*_tensors(types, cbar.astype(np.float64),
                                                     v2.astype(np.float64)))
        assert pair.dtype == torch.float64 and tuple(pair.shape) == (v2.shape[0], T, T)
        assert not pair.any() and not base.any()


def test_stacked_k1_keeps_its_axis_and_equals_squeezed():
    types, cbar, vals = _inputs(64, 230, None, seed=5)
    t, c, v = _tensors(types, cbar, vals)
    p1, b1 = kt.pair_scatter(t, c, v)
    pk, bk = kt.pair_scatter(t, c, v[None])
    assert tuple(p1.shape) == (230, 230) and tuple(pk.shape) == (1, 230, 230)
    assert tuple(b1.shape) == (230,) and tuple(bk.shape) == (1, 230)
    assert torch.equal(pk[0], p1) and torch.equal(bk[0], b1)


def test_out_of_range_types_are_dropped():
    T = 16
    types, cbar, vals = _inputs(50, T, 2, seed=7)
    types[::3] = -1
    types[1::7] = T + 1
    keep = (types >= 0) & (types < T)
    pair, base = kt.pair_scatter(*_tensors(types, cbar, vals))
    pair_k, base_k = kt.pair_scatter(*_tensors(types[keep], cbar[keep], vals[:, keep]))
    assert torch.equal(pair, pair_k) and torch.equal(base, base_k)
    all_bad = np.full_like(types, -1)
    pair, base = kt.pair_scatter(*_tensors(all_bad, cbar, vals))
    assert not pair.any() and not base.any()


def test_debug_raises_on_type_past_the_table():
    T = 16
    types, cbar, vals = _inputs(20, T, None, seed=9)
    types[:] = np.clip(types, -1, T - 1)
    kt.pair_scatter(*_tensors(types, cbar, vals), debug=True)  # -1 is legal
    types[11] = T
    with pytest.raises(ValueError, match=r"types\[11\] = 16 >= T = 16"):
        kt.pair_scatter(*_tensors(types, cbar, vals), debug=True)
    kt.pair_scatter(*_tensors(types, cbar, vals))  # off: the row is dropped


def test_kernel_argument_checks():
    types, cbar, vals = _tensors(*_inputs(8, 32, 2, seed=3))
    cases = [
        ((types.long(), cbar, vals), TypeError),
        ((types, cbar.double(), vals), TypeError),
        ((types, cbar, vals[:, :5]), ValueError),
        ((types, cbar.T.contiguous().T, vals), ValueError),  # not contiguous
        ((types, torch.zeros(8, 300), vals), ValueError),  # T past one CTA
        ((types, cbar, torch.zeros(5, 8)), ValueError),  # K past the registers
    ]
    for args, err in cases:
        with pytest.raises(err):
            kt._check(*args)
    kt._check(types, cbar, vals)
    kt._check(types, cbar, vals[0])


def test_ops_and_scatter_backends():
    types, cbar, vals = _inputs(40, 64, 2, seed=11)
    t, c, v = _tensors(types, cbar, vals)
    with pytest.raises(ValueError, match="CUDA"):
        ops.telemetry_pair_scatter(t, c, v, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        make_scatter("cuda")(t, c.double(), v.double())
    with pytest.raises(ValueError):
        ops.telemetry_pair_scatter(t, c, v, mode="pallas")
    with pytest.raises(ValueError):
        make_scatter("auto")
    pair, base = ops.telemetry_pair_scatter(t, c, v, mode="torch")
    want_pair, want_base = _oracle(types, cbar, vals)
    np.testing.assert_allclose(pair.numpy(), want_pair, **TOL)
    for backend in ("torch", "numpy"):
        pair, base = make_scatter(backend)(t, c.double(), v.double())
        assert pair.dtype == base.dtype == torch.float64
        np.testing.assert_allclose(pair.numpy(), want_pair, **TOL)
        np.testing.assert_allclose(base.numpy(), want_base, **TOL)
