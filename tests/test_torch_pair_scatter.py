"""Port: the pair-statistic scatter (``repro_torch.kernels.telemetry``).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds both of its
entries against their plain versions there). Here the contract entry's plain
PyTorch version and the wrapper's CPU route are held to a float64 oracle
computed inside each test, to the copied ``pair_scatter_ref`` and to the JAX
Pallas kernel in interpret mode, on the same seeded inputs; the banked
entry's plain version and CPU route to ``pair_scatter_banked_ref`` and to
the scatter-add of the JAX package's ``_bank_core``; and both wrappers'
contracts (empty batch, stacked and squeezed statistics, dropped keys, the
debug raise, argument checks) are tested.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.telemetry import pair_scatter as pallas_pair_scatter
from repro_torch.kernels import ops
from repro_torch.kernels import telemetry as kt
from repro_torch.kernels.ref import pair_scatter_banked_ref, pair_scatter_ref
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


# --- the banked entry ------------------------------------------------------------

# (m, B, T, K, share of keys dropped): the rack stream's shapes cut down, a
# bank of one, dropped keys, repeated keys, K = 1..3
BANKED_SHAPES = [(64, 256, 230, 2, 0.0), (1, 40, 230, 2, 0.1), (8, 300, 32, 2, 0.4),
                 (3, 200, 16, 1, 0.0), (5, 97, 64, 3, 0.2), (2, 64, 230, 2, 1.0)]


def _banked_inputs(m, B, T, K, drop, seed):
    """Keys server * T + type; a ``drop`` share -1 or past the key space;
    a third of the rows repeat the key of row 0's neighbourhood, so some
    slots sum many rows."""
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, m, B) * T + rng.integers(0, T, B)).astype(np.int32)
    keys[: B // 3] = keys[rng.integers(0, 3, B // 3)]
    bad = rng.random(B) < drop
    keys[bad] = rng.choice(np.array([-1, m * T, m * T + 7], np.int32), int(bad.sum()))
    co = (rng.random((B, T)) * 2).astype(np.float32)
    vals = rng.normal(size=(K, B)).astype(np.float32)
    return keys, co, vals


def _jax_bank_scatter(keys, co, vals, m, T):
    """The scatter-add of ``repro/telemetry/estimator.py``'s ``_bank_core``
    (its GPU lowering): contributions added into a dense [K, m, T + 1, T]
    table at (server, type), dropped rows into the dump slot T."""
    keys = jnp.asarray(keys)
    ok = (keys >= 0) & (keys < m * T)
    s_clip = jnp.clip(keys // T, 0, m - 1)
    tt = jnp.where(ok, keys % T, T)
    contrib = jnp.asarray(co)[None, :, :] * jnp.asarray(vals)[:, :, None]
    acc = jnp.zeros((vals.shape[0], m, T + 1, T), jnp.float32).at[:, s_clip, tt].add(contrib)
    return np.asarray(acc[:, :, :T]).reshape(vals.shape[0], m * T, T)


@pytest.mark.parametrize("m,B,T,K,drop", BANKED_SHAPES)
def test_banked_plain_and_cpu_wrapper_match_ref_and_jax(m, B, T, K, drop):
    keys, co, vals = _banked_inputs(m, B, T, K, drop, seed=m * 1000 + B + T)
    want_rows, want_keys = pair_scatter_banked_ref(keys, co, vals, m * T)
    dense = _jax_bank_scatter(keys, co, vals, m, T)
    n = int((want_keys < m * T).sum())
    assert n == len(np.unique(keys[(keys >= 0) & (keys < m * T)]))
    kt.reset_launches()
    for fn in (kt.pair_scatter_banked_torch, kt.pair_scatter_banked):
        rows, slot_keys = fn(*_tensors(keys, co, vals), m * T)
        assert rows.dtype == torch.float32 and slot_keys.dtype == torch.int32
        assert tuple(rows.shape) == (K, B, T) and tuple(slot_keys.shape) == (B,)
        np.testing.assert_array_equal(slot_keys.numpy(), want_keys)
        np.testing.assert_allclose(rows.numpy(), want_rows, **TOL)
        np.testing.assert_allclose(rows[:, :n].numpy(), dense[:, want_keys[:n]], **TOL)
        assert not rows[:, n:].any()  # slots past the last key hold zeros
    assert not kt.LAUNCHES  # the CPU route never counts a launch


def test_banked_contract_entry_agree_on_a_bank_of_one():
    """With one bank row the key is the type: the banked rows are the
    contract entry's target-major rows of the types present."""
    T = 64
    types, cbar, vals = _inputs(120, T, 2, seed=13)
    pair, _ = kt.pair_scatter(*_tensors(types, cbar, vals))
    rows, slot_keys = kt.pair_scatter_banked(*_tensors(types, cbar, vals), T)
    n = int((slot_keys < T).sum())
    present = slot_keys[:n].long()
    np.testing.assert_allclose(rows[:, :n].numpy(), pair.transpose(1, 2)[:, present].numpy(),
                               **TOL)
    absent = np.setdiff1d(np.arange(T), present.numpy())
    assert not pair[:, :, absent].any()


@pytest.mark.parametrize("K", [1, 2])
def test_banked_empty_and_all_dropped(K):
    T, n_rows = 32, 4 * 32
    keys, co, vals = _banked_inputs(4, 0, T, K, 0.0, seed=1)
    rows, slot_keys = kt.pair_scatter_banked(*_tensors(keys, co, vals), n_rows)
    assert tuple(rows.shape) == (K, 0, T) and tuple(slot_keys.shape) == (0,)
    rr, rk = pair_scatter_banked_ref(keys, co, vals, n_rows)
    assert rr.shape == (K, 0, T) and rk.shape == (0,)
    keys, co, vals = _banked_inputs(4, 30, T, K, 1.0, seed=2)
    rows, slot_keys = kt.pair_scatter_banked(*_tensors(keys, co, vals), n_rows)
    assert not rows.any() and bool((slot_keys == n_rows).all())


def test_banked_debug_checks_and_devices():
    T, n_rows = 16, 3 * 16
    keys, co, vals = _banked_inputs(3, 20, T, 2, 0.0, seed=5)
    kt.pair_scatter_banked(*_tensors(keys, co, vals), n_rows, debug=True)
    keys[7] = n_rows
    with pytest.raises(ValueError, match=r"keys\[7\] = 48 >= n_rows = 48"):
        kt.pair_scatter_banked(*_tensors(keys, co, vals), n_rows, debug=True)
    kt.pair_scatter_banked(*_tensors(keys, co, vals), n_rows)  # off: the row drops
    k, c, v = _tensors(keys, co, vals)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kt.pair_scatter_banked(k.to("meta"), c.to("meta"), v.to("meta"), n_rows)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kt.pair_scatter(k.to("meta"), c.to("meta"), v.to("meta"))
    cases = [
        ((k, c, v[0], n_rows), ValueError),  # vals must be [K, B]
        ((k, c, v, 0), ValueError),  # no key space
        ((k.long(), c, v, n_rows), TypeError),
        ((k, c.double(), v, n_rows), TypeError),
        ((k, torch.zeros(20, 300), v, n_rows), ValueError),  # T past the lanes
        ((k, c, torch.zeros(5, 20), n_rows), ValueError),  # K past the registers
    ]
    for args, err in cases:
        with pytest.raises(err):
            kt._check_banked(*args)
    kt._check_banked(k, c, v, n_rows)


@pytest.mark.parametrize("B", [1, 256, 257, 4096, 8192, 9000])
def test_scratch_covers_the_kernel_layout(B):
    """The launch's int32 scratch. The contract: per chunk of 256 rows, its
    sorted rows and each type's count and first position. The bank: the
    sorted rows [B], the segment starts [B + 1], and the sort's two
    ping-pong halves [4 B] once B passes the keys it keeps in shared
    memory."""
    chunks = (B + 255) // 256
    assert kt._scratch_ints(B, banked=False) == 3 * 256 * chunks
    assert kt._scratch_ints(B, banked=True) == 2 * B + 1 + (4 * B if B > kt.SMEM_ROWS else 0)
