"""Port: the optimizers and schedules (``repro_torch.optim``) against JAX's.

The same random tree (numpy, seeded) goes through JAX's and the port's
AdamW, 8-bit AdamW and Adafactor for 1 and 3 steps, with the global-norm
clip biting and not. Tolerance: each new parameter and state leaf within
1e-6 relative of JAX's, measured against the largest magnitude of its
part of the tree (parameters, m, v, factors) -- the global norm is a
float32 sum in another order, a few ulps apart, and its clip scale enters
every leaf. The 8-bit codes must be equal except where m2 / scale lies
at a .5 rounding tie after those ulps (the count is printed and bounded).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as JOptConfig
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import constant as jax_constant
from repro.optim import global_norm as jax_global_norm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim.adamw import _dq8 as jax_dq8
from repro.optim.adamw import _q8 as jax_q8
from repro_torch.convert import opt_state_from_numpy
from repro_torch.optim import (OptConfig, clip_by_global_norm, constant, global_norm,
                               make_optimizer, warmup_cosine)
from repro_torch.optim.adamw import _dq8, _q8
from repro_torch.tree import leaves, leaves_with_path

OPTIMIZERS = ["adamw", "adamw8bit", "adafactor"]
#: relative to the largest magnitude of the compared part of the tree
REL = 1e-6
#: 8-bit codes allowed to differ (rounding ties), out of ~4,400 per moment
MAX_TIES = 4
#: the tree: nested dicts, a 3-d, 2-d, 1-d and 0-d leaf, sizes off the
#: 8-bit block (256)
SHAPES = {"a": {"w": (3, 5, 7), "b": (7,)}, "c": (33, 130), "s": ()}


def _tree(rng, scale=1.0):
    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return np.asarray(rng.normal(size=t) * scale, np.float32)
    return draw(SHAPES)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _parts(state):
    """(name, leaves) of each part whose leaves share a scale."""
    out = {}
    for path, leaf in leaves_with_path(state):
        out.setdefault((path[0], path[-1]), []).append(leaf)
    return out


def _run(name, n_steps, grad_scale):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(n_steps)]
    jinit, jupd = jax_make_optimizer(name, JOptConfig())
    tinit, tupd = make_optimizer(name, OptConfig())
    jp, tp = _jax(params), _torch(params)
    js, ts = jinit(jp), tinit(tp)
    for k, g in enumerate(grads):
        lr = 1e-2 * (k + 1)
        jp, js, jstats = jupd(jp, _jax(g), js, jnp.float32(lr), JOptConfig())
        tp, ts, tstats = tupd(tp, _torch(g), ts, torch.tensor(lr, dtype=torch.float32),
                              OptConfig())
    return (jp, js, jstats), (tp, ts, tstats)


@pytest.mark.parametrize("grad_scale", [0.01, 3.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_steps_match_jax(name, n_steps, grad_scale):
    (jp, js, jstats), (tp, ts, tstats) = _run(name, n_steps, grad_scale)
    want = {"params": jax.tree_util.tree_map(np.asarray, jp),
            "state": jax.tree_util.tree_map(np.asarray, js)}
    got = {"params": tp, "state": ts}
    assert len(leaves(want)) == len(leaves(got))
    gn, jgn = float(tstats["grad_norm"]), float(jstats["grad_norm"])
    assert gn == pytest.approx(jgn, rel=REL)
    assert (jgn > 1.0) == (grad_scale > 1.0)  # the clip bites in the clipped cases
    ties = 0
    wparts, gparts = _parts(want), _parts(got)
    assert wparts.keys() == gparts.keys()
    for key in wparts:
        scale = max(float(np.abs(w.astype(np.float64)).max()) for w in wparts[key])
        for w, g in zip(wparts[key], gparts[key]):
            g = g.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, (key, g.shape, w.shape)
            if w.dtype == np.int8:
                ties += int((g != w).sum())
                assert np.abs(g.astype(np.int32) - w).max(initial=0) <= 1, key
            elif w.dtype == np.int32:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=REL * scale, err_msg=str(key))
    print(f"{name} x{n_steps} ({'clipped' if grad_scale > 1 else 'unclipped'}): "
          f"grad norm {gn} vs {jgn}, 8-bit codes apart {ties}")
    assert ties <= MAX_TIES


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_next_step_from_a_carried_jax_state(name):
    """A JAX state after 2 steps, carried across with ``opt_state_from_numpy``
    (keys, shapes, dtypes checked): the port's third step equals JAX's."""
    rng = np.random.default_rng(8)
    params, g1, g2, g3 = _tree(rng), _tree(rng), _tree(rng), _tree(rng)
    jinit, jupd = jax_make_optimizer(name, JOptConfig())
    jp, js = _jax(params), jinit(_jax(params))
    for g in (g1, g2):
        jp, js, _ = jupd(jp, _jax(g), js, jnp.float32(1e-2), JOptConfig())
    state_np = jax.tree_util.tree_map(np.asarray, js)
    params_np = jax.tree_util.tree_map(np.asarray, jp)
    ts = opt_state_from_numpy(name, state_np, params_np, device="cpu")
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    _, tupd = make_optimizer(name, OptConfig())
    tp, ts, _ = tupd(_torch(params_np), _torch(g3), ts, torch.tensor(1e-2), OptConfig())
    jp, js, _ = jupd(jp, _jax(g3), js, jnp.float32(1e-2), JOptConfig())
    for w, g in zip(jax.tree_util.tree_leaves(jp), leaves(tp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=REL * float(np.abs(np.asarray(w)).max()))
    with pytest.raises(KeyError):
        opt_state_from_numpy(name, {k: v for k, v in state_np.items() if k != "step"},
                             params_np, device="cpu")
    wrong = jax.tree_util.tree_map(lambda a: a.astype(np.float64) if a.ndim else a, state_np)
    with pytest.raises((TypeError, ValueError)):
        opt_state_from_numpy(name, wrong, params_np, device="cpu")


def test_schedules_match_jax():
    """warmup_cosine (float32 arithmetic on a float32 step) and constant at
    every step of a 120-step schedule and past its end: bit for bit but
    where the float32 cosine (XLA's polynomial against PyTorch's) rounds the
    other way, at 3 of 130 steps, where the lr lies within 2 float32 ulps
    (the cosine's one ulp, carried through three roundings)."""
    kw = dict(peak_lr=3e-4, warmup_steps=12, total_steps=120)
    apart = 0
    for step in range(0, 130):
        got = warmup_cosine(step, **kw)
        want = np.asarray(jax_warmup_cosine(step, **kw))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
        apart += int(got.numpy() != want)
        assert constant(step, peak_lr=3e-4).numpy() == np.asarray(jax_constant(step, peak_lr=3e-4))
    assert apart <= 3, apart
    t = torch.tensor(7, dtype=torch.int32)
    assert float(warmup_cosine(t, **kw)) == float(jax_warmup_cosine(jnp.int32(7), **kw))


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])
def test_clipping_matches_jax(grad_scale):
    g = _tree(np.random.default_rng(9), grad_scale)
    gn, jgn = global_norm(_torch(g)), jax_global_norm(_jax(g))
    assert float(gn) == pytest.approx(float(jgn), rel=REL)
    clipped, cn = clip_by_global_norm(_torch(g), 1.0)
    jclipped, jcn = jax_clip(_jax(g), 1.0)
    assert float(cn) == pytest.approx(float(jcn), rel=REL)
    for got, want in zip(leaves(clipped), jax.tree_util.tree_leaves(jclipped)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 * REL, atol=0)
    assert float(global_norm(clipped)) == pytest.approx(min(1.0, float(jgn)), rel=1e-5)


@pytest.mark.parametrize("n", [1, 255, 256, 1000])
def test_q8_codes_and_roundtrip_match_jax(n):
    x = (np.random.default_rng(n).normal(size=n) * 10).astype(np.float32)
    q, s = _q8(torch.from_numpy(x), 256)
    jq, js = jax_q8(jnp.asarray(x), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_dq8(q, s, (n,), 256).numpy(),
                                  np.asarray(jax_dq8(jq, js, (n,), 256)))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd", OptConfig())
