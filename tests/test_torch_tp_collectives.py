"""Port: the multi-device pieces under the decoder LMs' sharded route.

* ``distributed.collectives``: a mesh's ``all_reduce``, ``all_gather`` and
  ``reduce_scatter`` over ('data', 'model'), and the autograd pairs'
  forwards and backwards, at 1, 2 and 4 gloo ranks (one process per rank,
  ``tests/_torch_tp_ranks.py``), against numpy on every rank's inputs;
  the gloo form builds the gather and the reduce-scatter from all-reduces,
  which adds exact zeros, so all but the sums are bitwise.
* ``optim.grad_utils`` against JAX's ``repro.optim.grad_utils``: int8
  codes, scales and residuals equal on the same inputs, error feedback
  keeping the sent sum within 0.02 of the true one over 50 steps (JAX's
  test), ``compressed_psum_mean`` at 1, 2 and 4 ranks equal to the numpy
  mean within JAX's tolerances (rtol 0.02 / atol 0.05 for bf16, the same
  for int8, float32 rounding for 'none'), JAX's ``bucket_by_size`` buckets.
* The kernel's plain version (``flash_attention_torch``) at a rank's
  ``q_offset > 0`` with Sq < Skv (the sequence-sharded attention's rows),
  with and without a window, against JAX's ``chunked_attention`` at the
  same offset.
* ``sharding.local_shards`` round-trips bit for bit through ``assemble``
  for every arch on each mesh, parameters and AdamW state.
* The configuration's rules (``attn_shard``, ``grad_compression``) and the
  sharded route's refusals: the other families, Adafactor and 8-bit AdamW
  on a mesh that shards a leaf, ``--ckpt`` on a mesh; a failing collective
  raises.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_tp_collectives.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from _torch_tp_common import assemble
from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.optim import grad_utils as JG
from repro_torch.configs import MeshConfig, RunConfig, get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (local_shards, meta_params, opt_state_specs,
                                              param_specs)
from repro_torch.distributed.train_step import make_sharded_train_step
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, bucket_by_size, compressed_psum_mean
from repro_torch.optim import grad_utils as TG
from repro_torch.tree import leaves


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return ranks.spawn((1, 2, 4), tmp_path_factory.mktemp("tp_coll"), "collectives")


def _expected(world: int, rank: int) -> dict:
    """What ``ranks.run_collectives`` must give on ``rank``: the backward of
    a pair whose output has dy's shape gets dy, else the rank's x."""
    a = ranks.collective_inputs(world)
    x, dy = a["x"], a["dy"]
    own = slice(rank * 6, (rank + 1) * 6)
    g = [dy[r] if world == 1 else x[r] for r in range(world)]  # for [4, 6] outputs
    cat = np.concatenate(list(x), axis=1)
    return {
        "all_reduce": x.sum(0), "all_gather": cat, "reduce_scatter": dy.sum(0)[:, own],
        "copy_to.y": x[rank], "copy_to.dx": sum(g),
        "reduce_from.y": x.sum(0), "reduce_from.dx": g[rank],
        "gather_sum.y": cat, "gather_sum.dx": dy.sum(0)[:, own],
        "gather_from.y": cat, "gather_from.dx": dy[rank][:, own],
        "scatter_to.y": dy[rank][:, own], "scatter_to.dx": np.concatenate(g, axis=1),
    }


@pytest.mark.parametrize("world", [1, 2, 4])
def test_collectives_and_their_backwards_on_every_rank(groups, world):
    for data, model in ranks.MESHES[world]:
        for r, got in enumerate(groups[world]):
            pre = f"{data}x{model}/"
            for name, want in _expected(world, r).items():
                np.testing.assert_allclose(got[pre + name], want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{pre}{name} rank {r}")
            # the gathers and the slices are bitwise: all-reduces of exact zeros
            for name in ("all_gather", "gather_from.y", "gather_from.dx", "scatter_to.y"):
                assert np.array_equal(got[pre + name], _expected(world, r)[name]), name
            # one direct call each, then the pairs': copy_to's backward and
            # reduce_from's forward all-reduce; the three gathers' forwards
            # and scatter_to's backward all-gather; gather_sum's backward
            # reduce-scatters
            assert list(got[pre + "calls"]) == [1 + 2, 1 + 3, 1 + 1], got[pre + "calls"]


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compressed_psum_mean_equals_the_numpy_mean(groups, world, method):
    a = ranks.collective_inputs(world)
    tol = dict(rtol=1e-6, atol=1e-7) if method == "none" else dict(rtol=0.02, atol=0.05)
    for data, model in ranks.MESHES[world]:
        pre = f"{data}x{model}/"
        outs = [got[f"{pre}psum.{method}.g"] for got in groups[world]]
        for r, got in enumerate(groups[world]):
            np.testing.assert_allclose(got[f"{pre}psum.{method}.g"], a["g"].mean(0), **tol)
            np.testing.assert_allclose(got[f"{pre}psum.{method}.h"], a["h"].mean(0), **tol)
            assert np.array_equal(got[f"{pre}psum.{method}.g"], outs[0])  # replicated
            if method == "none":
                assert f"{pre}err.none.g" not in got
                continue
            # the residual is this rank's own quantization error of its gradient
            want_err = np.asarray(JG.compress(jnp.asarray(a["g"][r]), method, None)[2])
            np.testing.assert_allclose(got[f"{pre}err.{method}.g"], want_err, rtol=0, atol=1e-7)
            # the second step sends the gradient plus that residual
            sent = [np.asarray(JG.decompress(*JG.compress(jnp.asarray(a["g"][q]), method,
                                                          JG.compress(jnp.asarray(a["g"][q]),
                                                                      method, None)[2])[:2],
                                             method)) for q in range(world)]
            np.testing.assert_allclose(got[f"{pre}psum2.{method}.g"], np.mean(sent, 0),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_compress_matches_jax(method):
    rng = np.random.default_rng(1)
    g = rng.normal(size=(5, 33)).astype(np.float32) * 0.3
    e = rng.normal(size=(5, 33)).astype(np.float32) * 1e-3
    jp, ja, je = JG.compress(jnp.asarray(g), method, jnp.asarray(e))
    tp, ta, te = TG.compress(torch.from_numpy(g), method, torch.from_numpy(e))
    if method == "int8":
        assert tp.dtype == torch.int8
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert float(ta) == float(ja)
    else:
        assert np.array_equal(tp.float().numpy(), np.asarray(jp, np.float32))
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(TG.decompress(tp, ta, method).numpy(),
                          np.asarray(JG.decompress(jp, ja, method)))
    q, s = TG._quantize_int8(torch.zeros(4))
    assert float(s) == float(np.float32(1e-12)) and not q.any()


def test_error_feedback_preserves_sum_over_time():
    """JAX's ``test_error_feedback_preserves_sum_over_time`` on the port."""
    rng = np.random.default_rng(0)
    g_true_sum = np.zeros(256, np.float32)
    g_sent_sum = np.zeros(256, np.float32)
    err = torch.zeros(256)
    for _ in range(50):
        g = rng.normal(size=256).astype(np.float32) * 0.1
        payload, aux, err = TG.compress(torch.from_numpy(g), "int8", err)
        g_sent_sum += TG.decompress(payload, aux, "int8").numpy()
        g_true_sum += g
    assert np.abs(g_sent_sum - g_true_sum).max() < 0.02


def test_bucket_by_size_gives_jax_buckets():
    tree = {"b": np.zeros((512, 512), np.float32), "a": {"x": np.zeros(1000, np.float32),
            "y": [np.zeros((3, 4), np.float16), np.zeros(2 << 20, np.int8)]},
            "c": np.zeros((1024, 1024), np.float32), "d": np.zeros(7, np.float32)}
    for size in (4 << 20, 1 << 20, 64):
        assert bucket_by_size(tree, size) == JG.bucket_by_size(tree, size), size


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("tp", [2, 4])
def test_flash_at_a_ranks_offset_matches_chunked_attention(tp, window):
    """Each rank's rows of the sequence-sharded attention: queries [r S/tp,
    (r+1) S/tp) of every head against all S kv rows at q_offset = r S/tp."""
    B, S, H, Hkv, dh = 2, 24, 4, 2, 16
    rng = np.random.default_rng(tp + window)
    q, k, v = (rng.normal(size=(B, S, h, dh)).astype(np.float32) for h in (H, Hkv, Hkv))
    Sl = S // tp
    for r in range(tp):
        ql = q[:, r * Sl:(r + 1) * Sl]
        got = flash_attention_torch(torch.from_numpy(ql), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True, q_offset=r * Sl,
                                    window=window)
        want = JL.chunked_attention(jnp.asarray(ql.reshape(B, Sl, Hkv, H // Hkv, dh)),
                                    jnp.asarray(k), jnp.asarray(v), causal=True,
                                    q_offset=r * Sl, window=window, chunk=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, Sl, H, dh),
                                   rtol=1e-5, atol=2e-6, err_msg=f"rank {r} of {tp}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_local_shards_round_trip_bit_for_bit(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    full = {}

    def fill(infos, out):
        for k, i in infos.items():
            if isinstance(i, dict):
                out[k] = {}
                fill(i, out[k])
            else:
                out[k] = rng.normal(size=i.shape).astype(np.float32)

    fill(model.param_infos(), full)
    for data, mdl in ((1, 2), (2, 1), (1, 4), (2, 2)):
        mcfg = MeshConfig(data=data, model=mdl)
        sizes = {"data": data, "model": mdl}
        specs = param_specs(model, mcfg)
        o_specs = opt_state_specs(adamw_init, meta_params(model.param_infos()), specs)
        shards = [local_shards(full, specs, dict(zip(("data", "model"), divmod(r, mdl))), sizes)
                  for r in range(data * mdl)]
        for leaf_i, (want, spec) in enumerate(zip(leaves(full), _spec_leaves(specs))):
            pieces = [leaves(s)[leaf_i] for s in shards]
            assert np.array_equal(assemble(pieces, spec, sizes), want), (arch, data, mdl)
        # AdamW's m mirrors the parameter specs (ZeRO-1 through them)
        assert o_specs["m"] == specs and o_specs["v"] == specs


def _spec_leaves(specs):
    from repro_torch.distributed.sharding import leaves_of_specs

    return leaves_of_specs(specs)


def test_config_rules_and_compression_taken():
    for arch, heads in (("tinyllama-1.1b", "heads"), ("llama3.2-3b", "seq"),
                        ("moonshot-v1-16b-a3b", "heads"), ("starcoder2-7b", "seq"),
                        ("internvl2-2b", "heads")):
        assert get_config(arch).attn_shard == heads == jax_config(arch).attn_shard
        assert get_config(arch, smoke=True).attn_shard == "seq"  # 4 heads: JAX's TP_HINT 16
    cfg = get_config("tinyllama-1.1b", smoke=True)
    for method in ("none", "bf16", "int8"):
        assert RunConfig(model=cfg, shape="train_4k", grad_compression=method)
    with pytest.raises(ValueError, match="grad_compression"):
        RunConfig(model=cfg, shape="train_4k", grad_compression="fp8")
    assert JL.padded_vocab(cfg.vocab) % 4 == 0


def _fake_mesh(data: int, model: int) -> C.Mesh:
    """A mesh's shape and coordinates with no groups: enough for the specs
    and the refusals, which run before any collective."""
    return C.Mesh(sizes={"data": data, "model": model}, coords={"data": 0, "model": 0},
                  groups=dict.fromkeys((("data",), ("model",), ("data", "model"))),
                  backend="gloo")


def test_sharded_route_refusals():
    mesh = _fake_mesh(1, 2)
    for arch in ("rwkv6-7b", "jamba-v0.1-52b", "whisper-medium"):
        with pytest.raises(NotImplementedError, match="10p-b"):
            build_model(get_config(arch, smoke=True)).mesh_context(mesh)
    for opt in ("adafactor", "adamw8bit"):
        cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), optimizer=opt)
        with pytest.raises(ValueError, match="10p-b"):
            make_sharded_train_step(build_model(cfg), RunConfig(model=cfg, shape="train_4k"),
                                    mesh)
    # on a mesh that shards nothing Adafactor runs as on one card
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), optimizer="adafactor")
    make_sharded_train_step(build_model(cfg), RunConfig(model=cfg, shape="train_4k"),
                            _fake_mesh(1, 1))
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="10p-b"):
        train.main(["--device", "cpu", "--smoke", "--steps", "1", "--mesh", "1,1",
                    "--ckpt", "unused"])


def test_a_failing_collective_raises(monkeypatch):
    """The sharded route has no dense fallback: a collective that fails
    raises out of the model's forward."""
    import torch.distributed as dist

    def broken(*a, **k):
        raise RuntimeError("collective failed")

    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    ctx = model.mesh_context(_fake_mesh(1, 2))
    pnp = ranks.params_np(cfg)
    params = params_from_numpy(cfg, pnp, device="cpu", ctx=ctx)
    monkeypatch.setattr(dist, "all_reduce", broken)
    b = ranks.tb(ranks.batch_np(cfg, 0))
    from repro_torch.models import layers as L

    with L.activation_sharding(ctx), pytest.raises(RuntimeError, match="collective failed"):
        model.loss(params, b)
    # the one-card route on full weights never calls a collective
    model.loss(jax.tree_util.tree_map(torch.from_numpy, pnp), b)
