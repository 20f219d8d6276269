"""Port: the checkpointer (``repro_torch.checkpoint``) on JAX's cases and
JAX's on-disk layout.

The seven cases of ``tests/test_checkpoint.py`` run on the port's
``Checkpointer`` with a tree of tensors; then the same tree (numpy,
seeded) saved by both packages gives byte-identical files, and a
checkpoint written by either package restores in the other bit for bit,
a bf16 leaf included.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.tree import leaves


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "data": {"epoch": 1, "step": 5},
        "opt": {"m": np.ones((16, 8), np.float32), "step": np.asarray(7, np.int32)},
        "params": {"b": np.zeros(8, np.float32), "w": rng.normal(size=(16, 8)).astype(np.float32)},
    }


def _tree(seed=0):
    """JAX's test tree as tensors."""
    t = _np_tree(seed)
    return {"params": {k: torch.from_numpy(v) for k, v in t["params"].items()},
            "opt": {k: torch.from_numpy(np.array(v)) for k, v in t["opt"].items()}}


def _assert_same(got, want):
    for a, b in zip(leaves(got), leaves(want)):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_roundtrip_identity(tmp_path):
    ckpt = Checkpointer(tmp_path, async_save=False)
    tree = _tree()
    ckpt.save(3, tree)
    assert ckpt.latest_step() == 3
    back = ckpt.restore(3, tree)
    assert all(isinstance(x, torch.Tensor) for x in leaves(back))
    _assert_same(back, tree)


def test_async_save_then_wait(tmp_path):
    """The async save copies every leaf before it returns: writing the
    caller's tensors afterwards changes nothing on disk."""
    ckpt = Checkpointer(tmp_path, async_save=True)
    tree = _tree()
    want = _tree()
    ckpt.save(1, tree)
    for x in leaves(tree):
        x.add_(1)
    ckpt.wait()
    assert ckpt.latest_step() == 1
    _assert_same(ckpt.restore(1, tree), want)


def test_gc_keeps_latest(tmp_path):
    ckpt = Checkpointer(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _tree(s))
    assert ckpt.steps() == [3, 4]


def test_corruption_detected(tmp_path):
    ckpt = Checkpointer(tmp_path, async_save=False)
    tree = _tree()
    ckpt.save(5, tree)
    f = next((tmp_path / "step_000000005" / "arrays").glob("*w*.npy"))
    arr = np.load(f)
    arr[0, 0] += 1
    np.save(f, arr)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(5, tree)


def test_incomplete_write_invisible(tmp_path):
    """A crash mid-write (tmp dir present, no manifest) must be ignored."""
    ckpt = Checkpointer(tmp_path, async_save=False)
    ckpt.save(1, _tree())
    bad = tmp_path / ".tmp_step_000000009"
    (bad / "arrays").mkdir(parents=True)
    assert ckpt.latest_step() == 1


def test_restore_onto_another_device(tmp_path):
    """The elastic-restore path: same shapes, placed on the device asked
    for (``device=`` where JAX takes ``shardings=``), the 'meta' device
    standing in for a second one."""
    ckpt = Checkpointer(tmp_path, async_save=False)
    tree = _tree()
    ckpt.save(2, tree)
    _assert_same(ckpt.restore(2, tree, device="cpu"), tree)
    moved = ckpt.restore(2, tree, device="meta")
    assert all(x.device.type == "meta" for x in leaves(moved))


def test_shape_mismatch_rejected(tmp_path):
    ckpt = Checkpointer(tmp_path, async_save=False)
    ckpt.save(1, _tree())
    wrong = _tree()
    wrong["params"]["w"] = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(1, wrong)


def _files(step_dir):
    return {str(p.relative_to(step_dir)): p.read_bytes() for p in sorted(step_dir.rglob("*"))
            if p.is_file()}


def test_files_equal_jax(tmp_path):
    """The same tree (tensors and host ints here, jax arrays and ints there)
    written by both: the same file names, manifest and array bytes."""
    t = _np_tree(3)
    port = {"data": dict(t["data"]),
            "opt": {k: torch.from_numpy(np.array(v)) for k, v in t["opt"].items()},
            "params": {k: torch.from_numpy(v) for k, v in t["params"].items()}}
    jtree = {"data": dict(t["data"]), "opt": jax.tree_util.tree_map(jnp.asarray, t["opt"]),
             "params": jax.tree_util.tree_map(jnp.asarray, t["params"])}
    Checkpointer(tmp_path / "port", async_save=False).save(4, port)
    JCheckpointer(tmp_path / "jax", async_save=False).save(4, jtree)
    got, want = (_files(tmp_path / d / "step_000000004") for d in ("port", "jax"))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    manifest = json.loads(want["manifest.json"])
    assert "params][w" in manifest["leaves"]
    assert manifest["leaves"]["data][step"]["dtype"] == "int64"


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """Written by JAX, restored by the port into tensors (ints stay numpy);
    written by the port, restored by JAX: bit for bit both ways, a bf16 leaf
    included (stored as its bits, restored as bf16 without ml_dtypes)."""
    t = _np_tree(4)
    bf = np.random.default_rng(5).normal(size=(3, 64)).astype(np.float32)
    jtree = {"data": dict(t["data"]), "opt": jax.tree_util.tree_map(jnp.asarray, t["opt"]),
             "params": dict(jax.tree_util.tree_map(jnp.asarray, t["params"]),
                            h=jnp.asarray(bf, jnp.bfloat16))}
    JCheckpointer(tmp_path / "a", async_save=False).save(6, jtree)
    like = {"data": {"epoch": 0, "step": 0},
            "opt": {"m": torch.zeros(16, 8), "step": torch.zeros((), dtype=torch.int32)},
            "params": {"b": torch.zeros(8), "h": torch.zeros(3, 64, dtype=torch.bfloat16),
                       "w": torch.zeros(16, 8)}}
    back = Checkpointer(tmp_path / "a").restore(6, like)
    assert back["params"]["h"].dtype == torch.bfloat16
    assert int(back["data"]["step"]) == 5 and isinstance(back["data"]["step"], np.ndarray)
    for got, want in zip(leaves(back), jax.tree_util.tree_leaves(jtree)):
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), w.view(np.int16))
        else:
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w)

    Checkpointer(tmp_path / "b", async_save=False).save(7, back)
    written, jax_written = (_files(tmp_path / d) for d in ("b/step_000000007",
                                                           "a/step_000000006"))
    manifest, jax_manifest = (json.loads(f.pop("manifest.json")) for f in (written, jax_written))
    assert written == jax_written  # every array file byte for byte, the bf16 one included
    assert manifest == dict(jax_manifest, step=7)
    jlike = jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x)), jtree)
    again = JCheckpointer(tmp_path / "b").restore(7, jlike)
    for got, want in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(jtree)):
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":  # JAX's own restore gives the bits back too
            assert got.dtype.itemsize == 2
            np.testing.assert_array_equal(got.view(np.int16), w.view(np.int16))
        else:
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w)
