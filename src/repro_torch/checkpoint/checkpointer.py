"""Async, manifest-based checkpointing with atomic publish (copied from
``repro/checkpoint/checkpointer.py``, on the JAX package's on-disk layout).

Layout of a checkpoint step directory:
    <root>/step_000123/
        manifest.json       -- tree structure, shapes, dtypes, hashes
        arrays/<name>.npy   -- one file per leaf

Leaf names, the manifest and the array files are the JAX package's for
the same nested tree (``_leaf_name`` is JAX's ``keystr`` with its
brackets and quotes stripped), so a checkpoint written by either package
restores in the other. A bf16 leaf is stored as its 16 bits in numpy's
2-byte void type, with the header ``np.save`` writes for JAX's bf16
arrays and "bfloat16" in the manifest; it needs no ``ml_dtypes``, and
restores as a bf16 tensor.

Fault-tolerance contract:
  * writes go to a temp dir, fsynced, then atomically renamed -- a crash
    mid-write never corrupts the latest-complete pointer;
  * ``latest_step`` only reports directories with a manifest, and
    ``restore`` checks every leaf's sha256, so a restart loads a consistent
    step or raises;
  * ``restore`` takes ``device=`` where the JAX one takes ``shardings=``:
    the on-disk arrays are whole, so restoring onto another device is a copy.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..tree import leaves_with_path, map_with_path, structure, tree_map

#: numpy's type for a bf16 leaf on disk: its bits, as np.save writes JAX's
BF16_ON_DISK = np.dtype("V2")


def _leaf_name(path) -> str:
    return "".join(f"[{k!r}]" for k in path).replace("/", "_").replace("'", "").strip("[].")


def _tree_leaves_with_names(tree):
    flat = list(leaves_with_path(tree))
    names = [_leaf_name(p) for p, _ in flat]
    if len(set(names)) != len(names):
        raise ValueError("leaf names must be unique")
    return [(n, leaf) for n, (_, leaf) in zip(names, flat)]


def _to_host(x) -> np.ndarray:
    """A leaf as the numpy array written to disk: a tensor copied to the
    host (a bf16 one as its bits), anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(BF16_ON_DISK)
        return t.numpy()
    return np.asarray(x)


def _save(path: pathlib.Path, arr: np.ndarray) -> None:
    """``np.save``, but a bf16 leaf's bits get the header ``np.save`` gives
    JAX's bf16 arrays (descr '<V2'), so the file is byte for byte JAX's."""
    if arr.dtype != BF16_ON_DISK:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_ON_DISK else str(arr.dtype)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))


class Checkpointer:
    def __init__(self, root: str | os.PathLike, keep: int = 3, async_save: bool = True):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool | None = None) -> None:
        """Write ``tree`` as step ``step``. Every leaf is copied to the host
        before the call returns (an async save writes those copies on a
        thread), so the caller may update its tensors at once."""
        host_tree = tree_map(_to_host, tree)
        if blocking is None:
            blocking = not self.async_save
        self.wait()  # never overlap two saves
        if blocking:
            self._write(step, host_tree)
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host_tree))
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree: Any) -> None:
        final = self.root / f"step_{step:09d}"
        tmp = self.root / f".tmp_step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)

        entries = {}
        for name, arr in _tree_leaves_with_names(host_tree):
            _save(tmp / "arrays" / f"{name}.npy", arr)
            entries[name] = {
                "shape": list(arr.shape),
                "dtype": _dtype_name(arr),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            }
        manifest = {"step": step, "leaves": entries, "treedef": structure(host_tree)}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for d in self.root.glob("step_*"):
            if (d / "manifest.json").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device: str | torch.device | None = None,
                verify: bool = True) -> Any:
        """Load step into the structure of ``like`` (shapes must match).

        A leaf that is a tensor in ``like`` comes back as a new tensor, on
        ``device`` or else on that leaf's device; any other leaf comes back
        as the numpy array on disk, as the JAX package's restore gives it.
        The arrays keep their dtype on disk.
        """
        d = self.root / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())

        def load(path, leaf):
            name = _leaf_name(path)
            arr = np.load(d / "arrays" / f"{name}.npy")
            meta = manifest["leaves"][name]
            if verify:
                h = hashlib.sha256(arr.tobytes()).hexdigest()
                if h != meta["sha256"]:
                    raise IOError(f"checkpoint corruption in leaf {name}")
            if tuple(arr.shape) != _shape(leaf):
                raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {_shape(leaf)}")
            if not isinstance(leaf, torch.Tensor):
                return arr
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            return t.to(device if device is not None else leaf.device)

        return map_with_path(load, like)

