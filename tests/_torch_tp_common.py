"""Shared pieces of the port's tensor-parallel tests
(``tests/test_torch_tp_*.py``): the ranks' slices put back together under
the specs (``assemble``), with ranks that hold the same slice held to the
same values."""
import re

import numpy as np

import _torch_tp_ranks as ranks
from repro_torch.configs import MeshConfig
from repro_torch.distributed.sharding import param_specs
from repro_torch.models import build_model
from repro_torch.models.params import axis_names

#: every (data, model) mesh the groups run, and its world size
MESH_IDS = [(w, d, m) for w in (2, 4) for d, m in ranks.MESHES[w]]


def mesh_id(p) -> str:
    return f"{p[1]}x{p[2]}"


def leaf_spec(specs, key: str):
    """The spec of the leaf a ``keystr`` key names (after its kind)."""
    for k in re.findall(r"\['([^']+)'\]", key):
        specs = specs[k]
    return specs


def full_leaf(outs: list, pre: str, key: str, spec, sizes: dict) -> np.ndarray:
    """The leaf ``key`` assembled from every rank's slice; ranks holding the
    same slice must agree bit for bit."""
    pieces = [o[pre + key] for o in outs]
    by_slot: dict = {}
    for r, piece in enumerate(pieces):
        coords = dict(zip(("data", "model"), divmod(r, sizes["model"])))
        slot = tuple(tuple(coords[a] for a in ((e,) if isinstance(e, str) else (e or ())))
                     for e in spec)
        if slot in by_slot:
            assert np.array_equal(piece, by_slot[slot]), f"{pre}{key}: replicas differ"
        by_slot[slot] = piece
    return assemble(pieces, spec, sizes)


def specs_of(case: str, data: int, model: int):
    return param_specs(build_model(ranks.config(case)), MeshConfig(data=data, model=model))


def _slot(entry, coords: dict, sizes: dict) -> tuple[int, int]:
    """(slot, slots) of a rank along a spec entry's axes, the first outermost."""
    i, n = 0, 1
    for a in axis_names(entry):
        i, n = i * sizes[a] + coords[a], n * sizes[a]
    return i, n


def assemble(pieces: list, spec, sizes: dict) -> np.ndarray:
    """The full leaf from every rank's slice: ``pieces[r]`` is what rank r
    of a row-major (data, model) mesh of ``sizes`` holds under ``spec``.
    Each slice is written at its place, so ``assemble`` of
    ``sharding.local_shard``s is the leaf bit for bit."""
    first = pieces[0]
    out = np.empty([d * _slot(e, dict.fromkeys(sizes, 0), sizes)[1]
                    for d, e in zip(first.shape, spec)], dtype=first.dtype)
    for r, piece in enumerate(pieces):
        coords = dict(zip(("data", "model"), divmod(r, sizes["model"])))
        out[tuple(slice(_slot(e, coords, sizes)[0] * d, (_slot(e, coords, sizes)[0] + 1) * d)
                  for d, e in zip(first.shape, spec))] = piece
    return out
