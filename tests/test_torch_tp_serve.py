"""Port: the decoder LMs served on a (data, model) mesh, held to the
one-card route: greedy tokens from a prefill of 4 prompts of 12 tokens
(internvl: 8 patch embeddings before them) plus 8 decode steps, on a bf16
and an int8 KV cache, must be identical (JAX's
``tests/test_variants_multidev.py`` asks int8 decode on the mesh for 20 %
of the bf16 logits; this holds every token of both to the one-card run).

The cases and meshes of ``tests/test_torch_tp_train.py`` (one gloo group
of 2 and one of 4 ranks, ``tests/_torch_tp_ranks.py``), at float32
compute. On a mesh each rank serves its rows of the batch from its slices
of the weights, with its kv heads in the cache where they divide the
'model' ranks (tinyllama's 2 SMOKE kv heads on 2; the whole cache on 4,
each rank reading the kv heads of its query heads), the vocab-parallel
head and the (value, global index) argmax; the expert-parallel MoE
dispatches a decode step's rows with JAX's global capacity.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_tp_serve.py``.
"""
import numpy as np
import pytest

import _torch_tp_ranks as ranks
from _torch_tp_common import MESH_IDS, mesh_id

_PORT: dict = {}


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return ranks.spawn((2, 4), tmp_path_factory.mktemp("tp_serve"), "serve")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(ranks.CASES))
@pytest.mark.parametrize("mesh", MESH_IDS, ids=mesh_id)
def test_greedy_tokens_match_one_card(outs, case, mesh, kv):
    world, data, model = mesh
    if case not in _PORT:
        _PORT[case] = ranks.run_serve(case, None)
    want = _PORT[case][f"tokens_{kv}"]
    got = [o[f"{data}x{model}/{case}/tokens_{kv}"] for o in outs[world]]
    # this rank's rows: the batch splits over 'data' (every axis in 'dp')
    dp_layout = ranks.config(case).layout == "dp"
    rows = got if dp_layout else [got[d * model] for d in range(data)]
    assert np.array_equal(np.concatenate(rows), want)
    for r, toks in enumerate(got):  # ranks of one row block agree
        lead = r if dp_layout else (r // model) * model
        assert np.array_equal(toks, got[lead]), r
