"""Port: the data path (``repro_torch.data``) against the JAX package's.

The chunk store's bytes and replica datanodes, the token pipeline's
batches (synchronous and threaded), its cursor across a restart, rank
disjointness, and the loader placement must equal ``repro.data``'s bit for
bit on the same store: the port's copies are numpy only, with the same
arithmetic.
"""
import numpy as np
import pytest
from _hyp import given, settings, st

from repro.core import M1 as JM1
from repro.core import M2 as JM2
from repro.core import PAPER_CLUSTER as JPAPER
from repro.data import ChunkStore as JChunkStore
from repro.data import FileMeta as JFileMeta
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import synthetic_store as jax_store
from repro.data.placement import max_safe_ranks_per_host as jax_max_safe
from repro.data.placement import place_loaders as jax_place
from repro_torch.core import M1, M2, PAPER_CLUSTER
from repro_torch.data import ChunkStore, FileMeta, TokenPipeline, synthetic_store
from repro_torch.data.placement import max_safe_ranks_per_host, place_loaders

MB = 1024 * 1024
#: the stores of tests/test_data.py
STORES = [dict(n_files=2, file_mb=16, block_mb=8), dict(n_files=1, file_mb=16, block_mb=8),
          dict(block_mb=64)]


def _pair(**kw):
    return synthetic_store(**kw), jax_store(**kw)


@pytest.mark.parametrize("kw", STORES)
def test_chunks_bytes_and_replicas_equal_jax(kw):
    store, jstore = _pair(**kw)
    for f in store.files:
        chunks, jchunks = store.chunks(f), jstore.chunks(f)
        assert [(c.file_id, c.chunk_id, c.size) for c in chunks] == \
            [(c.file_id, c.chunk_id, c.size) for c in jchunks]
        for ref, jref in zip(chunks, jchunks):
            assert store.replicas(ref) == jstore.replicas(jref)
            for off, n in ((0, 4096), (13, 1000), (ref.size - 77, 200)):
                np.testing.assert_array_equal(store.read(ref, off, n), jstore.read(jref, off, n))
    ref, jref = store.chunks(0)[0], jstore.chunks(0)[0]
    np.testing.assert_array_equal(store.read_chunk(ref, 256 * 1024),
                                  jstore.read_chunk(jref, 256 * 1024))
    w, jw = store.as_workload(256 * 1024), jstore.as_workload(256 * 1024)
    assert (w.fs, w.rs, w.op) == (jw.fs, jw.rs, jw.op)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 1 << 22), st.integers(256, 1 << 20), st.integers(0, 1 << 16))
def test_property_reads_equal_jax(file_size, rs, offset):
    store = ChunkStore([FileMeta(3, file_size)], block_bytes=1 << 20)
    jstore = JChunkStore([JFileMeta(3, file_size)], block_bytes=1 << 20)
    ref, jref = store.chunks(3)[-1], jstore.chunks(3)[-1]
    np.testing.assert_array_equal(store.read_chunk(ref, rs), jstore.read_chunk(jref, rs))
    np.testing.assert_array_equal(store.read(ref, offset, rs), jstore.read(jref, offset, rs))
    assert store.replicas(ref) == jstore.replicas(jref)


def _batches(pipe, n):
    return [next(pipe) for _ in range(n)]


@pytest.mark.parametrize("threaded", [False, True])
def test_pipeline_batches_equal_jax(threaded):
    """Synchronous and threaded (prefetch 2) batches, tokens and labels,
    past an epoch boundary (4 chunks of the store), and the cursor."""
    store, jstore = _pair(n_files=2, file_mb=16, block_mb=8)
    kw = dict(vocab=1000, batch=2, seq_len=64, prefetch=2)
    pipe, jpipe = TokenPipeline(store, **kw), JTokenPipeline(jstore, **kw)
    if threaded:
        pipe.start(), jpipe.start()
    try:
        for b, jb in zip(_batches(pipe, 6), _batches(jpipe, 6)):
            assert set(b) == set(jb) == {"tokens", "labels"}
            for k in b:
                assert b[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(b[k], jb[k])
        assert pipe.state_dict() == jpipe.state_dict()
    finally:
        pipe.stop(), jpipe.stop()


def test_pipeline_restart_equals_jax():
    """A cursor saved by either package resumes the other's stream at the
    same next batch."""
    store, jstore = _pair(n_files=2, file_mb=16, block_mb=8)
    kw = dict(vocab=500, batch=2, seq_len=32)
    jpipe = JTokenPipeline(jstore, **kw)
    _batches(jpipe, 5)
    pipe = TokenPipeline(store, **kw)
    pipe.load_state_dict(jpipe.state_dict())
    np.testing.assert_array_equal(next(pipe)["tokens"], next(jpipe)["tokens"])
    back = JTokenPipeline(jstore, **kw)
    back.load_state_dict(pipe.state_dict())
    np.testing.assert_array_equal(next(back)["tokens"], next(pipe)["tokens"])


def test_rank_sharding_disjoint_and_equal_jax():
    store, jstore = _pair(n_files=2, file_mb=16, block_mb=8)
    kw = dict(vocab=500, batch=1, seq_len=32, world=2)
    got = [next(TokenPipeline(store, rank=r, **kw))["tokens"] for r in (0, 1)]
    want = [next(JTokenPipeline(jstore, rank=r, **kw))["tokens"] for r in (0, 1)]
    assert not np.array_equal(*got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("block_mb, request_bytes", [(64, 256 * 1024), (64, 4096), (1, 4096),
                                                    (1, 1 * MB)])
def test_placement_equals_jax(block_mb, request_bytes):
    """``place_loaders`` on the paper's cluster and ``max_safe_ranks_per_host``
    on M1 and M2 against JAX's, which packs with the float64 oracle's greedy:
    the default store (tests/test_data.py's), whose loaders fill the four
    servers and queue, and stores whose small requests pack 7 to 17 loaders
    on a host."""
    store, jstore = _pair(block_mb=block_mb)
    got, state = place_loaders(store, 12, PAPER_CLUSTER, request_bytes)
    want, jstate = jax_place(jstore, 12, JPAPER, request_bytes)
    assert [(p.rank, p.host) for p in got] == [(p.rank, p.host) for p in want]
    assert [[(w.fs, w.rs, w.op) for w in a] for a in state.assignments] == \
        [[(w.fs, w.rs, w.op) for w in a] for a in jstate.assignments]
    for host, jhost in ((M1, JM1), (M2, JM2)):
        assert max_safe_ranks_per_host(store, host, request_bytes) == \
            jax_max_safe(jstore, jhost, request_bytes)
