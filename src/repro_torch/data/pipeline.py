"""Sharded, double-buffered training input pipeline over the chunk store
(copied from ``repro/data/pipeline.py``, numpy only: the same batches for
the same store, rank and world, and the same two-int cursor).

Each data-parallel rank owns a disjoint chunk stream (rank-strided), converts
chunk bytes to token ids deterministically, and prefetches batches on a
background thread (the host-side "system file cache" tier of the paper's
hierarchy -- the prefetch depth plays the role of the write-back/read-ahead
buffer, and its RS/FS characterization feeds the consolidation scheduler via
``ChunkStore.as_workload``).

Determinism/fault tolerance: the stream position is a pure function of
(epoch, step, rank), checkpointed as two ints -- restart resumes exactly.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from .chunkstore import ChunkStore, FileMeta

MB = 1024 * 1024


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    step: int = 0


class TokenPipeline:
    def __init__(
        self,
        store: ChunkStore,
        *,
        vocab: int,
        batch: int,  # per-rank batch
        seq_len: int,
        rank: int = 0,
        world: int = 1,
        request_bytes: int = 256 * 1024,
        prefetch: int = 2,
        labels: bool = True,
    ):
        self.store = store
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.rank = rank
        self.world = world
        self.request_bytes = request_bytes
        self.prefetch = prefetch
        self.labels = labels
        self.state = PipelineState()
        self._all_chunks = [c for f in store.files.values() for c in store.chunks(f.file_id)]
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # --- deterministic batch synthesis -----------------------------------
    def _batch_at(self, epoch: int, step: int) -> dict[str, np.ndarray]:
        need = self.batch * (self.seq_len + 1)
        # rank-strided chunk selection
        idx = (step * self.world + self.rank + epoch * 7919) % len(self._all_chunks)
        ref = self._all_chunks[idx]
        raw = self.store.read_chunk(ref, self.request_bytes)
        if raw.size < need * 4:
            reps = -(-need * 4 // max(raw.size, 1))
            raw = np.tile(raw, reps)
        words = raw[: need * 4].view(np.uint32).astype(np.int64)
        toks = (words % self.vocab).astype(np.int32).reshape(self.batch, self.seq_len + 1)
        out = {"tokens": toks[:, :-1]}
        if self.labels:
            out["labels"] = toks[:, 1:]
        return out

    # --- prefetch thread -----------------------------------------------------
    def _worker(self):
        epoch, step = self.state.epoch, self.state.step
        while not self._stop.is_set():
            b = self._batch_at(epoch, step)
            step += 1
            if step * self.world >= len(self._all_chunks):
                epoch, step = epoch + 1, 0
            while not self._stop.is_set():
                try:
                    self._q.put((epoch, step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        if self._thread is None:
            b = self._batch_at(self.state.epoch, self.state.step)
            self.state.step += 1
            return b
        epoch, step, b = self._q.get()
        self.state.epoch, self.state.step = epoch, step
        return b

    # --- checkpoint integration ---------------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self.state.epoch, "step": self.state.step}

    def load_state_dict(self, d: dict):
        was_running = self._thread is not None
        self.stop()
        self.state = PipelineState(int(d["epoch"]), int(d["step"]))
        if was_running:
            self.start()


def synthetic_store(n_files: int = 4, file_mb: int = 256, block_mb: int = 64,
                    **kw) -> ChunkStore:
    files = [FileMeta(i, file_mb * MB) for i in range(n_files)]
    return ChunkStore(files, block_bytes=block_mb * MB, **kw)
