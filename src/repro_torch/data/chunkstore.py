"""HDFS-inspired chunk store: the data-pipeline substrate the paper's
workloads run against (copied from ``repro/data/chunkstore.py``, numpy only:
the same payload bytes and the same replica datanodes).

Files are split into block-sized chunks (64MB default, exactly HDFS; the
paper notes "we change the filesystem installation parameters" to use
non-default block sizes -- ``block_bytes`` is that knob). Reads are issued
in request-size (RS) units, so every consumer of this store *is* a paper
workload characterized by (FS=block_bytes, RS=read_bytes) -- which is how
the training input pipeline below plugs into the consolidation scheduler:
host-side input workers are admitted onto shared input hosts by the same
greedy algorithm that placed the paper's TestDFSIO tasks.

The store is deterministic-synthetic: chunk payloads are generated from
(file_id, chunk_id) seeds, so multi-host loaders need no shared filesystem
and restarts are reproducible (the fault-tolerance story needs replayable
input).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.workload import Workload

MB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class FileMeta:
    file_id: int
    size: int  # bytes

    def n_chunks(self, block_bytes: int) -> int:
        return -(-self.size // block_bytes)


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    file_id: int
    chunk_id: int
    size: int


class ChunkStore:
    """Deterministic block store: files -> 64MB chunks -> RS-sized reads."""

    def __init__(self, files: list[FileMeta], block_bytes: int = 64 * MB,
                 replication: int = 3, n_datanodes: int = 16):
        self.files = {f.file_id: f for f in files}
        self.block_bytes = block_bytes
        self.replication = replication
        self.n_datanodes = n_datanodes

    # --- namenode-ish metadata ------------------------------------------
    def chunks(self, file_id: int) -> list[ChunkRef]:
        f = self.files[file_id]
        out = []
        for c in range(f.n_chunks(self.block_bytes)):
            size = min(self.block_bytes, f.size - c * self.block_bytes)
            out.append(ChunkRef(file_id, c, size))
        return out

    def replicas(self, ref: ChunkRef) -> list[int]:
        """Datanodes holding a chunk (rendezvous placement, deterministic)."""
        scores = [
            (hash((ref.file_id, ref.chunk_id, dn)) & 0xFFFFFFFF, dn)
            for dn in range(self.n_datanodes)
        ]
        return [dn for _, dn in sorted(scores)[: self.replication]]

    # --- datanode-ish reads ------------------------------------------------
    def read(self, ref: ChunkRef, offset: int, nbytes: int) -> np.ndarray:
        """Read ``nbytes`` at ``offset`` within a chunk (one RS-sized request)."""
        nbytes = min(nbytes, ref.size - offset)
        if nbytes <= 0:
            return np.zeros(0, np.uint8)
        # deterministic payload: cheap counter-based PRNG on 8-byte words
        word0 = offset // 8
        nwords = -(-(offset % 8 + nbytes) // 8) + 1
        idx = (np.arange(word0, word0 + nwords, dtype=np.uint64)
               + np.uint64(ref.file_id) * np.uint64(0x9E3779B97F4A7C15)
               + np.uint64(ref.chunk_id) * np.uint64(0xBF58476D1CE4E5B9))
        x = idx * np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        raw = x.view(np.uint8)
        start = offset % 8
        return raw[start : start + nbytes]

    def read_chunk(self, ref: ChunkRef, request_bytes: int) -> np.ndarray:
        """Full chunk via RS-sized requests -> the paper's (FS, RS) access."""
        parts = [
            self.read(ref, off, request_bytes)
            for off in range(0, ref.size, request_bytes)
        ]
        return np.concatenate(parts) if parts else np.zeros(0, np.uint8)

    def as_workload(self, request_bytes: int, op: str = "read") -> Workload:
        """Characterize one loader task on this store (paper C1)."""
        return Workload(fs=float(self.block_bytes), rs=float(request_bytes), op=op)
