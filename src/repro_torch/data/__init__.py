"""The training data path of the port (counterpart of ``repro.data``): the
chunk store, the token pipeline over it and the loader placement, numpy
only and copied so that batches are JAX's bit for bit."""
from .chunkstore import ChunkRef, ChunkStore, FileMeta
from .pipeline import PipelineState, TokenPipeline, synthetic_store

__all__ = ["ChunkRef", "ChunkStore", "FileMeta", "PipelineState", "TokenPipeline",
           "synthetic_store"]
