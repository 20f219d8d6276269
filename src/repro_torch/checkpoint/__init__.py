"""Checkpointing of the port (counterpart of ``repro.checkpoint``), on the
JAX package's on-disk layout."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
