"""Model configurations of the port (counterpart of ``repro.configs``).

``configs/<id>.py`` exports ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family configuration for CPU tests), copied from
the JAX package for the dense family; ``registry.get_config`` maps ``--arch``
ids to them.
"""
from .base import SHAPES, ModelConfig
from .registry import ARCHS, SMOKES, get_config

__all__ = ["ARCHS", "SHAPES", "SMOKES", "ModelConfig", "get_config"]
