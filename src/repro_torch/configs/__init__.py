"""Model configurations of the port (counterpart of ``repro.configs``).

``configs/<id>.py`` exports ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family configuration for CPU tests), copied from
the JAX package for all ten archs; ``registry.get_config``
maps ``--arch`` ids to them.
"""
from .base import SHAPES, MeshConfig, ModelConfig
from .registry import ARCHS, SMOKES, get_config

__all__ = ["ARCHS", "SHAPES", "SMOKES", "MeshConfig", "ModelConfig", "get_config"]
