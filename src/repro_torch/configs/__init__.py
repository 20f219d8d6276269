"""Model configurations of the port (counterpart of ``repro.configs``).

``configs/<id>.py`` exports ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family configuration for CPU tests), copied from
the JAX package for all ten archs; ``registry.get_config``
maps ``--arch`` ids to them and ``registry.cells`` lists the (arch x
shape) cells; ``base.sharding_rules`` resolves logical axes onto a mesh.
"""
from .base import SHAPES, MeshConfig, ModelConfig, RunConfig, batch_axes, sharding_rules
from .registry import ARCHS, SMOKES, cells, get_config

__all__ = ["ARCHS", "SHAPES", "SMOKES", "MeshConfig", "ModelConfig", "RunConfig", "batch_axes",
           "cells", "get_config", "sharding_rules"]
