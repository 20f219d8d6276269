"""The dense LM family of the port (counterpart of ``repro.models``)."""
from .api import CACHE_PAD, Model, build_model
from .params import ParamInfo, materialize
from .transformer import TransformerLM

__all__ = ["CACHE_PAD", "Model", "ParamInfo", "TransformerLM", "build_model", "materialize"]
