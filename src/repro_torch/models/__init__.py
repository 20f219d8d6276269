"""The dense and ssm LM families of the port (counterpart of ``repro.models``)."""
from .api import CACHE_PAD, Model, build_model
from .params import ParamInfo, materialize
from .rwkv import RWKVLM
from .transformer import TransformerLM

__all__ = ["CACHE_PAD", "Model", "ParamInfo", "RWKVLM", "TransformerLM", "build_model",
           "materialize"]
