"""The dense, ssm and hybrid LM families of the port (counterpart of
``repro.models``)."""
from .api import CACHE_PAD, Model, build_model
from .hybrid import HybridLM
from .params import ParamInfo, materialize
from .rwkv import RWKVLM
from .transformer import TransformerLM

__all__ = ["CACHE_PAD", "HybridLM", "Model", "ParamInfo", "RWKVLM", "TransformerLM",
           "build_model", "materialize"]
