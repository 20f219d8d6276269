"""The LM families of the port (counterpart of ``repro.models``): dense,
moe and vlm (``TransformerLM``), ssm (``RWKVLM``), hybrid (``HybridLM``)
and encdec (``EncDecLM``)."""
from .api import CACHE_PAD, Model, build_model
from .encdec import EncDecLM
from .hybrid import HybridLM
from .params import ParamInfo, materialize
from .rwkv import RWKVLM
from .transformer import TransformerLM

__all__ = ["CACHE_PAD", "EncDecLM", "HybridLM", "Model", "ParamInfo", "RWKVLM",
           "TransformerLM", "build_model", "materialize"]
