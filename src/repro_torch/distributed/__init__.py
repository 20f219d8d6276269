"""Distribution in the port (counterpart of ``repro.distributed``): the
serving steps, the fault-tolerance plane and the server axis, which lays
the fleet's ``[m, ...]`` state over the ranks of a ``torch.distributed``
process group (``server_axis``)."""
from .server_axis import DENSE, ServerAxis

__all__ = ["DENSE", "ServerAxis"]
