"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Sources live in ``csrc/`` and are built by ``_build`` at first use; nothing
here imports a compiler or touches a device when the package is imported.
"""
