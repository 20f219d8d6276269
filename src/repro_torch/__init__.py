"""PyTorch/CUDA port of the consolidation engine (the JAX package ``repro``
is its reference).

Layout mirrors ``repro``: ``core/`` holds the paper model (numpy-only copies
of the workload grid, server specs, simulator and contention profiling), the
scorer algebra (``binpack_torch``), the event loop (``engine_torch``) and the
front end (``engine.ConsolidationEngine``); ``kernels/`` holds the
hand-written CUDA kernels with their plain PyTorch versions. Entry points
run on the card unless the caller passes ``device='cpu'``.
"""
