"""``repro_torch`` — the PyTorch/CUDA port of the ``repro`` HPO engine.

The define-by-run study loop of ``repro.core`` on in-memory storage, with the
TPE sampler's device engine in PyTorch and its Parzen scorer as a
hand-written CUDA kernel for Hopper (``kernels/csrc/parzen.cu``); the
multi-objective engine; and the LM workload's dense and Mamba2 hybrid
families (``models``, ``serve``, ``train``, ``tune``) with their kernels in
``kernels/csrc``.  The package imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``.
"""
