"""Kernels of the port: the engine policy (``ops``), plain PyTorch versions
(``ref``) and hand-written CUDA kernels (``csrc/``) with their wrappers."""
