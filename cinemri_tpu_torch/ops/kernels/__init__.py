"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Nothing here builds or loads a kernel at import; ``_build.load`` does so at
the first launch.
"""
