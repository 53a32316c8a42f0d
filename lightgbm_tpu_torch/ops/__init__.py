"""Hand-written CUDA kernels (``csrc/``), their build (``_build``) and
their PyTorch wrappers."""
