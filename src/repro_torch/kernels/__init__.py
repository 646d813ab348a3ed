"""Hand-written CUDA kernels (``csrc/``) with their PyTorch wrappers.

Each wrapper module holds the kernel's plain PyTorch version, used for
CPU tensors, and a ``launches`` count of kernel launches.
"""
