"""PyTorch/CUDA port of the ``repro`` package (JAX on TPU).

The module layout mirrors ``repro`` (``configs``, ``quant``, ``models``,
``kernels``, ``serving``); CUDA kernel sources live in ``csrc`` and are
built with ``nvcc`` at first use.  Entry points run on CUDA unless the
caller passes ``device="cpu"``, where every kernel wrapper runs its
plain PyTorch version.
"""
