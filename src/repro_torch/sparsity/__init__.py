"""Pruning masks (the JAX package's ``sparsity``)."""
