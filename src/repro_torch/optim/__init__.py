"""Optimizers (the JAX package's ``optim``)."""
