"""Checkpointing (the JAX package's ``checkpoint``)."""
