"""Logical-axis sharding rules over ``torch.distributed`` device meshes
(the JAX package's ``parallel``)."""
