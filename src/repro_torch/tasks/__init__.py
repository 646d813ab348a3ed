"""Pipe tasks of the design flow (the JAX package's ``tasks``): MODEL-GEN
and the TUNE O-task so far."""
