"""Pipe tasks of the design flow (the JAX package's ``tasks``): MODEL-GEN
and the PRUNING, SCALING, QUANTIZATION, TUNE and SERVE O-tasks."""
