"""The design-flow core: meta-model, pipe tasks, flow graphs, searches
and the prebuilt strategies (the JAX package's ``core``)."""
