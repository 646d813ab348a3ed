"""The training loop and the train/serve step functions (the JAX
package's ``runtime``)."""
