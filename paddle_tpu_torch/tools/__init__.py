"""Command-line tools of the port (counterparts of the JAX package's tools/)."""
