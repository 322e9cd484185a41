"""Runnable examples of the port (``examples/`` of the JAX package)."""
