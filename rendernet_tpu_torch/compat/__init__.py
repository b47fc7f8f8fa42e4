"""Interchange with the JAX package's weight files."""
