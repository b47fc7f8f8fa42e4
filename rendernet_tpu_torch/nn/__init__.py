"""Layers and initializers of the port."""
