"""Resampling, transforms and the conv kernels of the port."""
