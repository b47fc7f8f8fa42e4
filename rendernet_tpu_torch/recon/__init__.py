"""Gradient-based inverse rendering (shape, pose, texture and light recovery)."""
