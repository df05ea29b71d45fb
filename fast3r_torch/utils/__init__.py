"""Utilities: the JAX param-tree converter."""
