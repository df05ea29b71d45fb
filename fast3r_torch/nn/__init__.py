"""Layers: parameter modules and apply functions."""
