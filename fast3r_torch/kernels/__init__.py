"""Kernel build and loading."""
