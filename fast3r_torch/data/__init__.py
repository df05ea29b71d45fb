"""Synthetic data for tests and smoke runs."""
