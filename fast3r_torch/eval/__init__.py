"""Evaluation: local -> global alignment and camera pose recovery."""
