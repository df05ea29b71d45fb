"""Ops: the hand-written kernels with their plain versions, and plain tensor ops."""
