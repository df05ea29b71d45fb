"""Sine-cosine positional embedding tables (host side, numpy).

Counterpart of ``fast3r_tpu/ops/sincos.py:sincos_1d_table_np``: the fusion
decoder's image-index embedding is a 1D sincos table over indices 0..n-1,
computed in float64 and cast to float32.
"""

from __future__ import annotations

import numpy as np


def sincos_1d_table_np(embed_dim: int, n: int) -> np.ndarray:
    """(n, embed_dim) float32 table ``[sin(pos * omega), cos(pos * omega)]``
    with ``omega[i] = 1 / 10000 ** (i / (embed_dim / 2))``."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    half = embed_dim // 2
    omega = np.arange(half, dtype=float) / float(half)
    omega = 1.0 / 10000.0 ** omega
    pos = np.arange(n, dtype=float)
    out = np.einsum("m,d->md", pos, omega)
    emb = np.concatenate([np.sin(out), np.cos(out)], axis=1)
    return emb.astype(np.float32)
