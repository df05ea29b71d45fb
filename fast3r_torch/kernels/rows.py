"""The rows at which a kernel's output at the many-view shapes is held
against its plain version.

At 1000 views of 512x384 the blocks run on M = 768,000 tokens (1000 x 768):
the packed (3, M, 1024) qkv holds 2.36G elements and fc1's (M, 4096) output
3.15G, past 2^31, and the decoder's attention runs over S = M tokens, whose
S x S scores no plain version can form.  Every block kernel is row-wise (a
row of its output reads that row of its inputs), so its plain version on
some rows gives its output at those rows: the checks take the first and
last rows, where an element offset that wraps at 2^31 shows (the last rows
of each output and of each plane of the packed buffer), and a seeded sample
between.  The attention forward is held on a sample of query rows a head
against the plain attention of those rows over all keys
(``ops.flash_attention.attention_rows_lse_ref``).
"""

from __future__ import annotations

import torch

MANY_VIEW_TOKENS = 768_000  # 1000 views x 768 tokens (512x384, patch 16)


def check_rows(m: int, seed: int, edge: int = 1024, between: int = 2048,
               device="cpu") -> torch.Tensor:
    """Sorted distinct rows of an m-row output: the first and last ``edge``
    and ``between`` rows drawn with ``seed`` from those between (int64)."""
    g = torch.Generator().manual_seed(seed)
    mid = torch.randint(edge, max(edge + 1, m - edge), (between,), generator=g)
    rows = torch.cat([torch.arange(min(edge, m)), mid,
                      torch.arange(max(0, m - edge), m)])
    return rows.clamp(max=m - 1).unique().to(device)


def query_rows(s: int, heads: int, seed: int, last: int = 128,
               between: int = 128, device="cpu") -> torch.Tensor:
    """(heads, last + between) query rows of an s-token attention: for each
    head the last ``last`` rows and ``between`` rows drawn with ``seed``
    from the others (int64)."""
    g = torch.Generator().manual_seed(seed)
    mid = torch.randint(0, s - last, (heads, between), generator=g)
    tail = torch.arange(s - last, s).expand(heads, last)
    return torch.cat([mid, tail], dim=1).to(device)
