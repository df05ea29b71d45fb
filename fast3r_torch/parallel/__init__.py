"""Sequence parallelism of the port: ring attention (the plain ring and the
ring kernel, ``csrc/ring_attention.cu``) and the sequence-sharded serving
forward, counterparts of ``fast3r_tpu/parallel/{sequence,ring_rdma}.py``."""

from fast3r_torch.parallel.ring_rdma import ring_flash_attention_rdma
from fast3r_torch.parallel.sequence import (
    make_seq_sharded_forward,
    ring_flash_attention,
)

__all__ = ["make_seq_sharded_forward", "ring_flash_attention",
           "ring_flash_attention_rdma"]
