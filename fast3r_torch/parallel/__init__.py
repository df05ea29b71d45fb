"""Sequence parallelism of the port: ring attention (the plain ring, the
ring kernels ``csrc/ring_attention{,_bwd}.cu`` and the differentiable ring
of both), the sequence-sharded serving forward and the sequence-sharded
training step, counterparts of ``fast3r_tpu/parallel/{sequence,ring_rdma}.py``."""

from fast3r_torch.parallel.ring_rdma import (
    ring_flash_attention_rdma,
    ring_flash_attention_rdma_diff,
)
from fast3r_torch.parallel.sequence import (
    make_seq_sharded_forward,
    make_seq_sharded_train_step,
    ring_attention_bwd_ref,
    ring_flash_attention,
    seq_sharded_conf_loss,
    seq_sharded_config,
)

__all__ = ["make_seq_sharded_forward", "make_seq_sharded_train_step",
           "ring_attention_bwd_ref", "ring_flash_attention",
           "ring_flash_attention_rdma", "ring_flash_attention_rdma_diff",
           "seq_sharded_conf_loss", "seq_sharded_config"]
