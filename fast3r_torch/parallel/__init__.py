"""Parallelism of the port.  Sequence parallelism: ring attention (the
plain ring, the ring kernels ``csrc/ring_attention{,_bwd}.cu`` and the
differentiable ring of both), the sequence-sharded serving forward and the
sequence-sharded training step, counterparts of
``fast3r_tpu/parallel/{sequence,ring_rdma}.py``.  Data, ZeRO-2 and tensor
parallelism over ``torch.distributed`` ranks: ``parallel.mesh``, the
counterpart of ``fast3r_tpu/parallel/mesh.py`` (imported as a module: it
is the layer below ``train.step``, which this package's sequence-sharded
step imports)."""

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
