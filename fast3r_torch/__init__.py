"""fast3r_torch: the PyTorch + CUDA port of fast3r_tpu for NVIDIA Hopper.

The module layout and function names mirror ``fast3r_tpu``; ``fast3r_tpu``
stays the reference each module is tested against.  Every op takes its plain
PyTorch version on CPU tensors and its hand-written CUDA C++ kernel
(``fast3r_torch/csrc``) on CUDA tensors.
This package imports neither ``jax`` nor ``fast3r_tpu``.
"""

from fast3r_torch.inference import Fast3R, inference
from fast3r_torch.models.fast3r import Fast3RConfig, fast3r_forward, init_fast3r

__all__ = ["Fast3R", "Fast3RConfig", "fast3r_forward", "inference",
           "init_fast3r"]
