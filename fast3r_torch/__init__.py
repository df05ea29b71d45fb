"""fast3r_torch: the PyTorch + CUDA port of fast3r_tpu for NVIDIA Hopper.

The module layout and function names mirror ``fast3r_tpu``; ``fast3r_tpu``
stays the reference each module is tested against.  Every op takes its plain
PyTorch version on CPU tensors and its hand-written CUDA C++ kernel
(``fast3r_torch/csrc``) on CUDA tensors.
This package imports neither ``jax`` nor ``fast3r_tpu``.

The names below load on first use (PEP 562): a process that needs only the
data pipeline, as the training loader's ``spawn`` workers do, imports
neither torch nor the model.
"""

import importlib
import sys
import types

_LAZY = {"Fast3R": "fast3r_torch.inference",
         "inference": "fast3r_torch.inference",
         "Fast3RConfig": "fast3r_torch.models.fast3r",
         "fast3r_forward": "fast3r_torch.models.fast3r",
         "init_fast3r": "fast3r_torch.models.fast3r"}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name]), name)
    globals()[name] = value
    return value


class _Package(types.ModuleType):
    def __setattr__(self, name, value):
        # importing the submodule fast3r_torch.inference binds it here; the
        # package's ``inference`` stays the function, as it was when the
        # package imported it eagerly
        if name == "inference" and isinstance(value, types.ModuleType):
            value = value.inference
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
