"""avir_tpu_torch -- the PyTorch/CUDA port of avir_tpu.

A second package beside the JAX one, with the same module names.  The
host planner (filter design, step planning, composition into one banded
operator per axis) is a NumPy copy of the JAX package's; the device
side runs on PyTorch tensors, and each TPU kernel on the ported path is
a kernel written by hand for the NVIDIA Hopper card (``ops/cuda``).

This slice carries the AVIR main path: u8 in, 8-bit out, no gamma,
default dither, on the fused int8 two-pass kernel.  Entry points take
``device=None``, meaning ``"cuda"``; pass ``device="cpu"`` to run the
kernel's plain PyTorch version on the CPU.
"""

from .params import (
    Params,
    PARAMS_DEF,
    PARAMS_ULR,
    PARAMS_LR,
    PARAMS_LOW,
    PARAMS_HIGH,
    PARAMS_ULTRA,
    preset,
)
from .models.avir import ImageResizer, resize

__version__ = "0.1.0"

__all__ = [
    "Params",
    "PARAMS_DEF",
    "PARAMS_ULR",
    "PARAMS_LR",
    "PARAMS_LOW",
    "PARAMS_HIGH",
    "PARAMS_ULTRA",
    "preset",
    "ImageResizer",
    "resize",
]
