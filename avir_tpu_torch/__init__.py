"""avir_tpu_torch -- the PyTorch/CUDA port of avir_tpu.

A second package beside the JAX one, with the same module names.  The
host planner (filter design, step planning, composition into one banded
operator per axis) is a NumPy copy of the JAX package's; the device
side runs on PyTorch tensors, and each TPU kernel on the ported path is
a kernel written by hand for the NVIDIA Hopper card (``ops/cuda``).

It carries the AVIR resize (``ImageResizer``, ``resize``) and the LANCIR
resize (``LancIR``, ``lancir_resize``): u8, u16, float32 or float64 in
and out, 1 to 4 channels, any output bit depth, sRGB gamma with the
alpha bypass, the "auto", "fast" and "exact" precision tiers (and
LANCIR's host "f64"), and the default or error-diffusion dither, on the
fused two-pass kernel (int8 or split-bf16 modes, biased or
round-half-even epilogue, in-kernel gamma) and the wavefront
error-diffusion kernel.  Entry points take ``device=None``, meaning
``"cuda"``; pass ``device="cpu"`` to run the kernels' plain PyTorch
versions on the CPU.
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
from .models.lancir import LancIR, lancir_resize

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
    "LancIR",
    "lancir_resize",
]
