"""avir_tpu_torch -- the PyTorch/CUDA port of avir_tpu.

A second package beside the JAX one, with the same module names.  The
host planner (filter design, step planning, composition into one banded
operator per axis) is a NumPy copy of the JAX package's; the device
side runs on PyTorch tensors, and each TPU kernel on the ported path is
a kernel written by hand for the NVIDIA Hopper card (``ops/cuda``).

It carries the single-card public API of the JAX package: the AVIR
resize (``ImageResizer`` with ``resize`` and ``resize_batch``, ``resize``,
``make_resize_fn``) and the LANCIR resize (``LancIR``, ``lancir_resize``,
``make_lancir_resize_fn``): u8, u16, float32 or float64 in and out, any
channel count and output bit depth, sRGB gamma with the alpha bypass, the
"auto", "fast" and "exact" precision tiers and the float64 host route,
the default, error-diffusion and custom dithers, and the plan cache; the
native host binding (``native``), the ``imageresize`` CLI
(``python -m avir_tpu_torch.cli``) and the metrology (``metrology``).
Entry points take ``device=None``, meaning ``"cuda"``; pass
``device="cpu"`` to run the kernels' plain PyTorch versions on the CPU.
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
from .models.avir import ImageResizer, make_resize_fn, resize
from .models.lancir import LancIR, lancir_resize, make_lancir_resize_fn
from . import metrology, native

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
    "make_resize_fn",
    "LancIR",
    "lancir_resize",
    "make_lancir_resize_fn",
    "metrology",
    "native",
]
