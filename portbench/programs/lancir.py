"""LANCIR through ``avir_tpu_torch.make_lancir_resize_fn``."""

from __future__ import annotations

import avir_tpu_torch
import numpy as np

from .avir import route  # noqa: F401  (the executors carry the same fields)


def make(config: dict, src: tuple[int, int], dst: tuple[int, int], device):
    """The port's LANCIR device function for ``config``; ``src`` and
    ``dst`` are (width, height)."""
    (w, h), (nw, nh) = src, dst
    return avir_tpu_torch.make_lancir_resize_fn(
        (h, w, config["channels"]), np.dtype(config["in_dtype"]), nw, nh,
        la=config["la"],
        out_dtype=np.dtype(config["out_dtype"]),
        precision=config["precision"],
        device=device,
    )
