"""AVIR through ``avir_tpu_torch.make_resize_fn``."""

from __future__ import annotations

import avir_tpu_torch
import numpy as np


def make(config: dict, src: tuple[int, int], dst: tuple[int, int], device):
    """The port's device function for ``config``: u8 [H, W, C] on
    ``device`` -> [new_h, new_w, C].  ``src`` and ``dst`` are (width,
    height)."""
    (w, h), (nw, nh) = src, dst
    return avir_tpu_torch.make_resize_fn(
        (h, w, config["channels"]), np.dtype(config["in_dtype"]), nw, nh,
        out_dtype=np.dtype(config["out_dtype"]),
        params=avir_tpu_torch.preset(config["preset"]),
        res_bit_depth=config["res_bit_depth"],
        use_srgb_gamma=config["use_srgb_gamma"],
        dither=config["dither"],
        precision=config["precision"],
        device=device,
    )


def route(fn) -> dict:
    """The executor's route, pass order and K1 variant."""
    run = fn.run
    return {
        "route": run.route,
        "order": run.order,
        "launch_key": getattr(run.ops, "launch_key", None),
    }
