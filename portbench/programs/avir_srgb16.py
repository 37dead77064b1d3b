"""AVIR's 16-bit RGBA resize in linear light: the call of
``programs/avir.py`` with the configuration's ``alpha_index``, the channel
that bypasses the gamma conversions.  Its own name picks
``reference/avir_srgb16.py``."""

from __future__ import annotations

import avir_tpu_torch
import numpy as np
import torch
from avir_tpu_torch.ops.cuda import fused_split

from .avir import route as _route


def make(config: dict, src: tuple[int, int], dst: tuple[int, int], device):
    """The port's device function for ``config``: [H, W, C] of
    ``in_dtype`` on ``device`` -> [new_h, new_w, C] of ``out_dtype``.
    ``src`` and ``dst`` are (width, height)."""
    (w, h), (nw, nh) = src, dst
    fn = avir_tpu_torch.make_resize_fn(
        (h, w, config["channels"]), np.dtype(config["in_dtype"]), nw, nh,
        out_dtype=np.dtype(config["out_dtype"]),
        params=avir_tpu_torch.preset(config["preset"]),
        res_bit_depth=config["res_bit_depth"],
        use_srgb_gamma=config["use_srgb_gamma"],
        alpha_index=config["alpha_index"],
        dither=config["dither"],
        precision=config["precision"],
        device=device,
    )
    fn.in_dtype = getattr(torch, config["in_dtype"])  # the one input type fn takes
    return fn


def route(fn) -> dict:
    """``programs/avir.py``'s route, and where K1's operands have them the
    passes' modes, the input and output types, the alpha channel and the
    key a launch counts under in ``fused_split.forms`` (None in a port
    without that counter)."""
    ops = fn.run.ops
    form = getattr(fused_split, "form", None)
    return {
        **_route(fn),
        "mode_v": getattr(ops, "mode_v", None),
        "mode_h": getattr(ops, "mode_h", None),
        "in_dtype": str(fn.in_dtype).removeprefix("torch."),
        "out_dtype": str(getattr(ops, "out_dtype", None)).removeprefix("torch."),
        "alpha_index": getattr(getattr(ops, "epi", None), "alpha_index", None),
        "form": form(ops, fn.in_dtype) if form and fn.run.route == "split" else None,
    }
