"""The AVIR reference: the frozen planner's operators for the
configuration's preset and geometry, rounded half up and clamped, as
AVIR's default ditherer does for an 8-bit output (avir.h:4392-4419)."""

from __future__ import annotations

import numpy as np

from .dense import Reference, dense
from .params import preset
from .plan import build_resize_plan


def build(config: dict, src: tuple[int, int], dst: tuple[int, int]) -> Reference:
    """``src`` and ``dst`` are (width, height)."""
    if (
        config["in_dtype"] != "uint8"
        or config["out_dtype"] != "uint8"
        or config["use_srgb_gamma"]
        or config["dither"] != "default"
        or config["res_bit_depth"] != 8
    ):
        raise ValueError(
            "the AVIR reference covers 8-bit in and out, no gamma, the "
            "default dither and an 8-bit result"
        )
    (w, h), (nw, nh) = src, dst
    plan = build_resize_plan(
        w, h, nw, nh, config["channels"], np.uint8, np.uint8,
        params=preset(config["preset"]), res_bit_depth=8,
    )
    # For 8-bit in and out the output scale (255 / 255) is folded into the
    # taps, as the planner does.
    return Reference(
        v=dense(plan.v.op), h=dense(plan.h.op), out_mul=1.0,
        clamp=plan.out_type_max, rounding="half_up",
    )
