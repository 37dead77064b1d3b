"""The LANCIR reference: the frozen planner's Lanczos operators for the
configuration's ``la`` and geometry, scaled by the output multiplier and
rounded half to even, as LANCIR's integer output does
(lancir.h:1870-2002)."""

from __future__ import annotations

import numpy as np

from .dense import Reference, dense
from .lancir_plan import build_lancir_plan


def build(config: dict, src: tuple[int, int], dst: tuple[int, int]) -> Reference:
    """``src`` and ``dst`` are (width, height)."""
    if config["in_dtype"] != "uint8" or config["out_dtype"] != "uint8":
        raise ValueError("the LANCIR reference covers 8-bit in and out")
    (w, h), (nw, nh) = src, dst
    plan = build_lancir_plan(
        w, h, nw, nh, config["channels"], np.uint8, np.uint8, la=config["la"],
    )
    return Reference(
        v=dense(plan.v), h=dense(plan.h), out_mul=plan.out_mul,
        clamp=plan.clamp, rounding="half_even",
    )
