"""The AVIR reference for 16-bit RGBA in sRGB gamma mode
(``CImageResizerVars::UseSRGBGamma`` and ``AlphaIndex``,
avir.h:2466-2547; ``CImageResizer`` with ``ResBitDepth`` 16,
avir.h:4630-4635): each u16 value times 1 / 65535, to linear light
(``srgb.to_linear``); the frozen planner's operators for the
configuration's preset and geometry at a 16-bit result; back to sRGB
(``srgb.to_srgb``), times 65535 (the multipliers of avir.h:4740-4782),
rounded half up and clamped to [0, 65535], as AVIR's default ditherer does
with ``TruncBits`` = 16 - 16 = 0 (avir.h:5029-5045).  The alpha channel
(``alpha_index`` 0 or 3 of a 4-channel image) is scaled by 1 / 65535 and
back only, through neither conversion.  It is ``avir_srgb.py``'s
``SrgbReference`` with the 16-bit plan, so ``forward(x, dtype)`` and
``finish`` are the same, and the bfloat16 control runs on it unchanged.

Where it departs from upstream: every step is float64 (upstream's are
float32: its 16-bit outputs read up to ~0.05 LSB from this reference's,
so a value may round the other way where it lies that close to a
midpoint), and the linear values are not rounded anywhere.  The
converters are AVIR's own polynomials, not exact powers (``srgb.py``).
"""

from __future__ import annotations

import numpy as np

from .avir_srgb import SrgbReference
from .dense import dense
from .params import preset
from .plan import build_resize_plan


def build(config: dict, src: tuple[int, int], dst: tuple[int, int]) -> SrgbReference:
    """``src`` and ``dst`` are (width, height); ``config["alpha_index"]``
    (default -1: none) names a 4-channel image's alpha channel."""
    if (
        config["in_dtype"] != "uint16"
        or config["out_dtype"] != "uint16"
        or not config["use_srgb_gamma"]
        or config["dither"] != "default"
        or config["res_bit_depth"] != 16
    ):
        raise ValueError(
            "the AVIR 16-bit sRGB reference covers 16-bit in and out with "
            "gamma, the default dither and a 16-bit result"
        )
    (w, h), (nw, nh) = src, dst
    plan = build_resize_plan(
        w, h, nw, nh, config["channels"], np.uint16, np.uint16,
        params=preset(config["preset"]), res_bit_depth=16,
        use_srgb_gamma=True, alpha_index=config.get("alpha_index", -1),
    )
    # Under gamma the taps keep unit gain; the scales are the conversions'
    # 1 / 65535 and 65535 (plan.in_gamma_mult, plan.out_gamma_mult).
    return SrgbReference(
        v=dense(plan.v.op), h=dense(plan.h.op), out_mul=1.0,
        clamp=plan.out_type_max, rounding="half_up",
        in_mul=plan.in_gamma_mult, gamma_out_mul=plan.out_gamma_mult,
        alpha_index=plan.alpha_index,
    )
