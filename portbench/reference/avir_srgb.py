"""The AVIR reference in sRGB gamma mode (``CImageResizerVars::
UseSRGBGamma``, avir.h:2466-2547): each u8 value times 1 / 255, to linear
light (``srgb.to_linear``); the frozen planner's operators for the
configuration's preset and geometry, as without gamma; back to sRGB
(``srgb.to_srgb``), times 255, rounded half up and clamped, as AVIR's
default ditherer does for an 8-bit output (avir.h:4392-4419).  With
``alpha_index`` 0 or 3 of a 4-channel image, that channel bypasses both
conversions (scaled by 1 / 255 and back only).

Where it departs from upstream: every step is float64 (upstream's are
float32, its u8 table of ``to_linear`` included), and the linear values
are not rounded anywhere.  The converters are AVIR's own polynomials,
not exact powers (``srgb.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import srgb
from .dense import Reference, dense
from .params import preset
from .plan import build_resize_plan


@dataclasses.dataclass
class SrgbReference(Reference):
    in_mul: float = 1.0 / 255.0  # u8 value -> sRGB in [0, 1]
    gamma_out_mul: float = 255.0  # sRGB in [0, 1] -> output units
    alpha_index: int = -1  # the channel that bypasses the conversions

    def forward(self, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """[H, W, C] -> [new_h, new_w, C] float64 before rounding, every
        step (the conversions, the operators, the intermediate) in
        ``dtype``."""
        s = x.to(dtype) * self.in_mul
        lin = self._bypass(s, srgb.to_linear(s))
        y = super().forward(lin, dtype).to(dtype)  # exact: y holds dtype values
        out = self._bypass(y, srgb.to_srgb(y)) * self.gamma_out_mul
        return out.to(torch.float64)

    def _bypass(self, plain: torch.Tensor, converted: torch.Tensor) -> torch.Tensor:
        """``converted``, with the alpha channel taken from ``plain``."""
        if self.alpha_index not in (0, 3) or plain.shape[-1] != 4:
            return converted
        out = converted.clone()
        out[..., self.alpha_index] = plain[..., self.alpha_index]
        return out


def build(config: dict, src: tuple[int, int], dst: tuple[int, int]) -> SrgbReference:
    """``src`` and ``dst`` are (width, height); ``config["alpha_index"]``
    (default -1: none) names a 4-channel image's alpha channel."""
    if (
        config["in_dtype"] != "uint8"
        or config["out_dtype"] != "uint8"
        or not config["use_srgb_gamma"]
        or config["dither"] != "default"
        or config["res_bit_depth"] != 8
    ):
        raise ValueError(
            "the AVIR sRGB reference covers 8-bit in and out with gamma, the "
            "default dither and an 8-bit result"
        )
    (w, h), (nw, nh) = src, dst
    plan = build_resize_plan(
        w, h, nw, nh, config["channels"], np.uint8, np.uint8,
        params=preset(config["preset"]), res_bit_depth=8,
        use_srgb_gamma=True, alpha_index=config.get("alpha_index", -1),
    )
    # Under gamma the planner folds no output scale into the taps: they
    # keep unit gain, as without gamma for 8-bit in and out (255 / 255);
    # the scales are the conversions' 1 / 255 and 255.
    return SrgbReference(
        v=dense(plan.v.op), h=dense(plan.h.op), out_mul=1.0,
        clamp=plan.out_type_max, rounding="half_up",
        in_mul=plan.in_gamma_mult, gamma_out_mul=plan.out_gamma_mult,
        alpha_index=plan.alpha_index,
    )
