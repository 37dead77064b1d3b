"""AVIR's sRGB converters in plain PyTorch, computed in the dtype of
their argument.

``to_linear`` is ``convertSRGB2Lin`` (avir.h:208-220) with the polynomial
``pow24_sRGB`` (avir.h:162-174); ``to_srgb`` is ``convertLin2SRGB``
(avir.h:299-310) with ``pow24i_sRGB`` (avir.h:185-196).  These forms, and
not exact powers, define AVIR's gamma mode: upstream builds its u8 table
from them and applies them to every other input and to the output, so the
reference evaluates the same functions.  Upstream evaluates them in
float32; here each operation is one of the argument's dtype (float64 for
the yardstick, bfloat16 for the control).  A copy of the port's
``ops/gamma.py`` forms, kept here so that no change to the port can move
the yardstick.
"""

from __future__ import annotations

import torch


def pow24(x: torch.Tensor) -> torch.Tensor:
    """x ** 2.4 for x in about [0.09, 1] (pow24_sRGB)."""
    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2
    return (
        0.0985766365536824
        + 0.839474952656502 * x2
        + 0.363287814061725 * x3
        - 0.0125559718896615 / (0.12758338921578 + 0.290283465468235 * x)
        - 0.231757513261358 * x
        - 0.0395365717969074 * x4
    )


def pow24i(x: torch.Tensor) -> torch.Tensor:
    """x ** (1 / 2.4) for x in about [0.003, 1] (pow24i_sRGB)."""
    sx = torch.sqrt(x)
    ssx = torch.sqrt(sx)
    sssx = torch.sqrt(ssx)
    return (
        0.000213364515060263
        + 0.0149409239419218 * x
        + 0.433973412731747 * sx
        + ssx * (0.659628181609715 * sssx - 0.0380957908841466 - 0.0706476137208521 * sx)
    )


def to_linear(s: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> linear light (convertSRGB2Lin)."""
    return torch.where(s <= 0.04045, s / 12.92, pow24((s + 0.055) / 1.055))


def to_srgb(s: torch.Tensor) -> torch.Tensor:
    """Linear light -> sRGB (convertLin2SRGB).  The polynomial branch's
    argument is held at its cut-off, so that the branch not taken never
    takes the root of a negative value (the resize rings below 0)."""
    return torch.where(
        s <= 0.0031308, 12.92 * s, 1.055 * pow24i(s.clamp_min(0.0031308)) - 0.055
    )
