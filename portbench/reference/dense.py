"""A resize as two dense matrix products, in plain PyTorch.

``Reference.forward`` takes an input frame [H, W, C] and returns the
resized frame [new_h, new_w, C] before rounding, in the output's units;
``finish`` rounds and clamps it as the configuration states, or, with
``errdiff`` set, diffuses the error by AVIR's rule (``errdiff.py``).  In
float64 it is the yardstick; in bfloat16 it is the control that the check
has to refuse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import errdiff as _errdiff


def dense(op) -> np.ndarray:
    """The float64 matrix [n_out, n_in] of a banded operator (``starts``,
    ``taps``; every ``starts[i] + j`` lies inside the input)."""
    d = np.zeros((op.n_out, op.n_in), dtype=np.float64)
    rows = np.repeat(np.arange(op.n_out), op.taps.shape[1])
    cols = (np.asarray(op.starts, dtype=np.int64)[:, None] + np.arange(op.taps.shape[1])).ravel()
    d[rows, cols] = op.taps.ravel()
    return d


@dataclasses.dataclass
class Reference:
    v: np.ndarray  # float64 [new_h, src_h]
    h: np.ndarray  # float64 [new_w, src_w]
    out_mul: float  # applied after both passes
    clamp: float  # largest output value
    rounding: str  # "half_up" or "half_even"
    # AVIR's error-diffusion weights (errdiff.AVIR_WEIGHTS: current row
    # right, next row left, centre, right); None rounds each value alone.
    errdiff: tuple[float, float, float, float] | None = None

    def __post_init__(self):
        if self.rounding not in ("half_up", "half_even"):
            raise ValueError(f"unknown rounding {self.rounding!r}")
        self._ops = {}

    @property
    def order(self) -> str:
        """The pass order the geometry implies: the vertical pass first
        where the image shrinks, the horizontal one first where it grows."""
        (nh, h), (nw, w) = self.v.shape, self.h.shape
        return "vh" if nh * nw <= h * w else "hv"

    def _matrices(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._ops:
            self._ops[key] = tuple(
                torch.from_numpy(m).to(device=device, dtype=dtype) for m in (self.v, self.h)
            )
        return self._ops[key]

    def forward(self, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """[H, W, C] -> [new_h, new_w, C] float64, computed in ``dtype``
        (the operators, the frame and the intermediate all in it)."""
        v, hm = self._matrices(x.device, dtype)
        src_h, src_w, c = x.shape
        nh, nw = v.shape[0], hm.shape[0]
        x = x.to(dtype)
        if self.order == "vh":
            y = (v @ x.reshape(src_h, src_w * c)).reshape(nh, src_w, c)
            y = (y.transpose(1, 2) @ hm.T).transpose(1, 2)
        else:
            y = (x.transpose(1, 2) @ hm.T).transpose(1, 2).reshape(src_h, nw * c)
            y = (v @ y).reshape(nh, nw, c)
        y = y.to(torch.float64)
        return y * self.out_mul if self.out_mul != 1.0 else y

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        """Round (half up, or half to even) and clamp to [0, clamp]; with
        ``errdiff``, the float64 error diffusion of ``y`` [..., H, W, C]
        to 1 LSB, each frame and channel alone."""
        if self.errdiff is not None:
            h, w, c = y.shape[-3:]
            lanes = _errdiff.lanes(y.to(torch.float64))
            out = _errdiff.diffuse(lanes, self.errdiff, 1.0, self.clamp)
            return out.reshape(h, w, -1, c).permute(2, 0, 1, 3).reshape(y.shape)
        r = torch.floor(y + 0.5) if self.rounding == "half_up" else torch.round(y)
        return r.clamp(0.0, self.clamp)

    def nonzero_taps(self) -> tuple[int, int]:
        """Nonzero taps of the vertical and of the horizontal operator."""
        return int(np.count_nonzero(self.v)), int(np.count_nonzero(self.h))
