"""Carry a resize's weights from the JAX package into this port.

A resize's weights are its plan's two banded operators (one per axis).
These functions rebuild the port's ``BandedOp``, ``ResizePlan`` and
``LancirPlan`` from plain NumPy arrays and scalars, so the same taps can run through both
packages' executors.  Nothing here imports the JAX package: the caller
hands over the arrays (``np.asarray`` of each field).
"""

from __future__ import annotations

import numpy as np

from .plan.compose import BandedOp
from .plan.lancir_plan import LancirPlan
from .plan.plan import AxisPlan, ResizePlan

_AXIS_FIELDS = ("n_in", "n_out", "starts", "taps", "build_mode", "k", "o")


def banded_op_from_numpy(
    n_in: int, n_out: int, starts, taps
) -> BandedOp:
    """A BandedOp from its window starts [n_out] and taps [n_out, width]."""
    starts = np.asarray(starts, dtype=np.int32)
    taps = np.asarray(taps, dtype=np.float64)
    if starts.shape != (n_out,) or taps.ndim != 2 or taps.shape[0] != n_out:
        raise ValueError(
            f"starts {starts.shape} / taps {taps.shape} do not match "
            f"n_out={n_out}"
        )
    if n_out and int(starts.max()) + taps.shape[1] > n_in:
        raise ValueError("operator window runs past the input")
    return BandedOp(n_in=int(n_in), n_out=int(n_out), starts=starts, taps=taps)


def resize_plan_from_numpy(fields: dict) -> ResizePlan:
    """A ResizePlan from the JAX ``ResizePlan``'s scalar fields plus
    ``h`` and ``v`` given as ``(n_in, n_out, starts, taps, build_mode, k,
    o)``."""
    fields = dict(fields)

    def axis(value) -> AxisPlan:
        if len(value) != len(_AXIS_FIELDS):
            raise ValueError(f"axis needs {_AXIS_FIELDS}")
        n_in, n_out, starts, taps, build_mode, k, o = value
        return AxisPlan(
            op=banded_op_from_numpy(n_in, n_out, starts, taps),
            build_mode=int(build_mode),
            k=float(k),
            o=float(o),
        )

    fields["h"] = axis(fields["h"])
    fields["v"] = axis(fields["v"])
    return ResizePlan(**fields)


def lancir_plan_from_numpy(fields: dict) -> LancirPlan:
    """A LancirPlan from the JAX ``LancirPlan``'s scalar fields plus
    ``h`` and ``v`` given as ``(n_in, n_out, starts, taps)``."""
    fields = dict(fields)
    for axis in ("h", "v"):
        value = fields[axis]
        if len(value) != 4:
            raise ValueError("axis needs (n_in, n_out, starts, taps)")
        fields[axis] = banded_op_from_numpy(*value)
    return LancirPlan(**fields)
