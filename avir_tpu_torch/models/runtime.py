"""Execution of resize plans on PyTorch tensors.

Counterpart of the JAX package's ``models/runtime.py:make_avir_executor``
for this port's slice: u8 in, 8-bit out (``res_bit_depth=8``), no gamma,
default dither, ``precision="auto"``.  That configuration runs, in the
JAX package, the int8 mode of the fused two-pass kernel; here it runs
the same arithmetic in ``ops/cuda/fused_kernel.py``, one launch per
resize, V pass first for a downsize and H pass first for an upsize.

Every other configuration raises NotImplementedError naming the
ROADMAP.md item that will bring it; none is computed by another route.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.banded import block_banded
from ..ops.cuda.fused_kernel import (
    apply_fused_int8,
    int8_feasible,
    prepare_fused_int8,
)
from ..ops.lanes import lane_block_banded
from ..plan.plan import ResizePlan


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card; without one, that is an error."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the kernels' plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def unsupported_reason(plan: ResizePlan, precision: str) -> str | None:
    """Why the port cannot run this plan yet (with its ROADMAP.md
    item), or None when it can."""
    if precision != "auto":
        return f"precision={precision!r} (ROADMAP.md Queue 1 item 5)"
    if plan.is_in_float or plan.in_type_max != 255.0:
        return "non-u8 input (ROADMAP.md Queue 1 item 5)"
    if plan.is_out_float or plan.out_type_max != 255.0:
        return "non-u8 output (ROADMAP.md Queue 1 item 5)"
    if plan.use_srgb_gamma:
        return "sRGB gamma (ROADMAP.md Queue 1 item 7)"
    if plan.res_bit_depth != 8:
        return (
            f"res_bit_depth={plan.res_bit_depth} (ROADMAP.md Queue 1 item 5)"
        )
    if not 1 <= plan.el_count <= 4:
        return f"{plan.el_count} channels (ROADMAP.md Queue 1 item 4)"
    return None


def make_avir_executor(
    plan: ResizePlan,
    precision: str = "auto",
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a resize function u8 [H, W*C] -> u8 [new_h, new_w*C] on
    ``device`` for ``plan``.  The returned function carries the kernel
    operands as ``run.ops``."""
    reason = unsupported_reason(plan, precision)
    if reason is not None:
        raise NotImplementedError(f"not ported yet: {reason}")
    device = resolve_device(device)
    vop = block_banded(plan.v.op)
    lop = lane_block_banded(plan.h.op, plan.el_count)
    downsize = vop.n_out * lop.n_out <= vop.n_in * lop.n_in
    order = "vh" if downsize else "hv"
    if not int8_feasible(vop, lop, order):
        raise NotImplementedError(
            "not ported yet: int8-infeasible taps need the split-bf16 "
            "modes (ROADMAP.md Queue 1 item 5)"
        )
    ops = prepare_fused_int8(vop, lop, order, device)

    def run(src: torch.Tensor) -> torch.Tensor:
        return apply_fused_int8(ops, src)

    run.ops = ops
    return run
