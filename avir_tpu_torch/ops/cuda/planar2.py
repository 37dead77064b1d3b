"""K8: the split-bf16 fused resize with an in-chip de-interleave, its
wrapper and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/planar2_kernel.py``
(``apply_planar2_pallas``, ``regroup_channels``, ``planar2_viable``).  It
computes K7's function (ops/cuda/planar.py: split-bf16 V pass, DENSE H
taps per channel, K1's epilogue) straight from the interleaved image
[n_in_rows, n_in*C]: no de-interleaved copy in device memory.  The output
is channel-grouped, [Bv*Tv, Bh*C*Th] (H block, then channel, then pixel);
``regroup_channels`` re-interleaves it.  Gamma-in runs on the interleaved
window with the C = 4 alpha lane mask (alpha_index 0 or 3), gamma-out per
channel, skipping channel ``alpha_index``; ``out_gamma_mult`` applies to
every channel.

On the TPU the kernel de-interleaves the V result with strided lane
slices, which Mosaic cannot lower, so the JAX package's routing never
selects it and only its interpret mode runs (planar2_kernel.py:27-37
there).  On Hopper it is K7's kernel (csrc/planar.cu), a thread block
per channel, with the de-interleave where the first pass stages its image
tile: where 32 rows of a step's raw interleaved span fit its tile
(``planar.raw_row_bytes``: u8 up to C = 6, u16 up to 3, f32 at 1, rows
16-byte aligned), the block copies that span by 16-byte ``cp.async`` and
reads its channel from shared memory at a stride of C; otherwise it loads
its channel's pixels at a stride of C, one element a load.  The C blocks
of a chunk are neighbours in the grid, so they read the same rows from L2
together.  The routing still does not select it, as in the reference.
``planar2_viable`` is the JAX package's TPU VMEM budget, ported
unchanged for parity.

``apply_planar2`` launches the kernel on a CUDA tensor and runs
``apply_planar2_reference`` on a CPU tensor; they agree to float32
rounding (the split gate), not bit for bit.
"""

from __future__ import annotations

import torch

from ..banded import BlockedBandedOp
from ..gamma import _srgb_to_linear, f32
from ..lanes import LaneBlockedOp
from .fused_split import to_float32
from .launch import on_cpu
from .planar import PlanarOperands, launch_planar, planes_reference, prepare_planar

# Launches of the kernel, counted by the wrapper.
launches = {"planar2": 0}


def regroup_channels(
    out: torch.Tensor, c: int, th: int, new_h: int, new_w: int
) -> torch.Tensor:
    """[Bv*Tv, Bh*C*Th] channel-grouped -> [new_h, new_w*c] interleaved."""
    rows, lanes = out.shape
    bh = lanes // (c * th)
    x = out.reshape(rows, bh, c, th).permute(0, 1, 3, 2)
    return x.reshape(rows, bh * th * c)[:new_h, : new_w * c]


def planar2_viable(vop: BlockedBandedOp, pop: LaneBlockedOp, c: int) -> bool:
    """The JAX package's VMEM-budget check of its in-VMEM de-interleave
    kernel (a TPU limit, kept for parity)."""
    _, tv, wv = vop.taps_hi.shape
    _, wh, th = pop.taps_hi.shape
    whc = wh * c
    vmem = (
        2 * wv * whc           # double-buffered input window (u8-worst)
        + 4 * wv * whc         # f32 conversion temp
        + 2 * 2 * tv * wv * 2  # V taps hi/lo, double-buffered
        + 2 * 2 * wh * th * 2  # H taps hi/lo (dense), double-buffered
        + 4 * tv * whc         # V intermediate
        + 4 * tv * wh          # de-interleaved channel slice
        + 2 * 4 * tv * c * th  # output tiles
    )
    return vmem < 14 * 1024 * 1024


def prepare_planar2(
    vop: BlockedBandedOp,
    pop: LaneBlockedOp,
    c: int,
    device: torch.device | str,
    alpha_index: int = -1,
    **kw,
) -> PlanarOperands:
    """Operands of K8: ``prepare_planar``'s, for the interleaved input,
    with ``alpha_index`` the channel that bypasses the curves."""
    return prepare_planar(
        vop, pop, c, device, alpha_plane=alpha_index, interleaved=True, **kw
    )


def apply_planar2_reference(ops: PlanarOperands, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8: interleaved [n_in_rows, n_in*C] (u8, u16 or
    float32) -> channel-grouped [Bv*Tv, Bh*C*Th] of ``ops.out_dtype``, on
    the device of ``x``."""
    c = ops.c
    xf = torch.zeros((ops.rows_pad, ops.lanes_pad * c), dtype=torch.float32, device=x.device)
    rows, lanes = min(ops.rows_pad, x.shape[0]), min(ops.lanes_pad * c, x.shape[1])
    xf[:rows, :lanes] = to_float32(x[:rows, :lanes])
    if ops.epi.gamma:  # padding stays 0
        xf = _srgb_to_linear(xf * f32(ops.epi.in_gamma_mult), c, ops.alpha)
    planes = [p.contiguous() for p in xf.reshape(ops.rows_pad, ops.lanes_pad, c).unbind(2)]
    out = planes_reference(ops, planes)  # [c, Bv*Tv, Bh*Th]
    rows_out, lanes_out = out.shape[1:]
    out = out.reshape(c, rows_out, lanes_out // ops.th, ops.th).permute(1, 2, 0, 3)
    return out.reshape(ops.out_shape).contiguous()


def apply_planar2(ops: PlanarOperands, x: torch.Tensor) -> torch.Tensor:
    """K8: interleaved [n_in_rows, n_in*C] -> channel-grouped [Bv*Tv,
    Bh*C*Th] of ``ops.out_dtype``.  A CUDA tensor launches the kernel; a
    CPU tensor runs the plain version."""
    if not ops.interleaved:
        raise ValueError("planar operands are K7's (ops/cuda/planar.py)")
    if on_cpu(x, ops.device):
        return apply_planar2_reference(ops, x)
    return launch_planar(ops, x, launches)
