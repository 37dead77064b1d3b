"""The least time an H100 could take for a resize: the benchmark's own
count of the work, from the reference's operators.

Bytes: each input byte read once, each output byte written once, and each
nonzero tap once as a float32.  Operations: 2 x the band MACs of the two
passes in the order the geometry implies (``Reference.order``), counted
from the reference's nonzero taps.  This is the resize's work, not what an
implementation issues (limb products, padded windows), so it reads the
same whatever implements the resize.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
TAP_BYTES = 4


def band_macs(ref, channels: int) -> int:
    """Multiply-adds of the two passes in ``ref.order``: each output
    element of a pass costs the nonzero taps of its operator row."""
    (nh, h), (nw, w) = ref.v.shape, ref.h.shape
    nz_v, nz_h = ref.nonzero_taps()
    if ref.order == "vh":
        return nz_v * w * channels + nz_h * nh * channels
    return nz_h * h * channels + nz_v * nw * channels


def frame_bytes(ref, channels: int, in_itemsize: int, out_itemsize: int) -> int:
    (nh, h), (nw, w) = ref.v.shape, ref.h.shape
    return (
        h * w * channels * in_itemsize
        + nh * nw * channels * out_itemsize
        + sum(ref.nonzero_taps()) * TAP_BYTES
    )


def bound(ref, channels: int, in_itemsize: int, out_itemsize: int) -> dict:
    """The per-frame bound in seconds, what sets it, and its counts."""
    nbytes = frame_bytes(ref, channels, in_itemsize, out_itemsize)
    ops = 2 * band_macs(ref, channels)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return {
        "bound_s": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "ops": ops,
    }
