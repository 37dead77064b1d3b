"""The least time an H100 could take for the error diffusion of one
frame: the benchmark's own count of its work, beside ``roofline.py``'s
count of the resize's.

Bytes: the frame before dithering read once as float32 (AVIR's own
buffer type) and the output written once: nh x nw x C x (4 + the output's
itemsize).  Operations: each value takes four multiply-adds (the four
neighbours' noise) and one rounding, its quantisation and its noise,
counted as ``OPS_PER_VALUE``; they run on the float32 units outside the
tensor cores.  A frame's anti-diagonals, W + 2(H - 1), are the steps that
AVIR's rule needs one after another whatever computes it.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S

# NVIDIA H100 SXM data sheet, float32 outside the tensor cores, at its
# 700 W power limit.
FP32_OPS_PER_S = 67e12
# Four multiply-adds (8), the rounding (1) and the noise's subtraction (1).
OPS_PER_VALUE = 10
PREDITHER_BYTES = 4  # float32


def frame_bytes(dst: tuple[int, int], channels: int, out_itemsize: int) -> int:
    """``dst`` is (width, height)."""
    nw, nh = dst
    return nh * nw * channels * (PREDITHER_BYTES + out_itemsize)


def steps(dst: tuple[int, int]) -> int:
    """The frame's dependent anti-diagonals: W + 2(H - 1)."""
    nw, nh = dst
    return nw + 2 * (nh - 1) if nw and nh else 0


def bound(dst: tuple[int, int], channels: int, out_itemsize: int) -> dict:
    """The per-frame bound in seconds, what sets it, and its counts."""
    nw, nh = dst
    nbytes = frame_bytes(dst, channels, out_itemsize)
    ops = OPS_PER_VALUE * nh * nw * channels
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {
        "bound_s": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "ops": ops,
    }


# The device operations of the diffusion: K4's kernel, ``wavefront`` in
# the port's ``csrc/wavefront.cu``.
KERNEL = "wavefront"


def seconds_a_frame(sl) -> float | None:
    """The traced slice's device seconds in operations whose name holds
    KERNEL, over its frames; None where it has none."""
    if sl is None:
        return None
    times = [d for name, _, d in sl.device_ops if KERNEL in name]
    if not times or not sl.frames:
        return None
    return sum(times) * 1e-6 / sl.frames
