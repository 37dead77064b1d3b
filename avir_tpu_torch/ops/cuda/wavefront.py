"""K4, the error-diffusion wavefront scan: its wrapper and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/pallas/wavefront_kernel.py``
(``wavefront_scan_pallas`` and ``wavefront_scan_pallas_carry``) and of
the scan it accelerates, ``ops/dither.py:_wavefront_rows``.  Pixel (y, x)
of channel ch, at diagonal step t = 2y + x, takes

    cur = ((((s + W_CUR_RIGHT*n(y, x-1)) + W_NEXT_LEFT*n(y-1, x+1))
            + W_NEXT_CENTER*n(y-1, x)) + W_NEXT_RIGHT*n(y-1, x-1))
    z0 = round_biased(cur * tmi) * tm ;  out = clamp(z0, 0, out_max)
    n(y, x) = cur - z0   (0 outside 0 <= x < w: noise leaving a row end
                          is discarded, avir.h:4504-4524)

every product and sum rounded on its own in float32, with
``tmi = float32(1) / float32(tm)``.  With ``scan_order=True`` the sums
take the order of the JAX package's sequential nested scan
(``ops/dither.py:errdiff_dither_jnp``, ``dither="errdiff-device"``):

    cur = (s + ((W_NEXT_CENTER*n(y-1, x) + W_NEXT_LEFT*n(y-1, x+1))
                + W_NEXT_RIGHT*n(y-1, x-1))) + W_CUR_RIGHT*n(y, x-1)

which gives that scan's bits; the two orders differ by one quantization
step even at ``trunc_bits=0`` (isolated pixels of a small 16-bit image;
a flip carries through the diffused noise, to 10% of a 1080p u8 image),
as the JAX package's own two engines do.  Rows go in blocks; row 0 of a
block reads the previous block's last-row noise, so blocked and
single-block runs give the same bits.

``errdiff_wavefront`` launches the kernel (``csrc/wavefront.cu``) once per
image on a CUDA tensor: ``block_rows`` rows form a group, one thread block
each (one thread per (row, channel), in whole warps), and all groups run
at once, each reading the last-row noise of the group above from device
memory as it is written.  Inside a group no step waits on a block
barrier: a row takes the row above from the lane C before it by a warp
shuffle, or, where that lane lies in the warp before, from a ring of
tagged words in shared memory that it reads once a chunk of steps.  The
kernel has two instantiations by the block's threads (``launch_bound``:
up to 256, the default groups', or up to 1024), counted in ``forms``.
Before each launch the host allocates three tensors with ``torch.empty``:
``out``, the groups' last-row ``noise`` words (int64 [groups, W*C]) and
the one-word ``ticket``; the kernel's entry point zeroes the last two on
the stream.  On a CPU tensor it runs ``errdiff_wavefront_reference``,
whose ``block_rows`` is the rows of a block run one after another.  Both
do the same float32 operations in the same order, so they agree bit for
bit at any grouping.  While the tracer (utils/trace.py) is on, a call is
a ``k4.call`` span, which holds those allocations, and the ``ctypes``
call a ``k4.launch`` span inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import trace
from ..dither import (
    W_CUR_RIGHT,
    W_NEXT_CENTER,
    W_NEXT_LEFT,
    W_NEXT_RIGHT,
    round_biased,
    trunc_mul,
)
from .launch import F, I, P, Entry

_MAX_THREADS = 1024  # csrc: kMaxThreads, one thread per (row, channel)
_SMALL_THREADS = 256  # csrc: kSmallThreads, the default groups' instantiation
# Warps of one row group of the kernel when ``block_rows`` is None (see
# group_rows_for): the fastest of chip_smoke.py's sweep at the errdiff
# cells (PERF.md §6).
_GROUP_WARPS = 4
_OUT_KINDS = {torch.float32: 0, torch.uint8: 1, torch.uint16: 2}

# Launches of the kernel of this module (one per image), counted by the
# wrapper, and the same launches by instantiation (its launch bound in
# threads, ``launch_bound``).
launches = {"wavefront": 0}
forms = {_SMALL_THREADS: 0, _MAX_THREADS: 0}


def quant_steps(trunc_bits: int, out_max: float) -> tuple[float, float]:
    """(tm, tmi) as float32 values: the step and its float32 reciprocal
    (a float64 reciprocal flips pixels at half-step boundaries)."""
    tm = np.float32(trunc_mul(trunc_bits, float(out_max)))
    return float(tm), float(np.float32(1.0) / tm)


def launch_bound(threads: int) -> int:
    """The kernel instantiation that holds a block of ``threads`` (row,
    channel) threads: its launch bound, 256 or 1024."""
    if not 1 <= threads <= _MAX_THREADS:
        raise ValueError(f"{threads} threads: a group takes 1 to {_MAX_THREADS}")
    return _SMALL_THREADS if threads <= _SMALL_THREADS else _MAX_THREADS


def block_rows_for(h: int, c: int, block_rows: int | None) -> int:
    """Rows per block of the plain version: at most one thread per (row,
    channel) of a thread block."""
    rb = _MAX_THREADS // c if block_rows is None else block_rows
    return max(1, min(rb, h))


def group_rows_for(h: int, c: int, block_rows: int | None) -> int:
    """Rows per group of the kernel: ``block_rows``, or by default as many
    as fill ``_GROUP_WARPS`` warps with one thread per (row, channel)."""
    rb = max(1, _GROUP_WARPS * 32 // c) if block_rows is None else block_rows
    return max(1, min(rb, h))


def chain_steps(h: int, w: int, c: int, block_rows: int | None = None) -> int:
    """Diagonal steps in sequence when row blocks run one after another
    (the plain version's schedule): sum over row blocks of
    W + 2(R_b - 1)."""
    rb = block_rows_for(h, c, block_rows)
    return sum(w + 2 * (min(rb, h - y0) - 1) for y0 in range(0, h, rb))


def critical_steps(h: int, w: int) -> int:
    """Diagonal steps the recurrence itself needs in sequence, whatever
    the grouping: W + 2(H - 1).  The kernel's chain adds each group's lag
    behind the group above."""
    return w + 2 * (h - 1) if h and w else 0


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _wavefront_rows(
    block: torch.Tensor,
    n_last: torch.Tensor,
    tm: torch.Tensor,
    tmi: torch.Tensor,
    out_max: float,
    scan_order: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize one row block [R, W, C] (float32) given the previous
    block's last-row noise ``n_last`` [W, C] (zeros at the top).  Returns
    (quantized block [R, W, C] float32, its last-row noise [W, C])."""
    r, w, c = block.shape
    dev = block.device
    T = 2 * (r - 1) + w
    ys = torch.arange(r, device=dev)
    x_of = torch.arange(T, device=dev)[:, None] - 2 * ys[None, :]  # [T, R]
    valid = (x_of >= 0) & (x_of < w)
    # Skewed diagonals: S[t, y] = block[y, t - 2y] (0 off the image).
    S = torch.where(
        valid[:, :, None], block[ys[None, :], x_of.clamp(0, w - 1)], 0.0
    )  # [T, R, C]
    # Row 0's neighbours in the previous block: nl[x + 1] = n_last[x].
    nl = torch.zeros((T + 4, c), dtype=torch.float32, device=dev)
    nl[1 : w + 1] = n_last
    wr, wl, wc, wn = (
        torch.tensor(v, dtype=torch.float32, device=dev)
        for v in (W_CUR_RIGHT, W_NEXT_LEFT, W_NEXT_CENTER, W_NEXT_RIGHT)
    )
    zero = torch.zeros((r, c), dtype=torch.float32, device=dev)
    p1 = p2 = p3 = zero  # noise at steps t-1, t-2, t-3
    out = torch.empty((T, r, c), dtype=torch.float32, device=dev)
    last = torch.empty((T, c), dtype=torch.float32, device=dev)
    for t in range(T):
        d1 = torch.cat([nl[t + 2][None], p1[:-1]])  # (y-1, x+1)
        d2 = torch.cat([nl[t + 1][None], p2[:-1]])  # (y-1, x)
        d3 = torch.cat([nl[t][None], p3[:-1]])      # (y-1, x-1)
        if scan_order:
            up3 = wc * d2 + wl * d1
            up3 = up3 + wn * d3
            cur = (S[t] + up3) + wr * p1
        else:
            cur = S[t] + wr * p1                    # (y, x-1)
            cur = cur + wl * d1
            cur = cur + wc * d2
            cur = cur + wn * d3
        z0 = round_biased(cur * tmi) * tm
        noise = torch.where(valid[t][:, None], cur - z0, 0.0)
        out[t] = torch.clamp(z0, 0.0, out_max)
        last[t] = noise[-1]
        p1, p2, p3 = noise, p1, p2
    q = out[2 * ys[:, None] + torch.arange(w, device=dev)[None, :], ys[:, None]]
    return q, last[2 * (r - 1) : 2 * (r - 1) + w]


def errdiff_wavefront_reference(
    img: torch.Tensor,
    trunc_bits: int,
    out_max: float,
    block_rows: int | None = None,
    scan_order: bool = False,
) -> torch.Tensor:
    """Plain PyTorch wavefront error diffusion of the float32 image
    ``img`` [H, W, C] -> float32 [H, W, C], on the device of ``img``."""
    h, w, c = img.shape
    dev = img.device
    tm_f, tmi_f = quant_steps(trunc_bits, out_max)
    tm = torch.tensor(tm_f, dtype=torch.float32, device=dev)
    tmi = torch.tensor(tmi_f, dtype=torch.float32, device=dev)
    rb = block_rows_for(h, c, block_rows)
    n_last = torch.zeros((w, c), dtype=torch.float32, device=dev)
    outs = []
    for y0 in range(0, h, rb):
        q, n_last = _wavefront_rows(
            img[y0 : y0 + rb].float(), n_last, tm, tmi, float(out_max),
            scan_order,
        )
        outs.append(q)
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# avir_wavefront (csrc/wavefront.cu).
LAUNCH = Entry("wavefront", "avir_wavefront", span="k4.launch", params=(
    ("img", P), ("out", P), ("out_kind", I), ("h", I), ("w", I), ("c", I), ("rows", I),
    ("noise", P), ("ticket", P), ("tm", F), ("tmi", F), ("out_max", F),
    ("wr", F), ("wl", F), ("wc", F), ("wn", F), ("scan", I), ("bound", I), ("stream", P),
))


def errdiff_wavefront(
    img: torch.Tensor,
    trunc_bits: int,
    out_max: float,
    out_dtype: torch.dtype = torch.float32,
    block_rows: int | None = None,
    scan_order: bool = False,
) -> torch.Tensor:
    """Wavefront error diffusion of the float32 image ``img`` [H, W, C]
    -> [H, W, C] of ``out_dtype`` (float32, uint8 or uint16), in the
    sequential scan's sum order with ``scan_order`` (module docstring).
    A CUDA tensor launches the kernel once, with ``block_rows`` rows per
    group (``group_rows_for``); a CPU tensor runs the plain version with
    ``block_rows`` rows per block."""
    if trace.on:
        return trace.call(
            "k4.call", _errdiff_wavefront, img, trunc_bits, out_max, out_dtype,
            block_rows, scan_order,
        )
    return _errdiff_wavefront(img, trunc_bits, out_max, out_dtype, block_rows, scan_order)


def _errdiff_wavefront(img, trunc_bits, out_max, out_dtype, block_rows, scan_order):
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    if img.device.type == "cpu":
        out = errdiff_wavefront_reference(
            img, trunc_bits, out_max, block_rows, scan_order
        )
        return out if out_dtype == torch.float32 else out.to(out_dtype)
    if img.device.type != "cuda":
        raise ValueError(f"image on {img.device}: must be a CUDA or CPU tensor")
    if img.dtype != torch.float32 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError(
            f"expected a contiguous float32 [H, W, C] image, got {img.dtype} "
            f"{tuple(img.shape)}"
        )
    h, w, c = img.shape
    rb = group_rows_for(h, c, block_rows)
    if rb * c > _MAX_THREADS:
        raise ValueError(f"{rb} rows x {c} channels exceed {_MAX_THREADS} threads")
    out = torch.empty((h, w, c), dtype=out_dtype, device=img.device)
    if h == 0 or w == 0:
        return out
    groups = -(-h // rb)
    # Each group's last-row noise words, and the ticket (both zeroed by the
    # kernel's entry point, on the stream).
    noise = torch.empty((groups, w * c), dtype=torch.int64, device=img.device)
    ticket = torch.empty(1, dtype=torch.int32, device=img.device)
    tm, tmi = quant_steps(trunc_bits, out_max)
    weights = [
        float(np.float32(v))
        for v in (W_CUR_RIGHT, W_NEXT_LEFT, W_NEXT_CENTER, W_NEXT_RIGHT)
    ]
    bound = launch_bound(rb * c)
    LAUNCH.launch(
        img, launches, "wavefront", img.data_ptr(), out.data_ptr(), _OUT_KINDS[out_dtype],
        h, w, c, rb, noise.data_ptr(), ticket.data_ptr(), tm, tmi, float(out_max), *weights,
        int(scan_order), bound,
    )
    forms[bound] += 1
    return out
