"""AVIR's error diffusion in float64, and the reading that holds an
output to its rule.

AVIR's ditherer ``CImageResizerDithererErrdINL`` (avir.h:4440-4525) runs
rows top to bottom and values left to right, each channel alone:

    cur = s + wr*n(y, x-1) + wl*n(y-1, x+1) + wc*n(y-1, x) + wn*n(y-1, x-1)
    z0 = floor(cur / step + 1/2) * step ;  out = clamp(z0, 0, clamp)
    n(y, x) = cur - z0   (0 outside 0 <= x < W: noise leaving a row end is
                          dropped)

with ``weights`` = (wr, wl, wc, wn): the current row's right value, and
the next row's left, centre and right values.  Every value on the
anti-diagonal t = 2y + x depends only on diagonals t-1, t-2 and t-3, so
both functions walk the diagonals in order, each one a strided view of
the frame, batched over the last axis (frames and channels).  The sums
are taken in the order written above, in float64; the walk's order
changes no value.

Frames are [H, W, B]: B is frames times channels, contiguous, W >= 2.
"""

from __future__ import annotations

import torch

# avir.h:4490-4524: same row right; next row left, centre, right.
AVIR_WEIGHTS = (0.364842, 0.207305, 0.364842, 0.063011)


def lanes(frames: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [H, W, B], contiguous, B the frames times C."""
    h, w, c = frames.shape[-3:]
    return frames.reshape(-1, h, w, c).permute(1, 2, 0, 3).reshape(h, w, -1).contiguous()


def _diagonal(buf: torch.Tensor, t: int, y0: int, y1: int) -> torch.Tensor:
    """The view [y1 - y0 + 1, B] of ``buf`` at (y, t - 2y), y0 <= y <= y1."""
    h, w, b = buf.shape
    return buf.as_strided(
        (y1 - y0 + 1, b), ((w - 2) * b, 1), buf.storage_offset() + (y0 * (w - 2) + t) * b
    )


def _walk(x: torch.Tensor, weights, settle) -> None:
    """Walk the anti-diagonals of ``x`` [H, W, B] float64.  On each,
    ``settle(t, y0, y1, cur)`` takes the values ``cur`` of rows y0..y1
    before quantisation and returns the noise they carry on."""
    h, w, b = x.shape
    if w < 2 or not x.is_contiguous():
        raise ValueError("frames are [H, W >= 2, B], contiguous")
    wr, wl, wc, wn = weights
    # Noise of the last three diagonals by row; index y + 1 holds row y,
    # index 0 the row above the frame (always 0).
    zero = x.new_zeros((h + 1, b))
    p1 = p2 = p3 = zero
    for t in range(w + 2 * (h - 1)):
        y0, y1 = max(0, (t - w + 2) // 2), min(h - 1, t // 2)
        cur = _diagonal(x, t, y0, y1).add(p1[y0 + 1 : y1 + 2], alpha=wr)
        cur.add_(p1[y0 : y1 + 1], alpha=wl)
        cur.add_(p2[y0 : y1 + 1], alpha=wc)
        cur.add_(p3[y0 : y1 + 1], alpha=wn)
        noise = zero.clone()
        noise[y0 + 1 : y1 + 2] = settle(t, y0, y1, cur)
        p1, p2, p3 = noise, p1, p2


def _rounded(cur: torch.Tensor, step: float) -> torch.Tensor:
    """floor(cur / step + 1/2) * step."""
    return torch.floor(cur / step + 0.5) * step


def diffuse(x: torch.Tensor, weights, step: float, clamp: float) -> torch.Tensor:
    """The error-diffused frame of ``x`` [H, W, B] float64, clamped to
    [0, clamp], float64."""
    out = torch.empty_like(x)

    def settle(t, y0, y1, cur):
        z0 = _rounded(cur, step)
        _diagonal(out, t, y0, y1).copy_(z0.clamp(0.0, clamp))
        return cur - z0

    _walk(x, weights, settle)
    return out


def misses(out: torch.Tensor, exact: torch.Tensor, weights, step: float,
           clamp: float, tolerance: float) -> int:
    """Values of ``out`` [H, W, B] (any real type) that break the rule by
    more than ``tolerance`` steps, given the float64 frame before
    quantisation ``exact`` [H, W, B].

    The noise is rebuilt from ``exact`` and ``out`` alone: at each value
    ``cur`` comes from the rebuilt noise and z0 is the output value; at a
    clamped output (0 or ``clamp``) z0 is ``cur`` rounded, held at or
    beyond the clamp.  A value whose |cur - z0| exceeds half a step by
    more than ``tolerance`` steps is a miss.  The rebuilt noise is then
    clipped to half a step either way, so that the output's own small
    error (float32 sums, a float32 resize) does not build up down the
    frame: with weights that sum to 1 it is carried on undamped."""
    if out.shape != exact.shape:
        raise ValueError(f"shapes differ: {tuple(out.shape)} and {tuple(exact.shape)}")
    half, limit = step / 2, step * (0.5 + tolerance)
    count = exact.new_zeros((), dtype=torch.int64)

    def settle(t, y0, y1, cur):
        nonlocal count
        o = _diagonal(out, t, y0, y1).to(torch.float64)
        r = _rounded(cur, step)
        z0 = torch.where(o <= 0.0, r.clamp(max=0.0), torch.where(o >= clamp, r.clamp(min=clamp), o))
        noise = cur - z0
        count += (noise.abs() > limit).sum()
        return noise.clamp_(-half, half)

    _walk(exact, weights, settle)
    return int(count.item())
