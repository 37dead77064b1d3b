"""Composite-operator construction.

Every AVIR filtering step is a linear operator on a scanline (edge
replication included), so the whole per-axis step chain collapses into a
single banded operator: out[i] = sum_j taps[i, j] * src[starts[i] + j].
This module builds that operator on the host with scipy.sparse in float64
(over float32-quantized step taps, mirroring the reference's fptype
arithmetic at the tap level), turning the reference's per-step scanline
walks (avir.h:6522-6619) into one banded matrix product per axis.

Step semantics reproduced here:
  - doFilter: symmetric FIR with optional decimation and edge-pixel
    extension (avir.h:3748-3866), with prepareInBuf's clamped-edge reads
    (avir.h:3227-3239).
  - doUpsample: zero-stuffed transposed convolution over a virtually
    clamp-extended input; the PrefixDC/SuffixDC "tails" of the reference
    (avir.h:3632-3733) are exactly the truncation of that infinite
    extension, so composing the extension reproduces them. The filterless
    variant (avir.h:3260-3402) is plain zero-stuffing of the clamped
    input.
  - doResize / doResize2: fractional-delay filter-bank interpolation
    (avir.h:3884-4331); the order-1 tap interpolation ftp + ftp2*x is
    evaluated per output pixel at plan time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .steps import FilterStep


@dataclasses.dataclass
class BandedOp:
    """out[i] = sum_j taps[i, j] * src[clip(starts[i] + j, 0, n_in - 1)].

    starts is non-decreasing; taps rows are zero-padded to the common
    width.  All indices are guaranteed in-range after construction (edge
    clamping is folded into the taps), so starts[i] + width <= n_in.
    """

    n_in: int
    n_out: int
    starts: np.ndarray  # int32 [n_out]
    taps: np.ndarray  # float64 [n_out, width]

    @property
    def width(self) -> int:
        return self.taps.shape[1]


def _clamp_cols(idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return np.clip(idx, lo, hi)


def step_matrix(fs: FilterStep, prev_lo: int, prev_hi: int) -> tuple:
    """Sparse operator of one step over the previous stage's materialized
    rows [prev_lo, prev_hi), plus the new stage's materialized range.

    Returns (S, new_lo, new_hi) where S maps prev storage rows to new
    storage rows (storage row = stage index - lo).
    """
    nprev = prev_hi - prev_lo

    if fs.is_upsample:
        r = fs.resample_factor
        new_lo = -fs.out_prefix
        new_hi = fs.out_len + fs.out_suffix
        nnew = new_hi - new_lo

        if fs.flt_orig is not None:
            # Filterless zero-stuff: out[m] = u_cl(m / r) at multiples of r.
            m = np.arange(new_lo, new_hi)
            m = m[m % r == 0]
            q = m // r
            cols = _clamp_cols(q, 0, fs.in_len - 1) - prev_lo
            rows = m - new_lo
            data = np.ones(len(m), dtype=np.float64)
        else:
            flt = fs.flt.astype(np.float64)
            flen = len(flt)
            # Contributions: out[q*r - latency + j] += u_cl(q) * flt[j].
            q_min = (new_lo + fs.flt_latency - flen + 1) // r - 1
            q_max = (new_hi - 1 + fs.flt_latency) // r + 1
            q = np.arange(q_min, q_max + 1)
            j = np.arange(flen)
            rows = (q[:, None] * r - fs.flt_latency + j[None, :]) - new_lo
            cols = np.broadcast_to(
                (_clamp_cols(q, 0, fs.in_len - 1) - prev_lo)[:, None],
                rows.shape,
            )
            data = np.broadcast_to(flt[None, :], rows.shape)
            keep = (rows >= 0) & (rows < nnew)
            rows, cols, data = rows[keep], cols[keep], data[keep]

        S = sp.coo_matrix(
            (np.ravel(data), (np.ravel(rows), np.ravel(cols))),
            shape=(nnew, nprev),
        ).tocsr()
        return S, new_lo, new_hi

    if fs.resample_factor == 0:
        # Fractional-delay resize.
        bank = fs.bank
        fl = bank.filter_len
        fld21 = fl // 2 - 1
        n_out = fs.out_len
        # Effective float32 tap row per output pixel (order-0/1).
        taps = bank.filters[fs.fti].astype(np.float64)
        if bank.order > 0:
            taps = taps + (
                bank.deltas[fs.fti].astype(np.float64)
                * fs.frac_x.astype(np.float64)[:, None]
            )
        base = fs.src_pos_int - fld21
        idx = base[:, None] + np.arange(fl)[None, :]
        cols = _clamp_cols(idx, prev_lo, prev_hi - 1) - prev_lo
        rows = np.broadcast_to(np.arange(n_out)[:, None], cols.shape)
        S = sp.coo_matrix(
            (np.ravel(taps), (np.ravel(rows), np.ravel(cols))),
            shape=(n_out, nprev),
        ).tocsr()
        return S, 0, n_out

    # Plain filtering step (optional decimation by resample_factor).
    r = fs.resample_factor
    e = fs.edge_pixel_count
    flt = fs.flt.astype(np.float64)
    flen = len(flt)
    n_out = fs.out_len
    i = np.arange(n_out)
    idx = (i[:, None] - e) * r + np.arange(flen)[None, :] - fs.flt_latency
    cols = _clamp_cols(idx, 0, fs.in_len - 1) - prev_lo
    rows = np.broadcast_to(i[:, None], cols.shape)
    data = np.broadcast_to(flt[None, :], cols.shape)
    S = sp.coo_matrix(
        (np.ravel(data), (np.ravel(rows), np.ravel(cols))),
        shape=(n_out, nprev),
    ).tocsr()
    return S, 0, n_out


def compose_steps(steps: list[FilterStep], src_len: int) -> BandedOp:
    """Compose the step chain into a single banded operator over the
    source scanline."""
    M = sp.identity(src_len, format="csr", dtype=np.float64)
    lo, hi = 0, src_len

    for fs in steps:
        S, lo, hi = step_matrix(fs, lo, hi)
        M = S @ M

    # The final stage's materialized rows [lo, hi) contain [0, out_len).
    n_out = steps[-1].out_len
    M = M[-lo : -lo + n_out] if lo != 0 else M[:n_out]
    return csr_to_banded(M.tocsr(), src_len)


def csr_to_banded(M: sp.csr_matrix, n_in: int) -> BandedOp:
    """Convert a banded CSR matrix to (starts, taps) form."""
    n_out = M.shape[0]
    indptr, indices, data = M.indptr, M.indices, M.data

    counts = np.diff(indptr)
    if np.any(counts == 0):
        raise ValueError("empty operator row")
    row_min = np.minimum.reduceat(indices, indptr[:-1])
    row_max = np.maximum.reduceat(indices, indptr[:-1])
    width = int((row_max - row_min).max()) + 1

    taps = np.zeros((n_out, width), dtype=np.float64)
    rows = np.repeat(np.arange(n_out), counts)
    offs = indices - row_min[rows]
    # Duplicate (row, col) entries were already summed by CSR.
    taps[rows, offs] = data

    starts = row_min.astype(np.int64)
    # Keep starts + width within [0, n_in]: shift rows near the right edge
    # left (taps are zero there anyway only if the band is narrower; when
    # not, fold the clamp into the taps).
    over = starts + width - n_in
    if np.any(over > 0):
        shift = np.maximum(over, 0)
        if np.any(shift > starts):
            raise ValueError("band wider than source")
        new_taps = np.zeros_like(taps)
        for s in np.unique(shift):
            sel = shift == s
            if s == 0:
                new_taps[sel] = taps[sel]
            else:
                new_taps[sel, s:] = taps[sel, : width - s]
        taps = new_taps
        starts = starts - shift

    return BandedOp(
        n_in=n_in,
        n_out=n_out,
        starts=starts.astype(np.int32),
        taps=taps,
    )


def apply_banded_numpy(op: BandedOp, x: np.ndarray) -> np.ndarray:
    """Reference applier (host, float64): x is [n_in, ...]; returns
    [n_out, ...].  Used by tests and as the semantics spec for the device
    kernels."""
    flat = x.reshape(x.shape[0], -1).astype(np.float64)
    idx = op.starts[:, None] + np.arange(op.width)[None, :]
    gathered = flat[idx]  # [n_out, width, rest]
    out = np.einsum("ow,owr->or", op.taps, gathered)
    return out.reshape((op.n_out,) + x.shape[1:])
