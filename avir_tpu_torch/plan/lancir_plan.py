"""LANCIR plan: the fast Lanczos path as banded operators.

A copy of the JAX package's ``plan/lancir_plan.py``: the equivalent of
CLancIR::resizeImage's planning (lancir.h:386-543): per-axis Lanczos
fractional-delay filters with 1000 quantized fractional positions, edge
replication, centering offsets, and the round-half-even integer output
stage.  The reference's vertical-then-horizontal batched pipeline
collapses into the same two banded products as the AVIR path (linear
operators commute across axes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..filters.lanczos import LanczosBank
from .compose import BandedOp, csr_to_banded


@dataclasses.dataclass
class LancirPlan:
    h: BandedOp
    v: BandedOp
    src_w: int
    src_h: int
    new_w: int
    new_h: int
    el_count: int
    is_out_float: bool
    out_mul: float
    clamp: float
    in_exact_bf16: bool  # input values exactly representable in bf16
    in_itemsize: int = 1  # input element bytes (tile shaping)


def _axis_op(src_len: int, new_len: int, k: float, o: float, la: float) -> BandedOp:
    bank = LanczosBank(la, k)
    fl2 = bank.fl2
    kl = bank.kernel_len

    i = np.arange(new_len, dtype=np.float64)
    pos = o + k * i
    ix = np.floor(pos).astype(np.int64)

    taps = np.empty((new_len, kl), dtype=np.float64)
    for n in range(new_len):
        taps[n] = bank.filter_for_frac(float(pos[n] - ix[n]))

    base = ix + 1 - fl2
    idx = base[:, None] + np.arange(kl)[None, :]
    cols = np.clip(idx, 0, src_len - 1)
    rows = np.broadcast_to(np.arange(new_len)[:, None], cols.shape)
    M = sp.coo_matrix(
        (np.ravel(taps), (np.ravel(rows), np.ravel(cols))),
        shape=(new_len, src_len),
    ).tocsr()
    return csr_to_banded(M, src_len)


def build_lancir_plan(
    src_w: int,
    src_h: int,
    new_w: int,
    new_h: int,
    el_count: int,
    in_dtype: np.dtype,
    out_dtype: np.dtype,
    kx: float = 0.0,
    ky: float = 0.0,
    ox: float = 0.0,
    oy: float = 0.0,
    la: float = 3.0,
) -> LancirPlan:
    in_dtype = np.dtype(in_dtype)
    out_dtype = np.dtype(out_dtype)
    if la < 2.0:
        raise ValueError("Lanczos 'a' parameter must be >= 2.0")

    # Step/offset resolution (lancir.h:430-457).
    if kx >= 0.0:
        kx = src_w / new_w if kx == 0.0 else kx
        ox += (kx - 1.0) * 0.5
    else:
        kx = -kx
    if ky >= 0.0:
        ky = src_h / new_h if ky == 0.0 else ky
        oy += (ky - 1.0) * 0.5
    else:
        ky = -ky

    is_in_float = in_dtype.kind == "f"
    is_out_float = out_dtype.kind == "f"
    clamp = 255.0 if out_dtype.itemsize == 1 else 65535.0
    out_mul = (1.0 if is_out_float else clamp) / (
        1.0
        if is_in_float
        else (255.0 if in_dtype.itemsize == 1 else 65535.0)
    )

    return LancirPlan(
        in_exact_bf16=(not is_in_float) and in_dtype.itemsize == 1,
        in_itemsize=4 if is_in_float else in_dtype.itemsize,
        h=_axis_op(src_w, new_w, kx, ox, la),
        v=_axis_op(src_h, new_h, ky, oy, la),
        src_w=src_w,
        src_h=src_h,
        new_w=new_w,
        new_h=new_h,
        el_count=el_count,
        is_out_float=is_out_float,
        out_mul=out_mul,
        clamp=clamp,
    )
