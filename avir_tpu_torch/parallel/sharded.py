"""Multi-card sharded execution: row strips over a mesh of processes.

Counterpart of the 1-D (row-strip) half of the JAX package's
``parallel/sharded.py``, on ``torch.distributed``.  The image rows are
split over the sp ranks of a ``multihost.DpSpMesh``:

  - the horizontal pass needs whole scanlines, which every rank has;
  - the vertical pass contracts over the split row axis, so each rank
    computes its output rows from its input strip plus HALO rows that
    its neighbours send (``comm.exchange_halos``, the ``ppermute``
    there).  The halo is the banded operator's overhang past the strip
    (the reference's per-step InPrefix/InSuffix, avir.h:5899-5900);
  - when the vertical band is wider than a strip (an extreme downsize on
    many ranks) the strips are all-gathered instead
    (``svop.use_all_gather``);
  - the dp axis of the mesh carries independent frames.

Each rank runs one of two routes, as the JAX package does:

  - the kernel route, the counterpart of ``_pallas_strip_fn``: the rank's
    raw strip and halos make one ext buffer, and the same hand-written
    K1 as the single-card path (``ops/cuda/fused_kernel.py`` int8,
    ``ops/cuda/fused_split.py`` split-bf16, always ``order="vh"``) runs on
    it with the rank's own V operator (``shard_v_blocked``); the int8
    limbs share one global shift over all ranks' taps, so every rank's
    kernel has the same fixed-point scales;
  - the library route, the counterpart of ``shard_fn``: the horizontal
    pass, then the halo exchange on the float32 intermediate, then the
    vertical pass, both as batched products (``ops/banded.py:
    apply_blocked``, ``torch.bmm``).  It serves ``precision="exact"`` and
    the all-gather fallback, large plain products that the JAX package
    also leaves outside its kernels, and LANCIR's float output.

The JAX package's interior/boundary LANE split of the fused kernel
(``_split_lane_ops``) is the TPU's lane layout and is not carried, as on
one card.

Row padding: an image whose height does not divide by sp is zero-padded
(``pad_rows``).  The composed vertical taps only reference rows < src_h
(edge clamping is folded into the taps), so the pad rows are never read.
"""

from __future__ import annotations

import dataclasses
import logging
import types
from typing import Callable

import numpy as np
import torch

from ..models.avir import DITHERS, ERRDIFF, check_engine, errdiff_impl
from ..models.runtime import in_exact_bf16, out_dtype_of, resolve_modes
from ..ops.banded import (
    BlockedBandedOp,
    _round_up,
    apply_blocked,
    bf16_split,
    block_banded,
    pick_tile,
)
from ..ops.cuda.fused_kernel import (
    FusedInt8Operands,
    apply_fused_int8,
    int8_feasible,
    prepare_fused_int8,
)
from ..ops.cuda.fused_split import apply_fused_split, prepare_fused_split, to_float32
from ..ops.cuda.wavefront import errdiff_wavefront
from ..ops.dither import default_dither
from ..ops.gamma import f32, linear_to_srgb_2d, srgb_to_linear_2d
from ..ops.intq import first_pass_overflow_safe, quantize_limbs
from ..ops.lanes import lane_block_banded
from ..plan.compose import BandedOp
from .comm import all_gather_rows, exchange_halos, zeros_rows

logger = logging.getLogger("avir_tpu_torch.parallel")


# ---------------------------------------------------------------------------
# Host half: the per-rank operators (NumPy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedVOp:
    """Per-rank blocked form of the vertical banded operator.

    Rank d owns output rows [d*m, (d+1)*m) (m = padded n_out / n_dev) and
    reads input rows [d*strip - halo_lo, (d+1)*strip + halo_hi) in global
    coordinates (or all rows in the all-gather fallback)."""

    n_in: int            # global input rows (unpadded image height)
    n_out: int           # global output rows (unpadded)
    strip: int           # input rows per rank (of the padded height)
    m: int               # output rows per rank
    halo_lo: int
    halo_hi: int
    win: int
    tile: int
    offs: np.ndarray     # int32 [n_dev, blocks]: local window starts
    taps: np.ndarray     # f32 [n_dev, blocks, tile, win]
    use_all_gather: bool
    # The INTERIOR block range [b_int0, b_int1): blocks whose windows lie
    # inside the local strip on every rank (no halo rows), so that they
    # can run before the halos arrive.  The border blocks are the prefix
    # [0, b_int0) and the suffix [b_int1, blocks).
    b_int0: int = 0
    b_int1: int = 0


def _interior_split(
    offs: np.ndarray,
    valid: np.ndarray,
    halo_lo: int,
    strip: int,
    win: int,
) -> tuple[int, int]:
    """Classify blocks as interior (window inside the local strip on
    every rank that uses them) or border, and repair the unused entries.

    Mutates ``offs``: entries where ``valid`` is False (blocks with no real
    output rows on that rank; their taps are all zero) borrow a valid
    rank's offset, so that interior-rebased windows stay in range.
    Returns the contiguous interior range [b0, b1), or (0, 0) when the
    interior is empty or not contiguous (then every block is border, which
    is correct but overlaps nothing; logged at DEBUG)."""
    n_dev, blocks = offs.shape
    inter = np.zeros(blocks, dtype=bool)
    for b in range(blocks):
        vd = np.nonzero(valid[:, b])[0]
        assert vd.size > 0  # rank 0 always owns all its blocks
        o = offs[vd, b]
        inter[b] = bool(
            (o >= halo_lo).all() and (o + win <= halo_lo + strip).all()
        )
        for d in range(n_dev):
            if not valid[d, b]:
                offs[d, b] = o[0]
    if not inter.any():
        logger.debug(
            "interior/halo overlap disabled: no interior blocks "
            "(strip=%d, win=%d, halo_lo=%d, blocks=%d)",
            strip, win, halo_lo, blocks,
        )
        return 0, 0
    b0 = int(np.argmax(inter))
    b1 = blocks - int(np.argmax(inter[::-1]))
    if not inter[b0:b1].all():
        logger.debug(
            "interior/halo overlap disabled: interior blocks "
            "non-contiguous (strip=%d, win=%d, halo_lo=%d, mask=%s)",
            strip, win, halo_lo, inter.tolist(),
        )
        return 0, 0
    return b0, b1


def shard_v_op(
    op: BandedOp, n_dev: int, padded_h: int, tile: int = 64
) -> ShardedVOp:
    """Split a vertical BandedOp into per-rank blocked operators of one
    shape, and compute the halo requirement."""
    if padded_h % n_dev or padded_h < op.n_in:
        raise ValueError(f"padded height {padded_h} must divide by {n_dev} and cover {op.n_in}")
    n_out, width = op.n_out, op.width
    m = -(-n_out // n_dev)
    strip = padded_h // n_dev
    blocks = -(-m // tile)
    starts = op.starts.astype(np.int64)

    # Global input range needed by each rank's output rows.
    need_lo = np.empty(n_dev, dtype=np.int64)
    need_hi = np.empty(n_dev, dtype=np.int64)
    for d in range(n_dev):
        lo, hi = d * m, min((d + 1) * m, n_out)
        if lo >= n_out:  # the rank owns only padding rows
            need_lo[d] = min(d * strip, op.n_in)
            need_hi[d] = need_lo[d]
        else:
            need_lo[d] = starts[lo]
            need_hi[d] = starts[hi - 1] + width

    halo_lo = int(max(0, np.max(np.arange(n_dev) * strip - need_lo)))
    halo_hi = int(
        max(0, np.max(need_hi - (np.arange(n_dev) + 1) * strip))
    )
    use_all_gather = halo_lo > strip or halo_hi > strip
    if use_all_gather:
        halo_lo = 0
        halo_hi = 0

    # Window size: the largest span of any tile-block of output rows.
    win = 0
    for b0 in range(0, n_out, tile):
        b1 = min(b0 + tile, n_out)
        win = max(win, int(starts[b1 - 1]) + width - int(starts[b0]))
    win = _round_up(win, 128)

    offs = np.zeros((n_dev, blocks), dtype=np.int64)
    taps = np.zeros((n_dev, blocks, tile, win), dtype=np.float32)
    valid = np.zeros((n_dev, blocks), dtype=bool)
    for d in range(n_dev):
        base = 0 if use_all_gather else d * strip - halo_lo
        for b in range(blocks):
            lo = d * m + b * tile
            # Clamp to this rank's own rows: block rows past m are
            # discarded by the executor's [:m].
            hi = min(lo + tile, (d + 1) * m, n_out)
            if lo >= min((d + 1) * m, n_out):
                continue
            off = int(starts[lo]) - base
            assert off >= 0
            offs[d, b] = off
            valid[d, b] = True
            for i in range(lo, hi):
                c0 = int(starts[i]) - base - off
                taps[d, b, i - lo, c0 : c0 + width] = op.taps[i]

    b0 = b1 = 0
    if not use_all_gather:
        b0, b1 = _interior_split(offs, valid, halo_lo, strip, win)
    return ShardedVOp(
        n_in=op.n_in,
        n_out=n_out,
        strip=strip,
        m=m,
        halo_lo=halo_lo,
        halo_hi=halo_hi,
        win=win,
        tile=tile,
        offs=offs.astype(np.int32),
        taps=taps,
        use_all_gather=use_all_gather,
        b_int0=b0,
        b_int1=b1,
    )


def shard_v_blocked(
    op: BandedOp, n_dev: int, padded_h: int, tile: int | None = None,
    in_bytes: int = 1,
) -> ShardedVOp:
    """Like ``shard_v_op`` but with 32-row-aligned local window starts and
    the K1 tiles (``pick_tile``), so that each rank's taps feed K1 as its
    vertical operator, with the raw strip and its halos as K1's input."""
    if tile is None:
        tile = pick_tile(op, in_bytes=in_bytes)
    base_sv = shard_v_op(op, n_dev, padded_h, tile=tile)
    if base_sv.use_all_gather:
        return base_sv
    n_out, width = op.n_out, op.width
    m, strip = base_sv.m, base_sv.strip
    halo_lo, halo_hi = base_sv.halo_lo, base_sv.halo_hi
    # 32-align the low halo so that interior window starts stay 32-aligned
    # after rebasing to strip coordinates (offs - halo_lo): the extra
    # exchanged rows carry zero taps.
    if halo_lo > 0 and _round_up(halo_lo, 32) <= strip:
        halo_lo = _round_up(halo_lo, 32)
    blocks = -(-m // tile)
    starts = op.starts.astype(np.int64)

    # 32-aligning the window starts can move them up to 31 rows lower;
    # widen the window to keep every block's span covered.
    win = 0
    for b0 in range(0, n_out, tile):
        b1 = min(b0 + tile, n_out)
        win = max(win, int(starts[b1 - 1]) + width - int(starts[b0]))
    win = _round_up(win + 31, 32)

    # 32-align the extended strip itself (by taking a few more halo rows
    # from the next rank; their taps are zero), then pull windows left so
    # that offs + win fits inside it.
    ext_len = halo_lo + strip + halo_hi
    ext_pad = _round_up(ext_len, 32)
    if ext_pad >= win and ext_pad - ext_len + halo_hi <= strip:
        halo_hi += ext_pad - ext_len
        max_off = ext_pad - win
    else:
        max_off = None  # tiny strip: the ext buffer is zero-padded

    offs = np.zeros((n_dev, blocks), dtype=np.int64)
    taps = np.zeros((n_dev, blocks, tile, win), dtype=np.float32)
    valid = np.zeros((n_dev, blocks), dtype=bool)
    for d in range(n_dev):
        base = d * strip - halo_lo
        for b in range(blocks):
            lo = d * m + b * tile
            # Clamp to this rank's own rows (see shard_v_op): giving rows
            # past m the next rank's taps would widen the window.
            hi = min(lo + tile, (d + 1) * m, n_out)
            if lo >= min((d + 1) * m, n_out):
                continue
            off = ((int(starts[lo]) - base) // 32) * 32
            if max_off is not None:
                off = min(off, max_off)
            assert off >= 0, (d, b, off)
            offs[d, b] = off
            valid[d, b] = True
            for i in range(lo, hi):
                c0 = int(starts[i]) - base - off
                taps[d, b, i - lo, c0 : c0 + width] = op.taps[i]

    b0, b1 = _interior_split(offs, valid, halo_lo, strip, win)
    # Interior rebasing (offs - halo_lo) must keep the 32-row alignment;
    # otherwise every block is border.
    if halo_lo % 32:
        logger.debug(
            "interior/halo overlap disabled: halo_lo=%d not 32-aligned",
            halo_lo,
        )
        b0 = b1 = 0
    return ShardedVOp(
        n_in=op.n_in,
        n_out=n_out,
        strip=strip,
        m=m,
        halo_lo=halo_lo,
        halo_hi=halo_hi,
        win=win,
        tile=tile,
        offs=offs.astype(np.int32),
        taps=taps,
        use_all_gather=False,
        b_int0=b0,
        b_int1=b1,
    )


def pad_rows(src: np.ndarray, n_dev: int) -> np.ndarray:
    """Zero-pad image rows (axis -2 of [..., H, W*C]) to a multiple of the
    row-mesh size."""
    h = src.shape[-2]
    pad = (-h) % n_dev
    if pad == 0:
        return src
    widths = [(0, 0)] * src.ndim
    widths[-2] = (0, pad)
    return np.pad(src, widths)


def local_strip(mesh, src):
    """This rank's part of the padded input ``src`` ([H_pad, W*C], or
    [B, H_pad, W*C] with frames split over dp): its strip of rows, and
    with frames its dp share of them (what ``shard_map``'s in_specs cut
    there)."""
    strip = src.shape[-2] // mesh.sp
    rows = slice(mesh.sp_index * strip, (mesh.sp_index + 1) * strip)
    if src.ndim == 2:
        return src[rows]
    per = src.shape[0] // mesh.dp
    return src[mesh.dp_index * per : (mesh.dp_index + 1) * per, rows]


def halo_rows(src: torch.Tensor, svop: ShardedVOp, d: int):
    """(h_lo, h_hi) of rank ``d`` of ``svop``'s mesh cut from the whole
    padded input ``src`` [..., H_pad, W*C] in one process: what
    ``comm.exchange_halos`` delivers to that rank, zeros on the edges."""
    strip, lo, hi = svop.strip, svop.halo_lo, svop.halo_hi
    n_dev = src.shape[-2] // strip
    lead, lanes = src.shape[:-2], src.shape[-1]
    h_lo = zeros_rows((*lead, lo, lanes), src.dtype, src.device)
    h_hi = zeros_rows((*lead, hi, lanes), src.dtype, src.device)
    if d > 0:
        h_lo = src[..., d * strip - lo : d * strip, :].contiguous()
    if d + 1 < n_dev:
        h_hi = src[..., (d + 1) * strip : (d + 1) * strip + hi, :].contiguous()
    return h_lo, h_hi


# ---------------------------------------------------------------------------
# Device half: one rank's strip body
# ---------------------------------------------------------------------------


def _cat_rows(ts: list[torch.Tensor], rows: int = 0) -> torch.Tensor:
    """``ts`` concatenated along axis -2, then zero rows up to ``rows``,
    through uint8 views of the last axis (PyTorch's u16 has few ops)."""
    dtype = ts[0].dtype
    b = [t.contiguous().view(torch.uint8) for t in ts]
    have = sum(t.shape[-2] for t in b)
    if rows > have:
        b.append(torch.zeros(
            (*b[0].shape[:-2], rows - have, b[0].shape[-1]),
            dtype=torch.uint8, device=b[0].device,
        ))
    return (b[0] if len(b) == 1 else torch.cat(b, dim=-2)).view(dtype)


def _stack(ys: list[torch.Tensor]) -> torch.Tensor:
    """``torch.stack(ys)`` through uint8 views (see ``_cat_rows``)."""
    return torch.stack([y.contiguous().view(torch.uint8) for y in ys]).view(ys[0].dtype)


@dataclasses.dataclass(frozen=True)
class Strip:
    """One rank's strip body, a pure function of its strip ``x`` and its
    two halo blocks: ``strip(x, h_lo, h_hi)`` -> the rank's ``m`` output
    rows.  ``parts`` are (operands, reads_ext) in output-row order; each
    is one ``apply(operands, input)`` over the ext buffer (halo_lo rows,
    the strip, halo_hi rows, zero rows up to ``ext_rows``) or, for the
    interior blocks, over the strip alone.  ``local`` runs the interior
    parts, which may start before the halos arrive; ``finish`` the rest."""

    parts: tuple
    apply: Callable
    ext_rows: int
    m: int

    def local(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [self.apply(p, x) for p, on_ext in self.parts if not on_ext]

    def ext(self, x, h_lo, h_hi) -> torch.Tensor:
        return _cat_rows([h_lo, x, h_hi], self.ext_rows)

    def finish(self, x, h_lo, h_hi, local: list[torch.Tensor]) -> torch.Tensor:
        ext = None
        if any(on_ext for _, on_ext in self.parts):
            ext = self.ext(x, h_lo, h_hi)
        mid = iter(local)
        ys = [self.apply(p, ext) if on_ext else next(mid) for p, on_ext in self.parts]
        return _cat_rows(ys)[: self.m]

    def __call__(self, x, h_lo, h_hi) -> torch.Tensor:
        return self.finish(x, h_lo, h_hi, self.local(x))


def _rank_vop(
    sv: ShardedVOp, d: int, blocks: slice, n_in: int, rebase: int = 0,
    limbs: dict | None = None,
) -> BlockedBandedOp:
    """Rank ``d``'s V operator over ``blocks`` for an input of ``n_in``
    rows, window starts moved up by ``rebase`` rows (``mk_vop`` there)."""
    taps = np.ascontiguousarray(sv.taps[d, blocks])
    hi, lo = bf16_split(taps)
    offs = sv.offs[d, blocks] - rebase
    q = {}
    if limbs is not None:
        q = dict(
            taps_q1=np.ascontiguousarray(limbs["q1"][d, blocks]),
            taps_q0=np.ascontiguousarray(limbs["q0"][d, blocks]),
            q_shift=limbs["q_shift"], l1_max=limbs["l1_max"],
            q_abs1=limbs["q_abs1"], q_abs0=limbs["q_abs0"],
        )
    return BlockedBandedOp(
        n_in=n_in, n_out=taps.shape[0] * sv.tile,
        n_in_pad=max(n_in, int(offs.max()) + sv.win),
        tile=sv.tile, win=sv.win, offs=offs.astype(np.int32), taps=taps,
        taps_hi=hi, taps_lo=lo, **q,
    )


def _parts(sv: ShardedVOp, d: int, ext_rows: int, make: Callable) -> tuple:
    """(operands, reads_ext) of rank ``d``: one part over the ext buffer,
    or with an interior range the border blocks over ext and the interior
    ones over the strip (``_overlapped_v`` / ``pallas_fn`` there)."""
    blocks = sv.taps.shape[1]
    b0, b1 = sv.b_int0, sv.b_int1
    if b1 <= b0:
        return ((make(slice(None), ext_rows, 0), True),)
    parts = []
    if b0 > 0:
        parts.append((make(slice(0, b0), ext_rows, 0), True))
    parts.append((make(slice(b0, b1), sv.strip, sv.halo_lo), False))
    if b1 < blocks:
        parts.append((make(slice(b1, None), ext_rows, 0), True))
    return tuple(parts)


def _k1(ops, x: torch.Tensor) -> torch.Tensor:
    if isinstance(ops, FusedInt8Operands):
        return apply_fused_int8(ops, x)
    return apply_fused_split(ops, x)


def _global_limbs(svb: ShardedVOp) -> dict | None:
    """The int8 limbs of every rank's taps under ONE shift, with the
    magnitudes K1's inter-pass scale reads (``:1644-1689`` there), or None
    when the first pass could overflow s32."""
    q1, q0, shift = quantize_limbs(svb.taps)
    if not first_pass_overflow_safe(q1, q0, contract_axis=3):
        return None
    return dict(
        q1=q1, q0=q0, q_shift=shift,
        l1_max=float(np.abs(svb.taps).sum(axis=3).max()),
        q_abs1=int(np.abs(q1.astype(np.int64)).sum(axis=3).max()),
        q_abs0=int(np.abs(q0.astype(np.int64)).sum(axis=3).max()),
    )


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What the AVIR and LANCIR makers give the shared builder."""

    v_op: BandedOp
    h_op: BandedOp
    c: int
    new_w: int
    new_h: int
    in_bytes: int
    precision: str
    in_exact_bf16: bool
    int8_eligible: bool       # before the limbs' feasibility
    gamma: bool               # int8 feasibility with the gamma first pass
    kernel_route: bool        # the kernel route unless exact / all-gather
    int8_kw: dict             # prepare_fused_int8's epilogue
    split_kw: dict            # prepare_fused_split's epilogue and output
    pre: Callable             # library route: raw strip -> float32
    post: Callable            # library route: float32 rows -> output
    errdiff: bool
    trunc_bits: int
    out_max: float
    out_dtype: torch.dtype
    scan_order: bool


def _build(spec: _Spec, mesh, tile: int, pallas_tile, halo_overlap: bool):
    n_dev, d, device = mesh.sp, mesh.sp_index, torch.device(mesh.device)
    c, new_w, new_h = spec.c, spec.new_w, spec.new_h
    mode_first, mode_second = resolve_modes(spec.precision, spec.in_exact_bf16)
    padded_h = spec.v_op.n_in + ((-spec.v_op.n_in) % n_dev)
    svop = shard_v_op(spec.v_op, n_dev, padded_h, tile=tile)
    kernel = spec.kernel_route and spec.precision != "exact" and not svop.use_all_gather

    if kernel:
        svb = shard_v_blocked(spec.v_op, n_dev, padded_h, tile=pallas_tile, in_bytes=spec.in_bytes)
        lop = lane_block_banded(spec.h_op, c, in_bytes=spec.in_bytes)
        if spec.in_bytes >= 2 or not halo_overlap:
            # One launch over the ext buffer is the default, as there;
            # 2- and 4-byte strips never split.
            svb = dataclasses.replace(svb, b_int0=0, b_int1=0)
        ext_rows = _round_up(
            max(int(svb.offs.max()) + svb.win, svb.halo_lo + svb.strip + svb.halo_hi),
            32,
        )
        limbs = None
        if spec.int8_eligible and lop.taps_q1 is not None:
            limbs = _global_limbs(svb)
        if limbs is not None:
            # int8_feasible reads only these fields of the V operator.
            probe = types.SimpleNamespace(
                taps_q1=limbs["q1"],
                **{k: limbs[k] for k in ("q_shift", "l1_max", "q_abs1", "q_abs0")},
            )
            if not int8_feasible(probe, lop, "vh", spec.gamma):
                limbs = None
        if limbs is not None:
            route = "int8"

            def make(blocks, n_in, rebase):
                vop = _rank_vop(svb, d, blocks, n_in, rebase, limbs)
                return prepare_fused_int8(vop, lop, "vh", device, **spec.int8_kw)
        else:
            route = "split"

            def make(blocks, n_in, rebase):
                vop = _rank_vop(svb, d, blocks, n_in, rebase)
                return prepare_fused_split(
                    vop, lop, "vh", mode_first, mode_second, device, **spec.split_kw
                )

        sv = svb
        strip = Strip(_parts(svb, d, ext_rows, make), _k1, ext_rows, svb.m)

        def rows_of(xb: torch.Tensor) -> torch.Tensor:
            pending = exchange_halos(xb, svb, mesh.sp_group, async_op=True)
            local = [strip.local(f) for f in xb]
            h_lo, h_hi = pending.wait()
            return _stack([
                strip.finish(f, h_lo[i], h_hi[i], local[i]) for i, f in enumerate(xb)
            ])
    else:
        route, sv, strip = "library", svop, None
        hop = block_banded(spec.h_op, in_bytes=spec.in_bytes)

        def dev_taps(op: BlockedBandedOp, mode: str):
            # apply_blocked's taps on the device: float32, or the bf16 pair.
            if mode == "exact":
                return torch.from_numpy(op.taps).to(device)
            return op.taps_hi.to(device), op.taps_lo.to(device)

        h_taps = dev_taps(hop, mode_first)
        w = spec.h_op.n_in

        def h_pass(x: torch.Tensor) -> torch.Tensor:
            rows = x.shape[0]
            x = spec.pre(x).reshape(rows, w, c).transpose(0, 1).reshape(w, rows * c)
            x = apply_blocked(hop, x, mode_first, taps=h_taps)  # [new_w, rows*c]
            return x.reshape(new_w, rows, c).transpose(0, 1).reshape(rows, new_w * c)

        def make(blocks, n_in, rebase):
            vop = _rank_vop(svop, d, blocks, n_in, rebase)
            return vop, dev_taps(vop, mode_second)

        def v_apply(part, x):
            vop, taps = part
            return apply_blocked(vop, x, mode_second, taps=taps)

        if svop.use_all_gather:
            # Window offsets in the gathered image's coordinates.
            vpart = make(slice(None), n_dev * svop.strip, 0)

            def rows_of(xb: torch.Tensor) -> torch.Tensor:
                xh = torch.stack([h_pass(f) for f in xb])
                ext = all_gather_rows(xh, mesh.sp_group)
                return _stack([spec.post(v_apply(vpart, e)[: svop.m]) for e in ext])
        else:
            ext_rows = max(int(svop.offs.max()) + svop.win, svop.halo_lo + svop.strip + svop.halo_hi)
            vstrip = Strip(_parts(svop, d, ext_rows, make), v_apply, ext_rows, svop.m)

            def rows_of(xb: torch.Tensor) -> torch.Tensor:
                xh = torch.stack([h_pass(f) for f in xb])
                pending = exchange_halos(xh, svop, mesh.sp_group, async_op=True)
                local = [vstrip.local(f) for f in xh]
                h_lo, h_hi = pending.wait()
                return _stack([
                    spec.post(vstrip.finish(f, h_lo[i], h_hi[i], local[i]))
                    for i, f in enumerate(xh)
                ])

    body = rows_of
    m = sv.m
    if spec.errdiff:
        def body(xb: torch.Tensor) -> torch.Tensor:
            # The pre-dither float32 strips -> one all-gather of the
            # (post-resize) image -> K4 on the whole image, replicated on
            # every sp rank -> each rank keeps its own rows.
            full = all_gather_rows(rows_of(xb), mesh.sp_group)
            frames = []
            for img in full:
                img = img[:new_h].reshape(new_h, new_w, c).contiguous()
                q = errdiff_wavefront(
                    img, spec.trunc_bits, spec.out_max, out_dtype=spec.out_dtype,
                    scan_order=spec.scan_order,
                ).reshape(new_h, new_w * c)
                # Rows past new_h (padding) are zeros, as there.
                frames.append(_cat_rows([q], n_dev * m)[d * m : (d + 1) * m])
            return _stack(frames)

    shape = (sv.strip, spec.h_op.n_in * c)

    def run(x: torch.Tensor) -> torch.Tensor:
        if x.dim() not in (2, 3) or tuple(x.shape[-2:]) != shape:
            raise ValueError(f"expected this rank's strip [..., {shape[0]}, {shape[1]}], got {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"strip on {x.device}, mesh device {device}")
        x = x.contiguous()
        y = body(x if x.dim() == 3 else x[None])
        return y if x.dim() == 3 else y[0]

    run.route = route
    run.svop = sv
    run.strip = strip
    return run


def _check(engine: str, dither: str = "default") -> None:
    if engine not in ("auto", "pallas"):
        check_engine(engine)  # "xla": the library route is precision="exact"
        raise ValueError(f"unknown engine {engine!r} for the mesh")
    if dither not in DITHERS:
        raise ValueError(f"unknown dither {dither!r}")


def make_sharded_avir_executor(
    plan,
    mesh,
    precision: str = "auto",
    tile: int = 64,
    engine: str = "auto",
    pallas_tile: int | None = None,
    dither: str = "default",
    halo_overlap: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's executor of a ResizePlan on ``mesh`` (a
    ``multihost.DpSpMesh``; ``make_sharded_avir_executor`` there, whose
    ``Mesh`` and axis names it replaces).

    Call it on every rank of the mesh at once, with the rank's strip of the
    row-padded image (``pad_rows``, ``local_strip``): [strip, W*C], or
    [B_local, strip, W*C] with frames on the dp axis, on ``mesh.device``.
    It returns the rank's output rows [m, new_w*C] (or [B_local, m,
    new_w*C]) on that device; ``assemble`` gathers the image.

    ``engine``: "auto" or "pallas" run the kernel route (the hand-written
    K1 per strip, one launch per frame); "xla" raises ``ValueError`` (the
    library route is ``precision="exact"``).  ``halo_overlap=True`` runs
    a 1-byte strip's interior blocks before the halos arrive and its
    border blocks after (three launches; the same bits).  ``dither``:
    "default" rounds per strip; "errdiff" / "errdiff-wavefront" /
    "errdiff-device" gather the pre-dither float32 strips with one
    all-gather and run K4 on the whole image on every sp rank
    ("errdiff-device" in the sequential scan's sum order), each rank
    keeping its rows.  Float output ignores the dither.  sRGB gamma runs
    in K1 (int8 or split), with the alpha bypass.

    The function carries ``run.route`` ("int8", "split" or "library"),
    ``run.svop`` (the ``ShardedVOp`` it runs) and ``run.strip`` (the pure
    ``Strip`` of the kernel route, else None)."""
    _check(engine, dither)
    errdiff = dither in ERRDIFF and not plan.is_out_float
    in_b = 4 if plan.is_in_float else (1 if plan.in_type_max == 255.0 else 2)
    out_dt = out_dtype_of(plan)
    out_bits = 8 if plan.out_type_max == 255.0 else 16
    trunc_bits = 0 if plan.is_out_float else out_bits - plan.res_bit_depth
    gamma_kw = dict(
        gamma=plan.use_srgb_gamma, alpha_index=plan.alpha_index,
        in_gamma_mult=plan.in_gamma_mult, out_gamma_mult=plan.out_gamma_mult,
    )
    c = plan.el_count

    def pre(x):
        x = to_float32(x)
        if plan.use_srgb_gamma:
            x = srgb_to_linear_2d(x * f32(plan.in_gamma_mult), c, plan.alpha_index)
        return x

    def post(y):
        if plan.use_srgb_gamma:
            y = linear_to_srgb_2d(y, c, plan.alpha_index)
            if plan.out_gamma_mult != 0.0:
                y = y * f32(plan.out_gamma_mult)
        if plan.is_out_float or errdiff:
            return y  # errdiff: the pre-dither image, dithered after the gather
        return default_dither(y, trunc_bits, plan.out_type_max).to(torch.int32).to(out_dt)

    kernel_out = torch.float32 if plan.is_out_float or errdiff else out_dt
    spec = _Spec(
        v_op=plan.v.op, h_op=plan.h.op, c=c, new_w=plan.new_w, new_h=plan.new_h,
        in_bytes=in_b, precision=precision, in_exact_bf16=in_exact_bf16(plan),
        # errdiff feeds its residual back and sub-8-bit outputs quantize in
        # 2^trunc_bits steps: both need the full-precision route.
        int8_eligible=(
            precision == "auto" and in_b == 1 and out_dt == torch.uint8
            and not errdiff and trunc_bits == 0
        ),
        gamma=plan.use_srgb_gamma,
        kernel_route=True,
        int8_kw=gamma_kw,
        split_kw=dict(
            out_dtype=kernel_out, out_max=plan.out_type_max,
            trunc_bits=0 if errdiff else trunc_bits, **gamma_kw,
        ),
        pre=pre, post=post, errdiff=errdiff, trunc_bits=trunc_bits,
        out_max=plan.out_type_max, out_dtype=out_dt,
        scan_order=errdiff_impl(dither) == "scan",
    )
    return _build(spec, mesh, tile, pallas_tile, halo_overlap)


def make_sharded_lancir_executor(
    plan,
    mesh,
    precision: str = "auto",
    tile: int = 64,
    engine: str = "auto",
    pallas_tile: int | None = None,
    halo_overlap: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's executor of a LancirPlan on ``mesh`` (the row-strip
    scheme and call contract of ``make_sharded_avir_executor``), with
    LANCIR's round-half-even output stage: integer output runs K1 (int8
    for u8 in and out at ``precision="auto"``, else split) with ``scale``
    = the plan's ``out_mul``; float output and ``precision="exact"`` take
    the library route."""
    _check(engine)
    out_dt = (
        torch.float32 if plan.is_out_float
        else torch.uint8 if plan.clamp == 255.0 else torch.uint16
    )
    epi = dict(scale=plan.out_mul, round_mode="even")

    def post(y):
        if plan.out_mul != 1.0:
            y = y * f32(plan.out_mul)
        if plan.is_out_float:
            return y
        return torch.clamp(torch.round(y), 0.0, plan.clamp).to(torch.int32).to(out_dt)

    spec = _Spec(
        v_op=plan.v, h_op=plan.h, c=plan.el_count, new_w=plan.new_w,
        new_h=plan.new_h, in_bytes=plan.in_itemsize, precision=precision,
        in_exact_bf16=plan.in_exact_bf16,
        int8_eligible=precision == "auto" and plan.in_exact_bf16 and plan.clamp == 255.0,
        gamma=False,
        kernel_route=not plan.is_out_float,
        int8_kw=epi,
        split_kw=dict(out_dtype=out_dt, out_max=plan.clamp, **epi),
        pre=to_float32, post=post, errdiff=False, trunc_bits=0,
        out_max=plan.clamp, out_dtype=out_dt, scan_order=False,
    )
    return _build(spec, mesh, tile, pallas_tile, halo_overlap)


def assemble(mesh, y: torch.Tensor, new_h: int) -> torch.Tensor:
    """The whole output from every rank's rows ``y`` (``run``'s result;
    collective: every rank calls it): [new_h, new_w*C], or with frames
    [B, new_h, new_w*C] in dp order (``_slice_padded_out`` there)."""
    full = all_gather_rows(y, mesh.sp_group)[..., :new_h, :]
    if full.dim() == 3 and mesh.dp > 1:
        b, h, lanes = full.shape
        frames = all_gather_rows(full.reshape(b * h, lanes).contiguous(), mesh.dp_group)
        full = frames.reshape(mesh.dp * b, h, lanes)
    return full
