"""Analytic scaling model of the row-strip mesh (parallel/sharded.py).

Counterpart of the JAX package's ``parallel/scaling_model.py``, with the
fabric of an NVIDIA HGX H100 in place of the TPU's.  It predicts the
efficiency of the sharded executors on n cards from quantities that can be
derived or measured on one card:

  - the plan's exact halo traffic (``shard_v_blocked``: halo_lo / halo_hi
    rows x row bytes, sent to each neighbour by one point-to-point
    transfer per direction; the two directions use separate links and
    overlap);
  - a measured single-card kernel time for the configuration
    (``chip_smoke.py`` prints the per-strip and whole-image K1 times);
  - the interior/border block split (``b_int0`` / ``b_int1``): with
    ``halo_overlap=True`` the interior launch is issued before the halos
    are waited on, so halo time is exposed only beyond the interior
    blocks' compute;
  - the link constants below: data-sheet assumptions, not measurements.

Model per mesh size n (row-strip axis sp):

  t_comp(n)  = t_chip * (blocks_n / blocks_1) / n + t_dispatch * calls
  t_halo(n)  = lat + max(halo_lo, halo_hi) * row_bytes / bw
  t_exposed  = max(0, t_halo - t_interior)         # overlap credit
  t_step(n)  = t_comp(n) + t_exposed
  eff(n)     = t_chip / (n * t_step(n))

The dp (batch) axis exchanges nothing during a step (each host resizes its
own frames), so at fixed work per host the cross-host efficiency is the
sp efficiency computed here; the InfiniBand constants are for the
callers that put sp across hosts.

This is a model: no number it gives is a measured scaling.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# --- fabric constants: data-sheet assumptions, overridable ------------
# NVLink 4 on an HGX H100 (NVIDIA data sheet): 900 GB/s per GPU in both
# directions together, 450 GB/s each way, all to all through NVSwitch.
# Latency: an assumed 3 us for a small NCCL point-to-point transfer
# between two cards of one host (software-visible, not a data-sheet
# figure).
NVLINK_BW = 450e9
NVLINK_LAT = 3e-6
# NDR InfiniBand between hosts: 400 Gb/s (50 GB/s) per host each way,
# with an assumed 5 us for a small transfer; used by the dp axis, which
# exchanges nothing during a step.
IB_NDR_BW = 400e9 / 8
IB_NDR_LAT = 5e-6
# PCIe Gen5 x16, the option without NVLink: 64 GB/s each way (data sheet,
# before protocol overhead), an assumed 5 us for a small transfer.
PCIE5_BW = 64e9
PCIE5_LAT = 5e-6
# Per-launch overhead of a strip kernel: device time per K1 int8 launch on
# a tiny strip (64x32 -> 32x16 u8 RGB) between CUDA events around 200
# back-to-back launches, which the host's wrapper call bounds;
# chip_smoke.py's launch_overhead_us, 40.8 us on an H100 80GB HBM3 at
# 700.00 W.  The strip body issues one K1 launch, or three with
# halo_overlap (border lo / interior / border hi).
T_DISPATCH = 40.8e-6


@dataclasses.dataclass
class ScalePoint:
    n_dev: int
    strip_rows: int
    halo_rows: int          # max one-direction halo rows
    halo_bytes: int         # bytes sent per rank per direction
    t_comp_us: float
    t_halo_us: float
    t_interior_us: float
    t_exposed_us: float
    t_step_us: float
    efficiency: float
    all_gather: bool


def model_scaling(
    plan,
    t_chip_s: float,
    n_devs=(2, 4, 8, 16, 32),
    *,
    bw=NVLINK_BW,
    lat=NVLINK_LAT,
    t_dispatch=T_DISPATCH,
    in_itemsize: int | None = None,
    cores: int | None = None,
) -> list[ScalePoint]:
    """Predict row-strip scaling efficiency for ``plan`` from the
    measured single-card step time ``t_chip_s``.

    ``plan`` needs only ``.v.op`` / ``.src_h`` / ``.src_w`` /
    ``.el_count`` and an input dtype (AVIR ResizePlan and LancirPlan
    both qualify via the thin adapters below).

    ``cores`` caps the compute parallelism (ranks that share cores or
    one card: n ranks on c of them speed compute up by min(n, c), while
    halo traffic still scales with n).

    The interior-overlap credit (``t_int``) models the strip body with
    ``halo_overlap=True`` (and the library route, which always overlaps);
    the kernel route's default is one launch over the ext buffer, for
    which the credit is zero: pass the measured per-strip time instead."""
    from .sharded import shard_v_blocked

    v_op = plan.v.op if hasattr(plan, "v") and hasattr(plan.v, "op") \
        else plan.v
    h = plan.src_h
    c = plan.el_count
    if in_itemsize is None:
        # LancirPlan carries in_itemsize directly; ResizePlan derives
        # it from the float/type-max fields (must match the bytes the
        # production strip route ships per row).
        in_itemsize = getattr(plan, "in_itemsize", None)
        if in_itemsize is None:
            in_itemsize = 4 if getattr(plan, "is_in_float", False) else (
                1 if getattr(plan, "in_type_max", 255.0) == 255.0 else 2
            )
    row_bytes = plan.src_w * c * in_itemsize

    out = []
    for n in n_devs:
        padded_h = h + ((-h) % n)
        # The byte-aware tile the strip route uses.
        sv = shard_v_blocked(v_op, n, padded_h, in_bytes=in_itemsize)
        blocks_n = sv.taps.shape[1]
        blocks_1 = -(-v_op.n_out // sv.tile)  # single-card block count
        # Per-rank compute: the measured card time scaled by the share
        # of output-row blocks each rank runs (block count, not raw
        # rows: padding blocks cost full tiles), plus the launch
        # overhead of the up-to-3 strip kernel launches.
        work_ratio = blocks_n * n / max(blocks_1, 1)
        calls = 1 if sv.b_int1 <= sv.b_int0 else (
            1 + (1 if sv.b_int0 > 0 else 0)
            + (1 if sv.b_int1 < blocks_n else 0)
        )
        par = n if cores is None else min(n, cores)
        t_comp = t_chip_s * work_ratio / par + t_dispatch * calls
        if sv.use_all_gather:
            # Fallback: the whole (H-passed) image all-gathers; no
            # overlap.  bytes ~ (n-1)/n of the f32 intermediate.
            ag_bytes = int(
                (n - 1) / n * v_op.n_in
                * getattr(plan, "new_w", plan.src_w) * c * 4
            )
            t_halo = lat * int(np.ceil(np.log2(n))) + ag_bytes / bw
            t_int = 0.0
        else:
            halo = max(sv.halo_lo, sv.halo_hi)
            t_halo = lat + halo * row_bytes / bw
            n_int = max(sv.b_int1 - sv.b_int0, 0)
            # 2/4-byte strips always run one launch over the ext buffer
            # (parallel/sharded.py), so no overlap credit there.
            if in_itemsize >= 2:
                n_int = 0
            t_int = (
                t_chip_s * (n_int * n / max(blocks_1, 1)) / par
            )
        t_exposed = max(0.0, t_halo - t_int)
        t_step = t_comp + t_exposed
        out.append(
            ScalePoint(
                n_dev=n,
                strip_rows=sv.strip,
                halo_rows=0 if sv.use_all_gather
                else max(sv.halo_lo, sv.halo_hi),
                halo_bytes=0 if sv.use_all_gather
                else max(sv.halo_lo, sv.halo_hi) * row_bytes,
                t_comp_us=t_comp * 1e6,
                t_halo_us=t_halo * 1e6,
                t_interior_us=t_int * 1e6,
                t_exposed_us=t_exposed * 1e6,
                t_step_us=t_step * 1e6,
                efficiency=t_chip_s / (n * t_step),
                all_gather=sv.use_all_gather,
            )
        )
    return out


def format_table(points: list[ScalePoint]) -> str:
    lines = [
        "  n  strip  halo(rows/KB)  comp(us)  halo(us)  exposed  "
        "step(us)   eff",
    ]
    for p in points:
        lines.append(
            f"{p.n_dev:3d}  {p.strip_rows:5d}  "
            f"{p.halo_rows:4d}/{p.halo_bytes / 1024:7.1f}  "
            f"{p.t_comp_us:8.1f}  {p.t_halo_us:8.2f}  "
            f"{p.t_exposed_us:7.2f}  {p.t_step_us:8.1f}  "
            f"{p.efficiency:5.2f}"
            + ("  [all-gather]" if p.all_gather else "")
        )
    return "\n".join(lines)


@dataclasses.dataclass
class ScalePointErrdiff:
    n_dev: int
    t_resize_us: float      # sharded resize step (from model_scaling)
    t_gather_us: float      # all_gather of the pre-dither output
    t_wavefront_us: float   # full-image wavefront, replicated
    t_step_us: float
    efficiency: float


def model_scaling_errdiff(
    plan,
    t_chip_s: float,
    t_wavefront_s: float,
    n_devs=(2, 4, 8, 16),
    *,
    bw=NVLINK_BW,
    lat=NVLINK_LAT,
    t_dispatch=T_DISPATCH,
    in_itemsize: int | None = None,
) -> list[ScalePointErrdiff]:
    """Model the sharded ``dither="errdiff"`` step.

    The mesh path (parallel/sharded.py, errdiff epilogue) computes the
    pre-dither float strips sharded, all-gathers the post-resize image
    over the mesh, runs K4 on the whole image REPLICATED on every rank
    (the recurrence is serial across the whole image; the reference
    serializes it onto one thread too, avir.h:5047-5068), and keeps its
    own rows.  Step time is therefore floor-bounded by K4:

      t_step(n) = t_resize_step(n) + t_allgather(n) + t_wavefront

    with efficiency against the single-card errdiff step (t_chip +
    t_wavefront).  ``t_wavefront_s`` is a measured whole-image K4 time
    for the OUTPUT size (chip_smoke.py prints it).
    """
    base = model_scaling(
        plan, t_chip_s, n_devs, bw=bw, lat=lat,
        t_dispatch=t_dispatch, in_itemsize=in_itemsize,
    )
    new_w = getattr(plan, "new_w", plan.src_w)
    new_h = getattr(plan, "new_h", None)
    if new_h is None:
        new_h = plan.v.op.n_out if hasattr(plan.v, "op") \
            else plan.v.n_out
    out_bytes = new_h * new_w * plan.el_count * 4  # f32 pre-dither
    t_single = t_chip_s + t_wavefront_s
    out = []
    for p in base:
        n = p.n_dev
        t_ag = lat * max(1, int(np.ceil(np.log2(n)))) \
            + (n - 1) / n * out_bytes / bw
        t_step = p.t_step_us * 1e-6 + t_ag + t_wavefront_s
        out.append(
            ScalePointErrdiff(
                n_dev=n,
                t_resize_us=p.t_step_us,
                t_gather_us=t_ag * 1e6,
                t_wavefront_us=t_wavefront_s * 1e6,
                t_step_us=t_step * 1e6,
                efficiency=t_single / (n * t_step),
            )
        )
    return out


def format_table_errdiff(points: list[ScalePointErrdiff]) -> str:
    lines = [
        "  n  resize(us)  gather(us)  wavefront(us)  step(us)   eff",
    ]
    for p in points:
        lines.append(
            f"{p.n_dev:3d}  {p.t_resize_us:10.1f}  "
            f"{p.t_gather_us:10.2f}  {p.t_wavefront_us:13.1f}  "
            f"{p.t_step_us:8.1f}  {p.efficiency:5.2f}"
        )
    return "\n".join(lines)


def model_scaling_2d(
    plan,
    t_chip_s: float,
    grids=((1, 2), (2, 2), (2, 4), (4, 2), (4, 4), (2, 8), (4, 8)),
    *,
    bw=NVLINK_BW,
    lat=NVLINK_LAT,
    t_dispatch=T_DISPATCH,
    in_itemsize: int | None = None,
    tile: int = 64,
    t_rank_s: dict | None = None,
) -> list["ScalePoint2D"]:
    """Predict 2-D (rows x cols) intra-image scaling efficiency of
    the library route of a rows x cols mesh (f32 transposed-tile column
    halos, per-pass exchanges) from the measured single-card time, as the
    JAX package's model does for ``make_sharded_avir_executor_2d``.

    ``t_rank_s`` maps a grid (r, s) to a measured per-rank compute time in
    seconds: the slowest rank's K1 launches on its doubly extended tile
    (chip_smoke.py times every rank's ``Tile.compute`` alone on one
    card).  Where given it replaces the MAC-apportioned compute term and
    its dispatches; the halo terms stay the library route's (the kernel
    route moves raw integer bytes instead, fewer of them for u8).

    Differences from the 1-D model:

      - per-rank compute is apportioned between the two passes by
        exact MAC counts (the H pass contracts the local row extent,
        the V pass the already-H-resized column extent), with each
        axis's block-padding overhead applied to its own pass;
      - TWO halo exchanges: column halos on the raw tile (cheap
        integer bytes scaled by the 1/r row extent) and row halos on
        the f32 intermediate (scaled by the 1/s column extent) —
        sharding one axis SHRINKS the other axis's halo bytes;
      - each exchange's overlap credit comes from its own pass's
        interior blocks.

    The structural win over 1-D rows: at equal device count, strips
    stay fat in BOTH dimensions, so interior extinction (the 1-D knee
    at strip ~ V-window rows) is deferred to much larger n.
    """
    from .sharded import shard_v_op

    v_op = plan.v.op if hasattr(plan, "v") and hasattr(plan.v, "op") \
        else plan.v
    h_op = plan.h.op if hasattr(plan, "h") and hasattr(plan.h, "op") \
        else plan.h
    h, w, c = plan.src_h, plan.src_w, plan.el_count
    if in_itemsize is None:
        in_itemsize = getattr(plan, "in_itemsize", None)
        if in_itemsize is None:
            in_itemsize = 4 if getattr(plan, "is_in_float", False) else (
                1 if getattr(plan, "in_type_max", 255.0) == 255.0 else 2
            )

    # Single-card MAC totals at the same tile (V first on full width,
    # H on the resized height) apportion t_chip between the passes.
    bl_v1 = -(-v_op.n_out // tile)
    bl_h1 = -(-h_op.n_out // tile)
    sv1 = shard_v_op(v_op, 1, h + ((-h) % 1), tile=tile)
    sh1 = shard_v_op(h_op, 1, w + ((-w) % 1), tile=tile)
    M_v1 = bl_v1 * tile * sv1.win * (w * c)
    M_h1 = bl_h1 * tile * sh1.win * (v_op.n_out * c)
    M1 = M_v1 + M_h1

    out = []
    for r, s in grids:
        n = r * s
        svv = shard_v_op(v_op, r, h + ((-h) % r), tile=tile)
        svh = shard_v_op(h_op, s, w + ((-w) % s), tile=tile)
        hs = (h + ((-h) % r)) // r          # local raw rows
        bl_v = svv.taps.shape[1]
        bl_h = svh.taps.shape[1]
        # Per-rank MACs: H pass on [hs, ws] raw tile; V pass on the
        # H-resized [hs, m_w] tile.
        M_h_dev = bl_h * tile * svh.win * (hs * c)
        M_v_dev = bl_v * tile * svv.win * (svh.m * c)
        t_comp = (
            t_chip_s * (M_h_dev + M_v_dev) / M1 + t_dispatch * 2
        )
        if t_rank_s is not None and (r, s) in t_rank_s:
            t_comp = t_rank_s[r, s]
        # Column halos (raw integer bytes, 1/r of the rows).
        if svh.use_all_gather:
            ag = (s - 1) / s * w * hs * c * in_itemsize
            t_halo_c = lat * max(1, int(np.ceil(np.log2(max(s, 2))))) \
                + ag / bw
            t_int_h = 0.0
        else:
            halo_c = max(svh.halo_lo, svh.halo_hi)
            # The library route exchanges column halos on the f32
            # TRANSPOSED tile (gamma applied locally first), so that the
            # H pass overlaps them as the V pass does: 4 bytes an
            # element whatever the input type, with the interior-H
            # compute credit.
            t_halo_c = lat + halo_c * hs * c * 4 / bw
            n_int_h = max(svh.b_int1 - svh.b_int0, 0)
            t_int_h = t_chip_s * (
                n_int_h * tile * svh.win * hs * c
            ) / M1
        t_exp_c = max(0.0, t_halo_c - t_int_h) if s > 1 else 0.0
        # Row halos (f32 intermediate, 1/s of the columns).
        if svv.use_all_gather:
            ag = (r - 1) / r * v_op.n_in * svh.m * c * 4
            t_halo_r = lat * max(1, int(np.ceil(np.log2(max(r, 2))))) \
                + ag / bw
            t_int_v = 0.0
        else:
            halo_r = max(svv.halo_lo, svv.halo_hi)
            t_halo_r = lat + halo_r * svh.m * c * 4 / bw
            n_int_v = max(svv.b_int1 - svv.b_int0, 0)
            t_int_v = t_chip_s * (
                n_int_v * tile * svv.win * svh.m * c
            ) / M1
        t_exp_r = max(0.0, t_halo_r - t_int_v) if r > 1 else 0.0
        t_step = t_comp + t_exp_c + t_exp_r
        out.append(
            ScalePoint2D(
                r=r, s=s, n_dev=n,
                tile_rows=hs, tile_cols=(w + ((-w) % s)) // s,
                t_comp_us=t_comp * 1e6,
                t_exposed_col_us=t_exp_c * 1e6,
                t_exposed_row_us=t_exp_r * 1e6,
                t_step_us=t_step * 1e6,
                efficiency=t_chip_s / (n * t_step),
                all_gather=svv.use_all_gather or svh.use_all_gather,
            )
        )
    return out


@dataclasses.dataclass
class ScalePoint2D:
    r: int
    s: int
    n_dev: int
    tile_rows: int
    tile_cols: int
    t_comp_us: float
    t_exposed_col_us: float
    t_exposed_row_us: float
    t_step_us: float
    efficiency: float
    all_gather: bool


def format_table_2d(points: list[ScalePoint2D]) -> str:
    lines = [
        "  r x s    n   tile(rxc)    comp(us)  exp.col  exp.row  "
        "step(us)   eff",
    ]
    for p in points:
        lines.append(
            f"{p.r:3d}x{p.s:<3d} {p.n_dev:4d}  "
            f"{p.tile_rows:5d}x{p.tile_cols:<5d}  "
            f"{p.t_comp_us:9.1f}  {p.t_exposed_col_us:7.2f}  "
            f"{p.t_exposed_row_us:7.2f}  {p.t_step_us:8.1f}  "
            f"{p.efficiency:5.2f}"
            + ("  [all-gather]" if p.all_gather else "")
        )
    return "\n".join(lines)
